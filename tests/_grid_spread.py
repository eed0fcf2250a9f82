"""How far the (2, 2) grid's 7-step parameters can be expected to lie from
the reference's single process: the reference trainer against itself with
every step's raveled gradient multiplied by ``1 + EPS * xi`` (xi standard
normal, a fresh draw a step; ``_trajectory_spread.run_reference``), three
draws, for each config of ``test_torch_tensor_parallel``, beside the port
on the grid.  Each number is the largest deviation of a leaf's element as a
share of the leaf's largest element.  The basis of
``test_torch_tensor_parallel.PARAM_BOUND``; a diagnostic, not a test:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_grid_spread.py
"""
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _trajectory_spread as ts  # noqa: E402
import test_torch_tensor_parallel as tp  # noqa: E402


def leaf_share(a, b, sizes):
    out, off = 0.0, 0
    for n in sizes:
        x, y = a[off:off + n], b[off:off + n]
        out = max(out, float(np.abs(x - y).max() / np.abs(y).max()))
        off += n
    return out


def main(eps=1e-6, draws=3):
    ts._src = tp._src
    for name, cfg in sorted(tp.CFGS.items()):
        ts.CFG32 = cfg
        over = {k: v for k, v in tp.TRAIN.items() if k != "fused_loss"}
        base, _ = ts.run_reference(over, tp.STEPS)
        sizes = tp.leaf_sizes(name)
        spread = max(leaf_share(ts.run_reference(over, tp.STEPS, eps=eps,
                                                 seed=s)[0], base, sizes)
                     for s in range(draws))
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            ck = tp.init_checkpoint(tmp, name)
            res = tp.spawn(tmp, (2, 2), name, ckpt_dir=ck,
                           seeds=tmp / "seeds.npz",
                           tc=json.dumps(tp.TRAIN), steps=tp.STEPS)
        port = leaf_share(res[0]["params"], tp.reference(name)[4], sizes)
        print(f"{name}: the reference against itself at eps {eps:g}: "
              f"parameters within {spread:.3g} of a leaf's largest; the "
              f"port on (2, 2): {port:.3g} ({port / spread:.2f}x)")


if __name__ == "__main__":
    main()
