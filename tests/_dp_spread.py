"""How far the data-parallel trainer's 6-step trajectory can be expected
to lie from the reference's single process: the reference trainer against
itself with every step's raveled gradient multiplied by ``1 + EPS * xi``
(xi standard normal, a fresh draw a step; ``_trajectory_spread.
run_reference``), three draws, beside the port on 1 and 2 gloo ranks.  The
basis of ``test_torch_distributed.LOSS_SPREAD``; a diagnostic, not a test:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_dp_spread.py

EPS 1e-6 is a summation-order rounding of each element of the reduced
gradient (two ranks' partial sums against the whole batch's).
"""
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import _trajectory_spread as ts  # noqa: E402
import test_torch_distributed as td  # noqa: E402


def main(eps=1e-6, draws=3):
    ts._src = td._src           # the data-parallel tests' batches
    ts.CFG32 = td.CFG32
    for compress in (False, True):
        over = dict(td.DP_TRAIN, **(td.COMPRESS if compress else {}))
        over.pop("fused_loss")   # run_reference sets it
        _, base = ts.run_reference(over, td.STEPS)
        base = np.array([h["loss"] for h in base])
        spread = 0.0
        for seed in range(draws):
            _, hist = ts.run_reference(over, td.STEPS, eps=eps, seed=seed)
            rel = np.abs(np.array([h["loss"] for h in hist]) - base) / base
            spread = max(spread, rel.max())
        print(f"compress={compress}: the reference against itself at eps "
              f"{eps:g}: losses within {spread:.3g} relative")
        for world in (1, 2):
            with tempfile.TemporaryDirectory() as tmp:
                res, ref = td.port_run(Path(tmp), dict(over, fused_loss=True),
                                       world)
            rel = np.abs(res[0]["loss"] - np.asarray(ref)) / np.abs(ref)
            print(f"  the port on {world} rank(s): within {rel.max():.3g} "
                  f"relative ({rel.max() / max(spread, 1e-30):.2f}x)")


if __name__ == "__main__":
    main()
