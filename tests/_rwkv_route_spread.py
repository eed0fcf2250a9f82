"""How far apart rounding puts the two RWKV serving routes: the engine's
(``prefill_into_slot`` in chunks of 16, then ``decode_slots``) and the
lockstep's (``decode_step`` one token at a time), teacher-forced over 2
prompts of 24 tokens and 8 more (``chip_smoke.serving_routes``), on
rwkv6-7b's layout with random weights from a seed, in each dtype given.
The largest difference of the two routes' logits, over the largest logit,
at each position.  The fp32 and fp64 gaps at 32 layers set
``chip_smoke.RWKV_ROUTE_TOL_F64``.  On the card, at full width:

    python3 tests/_rwkv_route_spread.py

on the CPU, cut in width (d 1024):

    PYTHONPATH=src python tests/_rwkv_route_spread.py --device cpu --d-model 1024
"""
import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import serving_routes  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import get_model  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--d-model", type=int, default=None,
                    help="a width other than rwkv6-7b's 4096 (d_ff 3.5x)")
    ap.add_argument("--dtypes", default="float32,float64")
    ap.add_argument("--seed", type=int, default=10)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("rwkv6-7b"), n_layers=args.layers)
    if args.d_model:
        cfg = dataclasses.replace(cfg, d_model=args.d_model,
                                  n_heads=args.d_model // 64,
                                  n_kv_heads=args.d_model // 64,
                                  d_ff=args.d_model * 7 // 2)
    params = get_model(cfg).init_params(
        cfg, torch.Generator(device=args.device).manual_seed(0))
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    np.set_printoptions(precision=3, linewidth=120)
    for dtype in args.dtypes.split(","):
        t0 = time.perf_counter()
        diff, gap = serving_routes(torch, dataclasses.replace(cfg, dtype=dtype),
                                params, prompts, tokens, device=args.device)
        print(f"[route spread] {cfg.n_layers} layers, d {cfg.d_model}, "
              f"{dtype} on {args.device} ({time.perf_counter() - t0:.1f}s): "
              f"the routes' logits differ by up to {diff.max():.3g} of the "
              f"largest (smallest lockstep top-2 gap {gap.min():.3g}); by "
              f"position:\n{diff}", flush=True)


if __name__ == "__main__":
    main()
