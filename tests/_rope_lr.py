"""The rope models' first Sophia-G steps at several peak learning rates on
the card, through ``chip_smoke.train_model`` (bf16, engine kernels, the
GNB refresh every 3 steps on half the batch, B x S=2048; NeoX-6.6B at 8
layers): the losses behind phase 4c's choice of 1e-5.  A diagnostic
behind PERF.md, not a test (pytest does not collect it); it needs an
NVIDIA GPU and nvcc:

    python3 tests/_rope_lr.py [lr ...]        # default 1e-4 3e-5 1e-5

A run whose loss does not end below its start is logged, not raised.
"""
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main(argv):
    import torch

    lrs = [float(x) for x in argv] or [1e-4, 3e-5, 1e-5]
    cs.log(cs.card_line())
    cs.phase_build()
    for name, cfg, layers, B in cs._model_runs():
        for lr in lrs:
            try:
                cs.train_model(torch, name,
                               dataclasses.replace(cfg, n_layers=layers), B,
                               peak_lr=lr)
            except AssertionError as err:
                cs.log(f"[lr] {name} lr={lr:g}: {err}")
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main(sys.argv[1:])
