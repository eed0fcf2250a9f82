"""The grid's code on one card, before a four-card call: ``chip_smoke.py``'s
phase 7, then its ``--model-axis`` step-0 checks and training runs on a
(1, 1) grid under NCCL at world size 1 (every collective skipped; NeoX-6.6B
at 4 layers, deepseek-moe-16b at 2, both dispatches).  A diagnostic, not a
test; on a machine with one H100, from the root of a checkout:

    python3 tests/_grid_one_card.py
"""
import dataclasses
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def main():
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.configs.gpt2 import NEOX_6_6B
    from repro_torch.launch.mesh import initialize_distributed, make_mesh

    cs.phase_build()
    cs.phase_grid(torch)
    initialize_distributed(f"127.0.0.1:{cs._free_port()}", 1, 0)
    grid = make_mesh((1, 1))
    moe = get_config("deepseek-moe-16b")
    # one process against itself: the checks' plumbing
    cs.grid_step0(torch, "neox-6.6b", NEOX_6_6B, grid, 2, 2048)
    cs.grid_step0(torch, "deepseek-moe-16b", moe, grid, 4, 2048)
    cs.grid_train(torch, "neox-6.6b",
                  dataclasses.replace(NEOX_6_6B, n_layers=4), grid, 2, 2048,
                  4, 3)
    for impl in ("gspmd", "a2a"):
        cs.grid_train(torch, "deepseek-moe-16b",
                      dataclasses.replace(moe, n_layers=2), grid, 4, 2048, 4,
                      2, moe_impl=impl)
    print("GRID1_OK", flush=True)


if __name__ == "__main__":
    main()
