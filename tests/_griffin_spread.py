"""Rounding spreads of the Griffin port on the CPU, behind the bounds its
tests and ``chip_smoke.py`` hold (a diagnostic; pytest does not collect
it).

``--routes``: the two serving routes, the engine's (``prefill_into_slot``
token by token, then ``decode_slots``) and the lockstep's (``decode_step``
of every row), teacher-forced over 2 prompts of 24 tokens and 8 more in
fp32 at recurrentgemma-2b's 26 layers, cut in width (d 256 and 512, hd
128, window 16, vocab 4096), random weights from a seed: their largest
logit gap over the largest logit, and how far a one-ulp move of every
weight moves the lockstep's logits.  These set
``chip_smoke.GRIFFIN_ROUTE_TOL_F32``.

``--bf16``: the smoke config (5 layers) in bf16 against the reference
compiled with XLA's excess precision off (``REF_BF16``): the logits'
largest gap over the largest logit, each model's bf16 logits from the
reference's fp32 ones, their RMS ratio, and the share of GeGLU gate
elements where ``F.gelu`` and ``jax.nn.gelu`` round apart.  These set
``tests/test_torch_griffin.py:BF16_RTOL``.

    PYTHONPATH=src python tests/_griffin_spread.py --routes --bf16
"""
import argparse
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import get_model  # noqa: E402


def routes(widths=(256, 512), N=2, S=24, T=8):
    full = get_config("recurrentgemma-2b")
    for d in widths:
        cfg = dataclasses.replace(full, d_model=d, rnn_width=d,
                                  n_heads=2 * max(1, d // 256), head_dim=128,
                                  d_ff=3 * d, vocab_size=4096,
                                  dtype="float32", local_window=16)
        m = get_model(cfg)
        p = m.init_params(cfg, torch.Generator().manual_seed(0))
        rng = np.random.default_rng(0)
        seq = torch.from_numpy(rng.integers(0, cfg.vocab_size, (N, S + T))
                               .astype(np.int32))

        def lock(params):
            cache = m.init_cache(cfg, N, 0)
            out = []
            for t in range(S + T - 1):
                lg = m.decode_step(cfg, params, cache, seq[:, t:t + 1], t)
                if t >= S - 1:
                    out.append(lg[:, 0])
            return torch.stack(out, 1)

        def engine(params):
            st = m.init_slots(cfg, N, 0)
            out = [torch.stack([m.prefill_into_slot(
                cfg, params, st, i, seq[i:i + 1, :S], 0, S)
                for i in range(N)])]
            for t in range(T - 1):
                pos = torch.full((N,), S + t, dtype=torch.int32)
                out.append(m.decode_slots(cfg, params, st,
                                          seq[:, S + t:S + t + 1], pos)[:, 0])
            return torch.stack(out, 1)

        a, b = lock(p), engine(p)
        scale = a.abs().amax(-1)
        gap = float(((a - b).abs().amax(-1) / scale).max())
        gen = torch.Generator().manual_seed(5)
        with torch.no_grad():
            for q in p.parameters():
                s = torch.randint(0, 2, q.shape, generator=gen).float()
                q.mul_(1 + (2 * s - 1) * 2.0 ** -23)
        moved = float(((a - lock(p)).abs().amax(-1) / scale).max())
        print(f"d {d}, {cfg.n_layers} layers, fp32: the routes' logits "
              f"{gap:.3g} of the largest apart; a one-ulp move of every "
              f"weight moves them {moved:.3g}")


def bf16():
    import jax
    import math

    import torch.nn.functional as F
    from _griffin_models import batch, griffin_cfg, port_params, ref_params
    from _rope_models import tcfg
    from _rwkv_models import REF_BF16
    from repro.models import griffin as jg
    from repro_torch.models import griffin as tg

    cfg = griffin_cfg(dtype="bfloat16")
    c32 = dataclasses.replace(cfg, dtype="float32")
    params = ref_params(cfg)
    tp = port_params(cfg, params)
    jb, tb = batch(cfg)
    want = np.asarray(jax.jit(lambda p: jg.forward(cfg, p, jb["tokens"])[0],
                              compiler_options=REF_BF16)(params))
    f32 = np.asarray(jg.forward(c32, params, jb["tokens"])[0])
    got = tg.forward(tcfg(cfg), tp, tb["tokens"])[0].detach().numpy()

    def rel(x, y):
        return float(np.abs(x - y).max() / np.abs(y).max())

    def rms(x):
        return float(np.sqrt(np.mean(np.square(x))))

    print(f"bf16, {cfg.n_layers} layers: the port {rel(got, want):.3g} of "
          f"the largest logit from the reference; from the fp32 logits: "
          f"the port {rel(got, f32):.3g}, the reference {rel(want, f32):.3g}"
          f"; RMS ratio {rms(got - f32) / rms(want - f32):.3g}")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 40, 64)).astype(np.float32)).to(torch.bfloat16)
    c = torch.tensor(math.sqrt(2 / math.pi)).to(torch.bfloat16)
    op_by_op = x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3))))
    once = F.gelu(x, approximate="tanh")
    print(f"GeGLU gate: F.gelu and jax.nn.gelu's formula op by op differ in "
          f"{float((op_by_op != once).float().mean()):.1%} of the elements")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--routes", action="store_true")
    ap.add_argument("--bf16", action="store_true")
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    if args.routes:
        routes()
    if args.bf16:
        bf16()


if __name__ == "__main__":
    main()
