"""The port's CUDA kernels on the card: each against its plain PyTorch
version, the serve engine's launch count and the trainer's (flash
attention, the fused CE and the engine kernels).  Every test here needs an
NVIDIA GPU; each carries the ``cuda`` marker and skips without one.  The
file imports no JAX, so it runs on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.gpt2 import GPT2_TINY
from repro_torch.data import DataConfig, make_source
from repro_torch.kernels import (KERNEL_LAUNCHES, flash_attention, fused_ce,
                                 reset_launch_counts, sophia_update)
from repro_torch.kernels.decode_attention import (decode_attention,
                                                   decode_attention_plain)
from repro_torch.models import get_model
from repro_torch.quant import quantize_kv
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import TrainerConfig, make_train_fns, train_loop

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dt,quant", [(torch.float32, False),
                                      (torch.bfloat16, False),
                                      (torch.float32, True),
                                      (torch.bfloat16, True)])
@pytest.mark.parametrize("N,H,Hkv,C,hd,window,softcap,positions", [
    (8, 12, 12, 512, 64, None, None, None),   # GPT-2 small serving shape
    (4, 8, 2, 48, 128, None, None, None),     # GQA, ring off the kernel's tile
    (3, 4, 2, 64, 256, 12, 50.0, None),       # window + softcap
    # full_ctx_c1024: GPT-2's whole context over 8 slots, S = 2 splits
    (8, 12, 12, 1024, 64, None, None,
     [1023, 1024, 1500, 2047, 3000, 1023, 1100, 4095]),
    # batch64_c1024: 64 slots fill the card alone, S = 1
    (64, 12, 12, 1024, 64, None, None, [1023 + 37 * i for i in range(64)]),
    # negative_pos: every row masked, the uniform average over the ring
    # merged from S = 4 splits
    (3, 12, 12, 64, 64, None, None, [-1, -7, 3]),
    # splits_past_rows: most of the S = 4 splits have no rows
    (4, 12, 12, 512, 64, None, None, [0, 1, 2, 3]),
    # NeoX-6.6B's serving heads: hd 128, 32 heads
    (8, 32, 32, 512, 128, None, None, None),
    # yi-6b's (32 over 4) and qwen1.5-110b's (64 over 8): group 8
    (8, 32, 4, 512, 128, None, None, None),
    (8, 64, 8, 512, 128, None, None, None),
    # gemma2-9b's: hd 256, 16 over 8, softcap 50, its window binding
    (4, 16, 8, 8192, 256, 4096, 50.0, [4095, 5000, 8191, 12000]),
    # qwen2-vl-7b's group of 7 (28 over 4): the engine's ring, and the
    # lockstep decode's one row over a 32k prompt's linear cache
    (8, 28, 4, 512, 128, None, None, None),
    (1, 28, 4, 32776, 128, None, None, [32770]),
])
def test_decode_attention_kernel_matches_plain(cuda_device, dt, quant, N, H,
                                               Hkv, C, hd, window, softcap,
                                               positions):
    """fp32 within 1e-5 (sums in another order), bf16 within 2e-2 (the
    reference tests' bf16 bound).  Positions default to a spread over
    three laps of the ring."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    q = torch.randn((N, H, hd), generator=gen, device=cuda_device).to(dt)
    k = torch.randn((N, C, Hkv, hd), generator=gen, device=cuda_device)
    v = torch.randn((N, C, Hkv, hd), generator=gen, device=cuda_device)
    if positions is None:
        positions = [(i * 97 + 5) % (3 * C) for i in range(N)]
    pos = torch.tensor(positions, dtype=torch.int32, device=cuda_device)
    kw = dict(window=window, softcap=softcap)
    if quant:
        k, kw["k_scale"] = quantize_kv(k)
        v, kw["v_scale"] = quantize_kv(v)
    else:
        k, v = k.to(dt), v.to(dt)
    reset_launch_counts()
    got = decode_attention(q, k, v, pos, **kw)
    torch.cuda.synchronize()
    assert sum(KERNEL_LAUNCHES.values()) == 1
    want = decode_attention_plain(q, k, v, pos, **kw)
    atol = 1e-5 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


@pytest.mark.parametrize("dt,quant", [(torch.float32, False),
                                      (torch.bfloat16, False),
                                      (torch.float32, True),
                                      (torch.bfloat16, True)])
@pytest.mark.parametrize("hd", [64, 128, 256])
@pytest.mark.parametrize("G", [9, 10, 12, 16])
def test_decode_attention_head_tiles_match_plain(cuda_device, dt, quant, hd,
                                                 G):
    """Groups above 8 query heads per KV head run in two tiles of heads
    (recurrentgemma-2b's 10 over 1 at hd 256 among them): against the
    plain version at C 2048 with positions before and after the ring
    wraps, over 2 KV heads, fp32 within 1e-5 and bf16 within 2e-2."""
    N, Hkv, C = 4, 2, 2048
    gen = torch.Generator(device=cuda_device).manual_seed(G * hd)
    q = torch.randn((N, G * Hkv, hd), generator=gen, device=cuda_device).to(dt)
    k = torch.randn((N, C, Hkv, hd), generator=gen, device=cuda_device)
    v = torch.randn((N, C, Hkv, hd), generator=gen, device=cuda_device)
    pos = torch.tensor([100, 2047, 2048, 5000], dtype=torch.int32,
                       device=cuda_device)
    kw = {}
    if quant:
        k, kw["k_scale"] = quantize_kv(k)
        v, kw["v_scale"] = quantize_kv(v)
    else:
        k, v = k.to(dt), v.to(dt)
    reset_launch_counts()
    got = decode_attention(q, k, v, pos, **kw)
    torch.cuda.synchronize()
    assert sum(KERNEL_LAUNCHES.values()) == 1
    want = decode_attention_plain(q, k, v, pos, **kw)
    atol = 1e-5 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_engine_on_card_matches_cpu_and_launches_per_layer(cuda_device,
                                                           kv_dtype):
    """The engine on the card emits the CPU engine's greedy tokens (fp32,
    same weights) and launches the kernel once per layer per decode step.
    Two heads give GPT2_TINY's width a head dim of 64, one the kernel
    takes (its own 32 is refused)."""
    cfg = dataclasses.replace(GPT2_TINY, n_heads=2, n_kv_heads=2,
                              dtype="float32", kv_dtype=kv_dtype)
    params = get_model(cfg).init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0))
    rng = np.random.default_rng(1)
    spec = [(5, 7), (13, 3), (8, 9), (21, 5)]

    def run(device, p):
        eng = ServeEngine(cfg, p, n_slots=2, cache_len=64, page_len=8,
                          steps_per_tick=4, device=device)
        for i, (sp, mn) in enumerate(spec):
            eng.submit(Request(uid=i, tokens=prompts[i], max_new=mn))
        reset_launch_counts()
        out = {r.uid: r.tokens for r in eng.run()}
        return out, dict(KERNEL_LAUNCHES), eng

    prompts = [rng.integers(0, cfg.vocab_size, sp) for sp, _ in spec]
    got, launches, eng = run(cuda_device, params)
    want, _, _ = run("cpu", params.cpu())
    assert got == want
    name = "decode_attention_q8" if kv_dtype == "int8" else "decode_attention"
    assert launches == {name: cfg.n_layers * eng.decode_ticks
                        * eng.steps_per_tick}


@pytest.mark.parametrize("h_dtype,w_dtype", [(torch.float32, torch.float32),
                                             (torch.bfloat16, torch.float32),
                                             (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("tied,norm,softcap", [(True, "ln", None),
                                               (False, "rms", 30.0),
                                               (True, None, None)])
def test_fused_ce_kernels_match_plain(cuda_device, h_dtype, w_dtype, tied,
                                      norm, softcap):
    """Each CE kernel (forward, sampled forward, dh, dW) against its plain
    version at a small shape with a padded vocab, ragged rows and a mask
    (bf16 h: the tensor-core kernels; fp32 h: the FMA ones): fp32 within
    1e-5, bf16 within 2e-2 (dh and dW relative to their scale); the same
    draws (no near-ties at this size), never a padded column."""
    N, D, V, Vp = 77, 128, 1000, 1024
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    h = (torch.randn((N, D), generator=gen, device=cuda_device) * 2
         ).to(h_dtype)
    w = (torch.randn((Vp, D) if tied else (D, Vp), generator=gen,
                     device=cuda_device) * 0.05).to(w_dtype)
    normp = torch.stack([1.0 + 0.1 * torch.randn(D, generator=gen,
                                                 device=cuda_device),
                         0.1 * torch.randn(D, generator=gen,
                                           device=cuda_device)])
    labels = torch.randint(0, V, (N,), generator=gen, device=cuda_device,
                           dtype=torch.int32)
    mask = (torch.rand((N,), generator=gen, device=cuda_device) > 0.3).float()
    rs, _ = fused_ce.rowscale(N, mask)
    opts = dict(vocab=V, transpose_w=not tied, softcap=softcap, norm=norm)
    tol = 1e-5 if h_dtype == w_dtype == torch.float32 else 2e-2
    reset_launch_counts()
    lse, ll = fused_ce.ce_forward(h, w, normp, labels, **opts)
    lse_s, ll_s, y = fused_ce.ce_forward_sampled(h, w, normp, (5, 6), **opts)
    dh = fused_ce.ce_backward_dh(h, w, normp, labels, rs, lse, **opts)
    dw = fused_ce.ce_backward_dw(h, w, normp, labels, rs, lse, **opts)
    torch.cuda.synchronize()
    assert dict(KERNEL_LAUNCHES) == {"ce_forward": 1, "ce_forward_sampled": 1,
                                     "ce_backward_dh": 1, "ce_backward_dw": 1}
    lse_p, ll_p = fused_ce.ce_forward_plain(h, w, normp, labels, **opts)
    lse_sp, ll_sp, y_p = fused_ce.ce_forward_sampled_plain(h, w, normp,
                                                           (5, 6), **opts)
    dh_p, dw_p = fused_ce.ce_backward_plain(h, w, normp, labels, rs, lse,
                                            **opts)
    for got, want in ((lse, lse_p), (ll, ll_p), (lse_s, lse_sp),
                      (ll_s, ll_sp)):
        torch.testing.assert_close(got, want, rtol=0, atol=tol)
    assert torch.equal(y, y_p) and int(y.max()) < V
    for got, want in ((dh, dh_p), (dw, dw_p)):
        assert got.dtype == want.dtype
        scale = want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= tol * scale


def test_fused_ce_backward_at_gpt2_width(cuda_device):
    """dh and dW at GPT-2 small's loss width on the tensor-core route
    (bf16 h, fp32 tied W, ln fused): N=1000 ragged rows under a mask,
    D=768, Vp=50304, held element by element as ``chip_smoke.py`` holds
    them (``check_bf16_grad``: none beyond 2^-7 of its sum of absolute
    terms, at most 0.1% beyond 2^-16 of it), and the padded rows' d and the
    workspace never reach the output: every element finite."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs

    spec = dict(cs.CE_MAIN, N=1000, mask=True)
    h, w, normp, labels, rs, opts = cs._ce_inputs(torch, **spec)
    lse, _ = fused_ce.ce_forward_plain(h, w, normp, labels, **opts)
    reset_launch_counts()
    dh = fused_ce.ce_backward_dh(h, w, normp, labels, rs, lse, **opts)
    dw = fused_ce.ce_backward_dw(h, w, normp, labels, rs, lse, **opts)
    torch.cuda.synchronize()
    assert dict(KERNEL_LAUNCHES) == {"ce_backward_dh": 1, "ce_backward_dw": 1}
    dh_p, dw_p = fused_ce.ce_backward_plain(h, w, normp, labels, rs, lse,
                                            **opts)
    sums = cs._abs_sums(torch, h, w, normp, labels, rs, lse, opts)
    for name, got, want, s in (("dh", dh, dh_p, sums[0]),
                               ("dw", dw, dw_p, sums[1])):
        assert got.dtype == want.dtype and bool(torch.isfinite(got).all())
        cs.check_bf16_grad(torch, name, got, want, s)


def test_fused_ce_forward_at_gpt2_width(cuda_device):
    """The forward and the sampled forward at GPT-2 small's loss width on
    the tensor-core route (bf16 h, fp32 tied W, ln fused), N=1000 ragged
    rows (off the 128-row tile) and a vocabulary padded from 50257 to
    50304, held as ``chip_smoke.py`` holds them: lse and the label or
    drawn logit within the bf16 tolerance, every value finite, the draws
    equal to the plain version's except at near-ties (``_draw_gaps``) and
    never on a padded column."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke as cs

    spec = dict(cs.CE_MAIN, N=1000, V=50257)
    h, w, normp, labels, _, opts = cs._ce_inputs(torch, **spec)
    reset_launch_counts()
    lse, ll = fused_ce.ce_forward(h, w, normp, labels, **opts)
    lse_s, ll_s, y = fused_ce.ce_forward_sampled(h, w, normp, cs.CE_SEED,
                                                 **opts)
    torch.cuda.synchronize()
    assert dict(KERNEL_LAUNCHES) == {"ce_forward": 1, "ce_forward_sampled": 1}
    lse_p, ll_p = fused_ce.ce_forward_plain(h, w, normp, labels, **opts)
    lse_sp, ll_sp, y_p = fused_ce.ce_forward_sampled_plain(
        h, w, normp, cs.CE_SEED, **opts)
    tol = cs.TOL["bfloat16"]
    same = y == y_p
    near = cs._draw_gaps(torch, h, w, normp, opts) < cs.NEAR_TIE
    assert not bool((~same & ~near).any()) and int(y.max()) < spec["V"]
    for got, want in ((lse, lse_p), (ll, ll_p), (lse_s, lse_sp),
                      (ll_s[same], ll_sp[same])):
        assert bool(torch.isfinite(got).all())
        assert (got - want).abs().max().item() <= tol


def test_hutchinson_hvp_launches_no_backward_kernel(cuda_device):
    """u ⊙ Hu on GPT2_TINY (fp32, two heads of 64) through the loss and
    flash twins on the card: the HVP, forward-over-reverse, launches the
    CE forward once and the attention forward once per layer, and no CE
    or attention backward kernel; the estimate equals the CPU's (the twins'
    plain versions) within 1e-4 of its largest element."""
    from repro_torch.core import build_layout, functional_loss
    from repro_torch.core.estimators import hutchinson_estimator_flat
    from repro_torch.core.types import flat_tensors

    cfg = dataclasses.replace(GPT2_TINY, n_heads=2, n_kv_heads=2,
                              dtype="float32")
    model = get_model(cfg)
    params = model.init_params(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 128))
                                 .astype(np.int64))
             for k in ("tokens", "labels")}
    tree = params.param_tree()
    lay = build_layout(tree)
    u = tuple(torch.from_numpy(rng.standard_normal(n).astype(np.float32))
              for n in lay.shard_sizes)

    def estimate(p, b, probe):
        t = p.param_tree()
        loss = functional_loss(p, flat_tensors(t), lambda m: model.loss_fn(
            cfg, m, b, attn_impl="flash_jvp", loss_impl="fused_jvp")[0])
        return hutchinson_estimator_flat(loss, t, probe, lay)

    want = estimate(params, batch, u)
    card = params.to(cuda_device)
    reset_launch_counts()
    got = estimate(card, {k: v.to(cuda_device) for k, v in batch.items()},
                   tuple(x.to(cuda_device) for x in u))
    torch.cuda.synchronize()
    assert dict(KERNEL_LAUNCHES) == {"ce_forward": 1,
                                     "attn_fwd": cfg.n_layers}
    for a, b in zip(got, want):
        scale = b.abs().max().item()
        assert (a.cpu() - b).abs().max().item() <= 1e-4 * scale


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,hd,causal,window,softcap,qoff", [
    (2, 4, 4, 256, 256, 64, True, None, None, 0),     # GPT-2's layout
    (1, 8, 2, 128, 192, 128, True, 48, 20.0, 64),     # GQA, window, softcap
    (2, 2, 1, 100, 100, 32, False, None, None, 0),    # off the tile
    (2, 4, 4, 192, 192, 128, True, None, None, 0),    # hd 128
    (2, 8, 2, 256, 256, 64, True, None, None, 0),     # GQA 8/2
    (1, 32, 32, 2048, 2048, 128, True, None, None, 0),  # NeoX-6.6B, S 2048
    # hd 256 (gemma2): GQA 2 with window and softcap off the tile, a
    # q_offset, non-causal, and a 2048-token slice of its local layer
    (2, 4, 2, 300, 300, 256, True, 40, 50.0, 0),
    (1, 4, 2, 160, 256, 256, True, None, None, 96),
    (1, 2, 1, 100, 130, 256, False, None, None, 0),
    (1, 16, 8, 2048, 2048, 256, True, 1024, 50.0, 0),
    # qwen2-vl-7b's group of 7 at hd 128: its training shape
    (2, 28, 4, 2048, 2048, 128, True, None, None, 0),
])
def test_flash_attention_kernels_match_plain(cuda_device, dt, B, H, Hkv, Sq,
                                             Sk, hd, causal, window, softcap,
                                             qoff):
    """The forward, dQ and dK/dV kernels against their plain versions on
    the same inputs: o, lse, dq, dk and dv within 1e-5 (fp32) or 2e-2
    (bf16) of each output's largest element; in bf16 (the tensor-core
    kernels) also every element of o, dq, dk and dv within 2^-7 of its
    absolute sum (``flash_attention.contract_sums``)."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    q, g = (torch.randn((B, H, Sq, hd), generator=gen, device=cuda_device)
            .to(dt) for _ in range(2))
    k, v = (torch.randn((B, Hkv, Sk, hd), generator=gen, device=cuda_device)
            .to(dt) for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff,
              scale=hd ** -0.5)
    reset_launch_counts()
    o, lse = flash_attention.flash_forward(q, k, v, **kw)
    delta = (g.float() * o.float()).sum(-1)
    dq = flash_attention.flash_backward_dq(q, k, v, g, lse, delta, **kw)
    dk, dv = flash_attention.flash_backward_dkv(q, k, v, g, lse, delta, **kw)
    torch.cuda.synchronize()
    assert dict(KERNEL_LAUNCHES) == {"attn_fwd": 1, "attn_bwd_dq": 1,
                                     "attn_bwd_dkv": 1}
    want = (flash_attention.flash_forward_plain(q, k, v, **kw)
            + (flash_attention.flash_backward_dq_plain(q, k, v, g, lse, delta,
                                                       **kw),)
            + flash_attention.flash_backward_dkv_plain(q, k, v, g, lse, delta,
                                                       **kw))
    tol = 1e-5 if dt == torch.float32 else 2e-2
    for got, ref in zip((o, lse, dq, dk, dv), want):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        scale = ref.float().abs().max().item()
        assert (got.float() - ref.float()).abs().max().item() <= tol * scale
    if dt == torch.bfloat16:
        sums = flash_attention.contract_sums(q, k, v, g, lse, delta, **kw)
        got = dict(o=o, dq=dq, dk=dk, dv=dv)
        ref = dict(zip(("o", "dq", "dk", "dv"), (want[0],) + want[2:]))
        for name, s in sums.items():
            assert flash_attention.contract_misses(got[name], ref[name],
                                                   s)[0] == 0, name


@pytest.mark.parametrize("hd", [48, 512])
def test_flash_attention_kernel_refuses_head_dim(cuda_device, hd):
    """A head dim without a kernel instance raises on the card: no plain
    fallback."""
    q = torch.zeros((1, 2, 64, hd), device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention(q, q, q)


def test_trainer_launches_the_ce_kernels(cuda_device):
    """Four GPT2_TINY steps on the card (refresh at 0 and 2) on the
    default flash route: one CE forward, dh and dW per step, one more of
    each with the sampled forward per refresh, and each attention kernel
    once per layer for every step and every refresh; the losses agree with
    the CPU's plain path (fp32)."""
    cfg = dataclasses.replace(GPT2_TINY, dtype="float32")
    tc = TrainerConfig(peak_lr=5e-4, total_steps=8, warmup_steps=2,
                       hess_interval=2, hess_subbatch=2)
    hist, hist_cpu, launches = _train_card_and_cpu(cuda_device, cfg, tc)
    per_layer = cfg.n_layers * 6
    assert launches == {"ce_forward": 4, "ce_forward_sampled": 2,
                        "ce_backward_dh": 6, "ce_backward_dw": 6,
                        "attn_fwd": per_layer, "attn_bwd_dq": per_layer,
                        "attn_bwd_dkv": per_layer}
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in hist_cpu], rtol=1e-4)


def test_trainer_materialized_attention_on_card(cuda_device):
    """fused_attn=False keeps the materialized-scores route: no attention
    kernel launches, the CE kernels as before, losses as on the CPU."""
    cfg = dataclasses.replace(GPT2_TINY, dtype="float32")
    tc = TrainerConfig(peak_lr=5e-4, total_steps=8, warmup_steps=2,
                       hess_interval=2, hess_subbatch=2, fused_attn=False)
    hist, hist_cpu, launches = _train_card_and_cpu(cuda_device, cfg, tc)
    assert launches == {"ce_forward": 4, "ce_forward_sampled": 2,
                        "ce_backward_dh": 6, "ce_backward_dw": 6}
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in hist_cpu], rtol=1e-4)


def _cpu_probe(seed, device):
    """Hutchinson's probe drawn on the CPU and moved to ``device``, so
    that the card and the CPU run see the same u."""
    from repro_torch.train import hess_probe

    def probe(step, layout):
        return tuple(u.to(device)
                     for u in hess_probe(seed, step, layout, "cpu"))
    return probe


def _cpu_noise(seed, device):
    """The Gumbel noise of the chunked GNB sweep drawn on the CPU and moved
    to ``device``: the card and the CPU run then draw the same labels."""
    from repro_torch.core.estimators import gumbel
    from repro_torch.train import hess_generator

    def noise(step, shape):
        return gumbel(shape, hess_generator(seed, step, "cpu")).to(device)
    return noise


def _train_card_and_cpu(cuda_device, cfg, tc):
    """Four steps on the card and on the CPU from the same weights,
    Hutchinson probes and Gumbel noise: (card history, CPU history, the
    card run's launch counts)."""
    src = make_source(DataConfig(seq_len=32, global_batch=4,
                                 vocab_size=cfg.vocab_size))
    init_fn, _ = make_train_fns(cfg, tc, device=cuda_device)
    state = init_fn()
    cpu_params = get_model(cfg).init_params(cfg, torch.Generator())
    cpu_params.load_state_dict({k: v.cpu() for k, v in
                                state.params.state_dict().items()})
    reset_launch_counts()
    state, hist = train_loop(cfg, tc, src, num_steps=4, state=state,
                             device=cuda_device,
                             probe_fn=_cpu_probe(tc.seed, cuda_device),
                             noise_fn=_cpu_noise(tc.seed, cuda_device))
    launches = dict(KERNEL_LAUNCHES)
    cpu_init, _ = make_train_fns(cfg, tc, device="cpu")
    _, hist_cpu = train_loop(cfg, tc, src, num_steps=4,
                             state=cpu_init(cpu_params), device="cpu",
                             probe_fn=_cpu_probe(tc.seed, "cpu"),
                             noise_fn=_cpu_noise(tc.seed, "cpu"))
    return hist, hist_cpu, launches


# ---------------------------------------------------------------------------
# the engine kernels (rows 2-4 and 6)

SOPHIA = dict(beta1=0.96, gamma=0.05, eps=1e-12, weight_decay=0.2)
ADAMW = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.2)
ADAHESSIAN = dict(beta1=0.92, beta2=0.99, eps=1e-8, weight_decay=0.2)


def _bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _assert_bitwise(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


def _engine_operands(device, n, pdt, sdt, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(scale=1.0):
        return torch.randn((n,), generator=gen, device=device) * scale

    h = randn(0.01)
    h[::7] = 0.0            # zeros and negatives: max(gamma h, eps) = eps
    return (randn().to(pdt), randn(0.1).to(sdt), h.to(sdt), randn(0.1),
            randn(0.1).square())


@pytest.mark.parametrize("n,block", [(3 * 128, 128), (2 * 131072, 131072)])
@pytest.mark.parametrize("pdt,sdt", [(torch.float32, torch.float32),
                                     (torch.float32, torch.bfloat16),
                                     (torch.bfloat16, torch.bfloat16)])
def test_engine_kernels_match_plain_bitwise(cuda_device, n, block, pdt, sdt):
    """Rows 2, 3 (square off and on), 4 (flag 0 and 1) and 6 (steps 1 and
    1000) against their plain versions on the same device tensors: every
    output and every per-block clip count bit for bit, one launch each."""
    p, m, h, g, e = _engine_operands(cuda_device, n, pdt, sdt)
    lr = torch.tensor(3e-3, device=cuda_device)
    scale = torch.tensor(240.0, device=cuda_device)
    calls = [
        ("sophia_step", sophia_update.sophia_fused_block,
         sophia_update.sophia_fused_block_plain, (p, m, h, g, lr),
         dict(SOPHIA, block=block))]
    for square in (False, True):
        calls.append(("hessian_ema", sophia_update.hessian_ema_block,
                      sophia_update.hessian_ema_block_plain, (h, e),
                      dict(beta2=0.99, scale=scale, square=square,
                           block=block)))
    for flag in (0, 1):
        calls.append(("sophia_refresh",
                      sophia_update.sophia_refresh_fused_block,
                      sophia_update.sophia_refresh_fused_block_plain,
                      (p, m, h, g, e, lr, flag, scale),
                      dict(SOPHIA, beta2=0.99, block=block)))
    for step in (1, 1000):
        calls.append(("adamw_step", sophia_update.adamw_fused_block,
                      sophia_update.adamw_fused_block_plain,
                      (p, m, h.abs(), g, lr,
                       torch.tensor(float(step), device=cuda_device)),
                      dict(ADAMW, block=block)))
    for name, kernel, plain, args, kw in calls:
        reset_launch_counts()
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        assert dict(KERNEL_LAUNCHES) == {name: 1}
        want = plain(*args, **kw)
        for a, b in zip(*((got, want) if isinstance(got, tuple)
                          else ((got,), (want,)))):
            _assert_bitwise(a, b)


@pytest.mark.parametrize("n,block", [(3 * 128, 128), (2 * 131072, 131072)])
@pytest.mark.parametrize("pdt,sdt", [(torch.float32, torch.float32),
                                     (torch.float32, torch.bfloat16),
                                     (torch.bfloat16, torch.bfloat16)])
def test_baseline_engine_kernels_match_plain_bitwise(cuda_device, n, block,
                                                     pdt, sdt):
    """Rows 5 (flag 0 and 1 at steps 1 and 1000), 7 (steps 1 and 1000)
    and 8-10 (Lion, SignGD, SGD, with m = g = 0 on every 7th element:
    sign argument exactly 0) against their plain versions on the same
    device tensors, bit for bit, one launch each."""
    p, m, h, g, e = _engine_operands(cuda_device, n, pdt, sdt)
    m[::7] = 0.0
    g[::7] = 0.0
    v, e = h.abs(), e - e.mean()
    lr = torch.tensor(3e-3, device=cuda_device)
    one = torch.tensor(1.0, device=cuda_device)
    su = sophia_update
    calls = []
    for step in (1, 1000):
        st = torch.tensor(float(step), device=cuda_device)
        calls += [("adahessian_refresh", su.adahessian_refresh_fused_block,
                   su.adahessian_refresh_fused_block_plain,
                   (p, m, v, g, e, lr, flag, one, st),
                   dict(ADAHESSIAN, block=block)) for flag in (0, 1)]
        calls.append(("adahessian_step", su.adahessian_fused_block,
                      su.adahessian_fused_block_plain, (p, m, v, g, lr, st),
                      dict(ADAHESSIAN, block=block)))
    calls += [
        ("lion_step", su.lion_fused_block, su.lion_fused_block_plain,
         (p, m, g, lr), dict(beta1=0.95, beta2=0.98, weight_decay=0.2,
                             block=block)),
        ("signgd_step", su.signgd_fused_block, su.signgd_fused_block_plain,
         (p, m, g, lr), dict(beta1=0.96, weight_decay=0.2, block=block)),
        ("sgd_step", su.sgd_fused_block, su.sgd_fused_block_plain,
         (p, m, g, lr), dict(momentum=0.9, block=block))]
    for name, kernel, plain, args, kw in calls:
        reset_launch_counts()
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        assert dict(KERNEL_LAUNCHES) == {name: 1}
        want = plain(*args, **kw)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_bitwise(a, b)


def test_engine_kernels_refuse_bad_arguments(cuda_device):
    """n % block != 0, a CPU tensor among CUDA ones and a tensor off the
    16-byte alignment raise ValueError before any launch."""
    p, m, h, g, _ = _engine_operands(cuda_device, 512, torch.float32,
                                     torch.float32)
    reset_launch_counts()
    with pytest.raises(ValueError, match="multiple of block"):
        sophia_update.sophia_fused_block(p, m, h, g, 1e-3, block=384,
                                         **SOPHIA)
    with pytest.raises(ValueError, match="not cuda"):
        sophia_update.adamw_fused_block(p, m, h.cpu(), g, 1e-3, 1,
                                        block=128, **ADAMW)
    with pytest.raises(ValueError, match="aligned"):
        sophia_update.hessian_ema_block(h[1:385], g[1:385], beta2=0.99,
                                        block=128)
    assert not KERNEL_LAUNCHES


@pytest.mark.parametrize("optimizer", ["sophia_g", "adamw"])
def test_trainer_fused_kernel_launches_engine_kernels(cuda_device,
                                                      optimizer):
    """Four GPT2_TINY steps (refresh at 0 and 2) with ``fused_kernel``:
    Sophia-G launches the refresh-fused step on the refresh steps and the
    plain step on the others, AdamW its step on every one (and no sampled
    CE, no refresh); never the out-of-band EMA.  Losses as on the CPU."""
    cfg = dataclasses.replace(GPT2_TINY, dtype="float32")
    tc = TrainerConfig(optimizer=optimizer, peak_lr=5e-4, total_steps=8,
                       warmup_steps=2, hess_interval=2, hess_subbatch=2,
                       fused_kernel=True)
    hist, hist_cpu, launches = _train_card_and_cpu(cuda_device, cfg, tc)
    if optimizer == "sophia_g":
        per_layer = cfg.n_layers * 6
        assert launches == {"ce_forward": 4, "ce_forward_sampled": 2,
                            "ce_backward_dh": 6, "ce_backward_dw": 6,
                            "attn_fwd": per_layer, "attn_bwd_dq": per_layer,
                            "attn_bwd_dkv": per_layer, "sophia_step": 2,
                            "sophia_refresh": 2}
    else:
        per_layer = cfg.n_layers * 4
        assert launches == {"ce_forward": 4, "ce_backward_dh": 4,
                            "ce_backward_dw": 4, "attn_fwd": per_layer,
                            "attn_bwd_dq": per_layer,
                            "attn_bwd_dkv": per_layer, "adamw_step": 4}
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in hist_cpu], rtol=1e-4)


@pytest.mark.parametrize("over", [
    dict(optimizer="lion"), dict(optimizer="signgd"), dict(optimizer="sgd"),
    dict(optimizer="sophia_h", estimator="hutchinson"),
    dict(optimizer="adahessian", estimator="hutchinson")],
    ids=["lion", "signgd", "sgd", "sophia_h", "adahessian"])
def test_trainer_launches_baseline_kernels(cuda_device, over):
    """Four GPT2_TINY steps (refresh at 0 and 2 for the hessian-aware)
    with ``fused_kernel``: each optimizer launches its engine kernel on
    every step (the refresh-fused one on the refresh steps); a Hutchinson
    refresh adds one CE forward and one attention forward per layer and
    no backward kernel.  Losses as on the CPU with the same probes (for
    AdaHessian, which divides by |u . Hu|, the first three)."""
    cfg = dataclasses.replace(GPT2_TINY, dtype="float32")
    tc = TrainerConfig(peak_lr=5e-4, total_steps=8, warmup_steps=2,
                       hess_interval=2, hess_subbatch=2, fused_kernel=True,
                       **over)
    hist, hist_cpu, launches = _train_card_and_cpu(cuda_device, cfg, tc)
    aware = "estimator" in over
    n_ref = 2 if aware else 0
    L = cfg.n_layers
    want = {"ce_forward": 4 + n_ref, "ce_backward_dh": 4,
            "ce_backward_dw": 4, "attn_fwd": L * (4 + n_ref),
            "attn_bwd_dq": L * 4, "attn_bwd_dkv": L * 4}
    opt = over["optimizer"]
    if opt == "sophia_h":
        want.update(sophia_step=2, sophia_refresh=2)
    elif opt == "adahessian":
        want.update(adahessian_step=2, adahessian_refresh=2)
    else:
        want[f"{opt}_step"] = 4
    assert launches == want
    losses = [h["loss"] for h in hist]
    assert np.isfinite(losses).all()
    k = 3 if opt == "adahessian" else 4
    np.testing.assert_allclose(losses[:k], [h["loss"] for h in hist_cpu][:k],
                               rtol=1e-4)


@pytest.mark.parametrize("over,launches", [
    # remat "full": each flash layer's forward runs again in the backward
    (dict(remat="full"),
     {"ce_forward": 4, "ce_forward_sampled": 2, "ce_backward_dh": 6,
      "ce_backward_dw": 6, "attn_fwd": 12, "attn_bwd_dq": 6,
      "attn_bwd_dkv": 6}),
    # the chunked loss and the GNB refresh from materialized logits: no CE
    # kernel
    (dict(fused_loss=False),
     {"attn_fwd": 6, "attn_bwd_dq": 6, "attn_bwd_dkv": 6}),
    # chunked attention: no attention kernel
    (dict(attn_impl="chunked"),
     {"ce_forward": 4, "ce_forward_sampled": 2, "ce_backward_dh": 6,
      "ce_backward_dw": 6})])
def test_trainer_routes_launch_what_they_run(cuda_device, over, launches):
    """Four GPT2_TINY steps on the card (refresh at 0 and 2) on the
    trainer's other routes: the launch counts per layer (``launches``
    gives the attention kernels' per layer) and the losses against the
    CPU's plain path (fp32)."""
    cfg = dataclasses.replace(GPT2_TINY, dtype="float32")
    tc = TrainerConfig(peak_lr=5e-4, total_steps=8, warmup_steps=2,
                       hess_interval=2, hess_subbatch=2, **over)
    hist, hist_cpu, got = _train_card_and_cpu(cuda_device, cfg, tc)
    want = {k: v * (cfg.n_layers if k.startswith("attn") else 1)
            for k, v in launches.items()}
    assert got == want
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in hist_cpu], rtol=1e-4)


def test_per_leaf_sophia_matches_the_engine_on_card(cuda_device):
    """``chain(clip_by_global_norm(1.0), sophia_g(lr))`` on a GPT2_TINY
    parameter tree on the card against the engine's fused backend, fed the
    same gradients and Hessian estimate: 4 steps, the parameters within
    1e-6, the same clip fractions."""
    from repro_torch.core import (apply_updates, chain, clip_by_global_norm,
                                  ravel_shards, sophia_g, tree_map)
    from repro_torch.core.types import flat_tensors
    from repro_torch.train import make_engine

    cfg = dataclasses.replace(GPT2_TINY, dtype="float32")
    params = get_model(cfg).init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0))
    tree = tree_map(lambda t: t.detach().clone(), params.param_tree())
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    grads = [tree_map(lambda t: torch.randn(t.shape, generator=gen,
                                            device=cuda_device), tree)
             for _ in range(4)]
    est = tree_map(lambda t: torch.rand(t.shape, generator=gen,
                                        device=cuda_device) * 1e-3, tree)
    tc = TrainerConfig(fused_kernel=True, peak_lr=1e-3)
    opt = chain(clip_by_global_norm(1.0), sophia_g(1e-3))
    p_leaf = tree_map(lambda t: t.clone(), tree)
    s_leaf = opt.update_hessian(est, opt.init(p_leaf))
    engine, clip = make_engine(tc), clip_by_global_norm(1.0)
    p_eng = tree_map(lambda t: t.clone(), tree)
    lay = engine.layout(p_eng)
    e_state = engine.update_hessian(engine.init(p_eng),
                                    ravel_shards(lay, est, dtype=torch.float32),
                                    params=p_eng)
    c_state = clip.init(p_eng)
    for g in grads:
        upd, s_leaf = opt.update(g, s_leaf, p_leaf)
        p_leaf = apply_updates(p_leaf, upd)
        g_c, c_state = clip.update(g, c_state)
        _, e_state = engine.step_shards(e_state, p_eng,
                                        engine.ravel_grads(p_eng, g_c),
                                        torch.tensor(1e-3, device=cuda_device))
        assert float(s_leaf[1].clip_fraction) == float(e_state.clip_fraction)
    for a, b in zip(flat_tensors(p_leaf), flat_tensors(p_eng)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def _chip_smoke():
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    return chip_smoke


# what ``chip_smoke.check_ce_case`` launches: the sampled forward on every
# row and again on every other row (``sampled_rows_check``), dh and dW
# standalone and once more together (``ce_backward``, row 13)
CHECK_CE_CASE_LAUNCHES = {"ce_forward": 1, "ce_forward_sampled": 2,
                          "ce_backward_dh": 2, "ce_backward_dw": 2}


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("h", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [1536, 2048, 4096])
def test_fused_ce_kernels_at_the_rope_widths(cuda_device, D, h, tied):
    """The four CE kernels at NeoX-1.5B's, stablelm's and NeoX-6.6B's
    widths against their plain versions (``chip_smoke.check_ce_case``:
    the forwards within 1e-5 fp32 or 2e-2 bf16; dh and dW within 1e-5 of
    their largest element in fp32 and element by element against their
    absolute sums in bf16; the draws equal off near-ties), ragged rows,
    a padded vocab, untied with softcap 30 and a mask.  fp32 h runs the
    backward in D-slabs (2, 2 and 4 of them), bf16 h the tensor cores."""
    cs = _chip_smoke()
    spec = dict(cs.CE_MAIN, N=130 if h == "float32" else 1000, D=D, V=2000,
                Vp=2048, tied=tied, h=h, softcap=None if tied else 30.0,
                mask=not tied)
    reset_launch_counts()
    cs.check_ce_case(torch, f"D{D}", spec)
    assert dict(KERNEL_LAUNCHES) == CHECK_CE_CASE_LAUNCHES


@pytest.mark.parametrize("name", ["neox-1.5b", "stablelm-1.6b", "neox-6.6b"])
def test_rope_model_step0_matches_cpu(cuda_device, name):
    """Each rope model at full width and 2 layers, fp32: the step-0 loss
    within 1e-5 relative and every gradient within 1e-4 of its leaf's
    largest element against the CPU's plain path
    (``chip_smoke.model_step0_against_cpu``: flash attention with rope,
    the untied CE kernels, SwiGLU for stablelm)."""
    cs = _chip_smoke()
    cfg = {run[0]: run[1] for run in cs._model_runs()}[name]
    reset_launch_counts()
    _, rel = cs.model_step0_against_cpu(torch, name, cfg)
    assert rel <= 1e-4
    for kernel in ("ce_forward", "ce_backward_dh", "ce_backward_dw",
                   "attn_fwd", "attn_bwd_dq", "attn_bwd_dkv"):
        assert KERNEL_LAUNCHES.get(kernel), kernel


@pytest.mark.parametrize("h", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["yi-6b", "qwen1.5-110b", "gemma2-9b"])
def test_fused_ce_kernels_at_the_dense_shapes(cuda_device, name, h):
    """The four CE kernels at yi's, qwen1.5's and gemma2's widths and
    vocabularies with RMSNorm fused (gemma2 tied with its softcap 30)
    against their plain versions (``chip_smoke.check_ce_case``), at 130
    (fp32 h: the backward in 4, 7 and 3 D-slabs) or 1000 ragged rows."""
    cs = _chip_smoke()
    spec = dict(cs.CE_MAIN, **dict(cs.CE_DENSE_SHAPES)[name])
    spec.update(N=130 if h == "float32" else 1000, h=h, mask=True)
    reset_launch_counts()
    cs.check_ce_case(torch, f"{name}_rms", spec)
    assert dict(KERNEL_LAUNCHES) == CHECK_CE_CASE_LAUNCHES


@pytest.mark.parametrize("name", ["yi-6b", "gemma2-9b"])
def test_dense_model_step0_matches_cpu(cuda_device, name):
    """yi-6b and gemma2-9b at full width and 2 layers, fp32: the step-0
    loss within 1e-5 relative and every gradient within 1e-4 of its
    leaf's largest element against the CPU's plain path
    (``chip_smoke.model_step0_against_cpu``: RMSNorm, GQA, GeGLU, the
    sandwich norms, the embedding scale, hd 256 flash with its window and
    softcap, the tied CE with its softcap).  qwen1.5-110b's check (1 layer,
    ~31 GB of weights and gradients each side) runs in chip_smoke.py
    phase 4d only."""
    cs = _chip_smoke()
    cfg = {run[0]: run[1] for run in cs._dense_runs()}[name]
    reset_launch_counts()
    _, rel = cs.model_step0_against_cpu(torch, name, cfg)
    assert rel <= 1e-4
    for kernel in cs.STEP0_KERNELS:
        assert KERNEL_LAUNCHES.get(kernel), kernel


def _moe_on(device, p, x, cfg):
    from repro_torch.models import moe as tmoe

    pd = {k: ({kk: vv.to(device) for kk, vv in v.items()}
              if isinstance(v, dict) else v.to(device)) for k, v in p.items()}
    with torch.no_grad(), tmoe.record_routing() as calls:
        out, aux = tmoe.moe_ffn(pd, x.to(device), cfg)
    (rec,) = calls
    return out.cpu(), aux.item(), {k: v.cpu() for k, v in rec.items()}


@pytest.mark.parametrize("T,skew", [(80, 0.0), (8192, 1.0)])
def test_moe_ffn_matches_cpu_on_card(cuda_device, T, skew):
    """``models.moe.moe_ffn`` (fp32, deepseek's routing at a narrow width:
    16 experts of 256 x 128, top 4, 2 shared) on the card against the CPU,
    same weights and inputs: one group of 80 rows, and two groups of 4096
    whose skewed load makes capacity bind.  The expert choices and the
    dropped entries equal (the router's fp32 logits over D = 256 differ by
    ~1e-7 across devices; a token whose k-th and (k+1)-th probabilities
    are closer than 1e-6 may flip and is left out), the output within 1e-5
    of its largest element, aux within 1e-6."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.models import moe as tmoe

    cfg = dc.replace(get_config("deepseek-moe-16b"), d_model=256, d_ff=128,
                     n_experts=16, moe_top_k=4, dtype="float32")
    p = tmoe.init_moe(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(1)
    x = (torch.randn((2, T // 2, cfg.d_model), generator=gen)
         + skew * torch.randn((cfg.d_model,), generator=gen))
    o_card, aux_card, r_card = _moe_on(cuda_device, p, x, cfg)
    o_cpu, aux_cpu, r_cpu = _moe_on("cpu", p, x, cfg)
    top = r_cpu["probs"].sort(dim=-1, descending=True).values
    gap = top[:, cfg.moe_top_k - 1] - top[:, cfg.moe_top_k]
    same = (r_card["expert_idx"] == r_cpu["expert_idx"]).all(dim=1)
    assert bool((same | (gap < 1e-6)).all())
    if bool(same.all()):
        assert int((~r_card["keep"]).sum()) == int((~r_cpu["keep"]).sum())
    if skew:
        assert int((~r_cpu["keep"]).sum()) > 0
    a = o_card.reshape(T, -1)[same]
    b = o_cpu.reshape(T, -1)[same]
    torch.testing.assert_close(a, b, rtol=0,
                               atol=1e-5 * b.abs().max().item())
    assert abs(aux_card - aux_cpu) <= 1e-6


def test_moe_ffn_bf16_gradients_on_card(cuda_device):
    """The bf16 MoE FFN's forward and backward run on the card and give
    finite gradients for x and every weight, the router's included."""
    import dataclasses as dc

    from repro_torch.configs import get_config
    from repro_torch.models import moe as tmoe

    cfg = dc.replace(get_config("deepseek-moe-16b"), d_model=256, d_ff=128,
                     n_experts=16, moe_top_k=4)
    p = tmoe.init_moe(torch.Generator(device="cuda").manual_seed(0), cfg)
    leaves = [p["router"], p["w_gate"], p["w_up"], p["w_down"],
              *p["shared"].values()]
    for t in leaves:
        t.requires_grad_(True)
    x = torch.randn((2, 64, cfg.d_model), device="cuda").to(
        torch.bfloat16).requires_grad_(True)
    out, aux = tmoe.moe_ffn(p, x, cfg)
    grads = torch.autograd.grad(out.float().square().mean() + aux,
                                leaves + [x])
    assert out.dtype == torch.bfloat16
    for g in grads:
        assert torch.isfinite(g).all() and g.abs().max() > 0


def test_wkv_chunked_matches_cpu_on_card(cuda_device):
    """``models.rwkv.wkv_chunked`` (fp32, 4 chunks of 32, 4 heads of 64,
    decays down to the -4 clamp, a random state) and its gradients on the
    card against the CPU: within 1e-5 of each output's largest element."""
    from repro_torch.models import rwkv as trwkv

    gen = torch.Generator().manual_seed(3)
    B, S, H, K = 2, 128, 4, 64
    r, k, v = (0.5 * torch.randn((B, S, H, K), generator=gen)
               for _ in range(3))
    logw = (-4.0 * torch.rand((B, S, H, K), generator=gen)).clamp(-4, -1e-6)
    u = 0.1 * torch.randn((H, K), generator=gen)
    st = 0.5 * torch.randn((B, H, K, K), generator=gen)
    outs = []
    for dev in ("cuda", "cpu"):
        leaves = [t.to(dev).requires_grad_(True) for t in (r, k, v, logw, u,
                                                          st)]
        o, s = trwkv.wkv_chunked(*leaves)
        grads = torch.autograd.grad(o.square().mean() + s.square().mean(),
                                    leaves)
        outs.append([t.detach().cpu() for t in (o, s, *grads)])
    for got, want in zip(*outs):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("smoke", [True, False])
def test_rwkv_step0_matches_cpu(cuda_device, smoke):
    """rwkv6-7b at full width and 2 layers, and its smoke config (d 128),
    fp32: the step-0 loss and gradients through the CE kernels against the
    CPU's plain path, the state after the forward within 1e-5 of its
    largest element (``chip_smoke.rwkv_step0_against_cpu``); no attention
    kernel launches."""
    from repro_torch.configs import get_config

    cs = _chip_smoke()
    cfg = get_config("rwkv6-7b", smoke=smoke)
    _, rel, state_rel = cs.rwkv_step0_against_cpu(torch, cfg.name, cfg)
    assert rel <= 1e-4 and state_rel <= 1e-5
