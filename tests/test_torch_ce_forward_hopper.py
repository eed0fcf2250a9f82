"""The CE forward on the card's tensor cores (bf16 h: ``wgmma`` fed by TMA,
the fold in registers, ``csrc/fused_ce.cu:ce_fwd_wgmma_kernel``), both the
labelled sweep (``ce_forward``) and the draw (``ce_forward_sampled``),
against their plain versions: lse and the label or drawn logit within
1e-4, the drawn labels equal to the plain version's but at rows whose two
best perturbed logits lie within ``chip_smoke.NEAR_TIE`` of each other, and
never a padded column.  With a norm the plain version normalizes with the
kernels' own row statistics (``fused_ce.row_stats``): fed its own, an
element of h_n may round one bf16 ulp apart where the two sides'
statistics differ in the last bit, and one such element moves a logit by
~2e-4 at these inputs (``check_bf16_grad`` says the same of the
gradients).  Every test needs an NVIDIA GPU; each carries the
``cuda`` marker and skips without one.  The file imports no JAX, so it runs
on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_ce_forward_hopper.py \\
        -q --noconftest
"""
import os
import sys

import pytest
import torch

from repro_torch.kernels import (KERNEL_LAUNCHES, autotune, fused_ce,
                                 reset_launch_counts)

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

FWD_TOL = 1e-4
# N 8000 rows (Np 8064, off the 128-row tile: 23 pieces a row tile) over
# Vp 50,304, V < Vp pads 304 columns; D 256 keeps the plain sweep quick
RAGGED = dict(N=8000, D=256, V=50000, Vp=50304, mask=True, h="bfloat16")
CASES = [
    dict(tied=True, w="float32", norm="ln", softcap=None),
    dict(tied=False, w="float32", norm="rms", softcap=30.0),
    dict(tied=True, w="bfloat16", norm=None, softcap=None),
    dict(tied=False, w="bfloat16", norm="ln", softcap=30.0),
    dict(tied=True, w="float32", norm="rms", softcap=30.0),
    dict(tied=False, w="float32", norm=None, softcap=None),
]


def _case_id(c):
    return (f"{'tied' if c['tied'] else 'untied'}-W{c['w'][:4]}-"
            f"{c['norm']}-cap{c['softcap']}")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _cs():
    """``chip_smoke`` (at the root of the checkout): its CE inputs, its
    near-tie gap and its draw gaps."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke
    return chip_smoke


def _hold_forwards(spec):
    """Both forwards against their plain versions at ``spec``; returns the
    largest lse / logit gaps and the count of near-tie rows."""
    cs = _cs()
    h, w, normp, labels, _, opts = cs._ce_inputs(torch, **spec)
    reset_launch_counts()
    lse, ll = fused_ce.ce_forward(h, w, normp, labels, **opts)
    lse_s, ll_s, y = fused_ce.ce_forward_sampled(h, w, normp, cs.CE_SEED,
                                                 **opts)
    torch.cuda.synchronize()
    assert dict(KERNEL_LAUNCHES) == {"ce_forward": 1,
                                     "ce_forward_sampled": 1}
    stats = (None if opts["norm"] is None else
             fused_ce.row_stats(h, norm=opts["norm"], eps=opts["eps"]))
    lse_p, ll_p = fused_ce.ce_forward_plain(h, w, normp, labels, **opts,
                                            stats=stats)
    lse_sp, ll_sp, y_p = fused_ce.ce_forward_sampled_plain(
        h, w, normp, cs.CE_SEED, **opts, stats=stats)
    for t in (lse, ll, lse_s, ll_s):
        assert bool(torch.isfinite(t).all())
    gaps = {"lse": (lse - lse_p).abs().max().item(),
            "ll": (ll - ll_p).abs().max().item(),
            "lse_sampled": (lse_s - lse_sp).abs().max().item()}
    same = y == y_p
    near = cs._draw_gaps(torch, h, w, normp, opts, stats) < cs.NEAR_TIE
    assert not bool((~same & ~near).any()), \
        f"{int((~same).sum())} draws differ off a near tie"
    assert int(y.max()) < opts["vocab"] and int(y.min()) >= 0
    gaps["ll_sampled"] = (ll_s - ll_sp)[same].abs().max().item()
    assert max(gaps.values()) <= FWD_TOL, gaps
    return gaps, int(near.sum())


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_forwards_hold_at_ragged_shapes(cuda_device, case):
    """Tied and untied W, fp32 and bf16 W, a softcap, no norm, ln and rms,
    at N 8000 (off the row tile) with 304 padded columns."""
    _hold_forwards(dict(RAGGED, **case))


@pytest.mark.parametrize("N,D,V,Vp", [(7, 768, 50257, 50304),
                                      (300, 128, 1000, 1024),
                                      (300, 8192, 2000, 2048)])
@pytest.mark.parametrize("tied", [True, False])
def test_forwards_hold_across_widths(cuda_device, N, D, V, Vp, tied):
    """N 7 (one row tile, most of it padding, many pieces), the narrowest
    D and D 8192 (128 stages a tile); fp32 W, ln, masked rows."""
    _hold_forwards(dict(N=N, D=D, V=V, Vp=Vp, tied=tied, norm="ln",
                        softcap=None, h="bfloat16", w="float32", mask=True))


@pytest.mark.parametrize("tied", [True, False])
def test_sampled_forward_with_row_ids(cuda_device, tied):
    """Every other row with ``row_ids`` (a data-parallel rank's rows) draws
    what the whole call draws at those rows, with the same raw logits bit
    for bit, and its lse within 1e-4 (its pieces follow its row count)."""
    cs = _cs()
    spec = dict(RAGGED, tied=tied, w="float32", norm="rms", softcap=None)
    h, w, normp, _, _, opts = cs._ce_inputs(torch, **spec)
    lse, ll, y = fused_ce.ce_forward_sampled(h, w, normp, cs.CE_SEED, **opts)
    sel = torch.arange(1, h.shape[0], 2, device=h.device)
    lse_r, ll_r, y_r = fused_ce.ce_forward_sampled(
        h[sel].contiguous(), w, normp, cs.CE_SEED, row_ids=sel, **opts)
    torch.cuda.synchronize()
    assert torch.equal(y_r, y[sel]) and torch.equal(ll_r, ll[sel])
    assert (lse_r - lse[sel]).abs().max().item() <= FWD_TOL


def test_pieces_follow_the_plan(cuda_device, tmp_path, monkeypatch):
    """At GPT-2 small's loss shape, with no measured entry, the wrapper's
    lookup gives the walk the rule before the tuner gave on this card's SM
    count (``forward_plan``'s pieces and group); the call's answers do not
    depend on the row count's pieces (N 8192 and its first 4096 rows)."""
    from test_torch_autotune import _old_forward_plan
    cs = _cs()
    spec = dict(N=8192, D=768, V=50304, Vp=50304, tied=True, norm="ln",
                softcap=None, h="bfloat16", w="float32", mask=False)
    h, w, normp, labels, _, opts = cs._ce_inputs(torch, **spec)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    autotune.clear_memory_cache()
    try:
        t = fused_ce._tuned(h, w, transpose_w=opts["transpose_w"],
                            softcap=opts["softcap"], norm=opts["norm"])
    finally:
        autotune.clear_memory_cache()
    assert t.source == "seed"
    assert (t.pieces, t.group) == _old_forward_plan(8192, 50304, 768, sms)
    lse, ll = fused_ce.ce_forward(h, w, normp, labels, **opts)
    lse_h, ll_h = fused_ce.ce_forward(h[:4096].contiguous(), w, normp,
                                      labels[:4096], **opts)
    torch.cuda.synchronize()
    assert torch.equal(ll_h, ll[:4096])
    assert (lse_h - lse[:4096]).abs().max().item() <= FWD_TOL
