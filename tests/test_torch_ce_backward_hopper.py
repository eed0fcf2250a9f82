"""The CE backward on the card's tensor cores (bf16 h: ``wgmma`` fed by
TMA, ``csrc/fused_ce.cu:ce_wgmma_kernel``): the combined call against the
standalone dh and dW calls bit for bit, and all of them against the plain
backward element by element, as ``chip_smoke.check_bf16_grad`` holds them.
Every test needs an NVIDIA GPU; each carries the ``cuda`` marker and skips
without one.  The file imports no JAX, so it runs on a GPU machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_ce_backward_hopper.py \\
        -q --noconftest
"""
import os
import sys

import pytest
import torch

from repro_torch.kernels import (KERNEL_LAUNCHES, fused_ce,
                                 reset_launch_counts)

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda

# N 8000 rows (Np 8064, off the 128-row tile) over Vp 50,304 make seven
# vocabulary chunks of 7296 columns, the last 6528 wide; V < Vp pads 304
# columns.  D 256 keeps the plain backward quick.
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
    """``chip_smoke`` (at the root of the checkout): its CE inputs and its
    contract."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke
    return chip_smoke


def _inputs(spec):
    h, w, normp, labels, rs, opts = _cs()._ce_inputs(torch, **spec)
    lse, _ = fused_ce.ce_forward_plain(h, w, normp, labels, **opts)
    return h, w, normp, labels, rs, lse, opts


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_combined_backward_equals_the_standalone_calls(cuda_device, case):
    """``ce_backward`` (one prep and one logits sweep a chunk for both
    products) returns dh and dW bit for bit as ``ce_backward_dh`` and
    ``ce_backward_dw`` do, over seven chunks, and counts one launch of
    each."""
    h, w, normp, labels, rs, lse, opts = _inputs(dict(RAGGED, **case))
    reset_launch_counts()
    dh, dw = fused_ce.ce_backward(h, w, normp, labels, rs, lse, **opts)
    assert dict(KERNEL_LAUNCHES) == {"ce_backward_dh": 1,
                                     "ce_backward_dw": 1}
    dh1 = fused_ce.ce_backward_dh(h, w, normp, labels, rs, lse, **opts)
    dw1 = fused_ce.ce_backward_dw(h, w, normp, labels, rs, lse, **opts)
    torch.cuda.synchronize()
    assert dh.dtype == dh1.dtype and dw.dtype == dw1.dtype == w.dtype
    assert torch.equal(dh, dh1) and torch.equal(dw, dw1)


def _hold_to_contract(h, w, normp, labels, rs, lse, opts, dh, dw):
    """dh and dW against the plain backward, element by element
    (``check_bf16_grad``: none beyond 2^-7 of its sum of absolute terms,
    at most 0.1% beyond 2^-16 of it against the plain version fed the
    kernels' row statistics).  Returns the two shares."""
    cs = _cs()
    plain = fused_ce.ce_backward_plain(h, w, normp, labels, rs, lse, **opts)
    sums = cs._abs_sums(torch, h, w, normp, labels, rs, lse, opts)
    tight = (None, None)
    if opts["norm"] is not None:
        stats = fused_ce.row_stats(h, norm=opts["norm"], eps=opts["eps"])
        tight = tuple(zip(
            fused_ce.ce_backward_plain(h, w, normp, labels, rs, lse, **opts,
                                       stats=stats),
            cs._abs_sums(torch, h, w, normp, labels, rs, lse, opts, stats)))
    shares = []
    for name, got, want, s, t in zip(("dh", "dW"), (dh, dw), plain, sums,
                                     tight):
        assert got.dtype == want.dtype and bool(torch.isfinite(got).all())
        shares.append(cs.check_bf16_grad(torch, name, got, want, s, t)[1])
    return shares


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_backward_holds_the_contract_at_ragged_shapes(cuda_device, case):
    """Tied and untied W, fp32 and bf16 W, a softcap, no norm, ln and rms,
    at N 8000 (off the row tile), seven vocabulary chunks with a narrower
    last one, and 304 padded columns, which get exactly zero gradient."""
    h, w, normp, labels, rs, lse, opts = _inputs(dict(RAGGED, **case))
    dh, dw = fused_ce.ce_backward(h, w, normp, labels, rs, lse, **opts)
    torch.cuda.synchronize()
    pad = dw[:, opts["vocab"]:] if opts["transpose_w"] else \
        dw[opts["vocab"]:]
    assert pad.numel() and not bool((pad != 0).any())
    _hold_to_contract(h, w, normp, labels, rs, lse, opts, dh, dw)


@pytest.mark.parametrize("N,D,V,Vp", [(77, 128, 1000, 1024),
                                      (1000, 768, 50257, 50304),
                                      (300, 4096, 2000, 2048)])
@pytest.mark.parametrize("tied", [True, False])
def test_backward_holds_the_contract_across_widths(cuda_device, N, D, V,
                                                   Vp, tied):
    """One chunk each: the narrowest D (one row tile, fewer output tiles
    than SMs), GPT-2 small's loss width over its padded vocabulary, and D
    4096 (32 tiles across D); fp32 W, ln, masked rows."""
    spec = dict(N=N, D=D, V=V, Vp=Vp, tied=tied, norm="ln", softcap=None,
                h="bfloat16", w="float32", mask=True)
    h, w, normp, labels, rs, lse, opts = _inputs(spec)
    dh, dw = fused_ce.ce_backward(h, w, normp, labels, rs, lse, **opts)
    torch.cuda.synchronize()
    _hold_to_contract(h, w, normp, labels, rs, lse, opts, dh, dw)


def test_backward_without_a_norm_returns_dh_in_bf16(cuda_device):
    """With no norm dh comes back in h's dtype, rounded once from the fp32
    sums of every chunk (the workspace's accumulator), as the plain
    version rounds it."""
    spec = dict(RAGGED, tied=True, w="float32", norm=None, softcap=None)
    h, w, normp, labels, rs, lse, opts = _inputs(spec)
    dh, dw = fused_ce.ce_backward(h, w, normp, labels, rs, lse, **opts)
    torch.cuda.synchronize()
    assert dh.dtype == torch.bfloat16 and dw.dtype == torch.float32
    _hold_to_contract(h, w, normp, labels, rs, lse, opts, dh, dw)
