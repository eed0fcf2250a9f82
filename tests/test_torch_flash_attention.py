"""The port's flash attention (repro_torch.kernels.flash_attention) held
against the JAX reference on the CPU: the plain forward, dQ and dK/dV
against the port's copied oracles and the reference's ``kernels/ref.py``
oracles over the reference tests' case matrix (causal, window, softcap,
GQA, q_offset, non-causal), within 3e-6 in fp32; against the reference's
Pallas kernels (interpret mode, as its own tests run them on the CPU) and
``jax.grad`` within 6e-6 (both sides sit within 3e-6 of the oracle), and in
bf16 at the reference test's 2/256 relative + 2e-5 absolute; autograd
through the port's entry against the direct plain backward; the model-level
flash route on a GPT2_TINY layer; and a CPU emulation of the bf16
tensor-core route's rounding points held to its element-wise contract.
Inputs come from numpy."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gpt2 import GPT2_TINY
from repro.kernels import ref as jax_ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import get_model as jax_get_model
from repro.models.layers import train_attention as jax_train_attention
from repro_torch.convert import params_from_jax
from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
from repro_torch.kernels import ref as port_ref
from repro_torch.kernels.flash_attention import (
    NEG_INF, band_mask, contract_misses, contract_sums, flash_attention,
    flash_backward_dkv, flash_backward_dkv_plain, flash_backward_dq,
    flash_backward_dq_plain, flash_forward, flash_forward_plain)
from repro_torch.models import ModelConfig
from repro_torch.models.layers import train_attention

# One intra-op thread per process: the suite runs six pytest-xdist workers
# on the machine's cores, and torch's default pool in every worker
# oversubscribes them, slowing every test beside it (JAX's too) severalfold.
torch.set_num_threads(1)

F32_TOL = 3e-6
PALLAS_TOL = 6e-6
BF16_RTOL = 2.0 / 256
BF16_ATOL = 2e-5

# the case matrix of tests/test_flash_attention.py (block sizes and
# schedules are the reference kernel's, used only on its side)
CASES = [
    # B, H, Hkv, Sq, Sk, hd, bq, bk, causal, window, softcap, qoff, sched
    (1, 2, 1, 192, 192, 32, 64, 64, True, None, None, 0, None),
    (1, 2, 1, 192, 192, 32, 64, 64, True, 48, None, 0, "skip"),
    (1, 2, 1, 192, 192, 32, 64, 64, True, None, 20.0, 0, None),
    (1, 2, 2, 128, 192, 32, 32, 64, True, 80, 8.0, 64, "skip"),
    (1, 4, 1, 96, 160, 32, 32, 32, False, None, None, 0, "dense"),
    (2, 2, 1, 128, 128, 64, 64, 64, True, None, None, 0, "dense"),
    # gemma2's head dim and group (GQA 2), a window and its softcap of 50
    (1, 4, 2, 128, 128, 256, 64, 64, True, 48, 50.0, 0, "skip"),
]
IDS = ["causal", "window48", "softcap20", "gqa_window_softcap_qoffset",
       "noncausal_gqa4", "batch2_hd64", "hd256_gqa2_window48_softcap50"]


def _inputs(B, H, Hkv, Sq, Sk, hd, seed=0):
    rng = np.random.default_rng(seed + Sq + Sk + hd)
    q = rng.standard_normal((B, H, Sq, hd)).astype(np.float32) * 0.5
    k = rng.standard_normal((B, Hkv, Sk, hd)).astype(np.float32) * 0.5
    v = rng.standard_normal((B, Hkv, Sk, hd)).astype(np.float32) * 0.5
    g = rng.standard_normal((B, H, Sq, hd)).astype(np.float32) * 0.5
    return q, k, v, g


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _plain_all(q, k, v, g, kw):
    """(o, lse, dq, dk, dv) of the port's plain versions, delta from the
    rounded o as the autograd function computes it."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    o, lse = flash_forward_plain(q, k, v, scale=scale, **kw)
    delta = (g.float() * o.float()).sum(-1)
    dq = flash_backward_dq_plain(q, k, v, g, lse, delta, scale=scale, **kw)
    dk, dv = flash_backward_dkv_plain(q, k, v, g, lse, delta, scale=scale,
                                      **kw)
    return o, lse, dq, dk, dv


@pytest.mark.parametrize(
    "B,H,Hkv,Sq,Sk,hd,bq,bk,causal,window,softcap,qoff,sched", CASES,
    ids=IDS)
def test_plain_matches_oracles(B, H, Hkv, Sq, Sk, hd, bq, bk, causal,
                               window, softcap, qoff, sched):
    """Forward (o, lse), dQ and dK/dV within 3e-6 of the port's copied
    oracles and of the reference's ``kernels/ref.py`` oracles."""
    q, k, v, g = _inputs(B, H, Hkv, Sq, Sk, hd)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff)
    got = _plain_all(*map(torch.from_numpy, (q, k, v, g)), kw)
    port = (port_ref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                         **kw)
            + port_ref.flash_attention_grads_ref(
                *map(torch.from_numpy, (q, k, v, g)), **kw))
    ref = (jax_ref.flash_attention_ref(*map(jnp.asarray, (q, k, v)), **kw)
           + jax_ref.flash_attention_grads_ref(
               *map(jnp.asarray, (q, k, v, g)), **kw))
    for name, a, b, c in zip(("o", "lse", "dq", "dk", "dv"), got, port, ref):
        np.testing.assert_allclose(_np(a), _np(b), atol=F32_TOL, rtol=0,
                                   err_msg=f"{name} vs the port's oracle")
        np.testing.assert_allclose(_np(a), np.asarray(c), atol=F32_TOL,
                                   rtol=0,
                                   err_msg=f"{name} vs the reference oracle")


def _against_pallas(case, dtype, atol, rtol):
    B, H, Hkv, Sq, Sk, hd, bq, bk, causal, window, softcap, qoff, sched = \
        case
    q, k, v, g = _inputs(B, H, Hkv, Sq, Sk, hd, seed=1)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff)
    jdt = getattr(jnp, dtype)
    jq, jk, jv, jg = (jnp.asarray(x).astype(jdt) for x in (q, k, v, g))

    def f(q, k, v):
        o = jax_flash(q, k, v, block_q=bq, block_k=bk, schedule=sched, **kw)
        return (o.astype(jnp.float32) * jg.astype(jnp.float32)).sum(), o

    (_, jo), jgrads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                         has_aux=True)(jq, jk, jv)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    o = flash_attention(tq, tk, tv, **kw)
    tgrads = torch.autograd.grad(o, (tq, tk, tv),
                                 torch.from_numpy(g).to(tdt))
    for name, a, b in zip(("o", "dq", "dk", "dv"), (o,) + tgrads,
                          (jo,) + tuple(jgrads)):
        assert a.dtype == tdt
        np.testing.assert_allclose(_np(a), np.asarray(b.astype(jnp.float32)),
                                   atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("case", [CASES[1], CASES[3], CASES[4], CASES[6]],
                         ids=["window48", "gqa_window_softcap_qoffset",
                              "noncausal_gqa4",
                              "hd256_gqa2_window48_softcap50"])
def test_matches_reference_pallas_kernels(case):
    """o and (dq, dk, dv) against the reference's Pallas forward and its
    custom_vjp backward under jax.grad, fp32, within 6e-6."""
    _against_pallas(case, "float32", PALLAS_TOL, 0.0)


def test_matches_reference_pallas_kernels_bf16():
    """bf16 at the reference test's bound (one output-rounding ulp where
    sums in another order straddle a rounding boundary)."""
    _against_pallas(CASES[2], "bfloat16", BF16_ATOL, BF16_RTOL)


@pytest.mark.parametrize("case", [CASES[3], CASES[5]],
                         ids=["gqa_window_softcap_qoffset", "batch2_hd64"])
def test_autograd_equals_plain_backward(case):
    """torch.autograd through the entry gives exactly the direct plain dQ
    and dK/dV, also for a cotangent that arrives non-contiguous; the CPU
    route launches nothing."""
    B, H, Hkv, Sq, Sk, hd, _, _, causal, window, softcap, qoff, _ = case
    q, k, v, g = map(torch.from_numpy, _inputs(B, H, Hkv, Sq, Sk, hd))
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff)
    _, _, dq, dk, dv = _plain_all(q, k, v, g, kw)
    g_t = g.transpose(2, 3).contiguous().transpose(2, 3)
    assert not g_t.is_contiguous()
    reset_launch_counts()
    for cot in (g, g_t):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = flash_attention(*leaves, **kw)
        got = torch.autograd.grad(o, leaves, cot)
        for a, b in zip(got, (dq, dk, dv)):
            assert torch.equal(a, b)
    scale = 1.0 / np.sqrt(hd)
    o, lse = flash_forward(q, k, v, scale=scale, **kw)
    delta = (g * o).sum(-1)
    assert torch.equal(flash_backward_dq(q, k, v, g, lse, delta,
                                         scale=scale, **kw), dq)
    assert all(torch.equal(a, b) for a, b in zip(
        flash_backward_dkv(q, k, v, g, lse, delta, scale=scale, **kw),
        (dk, dv)))
    assert sum(KERNEL_LAUNCHES.values()) == 0


def test_row_with_no_key():
    """A query row that attends no key (window and q_offset past the keys)
    gets o = 0, lse at the -1e30 sentinel and zero gradient, as the
    reference oracle gives; the other rows match it."""
    q, k, v, g = map(torch.from_numpy, _inputs(1, 2, 1, 64, 96, 32))
    kw = dict(causal=True, window=16, softcap=None, q_offset=64)
    o, lse, dq, dk, dv = _plain_all(q, k, v, g, kw)
    empty = 64 + torch.arange(64) - 16 >= 95        # no key c in (qpos-16, 95]
    assert 0 < int(empty.sum()) < 64
    assert torch.all(o[:, :, empty] == 0) and torch.all(dq[:, :, empty] == 0)
    assert torch.all(lse[:, :, empty] < -1e29)
    ro, rl = jax_ref.flash_attention_ref(*map(jnp.asarray, (q, k, v)), **kw)
    np.testing.assert_allclose(o.numpy(), np.asarray(ro), atol=F32_TOL)
    np.testing.assert_allclose(lse[:, :, ~empty].numpy(),
                               np.asarray(rl)[:, :, ~empty.numpy()],
                               atol=F32_TOL)
    for a, b in zip((dq, dk, dv), jax_ref.flash_attention_grads_ref(
            *map(jnp.asarray, (q, k, v, g)), **kw)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=F32_TOL)


def test_entry_rejects_bad_arguments():
    q = torch.zeros(1, 3, 8, 32)
    kv = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError):
        flash_attention(q, kv, kv)                      # 3 % 2 heads
    with pytest.raises(ValueError):
        flash_attention(q[:, :2], kv, kv, q_offset=-1)


CFG32 = dataclasses.replace(GPT2_TINY, dtype="float32")
TCFG32 = ModelConfig(**dataclasses.asdict(CFG32))


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
def test_train_attention_flash_matches_reference(dtype, atol):
    """The model-level flash route of a GPT2_TINY layer (qkv, transposes,
    the kernels' plain versions, output projection) against the
    reference's ``train_attention(impl="flash")`` with the same weights:
    fp32 within 1e-5 (and its input gradient too), bf16 within 2e-2 (the
    reference tests' bf16 bound)."""
    params = jax_get_model(CFG32).init_params(CFG32, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), TCFG32)
    jp = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 40, CFG32.d_model)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def f(x):
        out = jax_train_attention(jp, x, CFG32, None, impl="flash")
        return (out.astype(jnp.float32) * jnp.asarray(g)).sum(), out

    (_, want), jdx = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(x).astype(jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    got = train_attention(tparams.layers[0].attn, tx, TCFG32, impl="flash")
    np.testing.assert_allclose(_np(got), np.asarray(want.astype(jnp.float32)),
                               atol=atol)
    if dtype == "float32":
        (dx,) = torch.autograd.grad(got, (tx,), torch.from_numpy(g))
        np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), atol=atol)


# ---------------------------------------------------------------------------
# the bf16 route's contract (csrc/flash_attention.cu, the tensor cores)


def _bf16_route_emulated(q, k, v, do, lse, delta, *, causal, scale, window,
                         softcap, q_offset, round_acc=False):
    """(o, dq, dk, dv) in bf16 with the rounding points of the
    tensor-core kernels: bf16 inputs, fp32 sums, P rounded to bf16 before
    P.V and P^T.dO, dS before dS.K and dS^T.Q, dq scaled at the end; dQ's
    dP summed in k-steps of 16 head dims, as ``wgmma`` sums it.  The
    forward and dQ walk key tiles of 64 (the forward with the online
    softmax), dK/dV the q tiles of 64 rows (32 at hd 128) of each query
    head of a group, as the kernels do.  ``round_acc`` also rounds each
    fp32 accumulator to bf16 after every tile, and dq's after every 16
    keys (each k-step of its product): designs the contract must
    refuse."""
    rnd = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    acc_rnd = rnd if round_acc else (lambda x: x)
    B, H, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = H // Hkv
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    kh, vh = k32.repeat_interleave(G, 1), v32.repeat_interleave(G, 1)
    mask = band_mask(Sq, Sk, causal=causal, window=window, q_offset=q_offset)

    def scores(qt, kt):
        s = torch.einsum("...qd,...td->...qt", qt, kt) * scale
        if softcap is None:
            return s, 1.0
        t = torch.tanh(s / softcap)
        return softcap * t, 1.0 - t * t

    bk = 32 if hd == 256 else 64
    m = torch.full((B, H, Sq), NEG_INF)
    l = torch.zeros(B, H, Sq)
    acc = torch.zeros(B, H, Sq, hd)
    for c0 in range(0, Sk, bk):
        mc = mask[:, c0:c0 + bk]
        z = torch.where(mc, scores(q32, kh[:, :, c0:c0 + bk])[0], NEG_INF)
        m_new = torch.maximum(m, z.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mc, torch.exp(z - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc_rnd(acc * alpha[..., None] + rnd(p) @ vh[:, :, c0:c0 + bk])
        m = m_new
    o = (acc / torch.clamp_min(l, 1e-30)[..., None]).to(torch.bfloat16)

    dq = torch.zeros(B, H, Sq, hd)
    for c0 in range(0, Sk, bk):
        mc = mask[:, c0:c0 + bk]
        kt = kh[:, :, c0:c0 + bk]
        z, dcap = scores(q32, kt)
        p = torch.where(mc, torch.exp(z - lse[..., None]), 0.0)
        # dP in k-steps of 16 head dims, as wgmma sums it: another order
        # than the plain version's
        vt = vh[:, :, c0:c0 + bk]
        dp = sum(do32[..., d:d + 16] @ vt[..., d:d + 16].transpose(-1, -2)
                 for d in range(0, hd, 16))
        ds = rnd(p * (dp - delta[..., None]) * dcap)
        for k0 in range(0, ds.shape[-1], 16):
            dq = acc_rnd(dq + ds[..., k0:k0 + 16] @ kt[:, :, k0:k0 + 16])
    dq = (dq * scale).to(torch.bfloat16)

    bq = 32 if hd >= 128 else 64
    qg = q32.reshape(B, Hkv, G, Sq, hd)
    dog = do32.reshape(B, Hkv, G, Sq, hd)
    lseg, deltag = lse.reshape(B, Hkv, G, Sq), delta.reshape(B, Hkv, G, Sq)
    dk, dv = torch.zeros(B, Hkv, Sk, hd), torch.zeros(B, Hkv, Sk, hd)
    for g in range(G):
        for r0 in range(0, Sq, bq):
            rows = slice(r0, r0 + bq)
            qt, dot = qg[:, :, g, rows], dog[:, :, g, rows]
            z, dcap = scores(qt, k32)
            mc = mask[rows]
            p = torch.where(mc, torch.exp(z - lseg[:, :, g, rows, None]),
                            0.0)
            dp = torch.einsum("bkqd,bktd->bkqt", dot, v32)
            ds = p * (dp - deltag[:, :, g, rows, None]) * dcap
            dv = acc_rnd(dv + torch.einsum("bkqt,bkqd->bktd", rnd(p), dot))
            dk = acc_rnd(dk + torch.einsum("bkqt,bkqd->bktd", rnd(ds), qt))
    return (o, dq, (dk * scale).to(torch.bfloat16),
            dv.to(torch.bfloat16))


def _bf16_inputs(B, H, Hkv, Sq, Sk, hd, seed):
    """bf16 q, k, v, do from numpy; v and do with a mean of 1, so that
    sums of P-weighted terms do not cancel and the contract's A is of the
    size of the output (an accumulator's rounding then shows)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, hd))
    k = rng.standard_normal((B, Hkv, Sk, hd))
    v = 1.0 + rng.standard_normal((B, Hkv, Sk, hd))
    do = 1.0 + rng.standard_normal((B, H, Sq, hd))
    return tuple(torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
                 for x in (q, k, v, do))


@functools.lru_cache(maxsize=None)
def _bf16_plain_and_emulated(case, seed=3, round_acc=False, k_mean=0.0,
                             v_trend=0.0):
    """({output: emulated}, {output: plain}, {output: absolute sums}) for
    o, dq, dk and dv; ``k_mean`` is added to every element of k, and key j
    of v gets ``v_trend`` times a ramp from -1 (the first key) to 1."""
    B, H, Hkv, Sq, Sk, hd, causal, window, softcap, qoff = case
    q, k, v, do = _bf16_inputs(B, H, Hkv, Sq, Sk, hd, seed)
    k = (k.float() + k_mean).to(torch.bfloat16)
    v = (v.float() + v_trend * torch.linspace(-1.0, 1.0, Sk)[:, None]
         ).to(torch.bfloat16)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff,
              scale=hd ** -0.5)
    o, lse = flash_forward_plain(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    dq = flash_backward_dq_plain(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_backward_dkv_plain(q, k, v, do, lse, delta, **kw)
    sums = contract_sums(q, k, v, do, lse, delta, **kw)
    got = _bf16_route_emulated(q, k, v, do, lse, delta, round_acc=round_acc,
                               **kw)
    names = ("o", "dq", "dk", "dv")
    return dict(zip(names, got)), dict(zip(names, (o, dq, dk, dv))), sums


# ATTN_CASES' edges (chip_smoke.py) at small sizes:
# B, H, Hkv, Sq, Sk, hd, causal, window, softcap, q_offset
BF16_CASES = {
    "causal_hd64": (1, 2, 2, 192, 192, 64, True, None, None, 0),
    "gqa_H4_Hkv2": (1, 4, 2, 128, 128, 32, True, None, None, 0),
    "window24_softcap20": (1, 2, 2, 160, 160, 64, True, 24, 20.0, 0),
    "q_offset64_Sq64_Sk128": (1, 2, 2, 64, 128, 64, True, None, None, 64),
    "noncausal": (1, 2, 1, 96, 128, 32, False, None, None, 0),
    "S100_off_tile": (1, 2, 2, 100, 100, 64, True, None, None, 0),
    "hd128": (1, 2, 2, 96, 96, 128, True, None, None, 0),
    "hd256_gqa2_window40_softcap50": (1, 4, 2, 96, 96, 256, True, 40, 50.0,
                                      0),
    "row_with_no_key": (1, 2, 2, 64, 96, 32, True, 16, None, 64),
}


@pytest.mark.parametrize("case", list(BF16_CASES.values()),
                         ids=list(BF16_CASES))
def test_bf16_route_emulation_meets_the_contract(case):
    """The numerical design of the tensor-core forward and dK/dV
    (``csrc/flash_attention.cu``), emulated: P and dS rounded to bf16
    once, every sum in fp32, hold every element of o, dk and dv within
    2^-7 of its absolute sum (``contract_sums``) of the fp32 plain
    version, the bound ``chip_smoke.py`` holds the kernels to."""
    got, want, sums = _bf16_plain_and_emulated(case)
    for name in ("o", "dk", "dv"):
        assert got[name].dtype == want[name].dtype == torch.bfloat16
        n_hard, share = contract_misses(got[name], want[name], sums[name])
        assert n_hard == 0, (name, n_hard, share)


@pytest.mark.parametrize("case", list(BF16_CASES.values()),
                         ids=list(BF16_CASES))
def test_bf16_dq_emulation_meets_the_contract(case):
    """The numerical design of the tensor-core dQ
    (``csrc/flash_attention.cu:dq_wgmma_kernel``), emulated: dS rounded to
    bf16 once, its product with K and the sum over key tiles in fp32, the
    scale at the end, holds every element of dq within 2^-7 of its
    absolute sum A_dq = scale * sum_j |ds_ij| |k_jd| of the fp32 plain
    version."""
    got, want, sums = _bf16_plain_and_emulated(case)
    assert got["dq"].dtype == want["dq"].dtype == torch.bfloat16
    n_hard, share = contract_misses(got["dq"], want["dq"], sums["dq"])
    assert n_hard == 0, (n_hard, share)


@functools.lru_cache(maxsize=None)
def _against_reference_bf16():
    """({output: emulated}, {output: the reference's}, {output: absolute
    sums}) for o, dq, dk and dv: the reference's Pallas forward and its
    custom_vjp backward in bf16 (interpret mode, as
    :func:`test_matches_reference_pallas_kernels_bf16` runs them) and the
    emulation on the same numpy inputs."""
    case = (1, 2, 1, 128, 128, 32, True, None, 20.0, 0)
    B, H, Hkv, Sq, Sk, hd, causal, window, softcap, qoff = case
    q, k, v, do = _bf16_inputs(B, H, Hkv, Sq, Sk, hd, seed=5)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff)
    jq, jk, jv, jg = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                      for t in (q, k, v, do))

    def f(q, k, v):
        o = jax_flash(q, k, v, block_q=64, block_k=64, **kw)
        return (o.astype(jnp.float32) * jg.astype(jnp.float32)).sum(), o

    (_, jo), jgrads = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(jq, jk, jv)
    scale = hd ** -0.5
    o, lse = flash_forward_plain(q, k, v, scale=scale, **kw)
    delta = (do.float() * o.float()).sum(-1)
    sums = contract_sums(q, k, v, do, lse, delta, scale=scale, **kw)
    names = ("o", "dq", "dk", "dv")
    got = _bf16_route_emulated(q, k, v, do, lse, delta, scale=scale, **kw)
    ref = (torch.from_numpy(np.array(b.astype(jnp.float32)))
           for b in (jo,) + tuple(jgrads))
    return dict(zip(names, got)), dict(zip(names, ref)), sums


def test_bf16_route_emulation_meets_the_contract_against_the_reference():
    """The emulation against the reference's Pallas forward and its
    custom_vjp backward in bf16 on the same numpy inputs: o, dk and dv
    within 2^-7 of their absolute sums."""
    got, ref, sums = _against_reference_bf16()
    for name in ("o", "dk", "dv"):
        assert contract_misses(got[name], ref[name], sums[name])[0] == 0, name


def test_bf16_dq_emulation_meets_the_contract_against_the_reference():
    """dq of the emulation against the reference's custom_vjp dq in bf16
    (interpret mode) on the same inputs: every element within 2^-7 of
    A_dq."""
    got, ref, sums = _against_reference_bf16()
    assert contract_misses(got["dq"], ref["dq"], sums["dq"])[0] == 0


def test_bf16_contract_refuses_a_bf16_accumulator():
    """The contract has teeth: the same emulation with each accumulator
    also rounded to bf16 after every tile (8 key tiles, 8 q tiles) puts
    elements of o and dv beyond 2^-7 of their absolute sum."""
    case = (1, 2, 2, 512, 512, 64, True, None, None, 0)
    got, want, sums = _bf16_plain_and_emulated(case, round_acc=True)
    misses = {name: contract_misses(got[name], want[name], sums[name])[0]
              for name in ("o", "dk", "dv")}
    assert misses["o"] > 0 and misses["dv"] > 0, misses


def test_bf16_contract_refuses_a_bf16_dq_accumulator():
    """The contract has teeth for dq too: with dq's accumulator rounded to
    bf16 after every k-step of its product (16 keys, as a bf16 accumulator
    would be), elements of dq land beyond 2^-7 of A_dq, where the fp32
    accumulator keeps every element inside.  Each row's dS sums to zero
    over its keys, so dq's partial sums grow large only where they are
    coherent: a ramp on v over the keys orders dS by key (negative early,
    positive late), and a mean of 2 on k (which shifts every score of a row
    alike, so p and dS stay) carries that order into every column of
    dq."""
    case = (1, 2, 2, 512, 512, 64, True, None, None, 0)
    inputs = dict(k_mean=2.0, v_trend=2.0)
    got, want, sums = _bf16_plain_and_emulated(case, round_acc=True, **inputs)
    assert contract_misses(got["dq"], want["dq"], sums["dq"])[0] > 0
    exact, want, sums = _bf16_plain_and_emulated(case, **inputs)
    assert contract_misses(exact["dq"], want["dq"], sums["dq"])[0] == 0
