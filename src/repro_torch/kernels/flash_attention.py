"""Training-path flash attention: the counterpart of
``repro/kernels/flash_attention.py`` (its ``custom_vjp`` route).

q (B, H, Sq, hd) attends k and v (B, Hkv, Sk, hd), GQA with ``H % Hkv ==
0``, without the (Sq, Sk) scores ever being stored:

  forward   one sweep over the key tiles keeps a running max, sum and fp32
            output accumulator per query row and writes o (q's dtype) and
            the row's log-sum-exp (fp32), the backward's residual;
  backward  ``delta = rowsum(g * o)`` in fp32 from the ROUNDED o (a plain
            op outside the kernels, as in the reference); then the dQ
            kernel and the dK/dV kernel each recompute ``p = exp(z - lse)``
            per tile and ``ds = p * (do . v^T - delta)``, the softcap chain
            ``1 - t^2`` on top.

On a CUDA tensor each wrapper launches its hand-written kernel of
``csrc/flash_attention.cu`` and adds one to its count in
``KERNEL_LAUNCHES``:

  ``flash_forward``       "attn_fwd"      (TPU ``_forward``, row 16)
  ``flash_backward_dq``   "attn_bwd_dq"   (``_backward`` dQ, row 17)
  ``flash_backward_dkv``  "attn_bwd_dkv"  (``_backward`` dK/dV, row 18)

Two routes, by dtype.  fp32 runs every product on the fp32 FMA units, so
that the card matches the CPU's plain version to 1e-5 of the largest
element.  bf16 (the training path) runs all three on the bf16 tensor
cores (``wgmma``, fp32 accumulate, tiles fed by ``cp.async``).  The bf16
route rounds P (the forward's P.V and dV's P^T.dO) and dS (dQ's dS.K and
dK's dS^T.Q) to bf16 once before its product; every other sum is fp32.
Its contract, held by :func:`contract_sums` on the card: every element x
of o, dq, dk and dv lies within ``2**-7 * A`` of the plain version, A the
element's absolute sum computed in fp32 by the plain side:

  o:   A = sum_j p_ij |v_jd|
  dq:  A = scale * sum_j (|ds_ij| + 2^-8 p_ij sum_e |do_ie| |v_je|) |k_jd|
  dv:  A = sum_i p_ij |do_id|              (over the GQA group too)
  dk:  A = scale * sum_i |ds_ij| |q_id|    (likewise)

(rounding P or dS moves the fp32 element by less than 2^-8 A; the
kernel's and the plain version's roundings into bf16 then land at most
one ulp apart, which is at most 2^-7 |x| where |x| ~ A and at most 2^-8 A
where terms cancel).  dq's second term is dS's own fp32 rounding: dS = p
(dP - delta) with dP = do . v an fp32 sum over hd products, which the
kernel takes in another order than the plain version, so the two dS
differ by up to 2 hd 2^-24 p sum_e |do_ie| |v_je| (2^-16 of it at hd
128).  Where dP - delta cancels, as at the first key of a causal row (p =
1, dP = delta but for rounding), that difference is all of dS, and
scale sum_j |ds_ij| |k_jd| alone would refuse any order of the sum but
the plain version's own.

On a CPU tensor a wrapper computes the plain version beside it, the
closed form of the ``kernels/ref.py`` oracles with the kernels' fp32
rounding points.  A CUDA tensor the kernels do not take (a head dim other
than 32, 64, 128 or 256, another dtype than fp32 or bf16, a bf16 operand
off a 16-byte boundary) raises ``ValueError``; there is no other route.
At hd 256 (gemma2) the kernels take smaller tiles: the bf16 forward and dQ
walk key tiles of 32, the bf16 dK/dV splits the head dims over two blocks
a key tile, and the fp32 dQ and dK/dV own 32 query rows or keys a block
(``csrc/flash_attention.cu``); the function and its rounding points are
the same.

Masking is the reference's: causal, a sliding window by key distance (the
sentinel ``1 << 30`` means none), ``q_offset`` shifting the query
positions, the softcap ``c * tanh(s / c)``, masked scores at -1e30, a
``where`` guard so that a fully-masked tile adds 0, and ``l = max(l,
1e-30)`` so that a row with no key gives o = 0 and lse ~ -1e30.  The
reference's block sizes and its "skip" / "dense" schedules are not
arguments: the schedules compute the same function, and the CUDA kernels
always skip the tiles outside the causal / window band.  lse is not
differentiable.

``use_jvp=True`` takes the twin of the Hutchinson path (the reference's
``custom_jvp`` twin, ``flash_attention.py:432-547``): o from the forward
kernel, and a backward and a tangent rule of plain differentiable
PyTorch over KV chunks of :func:`_chunk_len` keys, so that the HVP's
``torch.func.jvp`` of ``torch.func.grad`` never reaches the dQ or dK/dV
kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import KERNEL_LAUNCHES, _build

NEG_INF = -1e30           # masked-score sentinel of the reference
WINDOW_NONE = 1 << 30     # window value that masks nothing
HEAD_DIMS = (32, 64, 128, 256)
_f32 = torch.float32


# ---------------------------------------------------------------------------
# plain versions: the oracles' closed forms, per GQA group


def band_mask(Sq: int, Sk: int, *, causal: bool, window: Optional[int],
              q_offset: int, device=None) -> torch.Tensor:
    """(Sq, Sk) bool: query row r (position ``q_offset + r``) attends key
    c when ``c <= q_offset + r`` (causal) and ``c > q_offset + r -
    window``."""
    qpos = q_offset + torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    m = (kpos <= qpos) if causal else torch.ones((Sq, Sk), dtype=torch.bool,
                                                 device=device)
    if window is not None:
        m = m & (kpos > qpos - window)
    return m


def _grouped(x: torch.Tensor, Hkv: int) -> torch.Tensor:
    """(B, H, S, hd) -> fp32 (B, Hkv, G, S, hd)."""
    B, H, S, hd = x.shape
    return x.to(_f32).reshape(B, Hkv, H // Hkv, S, hd)


def _scores(q, k, *, causal, scale, window, softcap, q_offset):
    """(z, dcap, mask): the scaled, softcapped fp32 scores (B, Hkv, G, Sq,
    Sk), the softcap derivative (None uncapped) and the attend-mask."""
    Hkv, Sk = k.shape[1], k.shape[2]
    s = torch.einsum("bkgqd,bktd->bkgqt", _grouped(q, Hkv),
                     k.to(_f32)) * scale
    dcap = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s, dcap = softcap * t, 1.0 - t * t
    mask = band_mask(q.shape[2], Sk, causal=causal, window=window,
                     q_offset=q_offset, device=q.device)
    return s, dcap, mask


def _probs(z, mask, lse):
    """p = exp(z - lse) where attended, else 0 (the where guard)."""
    return torch.where(mask, torch.exp(z - lse[..., None]), 0.0)


def flash_forward_plain(q, k, v, *, causal=True, scale, window=None,
                        softcap=None, q_offset=0):
    """(o in q's dtype, lse (B, H, Sq) fp32)."""
    B, H, Sq, hd = q.shape
    Hkv = k.shape[1]
    z, _, mask = _scores(q, k, causal=causal, scale=scale, window=window,
                         softcap=softcap, q_offset=q_offset)
    z = torch.where(mask, z, NEG_INF)
    m = z.amax(-1)
    e = torch.where(mask, torch.exp(z - m[..., None]), 0.0)
    lse = m + torch.log(torch.clamp_min(e.sum(-1), 1e-30))
    o = torch.einsum("bkgqt,bktd->bkgqd", _probs(z, mask, lse), v.to(_f32))
    return (o.reshape(B, H, Sq, hd).to(q.dtype),
            lse.reshape(B, H, Sq))


def _ds(q, k, v, do, lse, delta, opts):
    """(p, ds) of the backward recompute, grouped fp32 (B, Hkv, G, Sq,
    Sk)."""
    Hkv = k.shape[1]
    z, dcap, mask = _scores(q, k, **opts)
    p = _probs(z, mask, lse.reshape(z.shape[:-1]))
    dp = torch.einsum("bkgqd,bktd->bkgqt", _grouped(do, Hkv), v.to(_f32))
    ds = p * (dp - delta.reshape(z.shape[:-1])[..., None])
    if dcap is not None:
        ds = ds * dcap
    return p, ds


def flash_backward_dq_plain(q, k, v, do, lse, delta, *, causal=True, scale,
                            window=None, softcap=None, q_offset=0):
    """dq in q's dtype: ``(ds . k) * scale``."""
    opts = dict(causal=causal, scale=scale, window=window, softcap=softcap,
                q_offset=q_offset)
    _, ds = _ds(q, k, v, do, lse, delta, opts)
    dq = torch.einsum("bkgqt,bktd->bkgqd", ds, k.to(_f32)) * scale
    return dq.reshape(q.shape).to(q.dtype)


def contract_sums(q, k, v, do, lse, delta, *, causal=True, scale,
                  window=None, softcap=None, q_offset=0):
    """{"o", "dq", "dk", "dv"}: each output element's absolute sum in
    fp32, the scale of the bf16 route's contract (module docstring): ``p .
    |v|``, ``scale * (|ds| + 2^-8 p (|do| . |v|^T)) . |k|``, ``scale *
    |ds|^T . |q|`` and ``p^T . |do|``, the last two summed over each GQA
    group, from the backward's lse and delta."""
    opts = dict(causal=causal, scale=scale, window=window, softcap=softcap,
                q_offset=q_offset)
    Hkv = k.shape[1]
    p, ds = _ds(q, k, v, do, lse, delta, opts)
    a_o = torch.einsum("bkgqt,bktd->bkgqd", p, v.to(_f32).abs())
    dp_abs = torch.einsum("bkgqd,bktd->bkgqt", _grouped(do, Hkv).abs(),
                          v.to(_f32).abs())
    a_dq = torch.einsum("bkgqt,bktd->bkgqd", ds.abs() + 2 ** -8 * p * dp_abs,
                        k.to(_f32).abs()) * scale
    del dp_abs
    a_dk = torch.einsum("bkgqt,bkgqd->bktd", ds.abs(),
                        _grouped(q, Hkv).abs()) * scale
    a_dv = torch.einsum("bkgqt,bkgqd->bktd", p, _grouped(do, Hkv).abs())
    return {"o": a_o.reshape(q.shape), "dq": a_dq.reshape(q.shape),
            "dk": a_dk, "dv": a_dv}


def contract_misses(got, want, sums) -> Tuple[int, float]:
    """(elements of ``got`` beyond ``2**-7`` of their absolute sum
    ``sums`` from ``want``, share beyond ``2**-9``): the bf16 route's
    contract (module docstring), with :func:`contract_sums`."""
    diff = (got.float() - want.float()).abs()
    return (int((diff > 2 ** -7 * sums).sum()),
            float((diff > 2 ** -9 * sums).float().mean()))


def flash_backward_dkv_plain(q, k, v, do, lse, delta, *, causal=True, scale,
                             window=None, softcap=None, q_offset=0):
    """(dk, dv) in k's and v's dtypes, summed over each GQA group:
    ``(ds^T . q) * scale`` and ``p^T . do``."""
    opts = dict(causal=causal, scale=scale, window=window, softcap=softcap,
                q_offset=q_offset)
    Hkv = k.shape[1]
    p, ds = _ds(q, k, v, do, lse, delta, opts)
    dk = torch.einsum("bkgqt,bkgqd->bktd", ds, _grouped(q, Hkv)) * scale
    dv = torch.einsum("bkgqt,bkgqd->bktd", p, _grouped(do, Hkv))
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernels


_PTR, _INT, _LL, _FLOAT = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_float)
_DIMS = [_INT] * 8 + [_LL, _LL, _FLOAT, _FLOAT, _PTR]
_SIGNATURES = {
    "flash_forward_launch": [_PTR] * 5 + _DIMS,
    "flash_backward_dq_launch": [_PTR] * 7 + _DIMS,
    "flash_backward_dkv_launch": [_PTR] * 8 + _DIMS,
}


@functools.cache
def _launch_fn(name: str):
    fn = getattr(_build.load("flash_attention"), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def check_kernel_args(q, k, v, do=None, lse=None, delta=None) -> None:
    """Raise ``ValueError`` for anything the CUDA kernels do not take."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} must be (B, "
                         f"H, Sq, hd) and k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} (B, Hkv, Sk, hd) alike")
    B, H, Sq, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[1]:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not fit "
                         f"q {tuple(q.shape)} (H must be a multiple of Hkv)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_attention: dtype {q.dtype} is not float32 "
                         "or bfloat16")
    want = [(q, q.shape, q.dtype), (k, k.shape, q.dtype),
            (v, k.shape, q.dtype), (do, q.shape, q.dtype),
            (lse, (B, H, Sq), _f32), (delta, (B, H, Sq), _f32)]
    for t, shape, dtype in want:
        if t is not None and (t.shape != shape or t.dtype != dtype
                              or t.device != q.device
                              or not t.is_contiguous()):
            raise ValueError("flash_attention: an operand is "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}; "
                             f"want {tuple(shape)} {dtype}, contiguous on "
                             f"{q.device}")
    # the tensor-core kernels copy rows in 16-byte pieces (cp.async)
    if q.dtype == torch.bfloat16 and any(
            t is not None and t.data_ptr() % 16 for t in (q, k, v, do)):
        raise ValueError("flash_attention: a bf16 operand does not start "
                         "on a 16-byte boundary")


def _dims(q, k, *, causal, window, q_offset, scale, softcap):
    B, H, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    return (B, H, Hkv, Sq, Sk, hd, int(q.dtype == torch.bfloat16),
            int(bool(causal)), WINDOW_NONE if window is None else int(window),
            int(q_offset), float(scale), float(softcap or 0.0),
            torch.cuda.current_stream(q.device).cuda_stream)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _forward_kernel(q, k, v, **opts):
    check_kernel_args(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=_f32, device=q.device)
    err = _launch_fn("flash_forward_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), *_dims(q, k, **opts))
    _raise_on(err, "attn_fwd")
    KERNEL_LAUNCHES["attn_fwd"] += 1
    return o, lse


def _dq_kernel(q, k, v, do, lse, delta, **opts):
    check_kernel_args(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    err = _launch_fn("flash_backward_dq_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_dims(q, k, **opts))
    _raise_on(err, "attn_bwd_dq")
    KERNEL_LAUNCHES["attn_bwd_dq"] += 1
    return dq


def _dkv_kernel(q, k, v, do, lse, delta, **opts):
    check_kernel_args(q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _launch_fn("flash_backward_dkv_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_dims(q, k, **opts))
    _raise_on(err, "attn_bwd_dkv")
    KERNEL_LAUNCHES["attn_bwd_dkv"] += 1
    return dk, dv


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type == "cpu"
    raise ValueError(f"flash_attention: no route for device {t.device}")


# ---------------------------------------------------------------------------
# entry points: plain version on the CPU, the kernel on the GPU


def flash_forward(q, k, v, *, causal=True, scale, window=None, softcap=None,
                  q_offset=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o like q, lse (B, H, Sq) fp32)."""
    opts = dict(causal=causal, scale=scale, window=window, softcap=softcap,
                q_offset=q_offset)
    if _on_cpu(q):
        return flash_forward_plain(q, k, v, **opts)
    return _forward_kernel(q, k, v, **opts)


def flash_backward_dq(q, k, v, do, lse, delta, *, causal=True, scale,
                      window=None, softcap=None, q_offset=0):
    """dq like q, from the forward's lse and ``delta = rowsum(do * o)``."""
    opts = dict(causal=causal, scale=scale, window=window, softcap=softcap,
                q_offset=q_offset)
    if _on_cpu(q):
        return flash_backward_dq_plain(q, k, v, do, lse, delta, **opts)
    return _dq_kernel(q, k, v, do, lse, delta, **opts)


def flash_backward_dkv(q, k, v, do, lse, delta, *, causal=True, scale,
                       window=None, softcap=None, q_offset=0):
    """(dk like k, dv like v), each summed over its GQA group."""
    opts = dict(causal=causal, scale=scale, window=window, softcap=softcap,
                q_offset=q_offset)
    if _on_cpu(q):
        return flash_backward_dkv_plain(q, k, v, do, lse, delta, **opts)
    return _dkv_kernel(q, k, v, do, lse, delta, **opts)


class _FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v); the backward launches dQ, then dK/dV."""

    @staticmethod
    def forward(ctx, q, k, v, opts):
        o, lse = flash_forward(q, k, v, **opts)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = opts
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        g = g.contiguous()
        delta = (g.to(_f32) * o.to(_f32)).sum(-1)
        dq = flash_backward_dq(q, k, v, g, lse, delta, **ctx.opts)
        dk, dv = flash_backward_dkv(q, k, v, g, lse, delta, **ctx.opts)
        return dq, dk, dv, None


def _chunk_len(S: int, cap: int = 512) -> int:
    """The twin's KV chunk: the largest divisor of S up to ``cap`` (the
    reference's)."""
    c = min(S, cap)
    while S % c:
        c -= 1
    return c


def _attention_backward_chunked(q, k, v, do, *, causal=True, scale,
                               window=None, softcap=None, q_offset=0):
    """(dq, dk, dv) of attention in plain differentiable PyTorch over KV
    chunks, all fp32: pass A recomputes each chunk's masked (softcapped)
    scores and the row log-sum-exp, then o; pass B forms ``p = exp(z -
    lse)``, ``ds = p * (do . v^T - rowsum(do * o)) * dcap`` and sums dq,
    dk and dv (dk and dv over each GQA group).  Differentiating it gives
    the second order of attention (the twin's backward)."""
    B, H, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    q32, do32 = _grouped(q, Hkv), _grouped(do, Hkv)
    k32, v32 = k.to(_f32), v.to(_f32)
    mask = band_mask(Sq, Sk, causal=causal, window=window,
                     q_offset=q_offset, device=q.device)
    c = _chunk_len(Sk)
    chunks, lse_parts = [], []
    for c0 in range(0, Sk, c):
        kc, mc = k32[:, :, c0:c0 + c], mask[:, c0:c0 + c]
        s = torch.einsum("bkgsh,bkth->bkgst", q32, kc) * scale
        dcap = None
        if softcap is not None:
            t = torch.tanh(s / softcap)
            s, dcap = softcap * t, 1.0 - t * t
        z = torch.where(mc, s, NEG_INF)
        chunks.append((c0, z, mc, dcap))
        lse_parts.append(torch.logsumexp(z, dim=-1))
    lse = torch.logsumexp(torch.stack(lse_parts), dim=0)[..., None]
    probs = [torch.where(mc, torch.exp(z - lse), 0.0)
             for _, z, mc, _ in chunks]
    o = sum(torch.einsum("bkgst,bkth->bkgsh", p, v32[:, :, c0:c0 + c])
            for (c0, _, _, _), p in zip(chunks, probs))
    delta = (do32 * o).sum(-1, keepdim=True)
    dq = torch.zeros_like(q32)
    dks, dvs = [], []
    for (c0, _, _, dcap), p in zip(chunks, probs):
        kc, vc = k32[:, :, c0:c0 + c], v32[:, :, c0:c0 + c]
        ds = p * (torch.einsum("bkgsh,bkth->bkgst", do32, vc) - delta)
        if dcap is not None:
            ds = ds * dcap
        dq = dq + torch.einsum("bkgst,bkth->bkgsh", ds, kc) * scale
        dks.append(torch.einsum("bkgst,bkgsh->bkth", ds, q32) * scale)
        dvs.append(torch.einsum("bkgst,bkgsh->bkth", p, do32))
    return (dq.reshape(B, H, Sq, hd).to(q.dtype),
            torch.cat(dks, dim=2).to(k.dtype),
            torch.cat(dvs, dim=2).to(v.dtype))


def _attention_tangent_chunked(q, k, v, dq, dk, dv, *, causal=True, scale,
                               window=None, softcap=None, q_offset=0):
    """The tangent of attention's output in plain PyTorch over KV chunks,
    all fp32, the reference's ``_flash_jvp_rule``: pass A recomputes each
    chunk's masked (softcapped) scores and the row log-sum-exp, then o;
    pass B sums ``do = (p * dz) . v - rowsum(p * dz) o + p . dv`` with
    ``dz = dcap * scale * (dq . k^T + q . dk^T)``.  A missing tangent is
    zero.  Returns ``do`` in q's dtype."""
    B, H, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    q32 = _grouped(q, Hkv)
    k32, v32 = k.to(_f32), v.to(_f32)
    dq32 = None if dq is None else _grouped(dq, Hkv)
    dk32 = None if dk is None else dk.to(_f32)
    dv32 = None if dv is None else dv.to(_f32)
    mask = band_mask(Sq, Sk, causal=causal, window=window,
                     q_offset=q_offset, device=q.device)
    c = _chunk_len(Sk)
    chunks, lse_parts = [], []
    for c0 in range(0, Sk, c):
        kc, mc = k32[:, :, c0:c0 + c], mask[:, c0:c0 + c]
        s = torch.einsum("bkgsh,bkth->bkgst", q32, kc) * scale
        dcap = None
        if softcap is not None:
            t = torch.tanh(s / softcap)
            s, dcap = softcap * t, 1.0 - t * t
        z = torch.where(mc, s, NEG_INF)
        chunks.append((c0, z, mc, dcap))
        lse_parts.append(torch.logsumexp(z, dim=-1))
    lse = torch.logsumexp(torch.stack(lse_parts), dim=0)[..., None]
    o = torch.zeros_like(q32)
    u = torch.zeros_like(q32[..., :1])
    t_pv = torch.zeros_like(q32)
    for c0, z, mc, dcap in chunks:
        p = torch.where(mc, torch.exp(z - lse), 0.0)
        vc = v32[:, :, c0:c0 + c]
        o = o + torch.einsum("bkgst,bkth->bkgsh", p, vc)
        dz = torch.zeros_like(z)
        if dq32 is not None:
            dz = dz + torch.einsum("bkgsh,bkth->bkgst", dq32,
                                   k32[:, :, c0:c0 + c])
        if dk32 is not None:
            dz = dz + torch.einsum("bkgsh,bkth->bkgst", q32,
                                   dk32[:, :, c0:c0 + c])
        dz = dz * scale
        if dcap is not None:
            dz = dz * dcap
        pdz = p * dz
        u = u + pdz.sum(-1, keepdim=True)
        t_pv = t_pv + torch.einsum("bkgst,bkth->bkgsh", pdz, vc)
        if dv32 is not None:
            t_pv = t_pv + torch.einsum("bkgst,bkth->bkgsh", p,
                                       dv32[:, :, c0:c0 + c])
    return (t_pv - u * o).reshape(B, H, Sq, hd).to(q.dtype)


class _FlashAttentionTwin(torch.autograd.Function):
    """o = attention(q, k, v) from the forward kernel; the backward is
    :func:`_attention_backward_chunked` and the tangent
    :func:`_attention_tangent_chunked`, both plain PyTorch, so that
    ``torch.func.jvp`` of ``torch.func.grad`` (the Hutchinson HVP,
    forward-over-reverse as the reference takes it) reaches no backward
    kernel.  The backward differentiates in forward mode only."""

    @staticmethod
    def forward(q, k, v, opts):
        o, _ = flash_forward(q, k, v, **opts)
        return o

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, opts = inputs
        ctx.save_for_backward(q, k, v)
        ctx.save_for_forward(q, k, v)
        ctx.opts = opts

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        # no graph for a second reverse pass (the HVP runs forward mode
        # over this backward; see fused_ce._FusedNLLTwin.backward)
        with torch.no_grad():
            return _attention_backward_chunked(q, k, v, g,
                                               **ctx.opts) + (None,)

    @staticmethod
    def jvp(ctx, dq, dk, dv, _):
        q, k, v = ctx.saved_tensors
        return _attention_tangent_chunked(q, k, v, dq, dk, dv, **ctx.opts)


def flash_attention(q, k, v, *, causal=True, scale=None, window=None,
                    softcap=None, q_offset=0, use_jvp=False):
    """Fused attention: q (B, H, Sq, hd), k and v (B, Hkv, Sk, hd) in fp32
    or bf16 -> o like q, differentiable in q, k and v.  ``scale``
    defaults to 1/sqrt(hd); ``window`` None or ``WINDOW_NONE`` is global;
    ``q_offset`` (>= 0) shifts the query positions.  ``use_jvp`` takes
    the twin whose backward is plain PyTorch and differentiable again."""
    if q.shape[1] % k.shape[1] or k.shape != v.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    opts = dict(causal=bool(causal),
                scale=float(1.0 / math.sqrt(q.shape[-1]) if scale is None
                            else scale),
                window=None if window is None or window >= WINDOW_NONE
                else int(window),
                softcap=None if softcap is None else float(softcap),
                q_offset=int(q_offset))
    fn = _FlashAttentionTwin if use_jvp else _FlashAttention
    return fn.apply(q.contiguous(), k.contiguous(), v.contiguous(), opts)


# ---------------------------------------------------------------------------
# work of one call (bound in chip_smoke.py)


def attn_flops(B, H, hd, pairs, which: str) -> int:
    """Multiply-add flops of one call over ``pairs`` attended (query, key)
    pairs per (batch, head): the forward's two products (q.k, p.v), dQ's
    three (q.k, do.v, ds.k), dK/dV's four (q.k, do.v, p^T.do, ds^T.q)."""
    n = {"attn_fwd": 2, "attn_bwd_dq": 3, "attn_bwd_dkv": 4}[which]
    return 2 * B * H * hd * pairs * n


def attn_bytes(B, H, Hkv, Sq, Sk, hd, which: str, *, itemsize: int) -> int:
    """Bytes one call must move: each input read once, each output
    written once (q-like planes, k-like planes, fp32 (B, H, Sq) rows)."""
    qp = B * H * Sq * hd * itemsize
    kp = B * Hkv * Sk * hd * itemsize
    row = 4 * B * H * Sq
    if which == "attn_fwd":
        return 2 * qp + 2 * kp + row              # q, k, v; o, lse
    if which == "attn_bwd_dq":
        return 3 * qp + 2 * kp + 2 * row          # q, k, v, do, lse, delta; dq
    return 2 * qp + 4 * kp + 2 * row              # ...; dk, dv
