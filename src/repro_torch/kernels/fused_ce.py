"""Logits-free fused LM cross-entropy: the counterpart of
``repro/kernels/fused_ce.py``.

The loss of a hidden batch against a (Vp, D) tied or (D, Vp) untied
unembedding without the (N, Vp) logits ever existing:

  forward   one vocab sweep keeps a running (max, sum-exp, label logit)
            per row and emits only ``lse`` and the label logit, (N,) each;
            the final norm is applied to the hidden rows inside the sweep;
  sampling  the same sweep draws ŷ ~ softmax(logits) by online Gumbel-argmax
            over counter-based hash noise (a pure uint32 function of
            ``(seed, row, col)``, so it reproduces the reference's draws
            exactly) and keeps the drawn column's raw logit: GNB's sampled
            labels with no second pass;
  backward one call recomputes the logits once for both gradients and
            emits d(normed hidden) and dW from ``softmax - onehot``; the
            autograd functions pull d(normed hidden) back through the norm
            with autograd of the plain :func:`apply_norm`;
  twin      :func:`fused_lm_loss_jvp`, the labeled NLL for the Hutchinson
            HVP: the forward kernel's value, and a backward and a tangent
            rule of plain differentiable PyTorch (2048-column chunks), so
            the HVP's ``torch.func.jvp`` of ``torch.func.grad`` never
            reaches a backward kernel (the reference's ``custom_jvp``
            twin);
  chunked   :func:`chunked_lm_loss` (and its sampled form), the
            reference's "chunked" loss route: the twin with the plain
            sweep as its forward, no kernel on any device.

On a CUDA tensor each entry point launches the hand-written kernels of
``csrc/fused_ce.cu`` (and adds one to its count in ``KERNEL_LAUNCHES``):

  ``ce_forward``          forward (TPU kernel ``_ce_forward``, row 11)
  ``ce_forward_sampled``  forward with the draw (``_ce_forward_sampled``,
                          row 12)
  ``ce_backward_dh``      d(normed hidden) (``_ce_backward`` dh, row 14)
  ``ce_backward_dw``      dW (``_ce_backward`` dW, row 15)
  ``ce_backward``         both (``_ce_backward``'s fused schedule, row 13):
                          one launch of the pair, counted as one of each

With h in bf16 (the training path) all of them multiply on the bf16
tensor cores through ``wgmma`` fed by TMA (h_n and W cast to bf16, as the
reference casts them; fp32 sums): the forwards in one persistent sweep, a
producer warp feeding two consumer warpgroups that fold each 128 x 128
logits tile from registers (:func:`forward_plan` is its walk), the
backward in one prep and one
logits sweep a chunk for both gradients;
with fp32 h on the fp32 FMA units (the card-vs-CPU checks at 1e-5).

On a CPU tensor it computes the plain version beside it, the reference's
checkpoint-free chunked sweep (``models/loss.py:_chunked_sweep``) with the
hash noise in place of ``jax.random``.  A CUDA tensor the kernel does not
take raises; there is no other route.

Compute convention (the reference's ``unembed``): W cast to the hidden
dtype, products summed in fp32, softcap in fp32, padded columns at the
-1e30 sentinel (never sampled, exactly zero gradient).  d(hidden) sums
``d . W`` with W in fp32; dW sums ``d^T . h_n`` in fp32 and rounds once
into W's dtype.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from . import KERNEL_LAUNCHES, _build

NEG_INF = -1e30       # masked-logit sentinel of the reference
CHUNK = 2048          # vocab columns per chunk of the plain sweep
NORMS = (None, "ln", "rms")
_NORM_CODE = {None: 0, "ln": 1, "rms": 2}
_f32 = torch.float32
_M32 = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# counter-based Gumbel noise (the reference's _mix32 / hash_gumbel)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32): split so that no
    product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32-style finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def hash_uniform(seed, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The fp32 uniform in [1e-7, 1 - 1e-7] behind :func:`hash_gumbel`."""
    s0, s1 = (int(v) & _M32 for v in seed)
    r = _mix32((rows.to(torch.int64) & _M32) ^ s0)
    x = _mix32(r ^ _mul32(cols.to(torch.int64) & _M32, 0x9E3779B9) ^ s1)
    u = (x >> 8).to(_f32) * (1.0 / (1 << 24))
    return u.clamp(1e-7, 1.0 - 1e-7)


def hash_gumbel(seed, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Gumbel(0, 1) noise as a pure function of ``(seed, row, col)``:
    ``seed`` two uint32 values (ints or a (2,) array), ``rows``/``cols``
    broadcastable integer tensors of global indices (taken mod 2**32)."""
    return -torch.log(-torch.log(hash_uniform(seed, rows, cols)))


# ---------------------------------------------------------------------------
# the online-reduction rules (the reference's, one copy)


def online_lse_step(m, l, s, valid=None):
    """One vocab chunk of a running log-sum-exp; ``valid`` masks columns
    so that a padded column adds nothing.  The final lse is m + log(l)."""
    m_new = torch.maximum(m, s.amax(-1))
    e = torch.exp(s - m_new[:, None])
    if valid is not None:
        e = torch.where(valid, e, 0.0)
    return m_new, l * torch.exp(m - m_new) + e.sum(-1)


def online_argmax_step(best, s, z, c0):
    """One vocab chunk of a running Gumbel-argmax over (zm, zi, zl):
    strict ``>`` across chunks and the first maximum within one, so any
    chunking gives the first argmax of the whole row."""
    zm, zi, zl = best
    zmax, zarg = z.max(-1)
    chunk_logit = s.gather(1, zarg[:, None])[:, 0]
    upd = zmax > zm
    return (torch.where(upd, zmax, zm),
            torch.where(upd, (c0 + zarg).to(torch.int32), zi),
            torch.where(upd, chunk_logit, zl))


def vocab_chunk(v: int, want: int, quantum: int = 1) -> int:
    """Largest multiple of ``quantum`` <= want dividing ``v``."""
    b = max(quantum, min(want, v))
    b -= b % quantum
    while b >= quantum:
        if v % b == 0:
            return b
        b -= quantum
    return quantum


def rowscale(n_rows: int, mask, device=None):
    """(per-row scale, n_valid): ``mask / sum(mask)`` flattened to
    (n_rows,), or uniform 1/N unmasked.  ``n_valid`` is GNB's batch
    factor B."""
    if mask is None:
        return (torch.full((n_rows,), 1.0 / n_rows, dtype=_f32,
                           device=device),
                torch.tensor(float(n_rows), dtype=_f32, device=device))
    m = mask.reshape(-1).to(_f32)
    n_valid = torch.clamp_min(m.sum(), 1.0)
    return m / n_valid, n_valid


def _row_stats_plain(x32, norm, eps):
    """(mean, 1/sqrt(var + eps)) of each row, (..., 1) fp32 each; rms: 0
    and 1/sqrt(mean(x^2) + eps)."""
    if norm == "ln":
        mu = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    elif norm == "rms":
        mu = torch.zeros_like(x32[..., :1])
        var = x32.square().mean(dim=-1, keepdim=True)
    else:
        raise ValueError(f"norm {norm!r} is not ln or rms")
    return mu, torch.rsqrt(var + eps)


def apply_norm(x, normp, norm, eps, stats=None):
    """The fused final norm, the reference's convention: fp32 statistics
    over the last axis, cast back to x's dtype.  ``normp`` is the (2, D)
    fp32 [scale; bias] pair: ln is ``scale * xhat + bias``, rms ``x *
    rsqrt(mean(x^2) + eps) * (1 + scale)`` (no bias).  ``stats``, an (N,
    2) fp32 [mean, 1/sqrt(var + eps)] per row (:func:`row_stats`),
    replaces the statistics this version would compute: with the kernels'
    own, it normalizes the rows as they do."""
    if norm is None:
        return x
    x32 = x.to(_f32)
    if stats is None:
        mu, rstd = _row_stats_plain(x32, norm, eps)
    else:
        mu, rstd = stats[..., :1], stats[..., 1:]
    scale = normp[0]
    if norm == "ln":
        out = (x32 - mu) * rstd * scale + normp[1]
    elif norm == "rms":
        out = x32 * rstd * (1.0 + scale)
    else:
        raise ValueError(f"norm {norm!r} is not ln or rms")
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# plain versions: the chunked vocab sweep


def _vp_of(w, transpose_w) -> int:
    return w.shape[1] if transpose_w else w.shape[0]


def _chunk_logits(h32, w, cdt, c0, bv, transpose_w, softcap, vocab):
    """One chunk's logits (s, valid, cols, dcap): W cast to the hidden
    dtype ``cdt``, fp32 products and sums, softcap, padded columns at the
    sentinel.  ``dcap`` is the softcap derivative (None uncapped)."""
    if transpose_w:
        raw = h32 @ w[:, c0:c0 + bv].to(cdt).to(_f32)
    else:
        raw = h32 @ w[c0:c0 + bv].to(cdt).to(_f32).T
    dcap = None
    if softcap is not None:
        t = torch.tanh(raw / softcap)
        raw = softcap * t
        dcap = 1.0 - t * t
    cols = torch.arange(c0, c0 + bv, device=raw.device)
    valid = (cols < vocab)[None, :]
    return torch.where(valid, raw, NEG_INF), valid, cols, dcap


def _sweep_plain(h2, w, normp, labels, seed, *, vocab, transpose_w, softcap,
                 norm, eps, chunk, row_ids=None, stats=None):
    hn = apply_norm(h2, normp, norm, eps, stats)
    N = hn.shape[0]
    Vp = _vp_of(w, transpose_w)
    bv = vocab_chunk(Vp, chunk, 128)
    h32 = hn.to(_f32)
    dev = h2.device
    m = torch.full((N,), NEG_INF, dtype=_f32, device=dev)
    l = torch.zeros((N,), dtype=_f32, device=dev)
    ll = torch.zeros((N,), dtype=_f32, device=dev)
    zm = torch.full((N,), NEG_INF, dtype=_f32, device=dev)
    zi = torch.zeros((N,), dtype=torch.int32, device=dev)
    rows = (torch.arange(N, device=dev) if row_ids is None
            else row_ids.to(dev))[:, None]
    for c0 in range(0, Vp, bv):
        s, valid, cols, _ = _chunk_logits(h32, w, hn.dtype, c0, bv,
                                          transpose_w, softcap, vocab)
        m, l = online_lse_step(m, l, s, valid)
        if seed is None:
            hit = cols[None, :] == labels.to(torch.int64)[:, None]
            ll = ll + torch.where(hit, s, 0.0).sum(-1)
        else:
            g = (seed(c0, bv) if callable(seed)
                 else hash_gumbel(seed, rows, cols[None, :]))
            z = torch.where(valid, s + g, NEG_INF)
            zm, zi, ll = online_argmax_step((zm, zi, ll), s, z, c0)
    lse = m + torch.log(torch.clamp_min(l, 1e-37))
    return lse, ll, zi


def ce_forward_plain(h2, w, normp, labels, *, vocab, transpose_w=False,
                     softcap=None, norm=None, eps=1e-6, chunk=CHUNK,
                     stats=None):
    """(lse, label logit) per row, fp32 (N,) each.  ``stats`` as in
    :func:`apply_norm`."""
    lse, ll, _ = _sweep_plain(h2, w, normp, labels, None, vocab=vocab,
                              transpose_w=transpose_w, softcap=softcap,
                              norm=norm, eps=eps, chunk=chunk, stats=stats)
    return lse, ll


def ce_forward_sampled_plain(h2, w, normp, seed, *, vocab,
                             transpose_w=False, softcap=None, norm=None,
                             eps=1e-6, chunk=CHUNK, row_ids=None,
                             stats=None):
    """(lse, drawn logit, ŷ int32) per row.  ``seed`` is two uint32
    values (the hash noise) or ``draw(c0, width) -> (N, width)`` fp32
    Gumbel noise of the chunk of columns from ``c0``, called in chunk
    order.  ``row_ids`` (N,) gives each row the hash's row index (its
    place in a larger batch); None: ``arange(N)``.  ``stats`` as in
    :func:`apply_norm`."""
    return _sweep_plain(h2, w, normp, None, seed, vocab=vocab,
                        transpose_w=transpose_w, softcap=softcap, norm=norm,
                        eps=eps, chunk=chunk, row_ids=row_ids, stats=stats)


def ce_backward_plain(h2, w, normp, labels, rs, lse, *, vocab,
                      transpose_w=False, softcap=None, norm=None, eps=1e-6,
                      chunk=CHUNK, stats=None):
    """(d normed hidden, dW): dh fp32 with a norm (the caller pulls it
    back), else h's dtype; dW in W's dtype and layout.  ``stats`` as in
    :func:`apply_norm`."""
    hn = apply_norm(h2, normp, norm, eps, stats)
    N, D = hn.shape
    Vp = _vp_of(w, transpose_w)
    bv = vocab_chunk(Vp, chunk, 128)
    h32 = hn.to(_f32)
    w32 = w.to(_f32)
    lab = labels.to(torch.int64)[:, None]
    dh = torch.zeros((N, D), dtype=_f32, device=h2.device)
    dw = torch.zeros(w.shape, dtype=_f32, device=h2.device)
    for c0 in range(0, Vp, bv):
        s, _, cols, dcap = _chunk_logits(h32, w, hn.dtype, c0, bv,
                                         transpose_w, softcap, vocab)
        p = torch.exp(s - lse[:, None])
        onehot = (cols[None, :] == lab).to(_f32)
        d = (p - onehot) * rs[:, None]
        if dcap is not None:
            d = d * dcap
        if transpose_w:
            dh += d @ w32[:, c0:c0 + bv].T
            dw[:, c0:c0 + bv] = h32.T @ d
        else:
            dh += d @ w32[c0:c0 + bv]
            dw[c0:c0 + bv] = d.T @ h32
    return (dh if norm is not None else dh.to(h2.dtype)), dw.to(w.dtype)


def ce_backward_dh_plain(*args, **kw):
    return ce_backward_plain(*args, **kw)[0]


def ce_backward_dw_plain(*args, **kw):
    return ce_backward_plain(*args, **kw)[1]


# ---------------------------------------------------------------------------
# the CUDA kernels


_PTR, _INT, _FLOAT, _UINT = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                             ctypes.c_uint)
_SIGNATURES = {
    "ce_forward_launch": [_PTR] * 11 + [_INT] * 8 + [_FLOAT, _FLOAT, _INT,
                                                      _UINT, _UINT, _INT,
                                                      _INT, _PTR, _PTR],
    "ce_forward_ws_bytes": [_INT] * 5,
    "ce_backward_launch": [_PTR] * 8 + [_INT, _PTR, _PTR] + [_INT] * 8
    + [_FLOAT, _FLOAT, _INT, _PTR],
    "ce_backward_ws_bytes": [_INT] * 7,
    "ce_row_stats_launch": [_PTR, _PTR] + [_INT] * 4 + [_FLOAT, _PTR],
}


@functools.cache
def _launch_fn(name: str):
    fn = getattr(_build.load("fused_ce"), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = (ctypes.c_longlong if name.endswith("_ws_bytes")
                  else ctypes.c_int)
    return fn


def check_kernel_args(h2, w, normp, *, transpose_w, norm) -> None:
    """Raise ``ValueError`` for anything the CUDA kernels do not take."""
    if h2.dim() != 2 or w.dim() != 2:
        raise ValueError(f"fused_ce: h {tuple(h2.shape)} must be (N, D) and "
                         f"w {tuple(w.shape)} two-dimensional")
    N, D = h2.shape
    Dw = w.shape[0] if transpose_w else w.shape[1]
    if Dw != D:
        raise ValueError(f"fused_ce: w {tuple(w.shape)} does not match "
                         f"D={D} (transpose_w={transpose_w})")
    if D % 128 or D == 0:
        raise ValueError(f"fused_ce: D={D} must be a positive multiple of "
                         "128 (the kernels' tile)")
    if _vp_of(w, transpose_w) % 128:
        raise ValueError("fused_ce: the padded vocab must be a multiple of "
                         "128")
    for t, name in ((h2, "h"), (w, "w")):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"fused_ce: {name} dtype {t.dtype} is not "
                             "float32 or bfloat16")
        if t.device != h2.device or not t.is_contiguous():
            raise ValueError(f"fused_ce: {name} must be contiguous on "
                             f"{h2.device}")
    # with bf16 h the tensor-core route reads W in 16-byte pieces (TMA
    # boxes of a bf16 W; the prep's loads of an fp32 W)
    if h2.dtype == torch.bfloat16 and w.data_ptr() % 16:
        raise ValueError("fused_ce: with bf16 h, w must start on a 16-byte "
                         "boundary")
    if norm not in _NORM_CODE:
        raise ValueError(f"fused_ce: norm {norm!r} not in {NORMS}")
    if (normp.shape != (2, D) or normp.dtype != _f32
            or normp.device != h2.device or not normp.is_contiguous()):
        raise ValueError("fused_ce: normp must be (2, D) float32, "
                         f"contiguous on {h2.device}")


def _common(h2, w, normp, *, vocab, transpose_w, softcap, norm, eps):
    check_kernel_args(h2, w, normp, transpose_w=transpose_w, norm=norm)
    N, D = h2.shape
    return dict(
        stats=torch.empty((max(N, 1), 2), dtype=_f32, device=h2.device),
        dims=(N, D, int(vocab), _vp_of(w, transpose_w),
              int(h2.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
              int(bool(transpose_w)), _NORM_CODE[norm]),
        cfg=(float(eps), float(softcap or 0.0)),
        stream=torch.cuda.current_stream(h2.device).cuda_stream)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def forward_splits(N: int, Vp: int) -> Tuple[int, int]:
    """(splits, tiles per split) of the fp32-h forward's vocab axis:
    enough (64-row x split) blocks for about four per SM of an H100.  (The
    bf16-h forward's pieces are :func:`forward_plan`'s.)"""
    n_tiles = Vp // 128
    row_blocks = -(-N // 64)
    want = max(1, min(n_tiles, -(-528 // row_blocks)))
    per = -(-n_tiles // want)
    return -(-n_tiles // per), per


H100_SMS = 132


class ForwardPlan(NamedTuple):
    """The persistent walk of the bf16-h forward (``csrc/fused_ce.cu``, the
    note above ``ce_fwd_wgmma_kernel``).  ``pieces`` (k) cuts each row
    tile's vocabulary into runs of consecutive 128-column tiles; the row
    tiles run in groups of ``group``; ``grid`` blocks, one an SM;
    ``busiest`` the 128 x 128 tiles of the block with the most;
    ``idle_share`` the share of the card's SM time the walk leaves idle at
    the end: 1 - tiles / (sms * busiest)."""
    row_tiles: int
    vocab_tiles: int
    pieces: int
    group: int
    grid: int
    busiest: int
    idle_share: float


H_N_L2_BYTES = 20 << 20   # h_n this large or smaller stays in the L2 whole
ROW_GROUP = 12            # else row tiles a group: ~sqrt of 132 blocks


def _piece(T: int, k: int, j: int) -> Tuple[int, int]:
    """Vocab tiles [v0, v1) of piece j of k: the first T % k one longer."""
    q, rem = divmod(T, k)
    v0 = j * q + min(j, rem)
    return v0, v0 + q + (j < rem)


def _unit(n_rt: int, k: int, G: int, u: int) -> Tuple[int, int]:
    """(row tile, piece) of unit u: groups of G row tiles (the last may
    hold fewer), within a group the row tiles fastest."""
    grp, r = divmod(u, G * k)
    rows = min(G, n_rt - grp * G)
    return grp * G + r % rows, r // rows


def piece_loads(N: int, Vp: int, sms: int = H100_SMS):
    """[(busiest block's tiles, k) for k = 1 .. Vp / 128]: each count of
    pieces and the 128 x 128 tiles its busiest block walks in the order
    without groups (block 0 is then the busiest: loads fall with b)."""
    n_rt, T = -(-N // 128), Vp // 128
    out = []
    for k in range(1, T + 1):
        units = n_rt * k
        grid = min(sms, units)
        q, rem = divmod(T, k)
        out.append((q * -(-units // grid) + -(-(rem * n_rt) // grid), k))
    return out


@functools.lru_cache(maxsize=256)
def forward_plan(N: int, Vp: int, D: int, sms: int = H100_SMS) -> ForwardPlan:
    """The bf16-h forward's schedule on a card of ``sms`` SMs, the seed of
    ``kernels/autotune.py`` (the pick without a measured entry).  Block b
    takes the units b, b + grid, b + 2 grid, ... of the order of
    :func:`_unit`: the row tiles fastest within a group, so the blocks in
    flight share a few W tiles and a group's rows of h_n (every row tile
    where h_n takes at most ``H_N_L2_BYTES``, else ``ROW_GROUP``).  k is
    the one that leaves the busiest block the fewest tiles in the order
    without groups (:func:`piece_loads`), then the fewest pieces (which
    size the partials: 4 fp32 and an int32 a piece and row); ``busiest``
    is counted in the grouped order."""
    n_rt = -(-N // 128)
    G = n_rt if n_rt * 256 * D <= H_N_L2_BYTES else min(n_rt, ROW_GROUP)
    _, k = min(piece_loads(N, Vp, sms))
    return plan_at(N, Vp, k, G, sms)


@functools.lru_cache(maxsize=1024)
def plan_at(N: int, Vp: int, pieces: int, group: int,
            sms: int = H100_SMS) -> ForwardPlan:
    """The walk of the bf16-h forward at ``pieces`` (k) and ``group`` (G),
    any 1 <= k <= Vp / 128 and 1 <= G <= the row tiles: its grid, its
    busiest block's tiles in the grouped order and its idle share."""
    n_rt, T = -(-N // 128), Vp // 128
    if not (1 <= pieces <= T and 1 <= group <= n_rt):
        raise ValueError(f"fused_ce: pieces {pieces} (1..{T}) or group "
                         f"{group} (1..{n_rt}) out of range")
    grid = min(sms, n_rt * pieces)
    loads = [0] * grid
    for u in range(n_rt * pieces):
        v0, v1 = _piece(T, pieces, _unit(n_rt, pieces, group, u)[1])
        loads[u % grid] += v1 - v0
    busiest = max(loads)
    return ForwardPlan(n_rt, T, pieces, group, grid, busiest,
                       1.0 - n_rt * T / (sms * busiest))


WS_BUDGET = 256 << 20    # the d planes of a chunk, the seed's budget


def backward_plan(N: int, Vp: int, budget: int = WS_BUDGET) -> int:
    """The bf16-h backward's chunk width cw, the seed of
    ``kernels/autotune.py``: as many 128-column tiles a chunk as keep its
    two bf16 d planes, (Np, cw) each, within ``budget`` bytes (at least
    one), spread evenly over the chunks that takes (``csrc/fused_ce.cu``,
    the chunk-width note: 7296 at N 8192, Vp 50,304)."""
    Np, tiles = -(-N // 128) * 128, Vp // 128
    per_tile = 4 * Np * 128
    most = min(tiles, max(1, budget // per_tile))
    n = -(-tiles // most)
    return -(-tiles // n) * 128


def _up256(x: int) -> int:
    return -(-x // 256) * 256


def backward_ws_bytes(N: int, D: int, Vp: int, *, w_bf16: bool,
                      dh_f32: bool, cw: int) -> int:
    """Workspace bytes of the bf16-h backward at chunk width ``cw`` (the
    C side's ``tc_plan``): h_n (Np, D) bf16, an fp32 W's hi and lo planes,
    the two (Np, cw) d planes and, for a bf16 dh, its fp32 sums (N, D)."""
    Np = -(-N // 128) * 128
    w_planes = 0 if w_bf16 else 2 * _up256(2 * Vp * D)
    return (_up256(2 * Np * D) + w_planes + 2 * _up256(2 * Np * cw)
            + (0 if dh_f32 else _up256(4 * N * D)))


def forward_units(plan: ForwardPlan):
    """Per block, its units in the order it runs them: (row tile, piece,
    first vocab tile, end vocab tile)."""
    out = [[] for _ in range(plan.grid)]
    for u in range(plan.row_tiles * plan.pieces):
        i, j = _unit(plan.row_tiles, plan.pieces, plan.group, u)
        out[u % plan.grid].append((i, j,
                                   *_piece(plan.vocab_tiles, plan.pieces, j)))
    return out


def _tuned(h2, w, *, transpose_w, softcap, norm):
    """The tuner's entry for this call's shape (kernels/autotune.py): a
    measured pick, or the seed (:func:`forward_plan`'s pieces and group,
    :func:`backward_plan`'s chunk width)."""
    from .autotune import get_tuned
    N, D = h2.shape
    return get_tuned(N, D, _vp_of(w, transpose_w), h_dtype=h2.dtype,
                     w_dtype=w.dtype, transpose_w=transpose_w,
                     softcap=softcap, norm=norm, device=h2.device)


def _forward_kernel(h2, w, normp, labels, seed, *, vocab, transpose_w,
                    softcap, norm, eps, row_ids=None, plan=None):
    """``plan`` (pieces, group) overrides the tuner's for bf16 h (the
    tuner's own measurements); the fp32-h route has no choice."""
    c = _common(h2, w, normp, vocab=vocab, transpose_w=transpose_w,
                softcap=softcap, norm=norm, eps=eps)
    N = h2.shape[0]
    dev = h2.device
    sample = seed is not None
    _, D, _, Vp, h_bf16, w_bf16 = c["dims"][:6]
    # bf16 h: the tensor-core route, one partial per piece of the walk and
    # a workspace for h_n and W's bf16 plane
    if not h_bf16:
        if plan is not None:
            raise ValueError("fused_ce: the fp32-h forward takes no plan")
        splits, per = forward_splits(N, Vp)
    elif plan is None:
        t = _tuned(h2, w, transpose_w=transpose_w, softcap=softcap,
                   norm=norm)
        splits, per = t.pieces, t.group
    else:
        splits, per = plan
    ws = torch.empty((max(1, _launch_fn("ce_forward_ws_bytes")(
        N, D, Vp, h_bf16, w_bf16)),), dtype=torch.uint8, device=dev)
    part = torch.empty((4 * splits * N,), dtype=_f32, device=dev)
    part_idx = torch.empty((splits * N,), dtype=torch.int32, device=dev)
    lse = torch.empty((N,), dtype=_f32, device=dev)
    ll = torch.empty((N,), dtype=_f32, device=dev)
    yhat = torch.empty((N,), dtype=torch.int32, device=dev)
    rid_ptr = None
    if sample:
        s0, s1 = (int(v) & _M32 for v in seed)
        lab_ptr = None
        if row_ids is not None:
            row_ids = row_ids.to(device=dev, dtype=torch.int32).contiguous()
            if row_ids.shape != (N,):
                raise ValueError(f"fused_ce: row_ids "
                                 f"{tuple(row_ids.shape)} must be ({N},)")
            rid_ptr = row_ids.data_ptr()
    else:
        labels = labels.to(device=dev, dtype=torch.int32).contiguous()
        if labels.shape != (N,):
            raise ValueError(f"fused_ce: labels {tuple(labels.shape)} must "
                             f"be ({N},)")
        s0 = s1 = 0
        lab_ptr = labels.data_ptr()
    err = _launch_fn("ce_forward_launch")(
        h2.data_ptr(), w.data_ptr(), normp.data_ptr(),
        c["stats"].data_ptr(), lab_ptr, rid_ptr, part.data_ptr(),
        part_idx.data_ptr(),
        lse.data_ptr(), ll.data_ptr(), yhat.data_ptr(), *c["dims"],
        *c["cfg"], int(sample), s0, s1, splits, per, ws.data_ptr(),
        c["stream"])
    name = "ce_forward_sampled" if sample else "ce_forward"
    _raise_on(err, name)
    KERNEL_LAUNCHES[name] += 1
    return lse, ll, yhat


def _backward_kernel(which, h2, w, normp, labels, rs, lse, *, vocab,
                     transpose_w, softcap, norm, eps, cw=None):
    """``which`` "dh", "dw" or "both" (a tuple (dh, dW) from one launch of
    the pair: with bf16 h one prep and one logits sweep a chunk feed both
    products; it counts one launch of each kernel, since both run).
    ``cw``, the vocabulary columns of a chunk, overrides the tuner's for
    bf16 h (the tuner's own measurements); the fp32-h route has no
    chunks."""
    c = _common(h2, w, normp, vocab=vocab, transpose_w=transpose_w,
                softcap=softcap, norm=norm, eps=eps)
    N = h2.shape[0]
    dev = h2.device
    labels = labels.to(device=dev, dtype=torch.int32).contiguous()
    rs = rs.to(device=dev, dtype=_f32).contiguous()
    lse = lse.to(device=dev, dtype=_f32).contiguous()
    for t, name in ((labels, "labels"), (rs, "rs"), (lse, "lse")):
        if t.shape != (N,):
            raise ValueError(f"fused_ce: {name} {tuple(t.shape)} must be "
                             f"({N},)")
    ptrs = (h2.data_ptr(), w.data_ptr(), normp.data_ptr(),
            c["stats"].data_ptr(), labels.data_ptr(), rs.data_ptr(),
            lse.data_ptr())
    # the tensor-core route's scratch (bf16 h): h_n, W's bf16 planes, one
    # vocab chunk of d in two bf16 planes, dh's fp32 sums
    dh_f32 = int(which == "dw" or norm is not None)
    _, D, _, Vp, h_bf16, w_bf16 = c["dims"][:6]
    if not h_bf16:
        if cw is not None:
            raise ValueError("fused_ce: the fp32-h backward takes no chunk "
                             "width")
        cw = 0
    elif cw is None:
        cw = _tuned(h2, w, transpose_w=transpose_w, softcap=softcap,
                    norm=norm).cw
    n_ws = _launch_fn("ce_backward_ws_bytes")(N, D, Vp, h_bf16, w_bf16,
                                              dh_f32, cw)
    if n_ws < 0:
        raise ValueError(f"fused_ce: chunk width {cw} is not a multiple of "
                         f"128 in [128, {Vp}]")
    ws = torch.empty((max(1, n_ws),), dtype=torch.uint8, device=dev)
    dh = dw = None
    if which != "dw":
        dh = torch.empty(h2.shape, device=dev,
                         dtype=_f32 if norm is not None else h2.dtype)
    if which != "dh":
        dw = torch.empty(w.shape, dtype=w.dtype, device=dev)
    # a null output (0) is one the C entry does not compute
    err = _launch_fn("ce_backward_launch")(
        *ptrs, 0 if dh is None else dh.data_ptr(), dh_f32,
        0 if dw is None else dw.data_ptr(), ws.data_ptr(), *c["dims"],
        *c["cfg"], cw, c["stream"])
    _raise_on(err, "ce_backward" if which == "both"
              else f"ce_backward_{which}")
    for name, out in (("ce_backward_dh", dh), ("ce_backward_dw", dw)):
        if out is not None:
            KERNEL_LAUNCHES[name] += 1
    return (dh, dw) if which == "both" else (dh if which == "dh" else dw)


def row_stats(h2, *, norm, eps=1e-6):
    """(N, 2) fp32: each row's mean and 1/sqrt(var + eps) (rms: 0 and
    1/sqrt(mean(x^2) + eps)), the statistics the kernels normalize with.
    On a CUDA tensor the first kernel every CE wrapper launches computes
    them (a checking aid, so it counts no launch: the card's check holds
    them against the plain ones and the plain backward fed them against
    the kernels); on the CPU the plain version's."""
    if _route(h2) == "cpu":
        return torch.cat(_row_stats_plain(h2.to(_f32), norm, eps), dim=-1)
    if norm not in ("ln", "rms") or h2.dim() != 2 or not h2.is_contiguous():
        raise ValueError("fused_ce.row_stats: a contiguous (N, D) h and "
                         "norm ln or rms")
    N, D = h2.shape
    stats = torch.empty((N, 2), dtype=_f32, device=h2.device)
    err = _launch_fn("ce_row_stats_launch")(
        h2.data_ptr(), stats.data_ptr(), N, D,
        int(h2.dtype == torch.bfloat16), _NORM_CODE[norm], float(eps),
        torch.cuda.current_stream(h2.device).cuda_stream)
    _raise_on(err, "row_stats")
    return stats


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"fused_ce: no route for device {t.device}")


# ---------------------------------------------------------------------------
# entry points: plain version on the CPU, the kernel on the GPU


def ce_forward(h2, w, normp, labels, *, vocab, transpose_w=False,
               softcap=None, norm=None, eps=1e-6):
    """h2 (N, D); w (Vp, D), or (D, Vp) with ``transpose_w``; normp (2, D)
    fp32; labels (N,) -> (lse, label logit), fp32 (N,) each."""
    if _route(h2) == "cpu":
        return ce_forward_plain(h2, w, normp, labels, vocab=vocab,
                                transpose_w=transpose_w, softcap=softcap,
                                norm=norm, eps=eps)
    lse, ll, _ = _forward_kernel(h2, w, normp, labels, None, vocab=vocab,
                                 transpose_w=transpose_w, softcap=softcap,
                                 norm=norm, eps=eps)
    return lse, ll


def ce_forward_sampled(h2, w, normp, seed, *, vocab, transpose_w=False,
                       softcap=None, norm=None, eps=1e-6, row_ids=None):
    """The forward sweep with the draw: (lse, drawn logit, ŷ int32);
    ``row_ids`` as in :func:`ce_forward_sampled_plain`."""
    if _route(h2) == "cpu":
        return ce_forward_sampled_plain(h2, w, normp, seed, vocab=vocab,
                                        transpose_w=transpose_w,
                                        softcap=softcap, norm=norm, eps=eps,
                                        row_ids=row_ids)
    return _forward_kernel(h2, w, normp, None, seed, vocab=vocab,
                           transpose_w=transpose_w, softcap=softcap,
                           norm=norm, eps=eps, row_ids=row_ids)


def ce_backward_dh(h2, w, normp, labels, rs, lse, *, vocab,
                   transpose_w=False, softcap=None, norm=None, eps=1e-6):
    """d(normed hidden) (N, D): fp32 with a norm, else h's dtype."""
    kw = dict(vocab=vocab, transpose_w=transpose_w, softcap=softcap,
              norm=norm, eps=eps)
    if _route(h2) == "cpu":
        return ce_backward_dh_plain(h2, w, normp, labels, rs, lse, **kw)
    return _backward_kernel("dh", h2, w, normp, labels, rs, lse, **kw)


def ce_backward_dw(h2, w, normp, labels, rs, lse, *, vocab,
                   transpose_w=False, softcap=None, norm=None, eps=1e-6):
    """dW in W's shape and dtype."""
    kw = dict(vocab=vocab, transpose_w=transpose_w, softcap=softcap,
              norm=norm, eps=eps)
    if _route(h2) == "cpu":
        return ce_backward_dw_plain(h2, w, normp, labels, rs, lse, **kw)
    return _backward_kernel("dw", h2, w, normp, labels, rs, lse, **kw)


def ce_backward(h2, w, normp, labels, rs, lse, *, vocab, transpose_w=False,
                softcap=None, norm=None, eps=1e-6):
    """(d normed hidden, dW): one plain sweep on the CPU; on the GPU one
    launch of the dh and dW kernels together (the reference's fused
    schedule: with bf16 h one prep and one logits recompute a vocabulary
    chunk for both products, each gradient bit for bit the one
    :func:`ce_backward_dh` or :func:`ce_backward_dw` returns).  It adds
    one to the counts of both ``ce_backward_dh`` and ``ce_backward_dw``,
    since both products run."""
    kw = dict(vocab=vocab, transpose_w=transpose_w, softcap=softcap,
              norm=norm, eps=eps)
    if _route(h2) == "cpu":
        return ce_backward_plain(h2, w, normp, labels, rs, lse, **kw)
    return _backward_kernel("both", h2, w, normp, labels, rs, lse, **kw)


# ---------------------------------------------------------------------------
# autograd


def _norm_pullback(h2, normp, norm, eps, dhn):
    """Pull d(normed hidden) back through the norm with autograd of the
    plain :func:`apply_norm` (the same fp32 statistics and cast as the
    kernels)."""
    if norm is None:
        return dhn.to(h2.dtype), None
    with torch.enable_grad():
        x = h2.detach().requires_grad_(True)
        p = normp.detach().requires_grad_(True)
        out = apply_norm(x, p, norm, eps).to(_f32)
        dh, dnormp = torch.autograd.grad(out, (x, p), dhn)
    return dh, dnormp


class _FusedNLL(torch.autograd.Function):
    """sum(rowscale * (lse - label logit)): differentiable in h2, w, normp
    and rowscale (whose cotangent is ``(lse - ll) * g``)."""

    @staticmethod
    def forward(ctx, h2, w, normp, rowscale, labels, opts):
        lse, ll = ce_forward(h2, w, normp, labels, **opts)
        ctx.save_for_backward(h2, w, normp, labels, rowscale, lse, ll)
        ctx.opts = opts
        return torch.sum(rowscale * (lse - ll))

    @staticmethod
    def backward(ctx, g):
        h2, w, normp, labels, rowscale, lse, ll = ctx.saved_tensors
        return _backward(ctx.opts, h2, w, normp, labels, rowscale, lse, ll,
                         g) + (None, None)


class _FusedSampledNLL(torch.autograd.Function):
    """The same loss against ŷ drawn inside the forward sweep."""

    @staticmethod
    def forward(ctx, h2, w, normp, rowscale, seed, row_ids, opts):
        lse, ll, yhat = ce_forward_sampled(h2, w, normp, seed,
                                           row_ids=row_ids, **opts)
        ctx.save_for_backward(h2, w, normp, yhat, rowscale, lse, ll)
        ctx.opts = opts
        return torch.sum(rowscale * (lse - ll))

    @staticmethod
    def backward(ctx, g):
        h2, w, normp, yhat, rowscale, lse, ll = ctx.saved_tensors
        return _backward(ctx.opts, h2, w, normp, yhat, rowscale, lse, ll,
                         g) + (None, None, None)


def _backward(opts, h2, w, normp, labels, rowscale, lse, ll, g):
    rs = (rowscale * g).to(_f32)
    dhn, dw = ce_backward(h2, w, normp, labels, rs, lse, **opts)
    dh, dnormp = _norm_pullback(h2, normp, opts["norm"], opts["eps"], dhn)
    return dh, dw, dnormp, (lse - ll) * g


class _FusedNLLTwin(torch.autograd.Function):
    """sum(rowscale * (lse - label logit)) without a norm: the forward is
    the CE forward kernel (row 11); the backward is
    :func:`_nll_backward_chunked` and the tangent
    :func:`_nll_tangent_chunked`, both plain PyTorch, so that
    ``torch.func.jvp`` of ``torch.func.grad`` (the HVP of the Hutchinson
    estimator, forward-over-reverse as the reference takes it) reaches no
    backward kernel.  The backward differentiates in forward mode only (a
    second reverse pass finds no graph).  The row scale (the mask) takes
    no derivative."""

    @staticmethod
    def forward(h2, w, rowscale, labels, opts):
        normp = torch.zeros((2, h2.shape[1]), dtype=_f32, device=h2.device)
        lse, ll = ce_forward(h2, w, normp, labels, **opts)
        return torch.sum(rowscale * (lse - ll))

    @staticmethod
    def setup_context(ctx, inputs, output):
        h2, w, rowscale, labels, opts = inputs
        ctx.save_for_backward(h2, w, rowscale, labels)
        ctx.save_for_forward(h2, w, rowscale, labels)
        ctx.opts = opts

    @staticmethod
    def backward(ctx, g):
        h2, w, rowscale, labels = ctx.saved_tensors
        # torch.func.grad differentiates with create_graph, which would
        # keep every chunk of this sweep for a second reverse pass that the
        # HVP never takes; forward mode (its jvp) passes through no_grad
        with torch.no_grad():
            dh, dw = _nll_backward_chunked(h2, w, rowscale, labels, g,
                                           **ctx.opts)
        return dh, dw, None, None, None

    @staticmethod
    def jvp(ctx, dh2, dw, *_):
        h2, w, rowscale, labels = ctx.saved_tensors
        return _nll_tangent_chunked(h2, w, rowscale, labels, dh2, dw,
                                    **ctx.opts)


class _ChunkedNLL(_FusedNLLTwin):
    """The reference's "chunked" loss route: :class:`_FusedNLLTwin` with
    the forward computed by the plain vocab sweep (:func:`ce_forward_plain`,
    2048-column chunks, no kernel) on every device.  The backward and the
    tangent recompute each chunk in plain PyTorch, so the route composes
    with ``torch.func`` (the Hutchinson HVP of ``fused_loss=False``)."""

    @staticmethod
    def forward(h2, w, rowscale, labels, opts):
        normp = torch.zeros((2, h2.shape[1]), dtype=_f32, device=h2.device)
        lse, ll = ce_forward_plain(h2, w, normp, labels, **opts)
        return torch.sum(rowscale * (lse - ll))


def _nll_backward_chunked(h2, w, rowscale, labels, g, *, vocab, transpose_w,
                          softcap, norm, eps, chunk=CHUNK):
    """(dh, dW) of sum(rowscale * (lse - label logit)) in plain PyTorch
    over vocab chunks, the reference's ``_fused_nll_jvp_rule`` sweeps
    transposed: sweep A recomputes each chunk's logits (W cast to h's
    dtype, fp32 products, softcap, padded columns at the sentinel) and the
    log-sum-exp; sweep B forms ``d = (softmax - onehot) * rowscale * g``
    per chunk and sums dh = d . W and dW = d^T . h.  Every operation is
    differentiable, so the result is too (lse included: its derivative
    reaches the second order).  The row scale (the mask) takes no
    gradient."""
    if norm is not None:
        raise ValueError("the NLL twin takes normed hidden states (apply "
                         "the norm first)")
    N, D = h2.shape
    Vp = _vp_of(w, transpose_w)
    bv = vocab_chunk(Vp, chunk, 128)
    h32 = h2.to(_f32)
    lab = labels.to(torch.int64)[:, None]
    chunks, lse_parts = [], []
    for c0 in range(0, Vp, bv):
        s, _, cols, dcap = _chunk_logits(h32, w, h2.dtype, c0, bv,
                                         transpose_w, softcap, vocab)
        chunks.append((c0, s, cols, dcap))
        lse_parts.append(torch.logsumexp(s, dim=-1))
    lse = torch.logsumexp(torch.stack(lse_parts), dim=0)
    rsg = (rowscale * g).to(_f32)
    dh = torch.zeros((N, D), dtype=_f32, device=h2.device)
    dws = []
    for c0, s, cols, dcap in chunks:
        d = (torch.exp(s - lse[:, None])
             - (cols[None, :] == lab).to(_f32)) * rsg[:, None]
        if dcap is not None:
            d = d * dcap
        if transpose_w:
            wc = w[:, c0:c0 + bv].to(h2.dtype).to(_f32)
            dh = dh + d @ wc.T
            dws.append(h32.T @ d)
        else:
            wc = w[c0:c0 + bv].to(h2.dtype).to(_f32)
            dh = dh + d @ wc
            dws.append(d.T @ h32)
    dw = torch.cat(dws, dim=1 if transpose_w else 0).to(w.dtype)
    return dh.to(h2.dtype), dw


def _nll_tangent_chunked(h2, w, rowscale, labels, dh2, dw, *, vocab,
                         transpose_w, softcap, norm, eps, chunk=CHUNK):
    """The tangent of sum(rowscale * (lse - label logit)) in plain PyTorch
    over vocab chunks, the reference's ``_fused_nll_jvp_rule``: sweep A
    recomputes the log-sum-exp; sweep B sums ``dlse - d(label logit)`` per
    row with ``dz = dcap * (dh . Wc^T + h . dWc^T)``, W and its tangent
    cast to h's dtype as the logits cast W.  A missing tangent is zero."""
    if norm is not None:
        raise ValueError("the NLL twin takes normed hidden states (apply "
                         "the norm first)")
    Vp = _vp_of(w, transpose_w)
    bv = vocab_chunk(Vp, chunk, 128)
    h32 = h2.to(_f32)
    dh32 = None if dh2 is None else dh2.to(h2.dtype).to(_f32)
    lab = labels.to(torch.int64)[:, None]
    lse = torch.logsumexp(torch.stack([
        torch.logsumexp(_chunk_logits(h32, w, h2.dtype, c0, bv, transpose_w,
                                      softcap, vocab)[0], dim=-1)
        for c0 in range(0, Vp, bv)]), dim=0)
    t = torch.zeros_like(lse)
    for c0 in range(0, Vp, bv):
        s, _, cols, dcap = _chunk_logits(h32, w, h2.dtype, c0, bv,
                                         transpose_w, softcap, vocab)
        dz = torch.zeros_like(s)
        if dh32 is not None:
            wc = (w[:, c0:c0 + bv] if transpose_w else w[c0:c0 + bv].T)
            dz = dz + dh32 @ wc.to(h2.dtype).to(_f32)
        if dw is not None:
            dwc = (dw[:, c0:c0 + bv] if transpose_w else dw[c0:c0 + bv].T)
            dz = dz + h32 @ dwc.to(h2.dtype).to(_f32)
        if dcap is not None:
            dz = dz * dcap
        t = t + (torch.exp(s - lse[:, None]) * dz).sum(-1) \
            - torch.where(cols[None, :] == lab, dz, 0.0).sum(-1)
    return torch.sum(rowscale * t)


def _pack_norm(norm_kind, norm_scale, norm_bias, D, device):
    """(norm, (2, D) fp32 [scale; bias]); zeros without a norm."""
    if norm_kind is None:
        return None, torch.zeros((2, D), dtype=_f32, device=device)
    if norm_kind not in ("ln", "rms"):
        raise ValueError(f"norm_kind {norm_kind!r} is not ln or rms")
    scale = norm_scale.to(_f32)
    bias = (torch.zeros((D,), dtype=_f32, device=device) if norm_bias is None
            else norm_bias.to(_f32))
    return norm_kind, torch.stack([scale, bias])


def _prep(hidden, w, mask, *, vocab_size, transpose_w, softcap, norm_kind,
          norm_scale, norm_bias, norm_eps):
    D = hidden.shape[-1]
    h2 = hidden.reshape(-1, D).contiguous()
    rs, n_valid = rowscale(h2.shape[0], mask, device=hidden.device)
    norm, normp = _pack_norm(norm_kind, norm_scale, norm_bias, D,
                             hidden.device)
    opts = dict(vocab=int(vocab_size), transpose_w=bool(transpose_w),
                softcap=float(softcap) if softcap else None, norm=norm,
                eps=float(norm_eps))
    return h2, rs, n_valid, normp, opts


def fused_lm_loss(hidden, w, labels, mask=None, *, vocab_size,
                  transpose_w=False, softcap=None, norm_kind=None,
                  norm_scale=None, norm_bias=None, norm_eps=1e-6):
    """Masked-mean LM cross-entropy without materializing logits.

    hidden (..., D); w (Vp, D) tied or (D, Vp) untied (``transpose_w``);
    labels (...) int; mask (...) optional.  Returns ``(loss, n_valid)``.
    Differentiable in ``hidden``, ``w`` and the norm parameters.  With
    ``norm_kind`` ("ln"/"rms") ``hidden`` is PRE-final-norm and the norm is
    applied inside the sweep."""
    h2, rs, n_valid, normp, opts = _prep(
        hidden, w, mask, vocab_size=vocab_size, transpose_w=transpose_w,
        softcap=softcap, norm_kind=norm_kind, norm_scale=norm_scale,
        norm_bias=norm_bias, norm_eps=norm_eps)
    lab = labels.reshape(-1).to(torch.int32)
    return _FusedNLL.apply(h2, w, normp, rs, lab, opts), n_valid


def fused_lm_loss_sampled(hidden, w, seed, mask=None, *, vocab_size,
                          transpose_w=False, softcap=None, norm_kind=None,
                          norm_scale=None, norm_bias=None, norm_eps=1e-6,
                          row_ids=None):
    """GNB's sampled-label CE in one sweep: draws ŷ ~ softmax(logits) with
    the hash noise of ``seed`` (two uint32 values) inside the forward and
    returns the masked-mean NLL against it as ``(loss, n_valid)``; its
    gradient is Algorithm 2's ĝ through this stage.  ``row_ids`` (one a
    position of ``hidden``, flattened) keys the noise on each position's
    row in a larger batch, so that a data-parallel rank draws the single
    process's labels for its rows."""
    h2, rs, n_valid, normp, opts = _prep(
        hidden, w, mask, vocab_size=vocab_size, transpose_w=transpose_w,
        softcap=softcap, norm_kind=norm_kind, norm_scale=norm_scale,
        norm_bias=norm_bias, norm_eps=norm_eps)
    seed = tuple(int(v) & _M32 for v in seed)
    if row_ids is not None:
        row_ids = row_ids.reshape(-1)
    return (_FusedSampledNLL.apply(h2, w, normp, rs, seed, row_ids, opts),
            n_valid)


def fused_lm_loss_jvp(hidden, w, labels, mask=None, *, vocab_size,
                      transpose_w=False, softcap=None):
    """The labeled NLL through the twin of the Hutchinson path: the value
    from the CE forward kernel, derivatives of any order from plain
    PyTorch (:class:`_FusedNLLTwin`).  No norm is fused: ``hidden`` is
    already normed (the caller applies the final norm in PyTorch, where
    autograd carries the tangent through it).  Returns ``(loss,
    n_valid)``."""
    h2, rs, n_valid, _, opts = _prep(
        hidden, w, mask, vocab_size=vocab_size, transpose_w=transpose_w,
        softcap=softcap, norm_kind=None, norm_scale=None, norm_bias=None,
        norm_eps=0.0)
    lab = labels.reshape(-1).to(torch.int32)
    return _FusedNLLTwin.apply(h2, w, rs, lab, opts), n_valid


def chunked_lm_loss(hidden, w, labels, mask=None, *, vocab_size,
                    transpose_w=False, softcap=None):
    """The labeled NLL through the plain vocab sweep (:class:`_ChunkedNLL`):
    no kernel on any device, derivatives of any order from plain PyTorch.
    ``hidden`` is already normed.  Returns ``(loss, n_valid)``."""
    h2, rs, n_valid, _, opts = _prep(
        hidden, w, mask, vocab_size=vocab_size, transpose_w=transpose_w,
        softcap=softcap, norm_kind=None, norm_scale=None, norm_bias=None,
        norm_eps=0.0)
    lab = labels.reshape(-1).to(torch.int32)
    return _ChunkedNLL.apply(h2, w, rs, lab, opts), n_valid


def chunked_lm_loss_sampled(hidden, w, draw, mask=None, *, vocab_size,
                            transpose_w=False, softcap=None):
    """GNB's sampled-label NLL through the plain vocab sweep: ŷ drawn by
    online chunked Gumbel-argmax from ``draw(c0, width)`` (the noise of
    each 2048-column chunk, :func:`ce_forward_sampled_plain`), then the
    NLL against ŷ through :func:`chunked_lm_loss`.  Returns ``(loss,
    n_valid)``."""
    h2 = hidden.reshape(-1, hidden.shape[-1])
    with torch.no_grad():
        normp = torch.zeros((2, h2.shape[1]), dtype=_f32, device=h2.device)
        _, _, yhat = ce_forward_sampled_plain(
            h2.detach(), w.detach(), normp, draw, vocab=int(vocab_size),
            transpose_w=bool(transpose_w),
            softcap=float(softcap) if softcap else None)
    return chunked_lm_loss(hidden, w, yhat.reshape(hidden.shape[:-1]), mask,
                           vocab_size=vocab_size, transpose_w=transpose_w,
                           softcap=softcap)


# ---------------------------------------------------------------------------
# work of one call (bound and yardstick in chip_smoke.py)


def ce_flops(N: int, D: int, Vp: int, which: str) -> int:
    """Multiply-add flops of one call: the forward's logits product; for
    each backward kernel alone the recomputed logits plus its own product;
    for ``ce_backward`` (both) the logits and the two products."""
    products = {"ce_backward_dh": 2, "ce_backward_dw": 2, "ce_backward": 3}
    return 2 * N * D * Vp * products.get(which, 1)


def ce_passes(which: str, *, w_bf16: bool) -> int:
    """The bf16 products of 2 N D Vp flops the tensor-core route (bf16 h)
    runs for one call: the logits once (the forwards, and once per
    backward call), d . W in three hi/lo passes (two with a bf16 W), d^T .
    h_n in two."""
    dh, dw = (2 if w_bf16 else 3), 2
    return {"ce_backward_dh": 1 + dh, "ce_backward_dw": 1 + dw,
            "ce_backward": 1 + dh + dw}.get(which, 1)


def ce_bytes(N: int, D: int, Vp: int, which: str, *, bytes_h: int,
             bytes_w: int, norm: bool = True) -> int:
    """Bytes one call must move: each input read once (h, W, the norm
    pair, the (N,) vectors it reads) and each output written once."""
    vec = 4 * N
    inputs = N * D * bytes_h + Vp * D * bytes_w + (8 * D if norm else 0)
    if which == "ce_forward":
        return inputs + vec + 2 * vec                  # labels; lse, ll
    if which == "ce_forward_sampled":
        return inputs + 3 * vec                        # lse, ll, yhat
    reads = inputs + 3 * vec                           # labels, rs, lse
    dh = N * D * (4 if norm else bytes_h)
    dw = Vp * D * bytes_w
    if which == "ce_backward_dh":
        return reads + dh
    if which == "ce_backward_dw":
        return reads + dw
    return reads + dh + dw                             # ce_backward: both


# ---------------------------------------------------------------------------
# device-memory traffic of the whole loss (launch/roofline.py's overlay; the
# reference's formulas, integer for integer)


def lm_loss_hbm_bytes_fused(N, D, V, *, bytes_h=2, bytes_w=4,
                            norm_fused=False) -> int:
    """The logits-free loss: h and W stream once a sweep (one forward, two
    backward), the outputs are dh, dW and four (N,) vectors; no term
    scales with N V.  ``norm_fused`` drops a standalone final norm's (N,
    D) write and read."""
    h = N * D * bytes_h
    wb = V * D * bytes_w
    vecs = 4 * N * 4
    total = 3 * (h + wb) + h + wb + vecs
    if not norm_fused:
        total += 2 * h
    return total


def lm_loss_hbm_bytes_unfused(N, D, V, *, bytes_h=2, bytes_w=4,
                              passes=5) -> int:
    """The materialized loss: the fp32 (N, V) logits cross device memory
    ``passes`` times (projection write, log-softmax read and write, the
    label gather, the backward's softmax read) beside the projection's
    operands."""
    return N * V * 4 * passes + 2 * (N * D * bytes_h + V * D * bytes_w)
