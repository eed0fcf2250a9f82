"""Decode attention: one query token per slot against its ring KV cache.

The counterpart of ``repro/kernels/decode_attention.py``
(``decode_attention_pallas``).  On a CUDA tensor :func:`decode_attention`
launches the hand-written Hopper kernel in ``csrc/decode_attention.cu``; on
a CPU tensor it computes :func:`decode_attention_plain`, the counterpart of
the reference oracle ``kernels/ref.py:decode_attention_ref``.  There is no
other route: a CUDA tensor the kernel does not take raises.

Layout (as ``models/transformer.init_slots`` allocates it):
    q          (N, H, hd)       one query token per slot
    k_cache/v  (N, C, Hkv, hd)  slot-major ring cache
    positions  (N,) int32       per-slot query position

Ring index ``s`` holds absolute position ``pos - ((pos - s) mod C)``
(floor-mod); an entry is valid when that is >= 0, and inside the window
when one is set.  An int8 cache passes ``k_scale``/``v_scale`` (N, C) fp32
per-token scales and dequantizes as fp32(q8) * scale, rounded once into q's
dtype.  The serve path pre-scales q (``models/layers.decode_attention_slots``)
and calls with ``scale=1.0``, as the reference's Pallas route does.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from ..quant import dequantize_kv
from . import KERNEL_LAUNCHES, _build

NEG_INF = -1e30           # masked-score sentinel of the reference
GLOBAL_WINDOW = 1 << 30   # window value that masks nothing
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 8             # query heads per KV head the kernel takes
MAX_SPLITS = 8            # blocks per ring walk: the portable cluster size
BLOCKS_PER_SM = 1         # the split's target: this many blocks an SM
MIN_SPLIT_ROWS = 16       # ring rows a split takes at least


def ring_mask(positions: torch.Tensor, C: int,
              window: Optional[int] = None) -> torch.Tensor:
    """(N, C) bool validity of each slot's ring entries at ``positions``
    (``torch.remainder`` is floor-mod, as ``jnp.mod``)."""
    pos = positions.to(torch.int32)[:, None]
    idx = torch.arange(C, dtype=torch.int32, device=positions.device)[None, :]
    abs_pos = pos - torch.remainder(pos - idx, C)
    valid = abs_pos >= 0
    if window is not None:
        valid = valid & (abs_pos > pos - window)
    return valid


def decode_attention_plain(q, k_cache, v_cache, positions, *, scale=None,
                           window=None, softcap=None, k_scale=None,
                           v_scale=None):
    """Masked-softmax decode attention in plain PyTorch (fp32 scores and
    softmax, output in q's dtype): the CPU route and the yardstick the
    kernel is held against."""
    N, H, hd = q.shape
    C, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if k_scale is not None:
        k_cache = dequantize_kv(k_cache, k_scale, q.dtype)
        v_cache = dequantize_kv(v_cache, v_scale, q.dtype)
    qg = q.to(torch.float32).reshape(N, Hkv, G, hd)
    s = torch.einsum("nkgd,nckd->nkgc", qg, k_cache.to(torch.float32)) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    valid = ring_mask(positions, C, window)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("nkgc,nckd->nkgd", w, v_cache.to(torch.float32))
    return o.reshape(N, H, hd).to(q.dtype)


def check_kernel_args(q, k_cache, v_cache, positions, k_scale=None,
                      v_scale=None) -> None:
    """Raise ``ValueError`` for anything the CUDA kernel does not take."""
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} must be "
                         f"(N, H, hd) and k/v {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} one (N, C, Hkv, hd) shape")
    N, H, hd = q.shape
    Nk, C, Hkv, hdk = k_cache.shape
    if Nk != N or hdk != hd or H % Hkv:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not "
                         f"match the cache {tuple(k_cache.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {hd} not in {HEAD_DIMS}")
    if H // Hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: {H // Hkv} query heads per KV "
                         f"head exceeds {MAX_GROUP}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"decode_attention: q dtype {q.dtype} is not "
                         "bfloat16 or float32")
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("decode_attention: pass both k_scale and v_scale")
    want = torch.int8 if quant else q.dtype
    if k_cache.dtype != want or v_cache.dtype != want:
        raise ValueError(f"decode_attention: cache dtype {k_cache.dtype} "
                         f"with q {q.dtype} needs {want}")
    tensors = [q, k_cache, v_cache, positions]
    if quant:
        for sc in (k_scale, v_scale):
            if sc.shape != (N, C) or sc.dtype != torch.float32:
                raise ValueError("decode_attention: scales must be (N, C) "
                                 "float32")
        tensors += [k_scale, v_scale]
    if positions.shape != (N,):
        raise ValueError(f"decode_attention: positions {tuple(positions.shape)}"
                         f" must be ({N},)")
    for t in tensors:
        if t.device != q.device:
            raise ValueError("decode_attention: tensors on different devices")
        if not t.is_contiguous():
            raise ValueError("decode_attention: tensors must be contiguous")
    for t in (q, k_cache, v_cache):
        if t.data_ptr() % 16:
            raise ValueError("decode_attention: q/k/v must be 16-byte aligned")


def split_count(N: int, Hkv: int, C: int, sms: int = 132) -> int:
    """Blocks S that split one (slot, KV head) ring walk, from static shapes
    only: the smallest power of two up to ``MAX_SPLITS`` with ``N * Hkv *
    S`` at least ``BLOCKS_PER_SM`` blocks on each of the card's ``sms``
    SMs, and no split shorter than ``MIN_SPLIT_ROWS`` ring rows.  Where
    ``N * Hkv`` alone fills the card it is 1 (``csrc/decode_attention.cu``'s
    header note gives the reason)."""
    s = 1
    while (s < MAX_SPLITS and N * Hkv * s < BLOCKS_PER_SM * sms
           and C // (2 * s) >= MIN_SPLIT_ROWS):
        s *= 2
    return s


@functools.cache
def _splits_on(index: int, N: int, Hkv: int, C: int) -> int:
    """:func:`split_count` on card ``index``, once per shape."""
    return split_count(N, Hkv, C, torch.cuda.get_device_properties(
        index).multi_processor_count)


_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


@functools.cache
def _launch_fn():
    fn = _build.load("decode_attention").decode_attention_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def max_active_clusters(N, H, Hkv, C, hd, q_dtype, quant, splits) -> int:
    """``cudaOccupancyMaxActiveClusters`` of a launch of the kernel at these
    shapes with ``splits`` blocks per (slot, KV head)."""
    fn = _build.load("decode_attention").decode_attention_max_active_clusters
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    n = ctypes.c_int(0)
    err = fn(N, H, Hkv, C, hd, int(q_dtype == torch.bfloat16), int(quant),
             splits, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: "
                           f"cudaError {err}")
    return n.value


def decode_attention(q, k_cache, v_cache, positions, *, scale=None,
                     window=None, softcap=None, k_scale=None, v_scale=None):
    """q (N, H, hd); k/v (N, C, Hkv, hd); positions (N,) -> (N, H, hd).

    A CPU tensor takes :func:`decode_attention_plain`; a CUDA tensor
    launches the kernel on the current stream, one cluster launch of
    :func:`split_count` blocks per (slot, KV head), and adds one to
    ``KERNEL_LAUNCHES["decode_attention"]`` (``"decode_attention_q8"`` for
    an int8 cache), or raises.  Nothing is read back from the device."""
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k_cache, v_cache, positions, scale=scale, window=window,
            softcap=softcap, k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no route for device {q.device}")
    positions = positions.to(torch.int32)
    check_kernel_args(q, k_cache, v_cache, positions, k_scale, v_scale)
    N, H, hd = q.shape
    C, Hkv = k_cache.shape[1], k_cache.shape[2]
    quant = k_scale is not None
    splits = _splits_on(q.device.index, N, Hkv, C)
    out = torch.empty_like(q)
    err = _launch_fn()(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        positions.data_ptr(), out.data_ptr(),
        N, H, Hkv, C, hd, int(q.dtype == torch.bfloat16), int(quant), splits,
        float(scale if scale is not None else 1.0 / math.sqrt(hd)),
        int(GLOBAL_WINDOW if window is None else window),
        float(softcap if softcap is not None else 0.0),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: "
                           f"cudaError {err}")
    KERNEL_LAUNCHES["decode_attention_q8" if quant else "decode_attention"] += 1
    return out


def decode_attention_hbm_bytes(N, H, Hkv, C, hd, bytes_per_el=2,
                               kv_dtype="bf16") -> int:
    """Analytic device-memory floor of one decode-attention call: Q and O in
    the compute dtype, plus the K/V ring read once (int8: 1 byte/element
    plus one fp32 per-token scale per K/V plane)."""
    q_o = 2 * N * H * hd * bytes_per_el
    if kv_dtype == "int8":
        kv = 2 * N * C * (Hkv * hd + 4)
    else:
        kv = 2 * N * C * Hkv * hd * bytes_per_el
    return q_o + kv
