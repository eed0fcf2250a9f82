"""Bucketed compressed data-parallel reduction: the counterpart of
``repro/distributed/overlap.py`` on ``torch.distributed``.

A flat gradient shard is cut into static, block-aligned buckets, and each
bucket runs its own collectives:

    shard = [bucket 0 | bucket 1 | ... | bucket B-1]
    each bucket:  reduce-scatter (fp32) -> [hook] -> + error view
                  -> int8 quantize -> all-gather (int8 + scales)
                  -> dequantize

Every collective is issued with ``async_op=True``: all buckets' reduce-
scatters go out first, then, once they are waited on and the hook has run
(the trainer's global-norm clip needs every rank's reduced segment before
any bucket is quantized, the reference's order), each bucket is quantized
and its all-gathers issued while the next bucket quantizes; each bucket
waits for its all-gathers just before its dequantize.  Overlapping the
buckets with the backward pass, which needs gradient hooks that fill the
flat buckets, is not done here.

Bucket geometry over W ranks is device-major, as in the reference: rank r
owns the contiguous segment ``[r*seg, (r+1)*seg)`` of the shard (``seg =
n/W``), and bucket j is the column slice ``g.view(W, seg)[:, s0:s1]``
(``s0 = start/W``), so rank r quantizes global elements ``r*seg + s0 +
[0, s1 - s0)`` and its error feedback for the bucket is ``e[s0:s1]`` of
its own segment.  Both the per-256-block scales and the stochastic-
rounding noise are functions of the global element index, and bucket
boundaries are multiples of ``block * W``, so any bucketing dequantizes
bit-identically to the monolithic call, on any number of ranks.

The reference's two fallbacks stay: with W <= 1 each bucket is quantized
locally, with no collective; where ``block * W`` does not divide the shard,
the shard is one bucket, all-reduced in fp32 and quantized whole, the same
on every rank (its error feedback then spans the whole shard on every
rank).

Telemetry (``telemetry=True``) stamps each bucket before its first issue
and after its dequantize: CUDA events on the card, ``time.perf_counter`` on
the CPU.  ``comm_seconds`` is the span from the earliest stamp to the
latest.  ``TIMELINE`` records ``(tag, seconds)`` pairs, tags ``shard *
10000 + bucket * 2 + phase`` (0 before, 1 after), as the reference's.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.engine import bucket_slices
from ..quant import _GOLDEN, _M32, _as_seed

__all__ = ["allreduce_shards_bucketed", "plan_buckets", "stamp",
           "delta_seconds", "timeline_enable", "timeline_snapshot",
           "decode_timeline", "world", "comm_device"]


def world(group=None) -> Tuple[int, int]:
    """(world size, rank) of ``group`` (the default process group when
    None), or (1, 0) when no process group is initialized."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def comm_device(group=None) -> torch.device:
    """Where a collective's own tensors live: the current card under NCCL,
    else the CPU."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def segmented(n: int, ndev: int, block: int) -> bool:
    """Whether a shard of ``n`` elements splits into block-aligned
    segments over ``ndev`` ranks (else the fp32 all-reduce fallback)."""
    return ndev > 1 and n % (ndev * block) == 0


# ---------------------------------------------------------------------------
# bucket planning

def plan_buckets(shard_sizes: Sequence[int], ndev: int, *, block: int = 256,
                 bucket_elems: Optional[int] = None
                 ) -> Tuple[Tuple[Tuple[int, int], ...], ...]:
    """Static bucket plan: per shard, a tuple of ``(start, stop)`` slices.

    ``bucket_elems``: None picks the roofline size
    (``launch.roofline.choose_bucket_elems``) when the reduction spans
    ranks and one bucket when ``ndev <= 1``; 0 forces one bucket; N > 0 is
    rounded up to ``block * ndev``."""
    align = block * max(1, ndev)
    plans = []
    for n in shard_sizes:
        n = int(n)
        if bucket_elems is None:
            if ndev <= 1:
                b = 0
            else:
                from ..launch.roofline import choose_bucket_elems
                b = choose_bucket_elems(n, ndev, block=block)
        else:
            b = int(bucket_elems)
        plans.append(bucket_slices(n, b, align=align))
    return tuple(plans)


# ---------------------------------------------------------------------------
# telemetry

#: process-local (tag, stamp) pairs, appended while recording is on;
#: :func:`timeline_snapshot` turns the stamps into seconds
TIMELINE: List[Tuple[int, Any]] = []
_TIMELINE_ON = False
_CUDA_BASE: List[Any] = []   # [(event, perf_counter)] to place CUDA events

_TAG_SHARD = 10000  # tag = shard * 10000 + bucket * 2 + phase(0=pre, 1=post)


def timeline_enable(on: bool = True) -> None:
    """Toggle TIMELINE recording (clears any prior records)."""
    global _TIMELINE_ON
    _TIMELINE_ON = bool(on)
    TIMELINE.clear()
    _CUDA_BASE.clear()


def stamp(device, tag: Optional[int] = None):
    """A timestamp in ``device``'s order: a recorded CUDA event on the
    card (it completes when the work queued before it has), else
    ``time.perf_counter()``.  With recording on, ``tag`` goes into
    TIMELINE."""
    if torch.device(device).type == "cuda":
        if _TIMELINE_ON and not _CUDA_BASE:
            base = torch.cuda.Event(enable_timing=True)
            base.record()
            _CUDA_BASE.append((base, time.perf_counter()))
        t = torch.cuda.Event(enable_timing=True)
        t.record()
    else:
        t = time.perf_counter()
    if _TIMELINE_ON and tag is not None:
        TIMELINE.append((int(tag), t))
    return t


def delta_seconds(t0, t1) -> float:
    """Seconds from stamp ``t0`` to stamp ``t1`` (waits for a CUDA
    event)."""
    if isinstance(t0, float):
        return t1 - t0
    t1.synchronize()
    return t0.elapsed_time(t1) / 1e3


def _seconds(t) -> float:
    if isinstance(t, float):
        return t
    base, host = _CUDA_BASE[0]
    return host + delta_seconds(base, t)


def timeline_snapshot() -> List[Tuple[int, float]]:
    return [(tag, _seconds(t)) for tag, t in TIMELINE]


def decode_timeline(records=None) -> List[Dict[str, Any]]:
    """TIMELINE records as dicts, times relative to the first record."""
    records = timeline_snapshot() if records is None else list(records)
    if not records:
        return []
    t0 = min(t for _, t in records)
    out = []
    for tag, t in records:
        shard, rest = divmod(int(tag), _TAG_SHARD)
        bucket, phase = divmod(rest, 2)
        out.append({"shard": shard, "bucket": bucket,
                    "phase": "post" if phase else "pre",
                    "t_rel_s": t - t0})
    out.sort(key=lambda r: r["t_rel_s"])
    return out


# ---------------------------------------------------------------------------
# the bucketed pipeline


def shard_seed(seed, i: int):
    """Shard ``i``'s seed: ``seed ^ (_GOLDEN * (i + 1))`` mod 2^32 (None
    stays None: round-to-nearest)."""
    return None if seed is None else seed ^ ((_GOLDEN * (i + 1)) & _M32)


def allreduce_shards_bucketed(compressor, g_shards, state, seed, *,
                              group=None, bucket_elems: Optional[int] = None,
                              telemetry: bool = False, before_quantize=None):
    """Per-bucket compressed reduction over flat gradient shards: the
    entry point behind ``GradCompressor.allreduce_shards`` (its docstring
    has the contract).  Returns ``(deq shards, state)``, and with
    ``telemetry`` a third element ``{"comm_seconds", "comm_t0"}``."""
    ndev, rank = world(group)
    block = compressor.block
    plans = plan_buckets([g.numel() for g in g_shards], ndev, block=block,
                         bucket_elems=bucket_elems)
    seed = _as_seed(seed)
    device = g_shards[0].device if g_shards else torch.device("cpu")

    buckets, outs, pre, post = [], [], [], []
    for i, (g, e, plan) in enumerate(zip(g_shards, state.error, plans)):
        out = torch.empty(g.shape, dtype=torch.float32, device=g.device)
        outs.append(out)
        for j, (start, stop) in enumerate(plan):
            if telemetry:
                pre.append(stamp(device, _TAG_SHARD * i + 2 * j))
            b = compressor._bucket(g, e, start, stop, shard_seed(seed, i),
                                   ndev, rank, group)
            b.tag = _TAG_SHARD * i + 2 * j + 1
            b.shard = i
            buckets.append(b)
    for b in buckets:
        b.wait()
    if before_quantize is not None:
        before_quantize([(b.red, b.segmented, b.shard, b.offset)
                         for b in buckets])
    for b in buckets:
        compressor._quantize_gather(b, group)
    k = 0
    for out, plan in zip(outs, plans):
        for _ in plan:
            b = buckets[k]
            compressor._dequantize(b, out)
            if telemetry:
                post.append(stamp(device, b.tag))
            k += 1

    from .compression import FlatCompressionState
    new_state = FlatCompressionState(error=tuple(state.error))
    if not telemetry:
        return tuple(outs), new_state
    if pre:
        ref = pre[0]
        lo = min(delta_seconds(ref, t) for t in pre)
        hi = max(delta_seconds(ref, t) for t in post)
        tele = {"comm_seconds": hi - lo, "comm_t0": ref}
    else:
        tele = {"comm_seconds": 0.0, "comm_t0": stamp(device)}
    return tuple(outs), new_state, tele
