"""Gradient compression inside the data-parallel reduction: the
counterpart of ``repro/distributed/compression.py`` on
``torch.distributed``.

int8 block-quantized gradients with per-block fp32 scales and error
feedback (the quantization residual is carried into the next step):
the all-gather that completes the reduction moves 1 + 4/256 bytes an
element instead of 4.  Stochastic rounding keeps the result unbiased in
expectation.

The reduction runs on the engine's flat gradient shards over the W ranks
of a process group.  Each rank holds its local partial gradient over the
whole shard; per bucket (``distributed/overlap.py``):

    local partial shard (fp32)
        |  reduce_scatter_tensor (SUM) of the device-major bucket slice
        v
    this rank's reduced segment + its error-feedback view
        |  _quantize: int8 + per-256-block fp32 scales, noise keyed on
        v  the global element index
    all_gather_into_tensor(int8), all_gather_into_tensor(scales)
        |  dequantize
        v
    the reduced, dequantized shard (the same on every rank)

The error feedback is sharded as in the reference: rank r keeps only its
segment, n/W elements a shard (:class:`FlatCompressionState`); a
checkpoint gathers the segments into the reference's full-length leaf.
Because the noise and the scales are functions of the global index and
segments are block-aligned, the result does not depend on W: two ranks
reducing g0 and g1 dequantize bit for bit what the reference's mesh-less
call gives on g0 + g1.

The legacy params-tree ``roundtrip`` is kept for tests, with one integer
seed a leaf from the caller (the reference splits a JAX key).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.types import leaf_parts, tree_leaves, tree_unflatten
from ..quant import _GOLDEN, _as_seed, _quantize, _uniform_noise
from .overlap import segmented, world

__all__ = ["CompressionState", "FlatCompressionState", "GradCompressor",
           "compressed_bytes", "_GOLDEN", "_as_seed", "_quantize",
           "_uniform_noise"]


class CompressionState(NamedTuple):
    error: Any  # error-feedback residuals, the structure of the grads


class FlatCompressionState(NamedTuple):
    """Error feedback over the engine's flat gradient shards: one fp32
    buffer per shard, this rank's segment of it (n/W elements) where the
    shard splits into block-aligned segments over the W ranks, else the
    whole shard.  It is indexed by global element index (offset by the
    segment's start), the coordinates of the noise hash and the scale
    blocks, so any bucketing reads and writes disjoint views of the same
    buffers, and switching bucket sizes between steps or across a restore
    is always legal."""

    error: Tuple[torch.Tensor, ...]


@dataclasses.dataclass
class _Bucket:
    """One bucket in flight: its geometry, its reduced fp32 values and
    the collectives still to wait on."""
    start: int
    stop: int
    ndev: int
    rank: int
    segmented: bool
    red: torch.Tensor          # reduced fp32: this rank's columns or all
    err: torch.Tensor          # the error-feedback view (updated in place)
    seed: Optional[int]
    offset: int                # global index of red[0]
    works: list
    gathered: Optional[tuple] = None
    deq: Optional[torch.Tensor] = None
    tag: int = 0
    shard: int = 0

    def wait(self):
        for w in self.works:
            w.wait()
        self.works = []


def error_len(n: int, ndev: int, block: int) -> int:
    """Elements of a rank's error-feedback buffer for a shard of ``n``."""
    return n // ndev if segmented(n, ndev, block) else n


# ---------------------------------------------------------------------------
# the compressor


class GradCompressor:
    def __init__(self, block: int = 256):
        self.block = block

    # -- flat-shard path ----------------------------------------------------

    def init_shards(self, layout, *, device=None,
                    group=None) -> FlatCompressionState:
        """Zero error feedback for an engine ShardLayout: this rank's
        segment of each shard."""
        ndev, _ = world(group)
        return FlatCompressionState(error=tuple(
            torch.zeros((error_len(int(n), ndev, self.block),),
                        dtype=torch.float32, device=device)
            for n in layout.shard_sizes))

    def wire_bytes(self, layout) -> Tuple[int, ...]:
        """Per-shard bytes on the wire for the compressed gather phase:
        n int8 payload + 4 bytes per 256-block fp32 scale."""
        return tuple(int(n) + 4 * (-(-int(n) // self.block))
                     for n in layout.shard_sizes)

    def allreduce_shards(self, g_shards, state: FlatCompressionState, seed,
                         *, group=None, bucket_elems: Optional[int] = None,
                         telemetry: bool = False, before_quantize=None):
        """Compressed data-parallel reduction over flat gradient shards.

        ``g_shards`` are this rank's local partial gradients (whole
        shards); ``seed`` an integer (None: round-to-nearest); each shard
        ``i`` draws with ``seed ^ (_GOLDEN * (i + 1))``.  ``bucket_elems``
        None picks the roofline bucket size, 0 the monolithic single
        bucket; any value dequantizes bit-identically to any other.
        ``before_quantize(pieces)``, if given, runs once every bucket is
        reduced and before any is quantized, on ``[(reduced fp32 tensor,
        segmented, shard, offset)]`` (``offset`` the global index of the
        tensor's first element in its shard); it may scale them in place
        (the trainer's clip).
        At W <= 1 those tensors may alias ``g_shards``.

        Returns ``(deq shards, state)``; the state's error buffers are
        updated in place.  With ``telemetry`` a third element
        ``{"comm_seconds", "comm_t0"}``."""
        from .overlap import allreduce_shards_bucketed
        return allreduce_shards_bucketed(
            self, g_shards, state, seed, group=group,
            bucket_elems=bucket_elems, telemetry=telemetry,
            before_quantize=before_quantize)

    def allreduce_shards_stateless(self, g_shards, seed, *, group=None,
                                   bucket_elems: Optional[int] = None
                                   ) -> Tuple[torch.Tensor, ...]:
        """Compressed reduction over flat shards WITHOUT error feedback:
        the Hessian refresh's estimator gradient (at 1/k refresh sparsity
        a carried residual would add noise-level EMA mass for one more
        parameter-sized buffer).  Same wire format and rank-count
        invariance as :meth:`allreduce_shards`."""
        ndev, _ = world(group)
        zero = FlatCompressionState(error=tuple(
            torch.zeros((error_len(g.numel(), ndev, self.block),),
                        dtype=torch.float32, device=g.device)
            for g in g_shards))
        deq, _ = self.allreduce_shards(g_shards, zero, seed, group=group,
                                       bucket_elems=bucket_elems)
        return deq

    def _allreduce_one(self, g, e, seed, *, group=None, offset: int = 0):
        """One whole bucket through the pipeline, synchronously: ``g``
        this rank's partial gradient over the bucket, ``e`` its error view
        (its segment, or all of it), ``offset`` the bucket's global index.
        Returns ``(deq over the bucket, e)``; ``e`` is updated in place."""
        ndev, rank = world(group)
        b = self._bucket(g, e, 0, g.numel(), _as_seed(seed), ndev, rank,
                         group, base=offset)
        b.wait()
        self._quantize_gather(b, group)
        out = torch.empty(g.shape, dtype=torch.float32, device=g.device)
        self._dequantize(b, out)
        return out, e

    # -- the pipeline's phases (distributed/overlap.py drives them) ---------

    def _bucket(self, g, e, start, stop, seed, ndev, rank, group, *,
                base: int = 0) -> _Bucket:
        """Issue bucket ``[start, stop)`` of shard ``g``: the reduce-
        scatter of its device-major slice, the fp32 all-reduce fallback,
        or (W <= 1) nothing.  ``base`` is the global index of ``g[0]``."""
        n = g.numel()
        seg_ok = segmented(n, ndev, self.block)
        works = []
        if seg_ok:
            seg = n // ndev
            s0, s1 = start // ndev, stop // ndev
            x = g.view(ndev, seg)[:, s0:s1].to(torch.float32).contiguous()
            red = torch.empty((s1 - s0,), dtype=torch.float32,
                              device=g.device)
            works.append(dist.reduce_scatter_tensor(
                red, x.view(-1), op=dist.ReduceOp.SUM, group=group,
                async_op=True))
            err, offset = e[s0:s1], base + s0 + rank * seg
        else:
            red = g[start:stop].to(torch.float32)
            if ndev > 1:
                red = red.clone()
                works.append(dist.all_reduce(red, op=dist.ReduceOp.SUM,
                                             group=group, async_op=True))
            err, offset = e[start:stop], base + start
        return _Bucket(start=start, stop=stop, ndev=ndev, rank=rank,
                       segmented=seg_ok, red=red, err=err, seed=seed,
                       offset=offset, works=works)

    def _quantize_gather(self, b: _Bucket, group) -> None:
        """Add the error view, quantize at the bucket's global offset,
        write the new error, and issue the all-gathers of the int8 payload
        and the scales (segmented buckets only)."""
        x = b.red + b.err
        q, scale, deq = _quantize(x, self.block, b.seed, offset=b.offset)
        torch.sub(x, deq, out=b.err)
        if not b.segmented:
            b.deq = deq
            return
        q_all = torch.empty((b.ndev * q.numel(),), dtype=torch.int8,
                            device=q.device)
        s_all = torch.empty((b.ndev * scale.numel(),), dtype=torch.float32,
                            device=q.device)
        b.works = [
            dist.all_gather_into_tensor(q_all, q.view(-1), group=group,
                                        async_op=True),
            dist.all_gather_into_tensor(s_all, scale.view(-1), group=group,
                                        async_op=True)]
        b.gathered = (q_all, s_all)

    def _dequantize(self, b: _Bucket, out: torch.Tensor) -> None:
        """Wait for the bucket's all-gathers and write its dequantized
        values into ``out`` (the whole shard) at the bucket's place."""
        if not b.segmented:
            out[b.start:b.stop].copy_(b.deq)
            return
        b.wait()
        q_all, s_all = b.gathered
        full = (q_all.view(-1, self.block).to(torch.float32)
                * s_all.view(-1, 1)).view(b.ndev, -1)
        seg = out.numel() // b.ndev
        s0, s1 = b.start // b.ndev, b.stop // b.ndev
        out.view(b.ndev, seg)[:, s0:s1].copy_(full)

    # -- legacy params-tree path --------------------------------------------

    def init(self, grads) -> CompressionState:
        return CompressionState(error=tree_unflatten(grads, [
            torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            for leaf in tree_leaves(grads) for t in leaf_parts(leaf)]))

    def roundtrip(self, grads, state: CompressionState,
                  seeds: Sequence[int]) -> tuple:
        """Simulate the compressed all-reduce on a params-shaped tree: the
        gradients as the receiving end sees them, and the new error
        feedback.  ``seeds``: one integer a leaf, in leaf order (a stacked
        leaf is quantized as one array, layer 0 first)."""
        leaves = tree_leaves(grads)
        errs = tree_leaves(state.error)
        if len(seeds) != len(leaves):
            raise ValueError(f"{len(seeds)} seeds for {len(leaves)} leaves")
        deq_parts, err_parts = [], []
        for leaf, e, seed in zip(leaves, errs, seeds):
            parts, eparts = leaf_parts(leaf), leaf_parts(e)
            g32 = (torch.stack(parts) if isinstance(leaf, (list, tuple))
                   else parts[0]).to(torch.float32)
            g32 = g32 + (torch.stack(eparts) if isinstance(e, (list, tuple))
                         else eparts[0])
            _, _, deq = _quantize(g32, self.block, seed)
            res = g32 - deq
            if isinstance(leaf, (list, tuple)):
                deq_parts.extend(deq.unbind(0))
                err_parts.extend(res.unbind(0))
            else:
                deq_parts.append(deq)
                err_parts.append(res)
        return (tree_unflatten(grads, deq_parts),
                CompressionState(error=tree_unflatten(grads, err_parts)))


def compressed_bytes(grads, block: int = 256) -> int:
    """Bytes on the wire for the compressed representation (int8 +
    scales): a params-shaped grad tree, or a tuple of the engine's flat
    shards (each a leaf)."""
    leaves = (list(grads) if isinstance(grads, (tuple, list))
              else tree_leaves(grads))
    total = 0
    for leaf in leaves:
        n = sum(t.numel() for t in leaf_parts(leaf))
        total += n + 4 * (-(-n // block))
    return total
