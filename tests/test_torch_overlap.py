"""The bucketed reduction's static plan, its communication model and its
telemetry against the reference on the CPU: ``bucket_slices`` (free and
on a ShardLayout) and ``plan_buckets`` over a grid, the ring model and the
bucket chooser on the same constants, bucketed dequantization bit for bit
equal to monolithic at three bucket sizes (one straddling a block), and
telemetry leaving the values unchanged."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.gpt2 import GPT2_TINY
from repro.core.engine import bucket_slices as jax_bucket_slices
from repro.distributed import overlap as jov
from repro.launch import roofline as jroof
from repro_torch.core.engine import bucket_slices, build_layout
from repro_torch.distributed import FlatCompressionState, GradCompressor
from repro_torch.distributed import overlap
from repro_torch.launch import roofline
from repro_torch.models import ModelConfig, get_model

torch.set_num_threads(1)

GRID = [(n, b, a) for n in (0, 256, 1000, 256 * 40, 131072 * 3)
        for b in (0, -1, 1, 300, 256 * 7, 10 ** 9)
        for a in (256, 512, 2048)]


@pytest.mark.parametrize("n,b,align", GRID)
def test_bucket_slices_are_the_reference(n, b, align):
    assert bucket_slices(n, b, align=align) == jax_bucket_slices(
        n, b, align=align)


def test_layout_bucket_slices():
    cfg = ModelConfig(**dataclasses.asdict(
        dataclasses.replace(GPT2_TINY, dtype="float32")))
    gen = torch.Generator().manual_seed(0)
    lay = build_layout(get_model(cfg).init_params(cfg, gen).param_tree())
    assert lay.bucket_slices(100_000, align=512) == tuple(
        jax_bucket_slices(n, 100_000, align=512) for n in lay.shard_sizes)


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
@pytest.mark.parametrize("bucket_elems", [None, 0, 5000, 131072])
def test_plan_buckets_is_the_reference(ndev, bucket_elems):
    """Equal plans for explicit sizes and on one rank; for the roofline
    size across ranks, the reference's plan at the port's chosen size
    (the two choosers take different links: ``LINK_BW`` here)."""
    sizes = (131072 * 8, 256 * 4, 131072 * 3 + 256)
    got = overlap.plan_buckets(sizes, ndev, bucket_elems=bucket_elems)
    if bucket_elems is None and ndev > 1:
        want = tuple(jov.plan_buckets(
            (n,), ndev, bucket_elems=roofline.choose_bucket_elems(n, ndev))[0]
            for n in sizes)
    else:
        want = jov.plan_buckets(sizes, ndev, bucket_elems=bucket_elems)
    assert got == want


@pytest.mark.parametrize("ndev", [1, 2, 8])
@pytest.mark.parametrize("n", [100, 131072, 124_518_400])
def test_comm_model_is_the_reference_on_the_same_constants(ndev, n):
    kw = dict(bw=roofline.LINK_BW, launch=roofline.COLLECTIVE_LAUNCH_S)
    assert roofline.ring_collective_seconds(4 * n, ndev) == \
        jroof.ring_collective_seconds(4 * n, ndev, **kw)
    assert roofline.ring_phase_seconds(n, ndev) == \
        jroof.ring_phase_seconds(n, ndev, **kw)
    assert roofline.choose_bucket_elems(n, ndev) == \
        jroof.choose_bucket_elems(n, ndev, **kw)
    buckets = [n // 4] * 4
    assert roofline.exposed_comm_seconds(buckets, ndev, 1e-3) == \
        jroof.exposed_comm_seconds(buckets, ndev, 1e-3, **kw)


@pytest.mark.parametrize("bucket_elems", [256 * 3, 256 * 11 + 1, 4096])
def test_bucketed_is_monolithic_bit_for_bit(bucket_elems):
    """Any bucketing dequantizes the monolithic call's values and leaves
    its error feedback (three steps; 256 * 11 + 1 straddles a block)."""
    sizes = (256 * 64, 256 * 13)
    comp = GradCompressor()
    states = [FlatCompressionState(error=tuple(torch.zeros(n)
                                               for n in sizes))
              for _ in range(2)]
    rs = np.random.default_rng(2)
    for step in range(3):
        g = tuple(torch.from_numpy(rs.standard_normal(n).astype(np.float32))
                  for n in sizes)
        a, states[0] = comp.allreduce_shards(g, states[0], step,
                                             bucket_elems=0)
        b, states[1] = comp.allreduce_shards(g, states[1], step,
                                             bucket_elems=bucket_elems)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        for x, y in zip(*(s.error for s in states)):
            assert torch.equal(x, y)


def test_telemetry_leaves_the_values_unchanged():
    """With telemetry the values are the same bit for bit; the window is
    a non-negative span and the TIMELINE decodes to every bucket's pre
    and post stamps."""
    sizes = (256 * 64, 256 * 13)
    comp = GradCompressor()
    g = tuple(torch.from_numpy(np.random.default_rng(i).standard_normal(
        n).astype(np.float32)) for i, n in enumerate(sizes))
    zero = [FlatCompressionState(error=tuple(torch.zeros(n) for n in sizes))
            for _ in range(2)]
    overlap.timeline_enable(True)
    try:
        a, _, tele = comp.allreduce_shards(g, zero[0], 5, bucket_elems=2048,
                                           telemetry=True)
        recs = overlap.decode_timeline()
    finally:
        overlap.timeline_enable(False)
    b, _ = comp.allreduce_shards(g, zero[1], 5, bucket_elems=2048)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert tele["comm_seconds"] >= 0.0
    n_buckets = sum(len(p) for p in overlap.plan_buckets(sizes, 1,
                                                         bucket_elems=2048))
    assert len(recs) == 2 * n_buckets
    assert {r["phase"] for r in recs} == {"pre", "post"}
    assert {(r["shard"], r["bucket"]) for r in recs} == {
        (i, j) for i, p in enumerate(overlap.plan_buckets(
            sizes, 1, bucket_elems=2048)) for j in range(len(p))}
