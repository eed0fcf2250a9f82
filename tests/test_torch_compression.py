"""The gradient half of the quantization core and the compressor against
the reference on the CPU, bit for bit: ``_uniform_noise`` and
``_quantize`` (``repro.quant``) over seeds, offsets near 2^32 and a length
that needs padding; the chunked quantize against the whole; the flat-
shard compressor's dequantized shards and error feedback against the
reference's mesh-less call over three error-feedback steps, bucketed and
monolithic; the stateless call, the wire-byte counts and the legacy
params-tree round trip."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jquant
from repro.distributed.compression import (CompressionState as JCState,
                                           FlatCompressionState as JFlat,
                                           GradCompressor as JCompressor,
                                           compressed_bytes as jax_bytes)
from repro_torch import quant
from repro_torch.distributed import (FlatCompressionState, GradCompressor,
                                     compressed_bytes)

torch.set_num_threads(1)

SEEDS = [0, 2 ** 31 + 7, 2 ** 32 - 1]
OFFSETS = [0, 2 ** 32 - 2 ** 16]


def _x(n, seed=0):
    rs = np.random.default_rng(seed)
    return (rs.standard_normal(n) * rs.uniform(0.01, 10.0, n)
            ).astype(np.float32)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("offset", OFFSETS)
def test_uniform_noise_is_the_reference(seed, offset):
    """The hash noise over 2^16 + 3 indices from ``offset`` (wrapping past
    2^32), bit for bit."""
    idx = (np.arange(2 ** 16 + 3, dtype=np.uint64) + offset) % 2 ** 32
    want = np.asarray(jquant._uniform_noise(
        jnp.uint32(seed), jnp.asarray(idx.astype(np.uint32))))
    got = quant._uniform_noise(seed, torch.from_numpy(idx.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("seed", [None] + SEEDS)
@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("n", [4096 * 3, 5000])
def test_quantize_is_the_reference(seed, offset, n):
    """q, scales and deq bit for bit, stochastic (integer seeds) and
    round-to-nearest (None); 5000 elements pad to 20 blocks."""
    x = _x(n, seed=n)
    rng = None if seed is None else jnp.uint32(seed)
    q, s, d = jquant._quantize(jnp.asarray(x), 256, rng, offset=offset)
    q2, s2, d2 = quant._quantize(torch.from_numpy(x), 256, seed,
                                 offset=offset)
    np.testing.assert_array_equal(q2.numpy(), np.asarray(q))
    np.testing.assert_array_equal(s2.numpy(), np.asarray(s))
    np.testing.assert_array_equal(d2.numpy().view(np.uint32),
                                  np.asarray(d).view(np.uint32))


@pytest.mark.parametrize("chunk", [256, 256 * 7, 1000])
def test_chunked_quantize_is_the_whole(monkeypatch, chunk):
    """Chunks of at most ``QUANT_CHUNK`` elements (rounded to blocks) key
    the noise on the global index: the result is the one-chunk result bit
    for bit."""
    x = torch.from_numpy(_x(256 * 37 + 11, seed=5))
    whole = quant._quantize(x, 256, 2 ** 31 + 7, offset=2 ** 32 - 512)
    monkeypatch.setattr(quant, "QUANT_CHUNK", chunk)
    parts = quant._quantize(x, 256, 2 ** 31 + 7, offset=2 ** 32 - 512)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


def test_seed_must_be_an_integer():
    with pytest.raises(TypeError):
        quant._as_seed(1.5)
    assert quant._as_seed(-1) == 2 ** 32 - 1
    assert quant._as_seed(torch.tensor(7)) == 7 and quant._as_seed(None) is None


SHARDS = (256 * 48, 256 * 9 + 256)


@pytest.mark.parametrize("bucket_elems", [0, None, 256 * 5, 256 * 7 + 13])
def test_compressor_is_the_reference_over_three_steps(bucket_elems):
    """``allreduce_shards`` without a process group: the dequantized
    shards and the error feedback equal the reference's mesh-less call
    over three error-feedback steps, monolithic and bucketed (one size
    straddles a block)."""
    jc, tc = JCompressor(), GradCompressor()
    je = JFlat(error=tuple(jnp.zeros(n, jnp.float32) for n in SHARDS))
    te = FlatCompressionState(error=tuple(torch.zeros(n) for n in SHARDS))
    for step in range(3):
        g = [_x(n, seed=10 * step + i) for i, n in enumerate(SHARDS)]
        jd, je = jc.allreduce_shards(tuple(map(jnp.asarray, g)), je,
                                     jnp.uint32(4000 + step),
                                     bucket_elems=bucket_elems)
        td, te = tc.allreduce_shards(tuple(map(torch.from_numpy, g)), te,
                                     4000 + step, bucket_elems=bucket_elems)
        for a, b in zip(td, jd):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b in zip(te.error, je.error):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("seed", [None, 9])
def test_stateless_and_one_bucket_are_the_reference(seed):
    """The stateless reduction and ``_allreduce_one`` at a global offset,
    bit for bit."""
    g = [_x(n, seed=i) for i, n in enumerate(SHARDS)]
    rng = None if seed is None else jnp.uint32(seed)
    want = JCompressor().allreduce_shards_stateless(
        tuple(map(jnp.asarray, g)), rng)
    got = GradCompressor().allreduce_shards_stateless(
        tuple(map(torch.from_numpy, g)), seed)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    e = _x(SHARDS[1], seed=3) * 1e-3
    d, e2 = JCompressor()._allreduce_one(jnp.asarray(g[1]), jnp.asarray(e),
                                         rng, None, None, offset=512)
    d2, e3 = GradCompressor()._allreduce_one(
        torch.from_numpy(g[1]), torch.from_numpy(e.copy()), seed,
        offset=512)
    np.testing.assert_array_equal(d2.numpy(), np.asarray(d))
    np.testing.assert_array_equal(e3.numpy(), np.asarray(e2))


@pytest.mark.parametrize("sizes", [(256,), (1,), (255, 257), (131072, 7),
                                   (124_518_400,)])
def test_wire_and_compressed_bytes_are_the_reference(sizes):
    layout = type("L", (), {"shard_sizes": sizes})
    assert GradCompressor().wire_bytes(layout) == JCompressor().wire_bytes(
        layout)
    small = [min(n, 4096) for n in sizes]
    assert compressed_bytes(tuple(torch.zeros(n) for n in small)) == \
        jax_bytes(tuple(jnp.zeros(n) for n in small))


def test_roundtrip_is_the_reference():
    """The params-tree round trip with the reference's per-leaf seeds (its
    key split, each key through ``_as_seed``) and a stacked leaf."""
    rs = np.random.default_rng(1)
    tree = {"a": rs.standard_normal((3, 50)).astype(np.float32),
            "b": rs.standard_normal((300,)).astype(np.float32)}
    key = jax.random.PRNGKey(4)
    jd, js = JCompressor().roundtrip(jax.tree.map(jnp.asarray, tree),
                                     JCompressor().init(tree), key)
    seeds = [int(jquant._as_seed(k)) for k in jax.random.split(key, 2)]
    port_tree = {"a": [torch.from_numpy(r) for r in tree["a"]],
                 "b": torch.from_numpy(tree["b"])}
    td, ts = GradCompressor().roundtrip(
        port_tree, GradCompressor().init(port_tree), seeds)
    np.testing.assert_array_equal(torch.stack(td["a"]).numpy(),
                                  np.asarray(jd["a"]))
    np.testing.assert_array_equal(td["b"].numpy(), np.asarray(jd["b"]))
    np.testing.assert_array_equal(torch.stack(ts.error["a"]).numpy(),
                                  np.asarray(js.error["a"]))
    assert isinstance(js, JCState)
