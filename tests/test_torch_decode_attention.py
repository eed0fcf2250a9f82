"""The port's decode attention (repro_torch.kernels.decode_attention) held
against the JAX reference: its plain version against the oracle
``repro.kernels.ref.decode_attention_ref`` and against the Pallas kernel in
interpret mode, on the same inputs made with numpy from a seed; and the
CUDA kernel's split schedule (``_decode_split.py``, S blocks per ring walk
merged by the online softmax's rescale) against both.  The CUDA kernel
itself is held against the plain version in test_torch_cuda.py."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import (
    decode_attention_hbm_bytes as jax_hbm_bytes, decode_attention_pallas)
from repro.kernels.ref import decode_attention_ref
from repro.quant import quantize_kv as jax_quantize_kv
from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
from repro_torch.kernels.decode_attention import (
    check_kernel_args, decode_attention, decode_attention_hbm_bytes,
    decode_attention_plain, head_tiles, split_count)

from _decode_split import decode_attention_split, split_bounds, walk_rows

pytestmark = pytest.mark.serve

TOL = 3e-6          # fp32, the reference tests' bound (plain vs oracle)
TOL_BF16 = 2e-2     # bf16 outputs, the reference tests' bound


def _rand(N, H, Hkv, C, hd, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((N, H, hd), dtype=np.float32)
    k = rng.standard_normal((N, C, Hkv, hd), dtype=np.float32)
    v = rng.standard_normal((N, C, Hkv, hd), dtype=np.float32)
    return q, k, v


def _both(q, k, v, pos, page=8, **kw):
    """(port plain, JAX oracle, JAX Pallas interpret) on one input set."""
    t = decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(pos),
                               **kw).numpy()
    jq, jk, jv, jp = map(jnp.asarray, (q, k, v, pos))
    ref = np.asarray(decode_attention_ref(jq, jk, jv, jp, **kw))
    pallas = np.asarray(decode_attention_pallas(jq, jk, jv, jp,
                                                page_len=page, **kw))
    return t, ref, pallas


@pytest.mark.parametrize("N,H,Hkv,C,hd,page", [
    (3, 4, 2, 32, 16, 8),     # GQA
    (2, 2, 1, 64, 8, 16),     # MQA
    (4, 8, 8, 16, 32, 16),    # MHA, single page
    (1, 4, 4, 48, 64, 8),     # non-power-of-two page count
])
def test_plain_matches_reference(N, H, Hkv, C, hd, page):
    q, k, v = _rand(N, H, Hkv, C, hd)
    pos = ((np.arange(N) * 7 + 3) % C).astype(np.int32)
    t, ref, pallas = _both(q, k, v, pos, page)
    np.testing.assert_allclose(t, ref, atol=TOL)
    np.testing.assert_allclose(t, pallas, atol=TOL)


def test_plain_ring_wraparound():
    """Positions beyond C: the ring has wrapped; stale entries must mask."""
    N, H, Hkv, C, hd = 2, 4, 2, 16, 16
    q, k, v = _rand(N, H, Hkv, C, hd, seed=1)
    pos = np.array([C + 3, 5 * C + 11], np.int32)
    t, ref, pallas = _both(q, k, v, pos)
    np.testing.assert_allclose(t, ref, atol=TOL)
    np.testing.assert_allclose(t, pallas, atol=TOL)


@pytest.mark.parametrize("window", [4, 12])
def test_plain_sliding_window(window):
    N, H, Hkv, C, hd = 2, 4, 1, 32, 16
    q, k, v = _rand(N, H, Hkv, C, hd, seed=2)
    pos = np.array([9, 27], np.int32)
    t, ref, pallas = _both(q, k, v, pos, window=window)
    np.testing.assert_allclose(t, ref, atol=TOL)
    np.testing.assert_allclose(t, pallas, atol=TOL)


def test_plain_softcap_and_window():
    N, H, Hkv, C, hd = 2, 4, 2, 32, 16
    q, k, v = _rand(N, H, Hkv, C, hd, seed=3)
    pos = np.array([6, 30], np.int32)
    t, ref, pallas = _both(q, k, v, pos, window=10, softcap=50.0)
    np.testing.assert_allclose(t, ref, atol=TOL)
    np.testing.assert_allclose(t, pallas, atol=TOL)


def test_plain_unwritten_ring_fully_masked():
    """A slot at position 0 attends only to its own just-written token even
    when the rest of the ring holds garbage: the output is exactly v[:, 0]."""
    N, H, Hkv, C, hd = 2, 2, 2, 16, 8
    q, k, v = _rand(N, H, Hkv, C, hd, seed=4)
    pos = np.array([0, 0], np.int32)
    t, ref, pallas = _both(q, k, v * 100.0, pos)
    np.testing.assert_allclose(t, v[:, 0] * 100.0, atol=TOL)
    np.testing.assert_allclose(t, pallas, atol=TOL)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plain_int8_matches_reference(dt):
    """The same int8 cache + scales (quantized by the reference) through
    both: the dequant rounds once into the compute dtype on each side."""
    N, H, Hkv, C, hd = 3, 4, 2, 48, 16
    q, k, v = _rand(N, H, Hkv, C, hd, seed=5)
    kq, ks = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(k)))
    vq, vs = (np.asarray(a) for a in jax_quantize_kv(jnp.asarray(v)))
    pos = np.array([17, 41, 30], np.int32)
    tq = torch.from_numpy(q).to(getattr(torch, dt))
    got = decode_attention_plain(
        tq, torch.from_numpy(kq), torch.from_numpy(vq), torch.from_numpy(pos),
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    jq = jnp.asarray(q).astype(getattr(jnp, dt))
    args = (jq, jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(pos))
    kw = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    ref = np.asarray(decode_attention_ref(*args, **kw), np.float32)
    pallas = np.asarray(decode_attention_pallas(*args, page_len=8, **kw),
                        np.float32)
    atol = TOL if dt == "float32" else TOL_BF16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=atol)
    np.testing.assert_allclose(got.float().numpy(), pallas, atol=atol)


def test_cpu_tensor_takes_plain_route_and_counts_nothing():
    q, k, v = _rand(2, 4, 2, 32, 64, seed=6)
    pos = torch.tensor([5, 40], dtype=torch.int32)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), pos)
    reset_launch_counts()
    got = decode_attention(*args, window=8)
    assert sum(KERNEL_LAUNCHES.values()) == 0
    torch.testing.assert_close(got, decode_attention_plain(*args, window=8),
                               rtol=0, atol=0)


@pytest.mark.parametrize("change,match", [
    (dict(hd=32), "head dim"),
    (dict(H=68, Hkv=4), "exceeds"),         # 17 heads a KV head: 3 tiles
    (dict(k_dtype=torch.bfloat16), "cache dtype"),
    (dict(pos_shape=(3,)), "positions"),
    (dict(noncontig=True), "contiguous"),
])
def test_kernel_args_rejected(change, match):
    """What the CUDA kernel does not take raises before any launch."""
    N, C = 2, 32
    H, Hkv, hd = change.get("H", 4), change.get("Hkv", 2), change.get("hd", 64)
    q = torch.zeros((N, H, hd))
    k = torch.zeros((N, C, Hkv, hd), dtype=change.get("k_dtype", torch.float32))
    if change.get("noncontig"):
        k = torch.zeros((N, Hkv, C, hd)).transpose(1, 2)
    pos = torch.zeros(change.get("pos_shape", (N,)), dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        check_kernel_args(q, k, k, pos)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_hbm_bytes_formula_matches_reference(kv_dtype):
    for shape in [(8, 12, 12, 512, 64), (4, 8, 2, 256, 128)]:
        assert (decode_attention_hbm_bytes(*shape, kv_dtype=kv_dtype)
                == jax_hbm_bytes(*shape, kv_dtype=kv_dtype))


# positions 0, C - 1, C, 3C + 5, -1 and -7 at C = 16
SPLIT_POS = [0, 15, 16, 53, -1, -7]
SPLIT_CASES = {
    # name: (N, H, Hkv, C, hd, positions, kwargs, int8 cache)
    "positions": (6, 4, 2, 16, 16, SPLIT_POS, {}, False),
    "window4_softcap50": (6, 4, 2, 16, 16, SPLIT_POS,
                          dict(window=4, softcap=50.0), False),
    "gqa4": (6, 8, 2, 16, 16, SPLIT_POS, {}, False),
    "int8": (6, 4, 2, 16, 16, SPLIT_POS, {}, True),
    "splits_past_rows": (4, 4, 2, 16, 16, [0, 1, 2, 5], {}, False),
}


@functools.cache
def _split_case(name):
    """Inputs and the two JAX outputs (oracle, Pallas interpret) of one
    case, computed once for every S."""
    N, H, Hkv, C, hd, pos, kw, quant = SPLIT_CASES[name]
    q, k, v = _rand(N, H, Hkv, C, hd, seed=7)
    pos = np.asarray(pos, np.int32)
    if quant:
        k, ks = (np.array(a) for a in jax_quantize_kv(jnp.asarray(k)))
        v, vs = (np.array(a) for a in jax_quantize_kv(jnp.asarray(v)))
        kw = dict(kw, k_scale=ks, v_scale=vs)
    jargs = tuple(map(jnp.asarray, (q, k, v, pos)))
    jkw = {key: jnp.asarray(a) if isinstance(a, np.ndarray) else a
           for key, a in kw.items()}
    ref = np.asarray(decode_attention_ref(*jargs, **jkw))
    pallas = np.asarray(decode_attention_pallas(*jargs, page_len=8, **jkw))
    return (q, k, v, pos), kw, ref, pallas


@pytest.mark.parametrize("S", [1, 2, 3, 8])
@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_split_schedule_matches_reference(case, S):
    """The kernel's schedule in fp32: S splits of each slot's walk (empty
    ones at S > n_rows, all-masked ones at negative positions, where the
    merge must give the reference's uniform average), merged by the
    rescale, within 3e-6 of the oracle and the Pallas kernel."""
    (q, k, v, pos), kw, ref, pallas = _split_case(case)
    tkw = {key: torch.from_numpy(a) if isinstance(a, np.ndarray) else a
           for key, a in kw.items()}
    got = decode_attention_split(*map(torch.from_numpy, (q, k, v, pos)), S,
                                 **tkw).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=TOL)
    np.testing.assert_allclose(got, pallas, atol=TOL)
    if case == "splits_past_rows" and S > 1:
        C = SPLIT_CASES[case][3]
        assert any(lo == hi for lo, hi in split_bounds(walk_rows(0, C), S))


@pytest.mark.parametrize("N,Hkv,C,want", [
    (8, 12, 512, 2),      # the serving shape: 96 blocks alone
    (8, 12, 1024, 2),     # GPT-2's full context
    (64, 12, 1024, 1),    # 768 blocks fill the card alone
    (16, 12, 1024, 1),
    (4, 12, 512, 4),
    (3, 12, 64, 4),       # no split shorter than 16 ring rows
    (4, 2, 256, 8),       # at most the portable cluster size
    (2, 2, 32, 2),
])
def test_split_count_rule(N, Hkv, C, want):
    assert split_count(N, Hkv, C, sms=132) == want


@pytest.mark.parametrize("G,tiles,per_tile,N,C,splits", [
    (1, 1, 1, 8, 512, 8),
    (8, 1, 8, 8, 512, 8),     # yi-6b's group: one tile
    (9, 2, 5, 8, 2048, 8),    # 5 and 4
    (10, 2, 5, 8, 2048, 8),   # recurrentgemma-2b: 8 x 1 x 2 x 8 = 128 blocks
    (12, 2, 6, 32, 2048, 4),
    (16, 2, 8, 64, 2048, 2),  # 128 blocks before the split
])
def test_head_tile_rule(G, tiles, per_tile, N, C, splits):
    """A KV head's G query heads run in ceil(G / 8) tiles of ceil(G / T)
    heads, the last tile non-empty; the split count counts N * Hkv * T
    blocks (one KV head here)."""
    assert head_tiles(G) == tiles
    assert -(-G // tiles) == per_tile
    assert (tiles - 1) * per_tile < G <= tiles * per_tile <= 8 * tiles
    assert split_count(N, 1, C, sms=132, tiles=tiles) == splits
