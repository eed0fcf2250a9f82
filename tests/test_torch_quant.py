"""The port's int8 KV quantization (repro_torch.quant) is bit-identical to
the reference's (repro.quant), exact round-half-to-even ties included."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import quant as jq
from repro_torch import quant as tq


def _ties():
    """Tokens whose scale is exactly 1 (max |x| = 127), so x / scale lands
    on .5 ties that round-half-to-even settles (0.5 -> 0, 1.5 -> 2,
    2.5 -> 2, -0.5 -> 0, -1.5 -> -2)."""
    x = np.zeros((2, 3, 2, 4), np.float32)
    x[..., 0, 0] = 127.0
    x[..., 0, 1:] = [0.5, 1.5, 2.5]
    x[..., 1, :] = [-0.5, -1.5, -2.5, 126.5]
    return x


@pytest.mark.parametrize("make", [
    lambda: np.random.default_rng(0).standard_normal((3, 16, 2, 8),
                                                     dtype=np.float32) * 4,
    lambda: np.random.default_rng(1).standard_normal((5, 4, 64),
                                                     dtype=np.float32),
    _ties,
    lambda: np.zeros((2, 3, 2, 4), np.float32),   # all-zero: scale floor
])
def test_quantize_kv_bit_identical(make):
    x = make()
    q_ref, s_ref = (np.asarray(a) for a in jq.quantize_kv(jnp.asarray(x)))
    q, s = tq.quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), q_ref)
    np.testing.assert_array_equal(s.numpy(), s_ref)


def test_ties_round_half_to_even():
    q, _ = tq.quantize_kv(torch.from_numpy(_ties()))
    np.testing.assert_array_equal(q[0, 0].numpy(),
                                  [[127, 0, 2, 2], [0, -2, -2, 126]])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_kv_bit_identical(dtype):
    x = np.random.default_rng(2).standard_normal((4, 8, 2, 16),
                                                 dtype=np.float32) * 3
    q_ref, s_ref = jq.quantize_kv(jnp.asarray(x))
    ref = np.asarray(jq.dequantize_kv(q_ref, s_ref, getattr(jnp, dtype)),
                     np.float32)
    got = tq.dequantize_kv(torch.from_numpy(np.asarray(q_ref)),
                           torch.from_numpy(np.asarray(s_ref)),
                           getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("hkv,hd,kv", [(12, 64, "bf16"), (12, 64, "int8"),
                                       (8, 128, "int8")])
def test_kv_bytes_per_token_matches(hkv, hd, kv):
    assert tq.kv_bytes_per_token(hkv, hd, kv) == jq.kv_bytes_per_token(
        hkv, hd, kv)
