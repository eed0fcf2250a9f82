"""The layers of the port's rope slice held against the JAX reference:
rotary position embeddings, SwiGLU, the embedding without a position table
and the untied unembedding, the parameter trees of GPT-NeoX and stablelm,
the fused CE's plain versions with the untied (D, Vp) layout at NeoX-1.5B's
width (D = 1536) against ``kernels/ref.py``, and the CE kernels' argument
checks at the widths of NeoX and stablelm."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.gpt2 import GPT2_TINY, NEOX_1_5B
from repro.kernels.fused_ce import seed_from_key
from repro.kernels.ref import lm_loss_grads_ref, lm_loss_sampled_ref
from repro.models import get_model as jax_get_model
from repro.models import layers as jl
from repro_torch.configs import get_config
from repro_torch.configs.gpt2 import NEOX_1_5B as T_NEOX_1_5B
from repro_torch.configs.gpt2 import NEOX_6_6B as T_NEOX_6_6B
from repro_torch.convert import params_from_jax
from repro_torch.core.types import leaf_shape, tree_leaves
from repro_torch.kernels import fused_ce as ce
from repro_torch.models import ModelConfig, get_model
from repro_torch.models import layers as tl

torch.set_num_threads(1)

NEOX_TINY = dataclasses.replace(NEOX_1_5B, name="neox-tiny", d_model=128,
                                n_layers=2, n_heads=4, n_kv_heads=4,
                                d_ff=512, vocab_size=512, dtype="float32")


def _t(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


def _to_torch(x):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


# ---------------------------------------------------------------------------
# rope


@pytest.mark.parametrize("hd", [8, 32, 64, 128])
def test_rope_freqs_bit_identical(hd):
    np.testing.assert_array_equal(tl.rope_freqs(hd, 10000.0).numpy(),
                                  np.asarray(jl.rope_freqs(hd, 10000.0)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_apply_rope_matches_reference(hd, dtype):
    """x (2, 64, 4, hd) rotated at positions drawn up to 2047 (NeoX's
    context).  The frequencies and angles are bit-identical; XLA's CPU cos
    and sin and PyTorch's differ by one fp32 ulp on ~5% of the angles, so
    fp32 results agree within 2e-6 (|x| < 5) and bf16 results, rounded
    from those, within one bf16 ulp (2^-7 relative) beyond that fp32 bound
    (a result that cancels to ~1e-7 can round either way)."""
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 64, 4, hd)).astype(np.float32)
    pos = rng.integers(0, 2048, (2, 64)).astype(np.int32)
    pos[0, :4] = [0, 1, 2046, 2047]
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = np.asarray(jl.apply_rope(jx, jnp.asarray(pos)).astype(
        jnp.float32))
    got = _np(tl.apply_rope(_to_torch(jx), torch.from_numpy(pos)))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=2e-6)
        assert (got == want).mean() > 0.99


# ---------------------------------------------------------------------------
# SwiGLU, the embedding, the untied unembedding


def test_swiglu_mlp_matches_reference():
    """fp32 SwiGLU at stablelm's smoke width: within 1e-5."""
    cfg = dataclasses.replace(jax_get_config("stablelm-1.6b", smoke=True),
                              dtype="float32")
    p = jl.init_mlp(jax.random.PRNGKey(0), cfg)
    x = np.random.default_rng(0).standard_normal((2, 8, cfg.d_model)) \
        .astype(np.float32)
    want = np.asarray(jl.mlp(p, jnp.asarray(x), cfg))
    got = tl.mlp({k: _to_torch(v) for k, v in p.items()},
                 torch.from_numpy(x), _t(cfg))
    assert sorted(p) == ["w_down", "w_gate", "w_up"]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("vocab", [512, 500])
def test_embed_and_untied_unembed_match_reference(vocab):
    """No position table under rope (positions ignored by the embedding),
    and the (D, Vp) unembedding with the padded columns at -1e30: the
    embedding bit for bit, the logits within 1e-5."""
    cfg = dataclasses.replace(NEOX_TINY, vocab_size=vocab)
    p = jl.init_embedding(jax.random.PRNGKey(1), cfg)
    assert sorted(p) == ["tok", "unembed"]
    tp = {k: _to_torch(v) for k, v in p.items()}
    rng = np.random.default_rng(2)
    toks = rng.integers(0, vocab, (2, 9)).astype(np.int32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    np.testing.assert_array_equal(
        tl.embed(tp, torch.from_numpy(toks), _t(cfg),
                 torch.from_numpy(pos.copy())).numpy(),
        np.asarray(jl.embed(p, jnp.asarray(toks), cfg, jnp.asarray(pos))))
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    want = np.asarray(jl.unembed(p, jnp.asarray(x), cfg))
    got = tl.unembed(tp, torch.from_numpy(x), _t(cfg)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (got[..., vocab:] == -1e30).all()


@pytest.mark.parametrize("name", ["gpt2_tiny", "neox_tiny", "stablelm_smoke"])
def test_parameter_tree_matches_reference(name):
    """The port's parameter tree has the reference's leaves, in the
    reference's flatten order and with its shapes (stacked leaves lead
    with the layer count): ``embed/unembed`` and ``mlp/w_gate`` where
    the config asks for them and no ``embed/pos`` under rope.  The
    checkpoint and the optimizer engine's flat shards rest on that order.
    The reference's weights carried over by ``params_from_jax`` come back
    unchanged."""
    cfg = {"gpt2_tiny": GPT2_TINY, "neox_tiny": NEOX_TINY,
           "stablelm_smoke": jax_get_config("stablelm-1.6b", smoke=True)}[name]
    jp = jax_get_model(cfg).init_params(cfg, jax.random.PRNGKey(0))
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(jp)[0]]
    tparams = get_model(_t(cfg)).init_params(_t(cfg),
                                             torch.Generator().manual_seed(0))
    tleaves = tree_leaves(tparams.param_tree())
    assert [leaf_shape(t) for t in tleaves] == \
        [tuple(a.shape) for a in jax.tree.leaves(jp)], paths
    carried = params_from_jax(jax.tree.map(np.asarray, jp), _t(cfg))
    for t, a in zip(tree_leaves(carried.param_tree()), jax.tree.leaves(jp)):
        t = torch.stack(t) if isinstance(t, list) else t
        np.testing.assert_array_equal(t.detach().numpy(), np.asarray(a))


@pytest.mark.parametrize("name", ["neox_tiny", "stablelm_smoke"])
def test_engine_state_carries_over_for_the_new_leaves(name):
    """The reference engine's flat m/h shards over the untied and SwiGLU
    trees have the port layout's sizes, so ``engine_state_from_jax``
    carries them over unchanged."""
    from repro.train import TrainerConfig as JTrainerConfig
    from repro.train import make_engine as jax_make_engine
    from repro_torch.convert import engine_state_from_jax
    from repro_torch.core import build_layout
    cfg = {"neox_tiny": NEOX_TINY,
           "stablelm_smoke": jax_get_config("stablelm-1.6b", smoke=True)}[name]
    jp = jax_get_model(cfg).init_params(cfg, jax.random.PRNGKey(0))
    engine = jax_make_engine(JTrainerConfig())
    rng = np.random.default_rng(0)
    jstate = engine.init(jp)
    jstate = jstate._replace(m=tuple(jnp.asarray(rng.standard_normal(
        m.shape).astype(np.float32)) for m in jstate.m))
    tparams = params_from_jax(jax.tree.map(np.asarray, jp), _t(cfg))
    got = engine_state_from_jax(jax.tree.map(np.asarray, jstate),
                                build_layout(tparams.param_tree()))
    for t, j in zip(got.m + got.h, jstate.m + jstate.h):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_configs_match_reference():
    """NEOX_1_5B, NEOX_6_6B and stablelm-1.6b field for field; NeoX is
    not in ``ARCHS``, as in the reference."""
    from repro.configs import ARCHS as JARCHS
    from repro.configs.gpt2 import NEOX_6_6B
    from repro_torch.configs import ARCHS
    pairs = [(NEOX_1_5B, T_NEOX_1_5B), (NEOX_6_6B, T_NEOX_6_6B),
             (jax_get_config("stablelm-1.6b"), get_config("stablelm-1.6b")),
             (jax_get_config("stablelm-1.6b", smoke=True),
              get_config("stablelm-1.6b", smoke=True))]
    for ref, port in pairs:
        assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    assert set(ARCHS) <= set(JARCHS)
    assert not any("neox" in k for k in ARCHS)


# ---------------------------------------------------------------------------
# the CE plain versions, untied, at NeoX-1.5B's width

D_WIDE, VOCAB_WIDE, VP_WIDE = 1536, 1000, 1024


def _wide(seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((3, 16, D_WIDE)).astype(np.float32)
    w = (rng.standard_normal((D_WIDE, VP_WIDE)) / np.sqrt(D_WIDE)
         ).astype(np.float32)
    labels = rng.integers(0, VOCAB_WIDE, (3, 16)).astype(np.int32)
    mask = (rng.random((3, 16)) > 0.3).astype(np.float32)
    return h, w, labels, mask


@pytest.mark.parametrize("impl", ["fused", "fused_jvp", "chunked"])
def test_untied_plain_loss_and_grads_at_d1536(impl):
    """The CPU plain versions behind every loss route with the untied
    (D, Vp) W at D = 1536 (padded vocab, masked rows) against the
    reference's closed-form oracle: loss, d(hidden) and dW within 3e-6,
    the reference tests' fp32 bound; the padded columns of dW exactly 0."""
    h, w, labels, mask = _wide()
    loss_r, dh_r, dw_r = lm_loss_grads_ref(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(labels),
        jnp.asarray(mask), vocab_size=VOCAB_WIDE, transpose_w=True)
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    route = {"fused": ce.fused_lm_loss, "fused_jvp": ce.fused_lm_loss_jvp,
             "chunked": ce.chunked_lm_loss}[impl]
    loss, n = route(th, tw, torch.from_numpy(labels), torch.from_numpy(mask),
                    vocab_size=VOCAB_WIDE, transpose_w=True)
    loss.backward()
    assert float(n) == mask.sum()
    np.testing.assert_allclose(loss.item(), float(loss_r), atol=3e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(dh_r), atol=3e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw_r), atol=3e-6)
    assert (tw.grad.numpy()[:, VOCAB_WIDE:] == 0).all()


def test_untied_plain_sampled_loss_at_d1536():
    """The sampled forward's plain version, untied at D = 1536, on the
    reference's noise seed: the same labels as the oracle's draw, and
    the NLL and its gradients within 3e-6."""
    h, w, _, mask = _wide(1)
    key = jax.random.PRNGKey(5)
    loss_r, y_r, dh_r, dw_r = lm_loss_sampled_ref(
        jnp.asarray(h), jnp.asarray(w), key, jnp.asarray(mask),
        vocab_size=VOCAB_WIDE, transpose_w=True)
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    h2 = th.detach().reshape(-1, D_WIDE)
    _, _, y = ce.ce_forward_sampled(h2, tw.detach(), None,
                                    np.asarray(seed_from_key(key)),
                                    vocab=VOCAB_WIDE, transpose_w=True)
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_r).reshape(-1))
    loss, _ = ce.fused_lm_loss_sampled(th, tw, np.asarray(seed_from_key(key)),
                                       torch.from_numpy(mask),
                                       vocab_size=VOCAB_WIDE,
                                       transpose_w=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_r), atol=3e-6)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(dh_r), atol=3e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw_r), atol=3e-6)


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("h_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [1536, 2048, 4096])
def test_kernel_args_take_the_neox_and_stablelm_widths(D, h_dtype, tied):
    """D 1536 (NeoX-1.5B), 2048 (stablelm-1.6b) and 4096 (NeoX-6.6B) pass
    the CUDA route's checks for both h dtypes and both W layouts (the
    fp32-h backward works in D-slabs since, and the tensor-core route's
    shared memory never depended on D); a width off the 128 tile still
    raises."""
    h = torch.zeros(8, D, dtype=h_dtype)
    w = torch.zeros((256, D) if tied else (D, 256))
    ce.check_kernel_args(h, w, torch.zeros(2, D), transpose_w=not tied,
                         norm="ln")
    with pytest.raises(ValueError, match="multiple of 128"):
        ce.check_kernel_args(torch.zeros(8, D + 64, dtype=h_dtype),
                             torch.zeros(256, D + 64),
                             torch.zeros(2, D + 64), transpose_w=False,
                             norm=None)
