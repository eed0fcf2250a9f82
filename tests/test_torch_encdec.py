"""The encoder-decoder family held against the JAX reference
(``repro.models.encdec``) on seamless-m4t-medium's smoke config (d 64,
2 + 2 layers, hd 16, frames of 20 against 12 target tokens), fp32 unless a
case says bf16: the config and ``check_supported``, the parameter tree,
the engine layout and the reference's parameter count (C9), the
conversion's refusals, the encoder on every attention route, the logits,
the loss and every gradient on three routes, the sampled loss, remat, and
cross-attention's unrotated q.  The reference's weights cross by
``params_from_jax``; inputs come from numpy seeds."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _encdec_models import (ARCH, assert_close, batch, encdec_cfg,
                            port_params, ref_params)
from _rope_models import tcfg
from _rwkv_models import REF_BF16
from repro.configs import get_config as jax_get_config
from repro.core.engine import build_layout as jax_build_layout
from repro.core.engine import ravel_shards as jax_ravel_shards
from repro.kernels.fused_ce import seed_from_key
from repro.models import encdec as je
from repro.models import layers as jl
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import build_layout, ravel_shards
from repro_torch.core.types import flat_tensors, tree_leaves
from repro_torch.models import check_supported, get_model
from repro_torch.models import encdec as te
from repro_torch.models import layers as tl

torch.set_num_threads(1)


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module")
def model():
    """(reference config fp32, reference params, the port's params)."""
    cfg = encdec_cfg()
    params = ref_params(cfg)
    return cfg, params, port_params(cfg, params)


# ---------------------------------------------------------------------------
# the config, check_supported, the tree


@pytest.mark.parametrize("smoke", [False, True])
def test_config_is_the_reference_config(smoke):
    """seamless-m4t-medium, full and smoke, is in ``ARCHS``, passes
    ``check_supported`` and is the reference's configuration field for
    field: bf16 compute, RMSNorm, rope theta 10000, GELU with biases, tied
    embeddings; the full config's vocabulary 256,206 pads to 256,256."""
    assert ARCH in ARCHS
    cfg = get_config(ARCH, smoke=smoke)
    check_supported(cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_get_config(ARCH, smoke=smoke))
    assert cfg.compute_dtype == torch.bfloat16
    assert (cfg.norm_type, cfg.rope_theta, cfg.activation) == \
        ("rms", 10000.0, "gelu")
    assert cfg.tie_embeddings and cfg.family == "encdec"
    if not smoke:
        assert cfg.padded_vocab == 256256
    assert set(get_model(cfg).__dict__) >= {
        "init_params", "forward_hidden", "forward", "loss_fn",
        "sampled_loss_fn", "logits_fn", "init_cache", "prefill_encoder",
        "decode_step", "init_slots", "prefill_encoder_slot",
        "prefill_into_slot", "decode_slots", "reset_slot"}


@pytest.mark.parametrize("field,value", [("learned_pos", True),
                                         ("mrope_sections", (2, 3, 3)),
                                         ("n_encoder_layers", 0),
                                         ("n_layers", 0)])
def test_check_supported_refuses_what_the_reference_fails_on(field, value):
    """Learned positions (the decoder embeds none, which the reference's
    table asserts on), M-RoPE sections (the encoder rotates by one (B, S)
    stream, which the sections index as three) and an empty encoder or
    decoder stack raise ``ValueError`` naming the field; ``norm_type`` is
    not read (every norm is RMSNorm)."""
    cfg = get_config(ARCH, smoke=True)
    check_supported(dataclasses.replace(cfg, norm_type="other"))
    with pytest.raises(ValueError, match=field):
        check_supported(dataclasses.replace(cfg, **{field: value}))


def test_parameter_tree_is_the_reference_tree(model):
    """The same leaves in the same sorted order and shapes, bit for bit:
    ``embed/tok``, ``frame_proj``, ``encoder`` (``attn``, ``ln1``, ``ln2``,
    ``mlp`` stacked over the encoder's layers), ``enc_norm``, ``decoder``
    (``cross_attn``, ``ln1``, ``ln2``, ``ln_x``, ``mlp``, ``self_attn``),
    ``final_norm``; the engine's layout over it is the reference's
    ``build_layout``, its shards bit for bit."""
    cfg, params, tparams = model
    tree = tparams.param_tree()
    assert sorted(tree) == sorted(params) == [
        "decoder", "embed", "enc_norm", "encoder", "final_norm",
        "frame_proj"]
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = tree_leaves(tree)
    assert len(got) == len(want)
    for leaf, (path, ref) in zip(got, want):
        arr = torch.stack(leaf) if isinstance(leaf, list) else leaf
        assert tuple(arr.shape) == ref.shape, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(_np(arr), np.asarray(ref))
    ref, lay = jax_build_layout(params, block=128), build_layout(tree,
                                                                 block=128)
    assert lay.leaf_shapes == ref.leaf_shapes and lay.manifest() == \
        ref.manifest()
    for a, b in zip(ravel_shards(lay, tree), jax_ravel_shards(ref, params)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def _reference_leaves(cfg):
    """{path: size} of the reference's ``init_params`` tree, from its
    shapes alone."""
    shapes = jax.eval_shape(lambda: je.init_params(cfg, jax.random.PRNGKey(0)))
    return {jax.tree_util.keystr(p): int(np.prod(x.shape))
            for p, x in jax.tree_util.tree_flatten_with_path(shapes)[0]}


@pytest.mark.parametrize("smoke", [False, True])
def test_param_count_gap_is_c9(smoke):
    """The reference's ``param_count`` (which the port keeps, so that both
    packages count alike) leaves out, leaf by leaf: ``frame_proj`` (D^2),
    the GELU MLP's biases (F + D a layer), the norms (two an encoder
    layer, three a decoder layer, two final) and the padded vocabulary's
    rows ((Vp - V) D).  seamless-m4t-medium has 615,962,624 parameters;
    the formula gives 614,676,480, 1,286,144 fewer (1,048,576 + 122,880 +
    63,488 + 51,200)."""
    cfg = jax_get_config(ARCH, smoke=smoke)
    sizes = _reference_leaves(cfg)
    n = sum(sizes.values())
    assert get_config(ARCH, smoke=smoke).param_count() == cfg.param_count()
    D, F, L, Le = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.n_encoder_layers
    parts = {
        "frame_proj": sizes["['frame_proj']"],
        "mlp biases": sum(s for p, s in sizes.items() if "'b_" in p),
        "norms": sum(s for p, s in sizes.items() if "scale" in p),
        "padded vocabulary": (cfg.padded_vocab - cfg.vocab_size) * D}
    assert parts == {"frame_proj": D * D, "mlp biases": (Le + L) * (F + D),
                     "norms": (2 * Le + 3 * L + 2) * D,
                     "padded vocabulary": (cfg.padded_vocab
                                           - cfg.vocab_size) * D}
    assert n == cfg.param_count() + sum(parts.values())
    if not smoke:
        assert (n, cfg.param_count()) == (615_962_624, 614_676_480)
        assert parts == {"frame_proj": 1_048_576, "mlp biases": 122_880,
                         "norms": 63_488, "padded vocabulary": 51_200}


def test_params_from_jax_refuses_unknown_keys_and_shapes(model):
    """A top-level key, a leaf inside a layer, a leaf of another shape, or
    a stack of another depth raises."""
    cfg, params, _ = model
    np_params = jax.tree.map(np.asarray, params)
    with pytest.raises(ValueError, match="top-level"):
        params_from_jax(dict(np_params, layers={}), tcfg(cfg))
    enc = dict(np_params["encoder"], extra={"x": np.zeros((2, 3))})
    with pytest.raises(ValueError, match="leaves"):
        params_from_jax(dict(np_params, encoder=enc), tcfg(cfg))
    dec = dict(np_params["decoder"],
               ln_x={"scale": np.zeros((2, 7), np.float32)})
    with pytest.raises(ValueError, match="leaves"):
        params_from_jax(dict(np_params, decoder=dec), tcfg(cfg))
    with pytest.raises(ValueError, match="frame_proj"):
        params_from_jax(dict(np_params, frame_proj=np.zeros((3, 3))),
                        tcfg(cfg))
    deep = jax.tree.map(lambda a: np.concatenate([a, a]),
                        np_params["decoder"])
    with pytest.raises(ValueError, match="layers"):
        params_from_jax(dict(np_params, decoder=deep), tcfg(cfg))


# ---------------------------------------------------------------------------
# the model functions


@functools.lru_cache(maxsize=None)
def _ref_encode():
    cfg = encdec_cfg()
    jb, _ = batch(cfg)
    return np.asarray(jax.jit(lambda p: je.encode(
        cfg, p, jb["frames"], attn_impl="full"))(ref_params(cfg)))


@pytest.mark.parametrize("attn_impl", ["full", "chunked", "flash",
                                       "flash_jvp"])
def test_encode_matches_reference(model, attn_impl):
    """The encoder (frames cast before ``frame_proj``, bidirectional
    attention rotated by 0..S_src - 1, the final ``enc_norm``) over 20
    frames on the materialized, chunked, flash and flash-twin routes,
    against the reference's: within 1e-5 of the largest element."""
    cfg, params, tparams = model
    _, tb = batch(cfg)
    got = te.encode(tcfg(cfg), tparams, tb["frames"], attn_impl=attn_impl)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 20, 64)
    assert_close(got, _ref_encode(), what=f"encode {attn_impl}")


# bf16: through 2 + 2 layers the port's logits lie 0.88% of the largest
# from the reference's compiled with excess precision off (REF_BF16),
# where bf16 itself moves the reference's 1.1% from its fp32 logits: each
# is held within 2^-5 of its largest element (the Griffin family's bf16
# bound), and the port's bf16 logits as near the reference's fp32 ones as
# the reference's bf16 (RMS, within 1.5x).
BF16_RTOL = 2.0 ** -5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_reference(model, dtype):
    """``forward``'s logits over 12 target tokens and 20 frames (S_src !=
    S_tgt) on the flash route, and aux 0: fp32 within 1e-5 of the largest
    element of the reference's, bf16 within BF16_RTOL."""
    cfg, params, tparams = model
    cfg = dataclasses.replace(cfg, dtype=dtype)
    jb, tb = batch(cfg)
    got, aux = te.forward(tcfg(cfg), tparams, tb["tokens"],
                          frames=tb["frames"], attn_impl="flash")
    assert float(aux) == 0.0 and tuple(got.shape) == (2, 12, 512)
    want = jax.jit(lambda p: je.forward(cfg, p, jb["tokens"],
                                        frames=jb["frames"])[0],
                   compiler_options=REF_BF16 if dtype == "bfloat16"
                   else None)(params)
    assert_close(got, want, BF16_RTOL if dtype == "bfloat16" else 1e-5,
                 "logits")
    if dtype == "bfloat16":
        f32 = np.asarray(je.forward(encdec_cfg(), params, jb["tokens"],
                                    frames=jb["frames"])[0])

        def rms(a):
            return float(np.sqrt(np.mean(np.square(a))))

        assert rms(_np(got) - f32) <= 1.5 * rms(np.asarray(want) - f32)


def _assert_grads(tparams, loss, grads, rtol=1e-5):
    """Every leaf's gradient non-zero in the reference and within ``rtol``
    of its largest element."""
    tree = tparams.param_tree()
    it = iter(torch.autograd.grad(loss, flat_tensors(tree)))
    for leaf, (path, want) in zip(
            tree_leaves(tree), jax.tree_util.tree_flatten_with_path(grads)[0]):
        got = (torch.stack([next(it) for _ in leaf])
               if isinstance(leaf, list) else next(it))
        assert np.abs(np.asarray(want)).max() > 0, jax.tree_util.keystr(path)
        assert_close(got, want, rtol, f"gradient {jax.tree_util.keystr(path)}")


@functools.lru_cache(maxsize=None)
def _ref_loss_and_grads(loss_impl, attn_impl):
    cfg = encdec_cfg()
    jb, _ = batch(cfg)
    return jax.jit(jax.value_and_grad(
        lambda q: je.loss_fn(cfg, q, jb, loss_impl=loss_impl,
                             attn_impl=attn_impl)[0]))(ref_params(cfg))


@pytest.mark.parametrize("loss_impl,attn_impl", [("fused", "flash"),
                                                 ("fused", "full"),
                                                 ("chunked", "chunked")])
def test_loss_and_grads_match_reference(model, loss_impl, attn_impl):
    """``loss_fn`` on the fused-kernel twin route (the final RMSNorm fused
    into the sweep) and the chunked route, over the flash kernels' plain
    versions, the materialized scores and the chunked online softmax
    (whose cross-attention takes the materialized route, as the
    reference's): the loss, aux 0 and every gradient within 1e-5 of the
    largest, ``frame_proj``'s and the encoder's (which reach them only
    through the cross-attention's K and V) included, against the
    reference's same route."""
    cfg, params, tparams = model
    _, tb = batch(cfg)
    jloss, jgrads = _ref_loss_and_grads(loss_impl, attn_impl)
    loss, met = te.loss_fn(tcfg(cfg), tparams, tb, attn_impl=attn_impl,
                           loss_impl=loss_impl)
    assert_close(loss.item(), jloss, what="loss")
    assert met["aux"].item() == 0.0 and met["ce"].item() == loss.item()
    _assert_grads(tparams, loss, jgrads)


def test_sampled_loss_matches_reference(model):
    """GNB's sampled NLL on the reference's noise seed (the fused route):
    the count, the NLL and every gradient."""
    cfg, params, tparams = model
    jb, tb = batch(cfg, seed=2)
    key = jax.random.PRNGKey(11)
    (jnll, jn), jgrads = jax.jit(jax.value_and_grad(
        lambda q: je.sampled_loss_fn(cfg, q, jb, key, loss_impl="fused",
                                     attn_impl="flash"),
        has_aux=True))(params)
    nll, n = te.sampled_loss_fn(tcfg(cfg), tparams, tb,
                                np.asarray(seed_from_key(key)),
                                attn_impl="flash")
    assert float(n) == float(jn)
    assert_close(nll.item(), jnll, what="nll")
    _assert_grads(tparams, nll, jgrads)


@pytest.mark.parametrize("remat,checkpoints", [("full", 4), ("dots", 0),
                                               ("scan2", 0)])
def test_remat_is_bit_identical(monkeypatch, remat, checkpoints):
    """"full" checkpoints each encoder and decoder layer, as the
    reference's ``jax.checkpoint`` of its two scan bodies; "dots" and
    "scan2" are inert in this family, as in the reference: no checkpoint
    at all.  The loss and every gradient equal those without remat, bit
    for bit."""
    import torch.utils.checkpoint as ckpt

    calls = []
    real = ckpt.checkpoint

    def counted(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(ckpt, "checkpoint", counted)
    cfg = tcfg(encdec_cfg())
    params = get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0))
    _, tb = batch(cfg)
    out = []
    for policy in ("none", remat):
        calls.clear()
        loss, _ = get_model(cfg).loss_fn(cfg, params, tb, remat=policy,
                                         attn_impl="flash")
        out.append([loss] + list(torch.autograd.grad(
            loss, flat_tensors(params.param_tree()))))
    assert len(calls) == checkpoints
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("impl", ["full", "flash", "flash_jvp"])
def test_cross_attention_q_is_not_rotated(model, impl):
    """Cross-attention (``kv_override``) projects q and leaves it
    unrotated, as the reference's ``_qkv`` does under an override, while
    rope is on: on each route the port's output equals the reference's
    ``full_attention`` with the override within 1e-5, and differs from the
    same attention with q rotated by its positions by more than 1e-2 of
    the largest element (so a rotated q fails here)."""
    cfg, params, tparams = model
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 12, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, 20, 4, 16)).astype(np.float32)
            for _ in range(2))
    p_ref = jax.tree.map(lambda a: a[0], params["decoder"])["cross_attn"]
    p = tparams.decoder[0]["cross_attn"]
    positions = jnp.broadcast_to(jnp.arange(12)[None], (2, 12))
    want = np.asarray(jl.full_attention(
        p_ref, jnp.asarray(x), cfg, positions, causal=False,
        kv_override=(jnp.asarray(k), jnp.asarray(v))))
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    got = tl.train_attention(p, torch.from_numpy(x), tcfg(cfg), causal=False,
                             kv_override=(tk, tv), impl=impl)
    assert_close(got, want, what=f"cross-attention {impl}")
    tpos = torch.arange(12)[None].expand(2, 12)
    q = tl.apply_rope(tl.cross_q(p, torch.from_numpy(x), tcfg(cfg)), tpos)
    rotated = tl._flash_attention_proj(p, torch.from_numpy(x), tcfg(cfg),
                                       qkv=(q, tk, tv), causal=False)
    gap = np.abs(_np(rotated) - want).max() / np.abs(want).max()
    assert gap > 1e-2
