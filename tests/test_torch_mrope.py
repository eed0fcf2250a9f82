"""M-RoPE and the patch-embedding input of qwen2-vl-7b held against the
JAX reference: ``apply_rope`` with sections, and qwen2-vl-7b's smoke
config (fp32, the reference's weights carried across by
``params_from_jax`` with every all-zero leaf, the QKV biases and the
RMSNorm scales, drawn from a seed so that it shows; numpy inputs) on a
batch in Qwen2-VL's layout (``chip_smoke.vlm_batch``: patch embeddings
over the first positions, the loss mask 0 there, and (B, 3, S) positions
whose three streams differ, since with three equal streams M-RoPE is
plain rope): forward logits, the loss on the fused, chunked and unfused
routes with every gradient (``patch_proj`` among them), the sampled loss,
text-only batches, Sophia-G trainer steps and a Hutchinson refresh, and
checkpoints both ways.  The smoke head dim (16) is below what the
reference's flash kernel takes, so both sides attend on the
materialized-scores route."""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _rope_models import tcfg, trajectories
from repro.configs import get_config as jax_get_config
from repro.kernels.fused_ce import seed_from_key
from repro.models import get_model as jax_get_model
from repro.models import layers as jl
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import checkpoint as jax_checkpoint
from repro.train import make_train_fns as jax_make_train_fns
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import subsample_batch
from repro_torch.core.types import flat_tensors, leaf_shape, tree_leaves
from repro_torch.models import check_supported, get_model
from repro_torch.models import layers as tl
from repro_torch.train import TrainerConfig, checkpoint, make_train_fns
from repro_torch.train.trainer import to_device_batch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import VLMSource, vlm_batch  # noqa: E402

torch.set_num_threads(1)

NAME = "qwen2-vl-7b"
# fp32 sums over D = 64 and 2 layers in other orders: losses and gradients
# within 3e-6, the rope tests' bound; the untied logits also get 1e-6 of
# the largest one, as the dense configs' (tests/test_torch_dense_features.py)
ATOL = 3e-6
LOGIT_RTOL = 1e-6
# the smoke batch: 16 patches on a 4-wide lattice, then 24 text tokens
B, S, P, GRID = 2, 40, 16, 4


def _cfg(**over):
    return dataclasses.replace(jax_get_config(NAME, smoke=True),
                               **{"dtype": "float32", **over})


def _seeded_zeros(params, seed=3):
    """The reference tree with every all-zero leaf (QKV biases, RMSNorm
    scales) drawn from N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)

    def fill(x):
        x = np.asarray(x)
        if np.any(x):
            return jnp.asarray(x)
        return jnp.asarray((0.1 * rng.standard_normal(x.shape))
                           .astype(x.dtype))
    return jax.tree.map(fill, params)


@pytest.fixture(scope="module")
def model():
    """(reference config, reference params, the port's params)."""
    cfg = _cfg()
    params = _seeded_zeros(jax_get_model(cfg).init_params(
        cfg, jax.random.PRNGKey(0)))
    return cfg, params, params_from_jax(jax.tree.map(np.asarray, params),
                                        tcfg(cfg))


def _batch(cfg, seed=1, text_only=False):
    out = vlm_batch(cfg, B, S, seed, P, GRID)
    if text_only:
        out = {k: out[k] for k in ("tokens", "labels")}
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _assert_grads(tparams, loss, jgrads, atol):
    tree = tparams.param_tree()
    grads = iter(torch.autograd.grad(loss, flat_tensors(tree),
                                     materialize_grads=True))
    for leaf, want in zip(tree_leaves(tree), jax.tree.leaves(jgrads)):
        got = (torch.stack([next(grads) for _ in leaf])
               if isinstance(leaf, list) else next(grads))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


# ---------------------------------------------------------------------------
# M-RoPE alone


def _to_torch(x):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sections", [(2, 3, 3), (16, 24, 24)])
def test_apply_rope_sections_match_reference(sections, dtype):
    """x (2, 48, 4, hd) rotated by three different position streams drawn
    up to 2047: the smoke config's sections (hd 16) and qwen2-vl-7b's
    (hd 128, theta 1e6).  The bounds of the plain rope test
    (tests/test_torch_rope.py: XLA's and PyTorch's CPU cos and sin differ
    by an fp32 ulp on some angles): fp32 within 2e-6, bf16 within one bf16
    ulp beyond that."""
    hd = 2 * sum(sections)
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 48, 4, hd)).astype(np.float32)
    pos = rng.integers(0, 2048, (2, 3, 48)).astype(np.int32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    want = np.asarray(jl.apply_rope(jx, jnp.asarray(pos), 1e6, sections)
                      .astype(jnp.float32))
    got = tl.apply_rope(_to_torch(jx), torch.from_numpy(pos), 1e6, sections)
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=2e-6)
        assert (got == want).mean() > 0.99


def test_equal_streams_are_plain_rope_and_the_layout_differs():
    """With three equal streams M-RoPE is plain rope bit for bit, so a
    check on default positions says nothing about the sections; the
    smoke batch's streams differ over the patches (t = 0, h and w on the
    lattice) and move each section by its own stream."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((1, S, 2, 16))
                         .astype(np.float32))
    flat = torch.arange(S)[None]
    same = tl.apply_rope(x, flat[:, None].expand(1, 3, S), 1e4, (2, 3, 3))
    assert torch.equal(same, tl.apply_rope(x, flat, 1e4))
    pos = torch.from_numpy(vlm_batch(_cfg(), 1, S, 0, P, GRID)["positions"])
    assert not torch.equal(pos[:, 0], pos[:, 1])
    assert not torch.equal(pos[:, 1], pos[:, 2])
    assert pos[0, :, P:].eq(pos[0, 0, P:]).all()        # text: one stream
    assert not torch.equal(tl.apply_rope(x, pos, 1e4, (2, 3, 3)), same)


def test_check_supported_takes_qwen2_vl():
    """qwen2-vl-7b is in ``ARCHS`` with the reference's configs, field for
    field, and passes ``check_supported``; sections that do not cover the
    rotary half of the head dim raise."""
    assert NAME in ARCHS
    for smoke in (False, True):
        cfg = get_config(NAME, smoke=smoke)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jax_get_config(NAME, smoke=smoke))
        check_supported(cfg)
    with pytest.raises(ValueError, match="mrope_sections"):
        check_supported(dataclasses.replace(get_config(NAME, smoke=True),
                                            mrope_sections=(2, 3, 2)))


# ---------------------------------------------------------------------------
# the smoke config


def test_parameter_tree_is_the_reference_tree(model):
    """The same leaves in the same sorted order and shapes, ``patch_proj``
    (D, D) last, after ``layers``; ``params_from_jax`` raises on a
    top-level key it does not know rather than dropping it."""
    cfg, params, tparams = model
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = tree_leaves(tparams.param_tree())
    assert len(got) == len(want)
    for leaf, (path, ref) in zip(got, want):
        assert leaf_shape(leaf) == ref.shape, jax.tree_util.keystr(path)
    assert jax.tree_util.keystr(want[-1][0]) == "['patch_proj']"
    assert got[-1] is tparams.patch_proj
    np_params = dict(jax.tree.map(np.asarray, params))
    with pytest.raises(ValueError, match="vision"):
        params_from_jax(dict(np_params, vision=np.zeros(2)), tcfg(cfg))
    fresh = get_model(tcfg(cfg)).init_params(tcfg(cfg),
                                             torch.Generator().manual_seed(0))
    assert [leaf_shape(x) for x in tree_leaves(fresh.param_tree())] == \
        [leaf_shape(x) for x in got]


@pytest.mark.parametrize("text_only", [False, True])
def test_forward_logits_match_reference(model, text_only):
    """With patch embeddings and the (B, 3, S) layout, and text-only with
    the default positions (0..S-1 broadcast to the three streams)."""
    cfg, params, tparams = model
    jb, tb = _batch(cfg, text_only=text_only)
    want, _ = jax_get_model(cfg).forward(
        cfg, params, jb["tokens"], positions=jb.get("positions"),
        patch_embeds=jb.get("patch_embeds"), attn_impl="full")
    got, _ = get_model(tcfg(cfg)).forward(
        tcfg(cfg), tparams, tb["tokens"], positions=tb.get("positions"),
        patch_embeds=tb.get("patch_embeds"), attn_impl="full")
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=ATOL + LOGIT_RTOL * np.abs(want).max())


@pytest.mark.parametrize("impl", ["fused", "chunked", "unfused"])
def test_loss_and_grads_match_reference(model, impl):
    """The masked-mean CE (the patch positions masked out) on each loss
    route: loss and every gradient, ``patch_proj``'s among them, within
    3e-6."""
    cfg, params, tparams = model
    jb, tb = _batch(cfg)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_get_model(cfg).loss_fn(cfg, p, jb, loss_impl=impl,
                                             attn_impl="full"),
        has_aux=True)(params)
    assert np.abs(np.asarray(jgrads["patch_proj"])).max() > 0
    loss, _ = get_model(tcfg(cfg)).loss_fn(tcfg(cfg), tparams, tb,
                                           loss_impl=impl, attn_impl="full")
    np.testing.assert_allclose(loss.item(), float(jloss), atol=ATOL)
    _assert_grads(tparams, loss, jgrads, ATOL)


def test_text_only_loss_gives_patch_proj_a_zero_gradient(model):
    """A text-only batch (the launchers' synthetic data) never reaches
    ``patch_proj``: its gradient is zeros on both sides, the rest within
    3e-6."""
    cfg, params, tparams = model
    jb, tb = _batch(cfg, text_only=True)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jax_get_model(cfg).loss_fn(cfg, p, jb, attn_impl="full"),
        has_aux=True)(params)
    loss, _ = get_model(tcfg(cfg)).loss_fn(tcfg(cfg), tparams, tb,
                                           attn_impl="full")
    np.testing.assert_allclose(loss.item(), float(jloss), atol=ATOL)
    assert not np.asarray(jgrads["patch_proj"]).any()
    _assert_grads(tparams, loss, jgrads, ATOL)


def test_sampled_loss_matches_reference(model):
    """GNB's sampled NLL on the reference's noise seed over the patch
    batch: the same draws, the NLL, its count of valid positions and ĝ
    within 3e-6."""
    cfg, params, tparams = model
    jb, tb = _batch(cfg, seed=2)
    key = jax.random.PRNGKey(11)
    (jnll, jn), jgrads = jax.value_and_grad(
        lambda p: jax_get_model(cfg).sampled_loss_fn(
            cfg, p, jb, key, loss_impl="fused", attn_impl="full"),
        has_aux=True)(params)
    nll, n = get_model(tcfg(cfg)).sampled_loss_fn(
        tcfg(cfg), tparams, tb, np.asarray(seed_from_key(key)),
        attn_impl="full")
    assert float(n) == float(jn) == B * (S - P)
    np.testing.assert_allclose(nll.item(), float(jnll), atol=ATOL)
    _assert_grads(tparams, nll, jgrads, ATOL)


def test_flash_and_chunked_routes_agree(model):
    """The port's flash (plain version on the CPU) and chunked routes give
    the materialized route's hidden state under M-RoPE with patches
    (softmax sums in other orders: within 1e-5)."""
    cfg, _, tparams = model
    _, tb = _batch(cfg)
    kw = dict(positions=tb["positions"], patch_embeds=tb["patch_embeds"])
    fh = get_model(tcfg(cfg)).forward_hidden
    ref, _ = fh(tcfg(cfg), tparams, tb["tokens"], attn_impl="full", **kw)
    for impl in ("flash", "chunked"):
        got, _ = fh(tcfg(cfg), tparams, tb["tokens"], attn_impl=impl, **kw)
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# training


def test_trainer_batches_carry_patches_and_positions():
    """``to_device_batch`` keeps ``patch_embeds`` (B, P, D) fp32 and the
    (B, 3, S) int positions; the estimator's ``subsample_batch`` slices
    every entry on the batch axis."""
    cfg = _cfg()
    batch = to_device_batch(vlm_batch(cfg, 4, S, 0, P, GRID), "cpu")
    assert batch["patch_embeds"].dtype == torch.float32
    assert tuple(batch["patch_embeds"].shape) == (4, P, cfg.d_model)
    assert tuple(batch["positions"].shape) == (4, 3, S)
    sub = subsample_batch(batch, 2)
    for key, value in sub.items():
        assert torch.equal(value, batch[key][:2]), key


def _source(cfg):
    return VLMSource(cfg, 4, S, 0, P, GRID)


def test_sophia_g_trajectory_matches_reference_trainer():
    """5 Sophia-G steps on patch batches, the GNB refresh at 0 and 4 (the
    fused loss, the reference's noise seeds), from the seeded weights:
    the trajectory contract of tests/test_torch_train.py, equal refresh
    counts, losses to rtol 1e-4 / atol 1e-5, every parameter coordinate
    within 2e-3 and >= 99.95% of them within 3e-6 + 1e-5 |a|, m and h
    within 2e-3."""
    cfg = _cfg()
    params = _seeded_zeros(jax_get_model(cfg).init_params(
        cfg, jax.random.PRNGKey(0)))
    hist, hist_ref, a, b, s_port, s_ref = trajectories(
        cfg, "full", dict(optimizer="sophia_g"), 5, params=params,
        source=_source(cfg))
    assert int(s_port.opt_state.hess_count) == \
        int(s_ref.opt_state.hess_count) == 2
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in hist_ref], rtol=1e-4,
                               atol=1e-5)
    bad = np.abs(b - a) > (3e-6 + 1e-5 * np.abs(a))
    assert bad.mean() <= 5e-4, f"{bad.sum()} / {bad.size} beyond 3e-6"
    np.testing.assert_allclose(b, a, rtol=1e-2, atol=2e-3)
    for x, y in zip(s_port.opt_state.m + s_port.opt_state.h,
                    s_ref.opt_state.m + s_ref.opt_state.h):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-2,
                                   atol=2e-3)


def test_hutchinson_refresh_through_mrope_and_patches():
    """One Sophia-H step with the Hutchinson refresh on a patch batch: its
    HVP runs forward-over-reverse through M-RoPE and ``patch_proj`` on the
    reference's probe.  The loss within 1e-5 and the refreshed h within
    1e-4 of its largest element, the bound of the rope models' case
    (tests/test_torch_neox.py)."""
    cfg = _cfg()
    params = _seeded_zeros(jax_get_model(cfg).init_params(
        cfg, jax.random.PRNGKey(0)))
    hist, hist_ref, _, _, s_port, s_ref = trajectories(
        cfg, "full", dict(optimizer="sophia_h", estimator="hutchinson"), 1,
        params=params, source=_source(cfg))
    np.testing.assert_allclose(hist[0]["loss"], hist_ref[0]["loss"],
                               atol=1e-5)
    for x, y in zip(s_port.opt_state.h, s_ref.opt_state.h):
        y = np.asarray(y)
        assert np.abs(y).max() > 0
        np.testing.assert_allclose(x.numpy(), y, rtol=0,
                                   atol=1e-4 * np.abs(y).max())


# ---------------------------------------------------------------------------
# checkpoints


TRAIN = dict(optimizer="sophia_g", peak_lr=5e-4, total_steps=64,
             warmup_steps=4, hess_interval=4, hess_subbatch=2,
             fused_attn=False, seed=0)


def _port_trained(cfg, steps=2):
    """The port's trainer after ``steps`` steps on patch batches."""
    init_fn, step = make_train_fns(tcfg(cfg), TrainerConfig(**TRAIN),
                                   device="cpu")
    state = init_fn()
    for t in range(steps):
        batch = to_device_batch(_source(cfg).batch_at(t), "cpu")
        state, _ = step(state, batch, t % TRAIN["hess_interval"] == 0)
    return state


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """The port's checkpoint after 2 steps on patch batches: the
    reference's ``restore`` reads every leaf back bit for bit,
    ``patch_proj`` in its sorted place after the layers, with the shapes
    and dtypes its own manifest would list."""
    cfg = _cfg()
    state = _port_trained(cfg)
    checkpoint.save(str(tmp_path), 2, state)
    like = jax_make_train_fns(cfg, JTrainerConfig(**TRAIN))[0](
        jax.random.PRNGKey(0))
    ref, step = jax_checkpoint.restore(str(tmp_path), like)
    assert step == 2
    got = [arr for arr, _ in checkpoint._state_leaves(state)]
    want = jax.tree.leaves(ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(w), g)
    np.testing.assert_array_equal(np.asarray(ref.params["patch_proj"]),
                                  state.params.patch_proj.detach().numpy())


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    """The reference's checkpoint after 2 steps on patch batches restores
    into a fresh port state, every leaf bit for bit, ``patch_proj``
    included."""
    cfg = _cfg()
    init_fn, step = jax_make_train_fns(cfg, JTrainerConfig(**TRAIN))
    state = init_fn(jax.random.PRNGKey(0))
    for t in range(2):
        batch = {k: jnp.asarray(v) for k, v in _source(cfg).batch_at(t)
                 .items()}
        state, _ = jax.jit(step)(state, batch, t % TRAIN["hess_interval"]
                                 == 0)
    jax_checkpoint.save(str(tmp_path), 2, state)
    fresh = make_train_fns(tcfg(cfg), TrainerConfig(**TRAIN),
                           device="cpu")[0]()
    restored, at = checkpoint.restore(str(tmp_path), fresh)
    assert at == 2
    got = [arr for arr, _ in checkpoint._state_leaves(restored)]
    want = jax.tree.leaves(state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.tobytes() == np.asarray(w).tobytes()
    np.testing.assert_array_equal(restored.params.patch_proj.detach().numpy(),
                                  np.asarray(state.params["patch_proj"]))
