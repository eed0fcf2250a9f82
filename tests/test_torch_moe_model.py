"""The MoE family's trunk held against the JAX reference: deepseek-moe-16b's
and llama4-maverick's smoke configs (every layer MoE; a (dense, MoE) pair
per group with llama4's interleaving) through ``forward``, ``loss_fn`` on
every loss route with every gradient, ``sampled_loss_fn``, ``logits_fn``
and every remat policy, and the optimizer engine's layout and state.
fp32, the reference's weights carried across by ``params_from_jax``,
numpy inputs.  The smoke head dim (16) is below what the reference's flash
kernel takes, so both sides attend on the materialized-scores route."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _moe_models import ATOL, LOGIT_RTOL, NAMES
from _moe_models import assert_grads as _assert_grads
from _moe_models import batch as _batch
from _moe_models import moe_cfg as _cfg
from _moe_models import ref_params as _ref_params
from _rope_models import tcfg
from repro.core.engine import build_layout as jax_build_layout
from repro.core.engine import ravel_shards as jax_ravel_shards
from repro.kernels.fused_ce import seed_from_key
from repro.models import get_model as jax_get_model
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import make_engine as jax_make_engine
from repro_torch.convert import engine_state_from_jax, params_from_jax
from repro_torch.core import build_layout, ravel_shards
from repro_torch.core.types import flat_tensors, tree_leaves
from repro_torch.models import get_model
from repro_torch.train import TrainerConfig, make_engine

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=NAMES)
def model(request):
    """(reference config, reference params, the port's params)."""
    cfg = _cfg(request.param)
    params = _ref_params(cfg)
    return cfg, params, params_from_jax(jax.tree.map(np.asarray, params),
                                        tcfg(cfg))


# ---------------------------------------------------------------------------
# the smoke models


def test_parameter_tree_is_the_reference_tree(model):
    """The same leaves in the same sorted order and shapes: ``moe/{router,
    shared/{...}, w_down, w_gate, w_up}`` stacked over the layers, or over
    the groups under ``dense`` and ``moe`` with llama4's interleaving."""
    cfg, params, tparams = model
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = tree_leaves(tparams.param_tree())
    assert len(got) == len(want)
    for leaf, (path, ref) in zip(got, want):
        shape = ((len(leaf),) + tuple(leaf[0].shape)
                 if isinstance(leaf, list) else tuple(leaf.shape))
        assert shape == ref.shape, jax.tree_util.keystr(path)
        assert np.array_equal(
            (torch.stack(leaf) if isinstance(leaf, list) else leaf)
            .detach().numpy(), np.asarray(ref)), jax.tree_util.keystr(path)
    names = [jax.tree_util.keystr(p) for p, _ in want]
    assert any("'shared'" in n and "'router'" not in n for n in names)
    assert any("'dense'" in n for n in names) is (cfg.moe_every > 1)


@pytest.mark.parametrize("temp", [False, True])
def test_forward_logits_and_aux_match_reference(model, temp):
    """The logits and the summed load-balance loss, llama4's with the
    temperature by layer as well (one value per group)."""
    cfg, params, tparams = model
    cfg = dataclasses.replace(cfg, attn_temperature_by_layer=temp)
    jb, tb = _batch(cfg)
    want, jaux = jax_get_model(cfg).forward(cfg, params, jb["tokens"],
                                            attn_impl="full")
    got, aux = get_model(tcfg(cfg)).forward(tcfg(cfg), tparams, tb["tokens"],
                                            attn_impl="full")
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want,
                               atol=ATOL + LOGIT_RTOL * np.abs(want).max())
    assert float(jaux) > 0
    np.testing.assert_allclose(aux.item(), float(jaux), atol=ATOL)
    lg = get_model(tcfg(cfg)).logits_fn(tcfg(cfg), tparams, tb,
                                        attn_impl="full")
    assert torch.equal(lg, got)


@pytest.mark.parametrize("impl", ["fused", "chunked", "unfused"])
def test_loss_and_grads_match_reference(model, impl):
    """ce + aux and each of them, and every gradient (the router's reach it
    through the gates and the aux's mean probabilities)."""
    cfg, params, tparams = model
    jb, tb = _batch(cfg)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jax_get_model(cfg).loss_fn(cfg, p, jb, loss_impl=impl,
                                             attn_impl="full"),
        has_aux=True)(params)
    loss, met = get_model(tcfg(cfg)).loss_fn(tcfg(cfg), tparams, tb,
                                             loss_impl=impl, attn_impl="full")
    np.testing.assert_allclose(loss.item(), float(jloss), atol=ATOL)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(met[key].item(), float(jmet[key]),
                                   atol=ATOL)
    _assert_grads(tparams, loss, jgrads)


def test_sampled_loss_leaves_aux_out(model):
    """GNB's sampled NLL on the reference's noise seed, without the
    load-balance term: the draws' count, the NLL and every gradient."""
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
    assert float(n) == float(jn)
    np.testing.assert_allclose(nll.item(), float(jnll), atol=ATOL)
    _assert_grads(tparams, nll, jgrads)


@pytest.mark.parametrize("remat", ["full", "dots", "scan2"])
@pytest.mark.parametrize("arch", NAMES)
def test_remat_is_bit_identical(arch, remat):
    """Each remat policy ("scan2": llama4's 4 layers in one group,
    deepseek's 2 in the plain loop): the loss, aux and every gradient
    equal those without remat, bit for bit."""
    cfg = tcfg(_cfg(arch))
    params = get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0))
    _, tb = _batch(cfg)
    out = []
    for policy in ("none", remat):
        loss, met = get_model(cfg).loss_fn(cfg, params, tb, remat=policy,
                                           attn_impl="flash")
        out.append([loss, met["aux"]] + list(torch.autograd.grad(
            loss, flat_tensors(params.param_tree()))))
    assert out[0][1] > 0
    for a, b in zip(*out):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the optimizer engine's layout and state


@pytest.mark.parametrize("block", [128, 128 * 1024])
def test_layout_and_state_match_reference(model, block):
    """``build_layout`` over the MoE tree (``dense`` < ``moe``; ``attn`` <
    ``ln1`` < ``ln2`` < ``moe``; ``router`` < ``shared`` < ``w_down`` <
    ``w_gate`` < ``w_up``) gives the reference's leaf order, offsets and
    shard sizes, the raveled parameters bit for bit, and the reference
    engine's state carries over to the port's engine as a plain copy."""
    cfg, params, tparams = model
    tree = tparams.param_tree()
    ref, lay = jax_build_layout(params, block=block), build_layout(
        tree, block=block)
    assert lay.leaf_shapes == ref.leaf_shapes
    assert lay.leaf_offset == ref.leaf_offset
    assert lay.shard_sizes == ref.shard_sizes
    assert lay.manifest() == ref.manifest()
    for a, b in zip(ravel_shards(lay, tree), jax_ravel_shards(ref, params)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    over = dict(optimizer="sophia_g", peak_lr=5e-4, total_steps=8)
    jeng = jax_make_engine(JTrainerConfig(**over))
    eng = make_engine(TrainerConfig(**over))
    assert eng.layout(tree).shard_sizes == jeng.layout(params).shard_sizes
    rng = np.random.default_rng(5)
    jstate = jeng.init(params)
    jstate = jstate._replace(
        m=tuple(jnp.asarray(rng.standard_normal(m.shape).astype(np.float32))
                for m in jstate.m))
    state = engine_state_from_jax(jax.tree.map(np.asarray, jstate),
                                  eng.layout(tree))
    for got, want in zip(state.m + state.h, jstate.m + jstate.h):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
