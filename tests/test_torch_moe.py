"""The MoE FFN held against the JAX reference: ``models/moe.py`` against
``repro.models.moe.moe_ffn_gspmd`` (slots, capacities, top-k ties, drops,
two dispatch groups, fp32 and bf16, the gradients of x and of every leaf)
for deepseek-moe-16b's and llama4-maverick's smoke widths (top 3 of 8
experts with 2 shared; top 1 of 8 with 1 shared), the fields of a MoE
config ``check_supported`` refuses, and the parameter counts.  The
reference's weights, numpy inputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _moe_models import ATOL, LOGIT_RTOL, NAMES
from _moe_models import moe_cfg as _cfg
from _rope_models import tcfg
from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro.models.transformer import layer_scales as jax_layer_scales
from repro.models.transformer import layer_windows as jax_layer_windows
from repro_torch.models import check_supported
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import layer_scales, layer_windows

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# slots and capacities


def test_slots_match_reference():
    """Each entry's rank among its expert's entries, in order: the
    reference's own case (tests/test_models.py) and random rows, one and
    several at a time."""
    e = np.array([0, 0, 0, 1, 0, 1, 2, 0], np.int32)
    assert tmoe._slots_in_group(torch.from_numpy(e)).tolist() == \
        [0, 1, 2, 0, 3, 1, 0, 4]
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 7, (3, 500)).astype(np.int32)
    want = np.stack([np.asarray(jmoe._slots_in_group(jnp.asarray(r)))
                     for r in rows])
    got = tmoe._slots_in_group(torch.from_numpy(rows).long())
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sg,k,e,f", [(8, 6, 64, 1.25), (4096, 6, 64, 1.25),
                                      (4096, 1, 128, 1.25), (80, 3, 8, 1.25),
                                      (1000, 2, 16, 1.0), (33, 1, 8, 2.0)])
def test_group_capacity_matches_reference(sg, k, e, f):
    assert tmoe._group_capacity(sg, k, e, f) == \
        jmoe._group_capacity(sg, k, e, f)


# ---------------------------------------------------------------------------
# moe_ffn against moe_ffn_gspmd


def _moe_inputs(cfg, T, seed=0, skew=0.0):
    """The reference's MoE weights and x (2, T/2, D) ~ N(0, 1) plus
    ``skew`` times one shared N(0, 1) vector, which makes every token
    prefer the same experts."""
    p = jmoe.init_moe(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, T // 2, cfg.d_model)).astype(np.float32)
    x += skew * rng.standard_normal(cfg.d_model).astype(np.float32)
    return p, x


def _ref_routing(p, x, cfg):
    """The reference's expert choices (T, k) and dropped-entry count, by
    its own code (moe.py:109-131)."""
    T = x.shape[0] * x.shape[1]
    xt = jnp.asarray(x).reshape(T, -1).astype(jnp.float32)
    probs = jax.nn.softmax(xt @ p["router"].astype(jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs, cfg.moe_top_k)
    gsz = min(jmoe.GROUP_SIZE, T)
    cg = jmoe._group_capacity(gsz, cfg.moe_top_k, cfg.n_experts,
                              cfg.capacity_factor)
    slot = jax.vmap(jmoe._slots_in_group)(
        idx.reshape(T // gsz, -1).astype(jnp.int32))
    return np.asarray(idx), int((np.asarray(slot) >= cg).sum())


def _port_moe(p, x, cfg, dtype=torch.float32, grad=False):
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a))
                      .requires_grad_(grad), p)
    tx = torch.from_numpy(x).to(dtype).requires_grad_(grad)
    with tmoe.record_routing() as calls:
        out, aux = tmoe.moe_ffn(tp, tx, tcfg(cfg))
    (rec,) = calls
    return tp, tx, out, aux, rec


@pytest.mark.parametrize("arch", NAMES)
def test_moe_ffn_matches_reference_fp32(arch):
    """The output, aux, the expert choices and the gradients of a weighted
    sum of the output plus aux with respect to x and every leaf, the
    router and the shared experts included."""
    cfg = _cfg(arch)
    p, x = _moe_inputs(cfg, 80)
    w = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def ref(p, x):
        out, aux = jmoe.moe_ffn_gspmd(p, x, cfg)
        return jnp.sum(out * w) + aux, (out, aux)

    (_, (jout, jaux)), jg = jax.value_and_grad(
        ref, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))
    tp, tx, out, aux, rec = _port_moe(p, x, cfg, grad=True)
    idx, dropped = _ref_routing(p, x, cfg)
    np.testing.assert_array_equal(rec["expert_idx"].numpy(), idx)
    assert int((~rec["keep"]).sum()) == dropped
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=ATOL)
    np.testing.assert_allclose(aux.item(), float(jaux), atol=ATOL)
    loss = (out * torch.from_numpy(w)).sum() + aux
    leaves = jax.tree.leaves(tp)
    grads = torch.autograd.grad(loss, leaves + [tx])
    for got, want in zip(grads, jax.tree.leaves(jg[0]) + [jg[1]]):
        want = np.asarray(want)
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(
            got.numpy(), want, atol=ATOL + LOGIT_RTOL * np.abs(want).max())


# bf16 activations: the router reads x exactly in fp32 (the same choices).
# The FFN rounds to bf16 at each product, the SwiGLU product, the gate and
# each of the k adds, as the reference's does but from products summed in
# other orders, so a value may land an ulp or two away at each rounding:
# the output and the gradient of x within 4 bf16 ulps of their largest
# element (2^-6 of it; the largest gaps seen are 2 ulps), aux (fp32)
# within 3e-6
BF16_REL = 2.0 ** -6


@pytest.mark.parametrize("arch", NAMES)
def test_moe_ffn_matches_reference_bf16(arch):
    cfg = _cfg(arch)
    p, x = _moe_inputs(cfg, 80, seed=1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)

    def ref(x):
        out, aux = jmoe.moe_ffn_gspmd(p, x, cfg)
        return jnp.sum(out.astype(jnp.float32)) + aux, (out, aux)

    (_, (jout, jaux)), jgx = jax.value_and_grad(ref, has_aux=True)(xb)
    _, tx, out, aux, rec = _port_moe(p, x, cfg, torch.bfloat16, grad=True)
    idx, _ = _ref_routing(p, np.asarray(xb.astype(jnp.float32)), cfg)
    np.testing.assert_array_equal(rec["expert_idx"].numpy(), idx)
    assert out.dtype == torch.bfloat16
    want = np.asarray(jout.astype(jnp.float32))
    np.testing.assert_allclose(out.detach().float().numpy(), want, rtol=0,
                               atol=BF16_REL * np.abs(want).max())
    np.testing.assert_allclose(aux.item(), float(jaux), atol=ATOL)
    (gx,) = torch.autograd.grad(out.float().sum() + aux, [tx])
    want = np.asarray(jgx.astype(jnp.float32))
    np.testing.assert_allclose(gx.float().numpy(), want, rtol=0,
                               atol=BF16_REL * np.abs(want).max())


def test_capacity_binds_and_drops_what_the_reference_drops():
    """Skewed inputs concentrate the choices: some experts get more than
    their capacity of 80 slots.  The drop count equals the reference's and
    is above 0, and the outputs agree (a dropped entry contributes
    zero)."""
    cfg = _cfg("deepseek-moe-16b")
    p, x = _moe_inputs(cfg, 160, seed=2, skew=1.0)
    jout, jaux = jmoe.moe_ffn_gspmd(p, jnp.asarray(x), cfg)
    _, _, out, aux, rec = _port_moe(p, x, cfg)
    idx, dropped = _ref_routing(p, x, cfg)
    assert dropped > 0
    np.testing.assert_array_equal(rec["expert_idx"].numpy(), idx)
    assert int((~rec["keep"]).sum()) == dropped
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(aux.item(), float(jaux), atol=ATOL)


def test_two_dispatch_groups_match_reference():
    """T = 8192 at d 64: two groups of 4096, each with its own capacity and
    slots (entries of the second group rank from 0 again)."""
    cfg = _cfg("deepseek-moe-16b")
    p, x = _moe_inputs(cfg, 8192, seed=2, skew=1.0)
    jout, jaux = jmoe.moe_ffn_gspmd(p, jnp.asarray(x), cfg)
    _, _, out, aux, rec = _port_moe(p, x, cfg)
    idx, dropped = _ref_routing(p, x, cfg)
    assert dropped > 0
    np.testing.assert_array_equal(rec["expert_idx"].numpy(), idx)
    assert int((~rec["keep"]).sum()) == dropped
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)
    np.testing.assert_allclose(aux.item(), float(jaux), atol=ATOL)


def test_tokens_that_do_not_split_into_groups_raise():
    """T = 5000 > 4096 is not a multiple of the group: the reference's
    reshape fails, and the port raises a ValueError there (no padding)."""
    cfg = _cfg("deepseek-moe-16b")
    p, x = _moe_inputs(cfg, 5000)
    with pytest.raises(TypeError):
        jmoe.moe_ffn_gspmd(p, jnp.asarray(x), cfg)
    with pytest.raises(ValueError, match="groups of 4096"):
        _port_moe(p, x, cfg)


@pytest.mark.parametrize("arch", NAMES)
def test_zero_row_picks_the_lowest_indices(arch):
    """A zero input row gives every expert the same probability: the port
    picks experts 0..k-1, as ``jax.lax.top_k`` does, with equal gates."""
    cfg = _cfg(arch)
    p, x = _moe_inputs(cfg, 8)
    x[0, 1] = 0.0
    _, _, out, _, rec = _port_moe(p, x, cfg)
    idx, _ = _ref_routing(p, x, cfg)
    assert idx[1].tolist() == list(range(cfg.moe_top_k))
    np.testing.assert_array_equal(rec["expert_idx"].numpy(), idx)
    jout, _ = jmoe.moe_ffn_gspmd(p, jnp.asarray(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL)


# ---------------------------------------------------------------------------
# configs


@pytest.mark.parametrize("over,field", [
    (dict(n_experts=0, moe_top_k=0), "n_experts"),
    (dict(moe_top_k=9), "moe_top_k"), (dict(moe_top_k=0), "moe_top_k"),
    (dict(n_layers=3, moe_every=2), "n_layers"),
    (dict(moe_every=4), "moe_every")])
def test_moe_fields_the_reference_would_fail_on_raise(over, field):
    cfg = dataclasses.replace(tcfg(_cfg("llama4-maverick-400b-a17b")),
                              **over)
    with pytest.raises(ValueError, match=field):
        check_supported(cfg)


@pytest.mark.parametrize("arch", NAMES)
def test_param_counts_are_the_reference_counts(arch):
    for smoke in (False, True):
        cfg = jax_get_config(arch, smoke=smoke)
        assert tcfg(cfg).param_count() == cfg.param_count()
        assert tcfg(cfg).active_param_count() == cfg.active_param_count()


@pytest.mark.parametrize("temp", [False, True])
def test_per_group_windows_and_scales(temp):
    """llama4's (dense, MoE) groups share the group's window and
    temperature 1 / (1 + g); deepseek's layers each take their own."""
    for arch in NAMES:
        cfg = _cfg(arch, attn_temperature_by_layer=temp, local_window=8)
        per = cfg.moe_every
        want_s = np.repeat(np.asarray(jax_layer_scales(cfg)), per)
        want_w = np.repeat(np.asarray(jax_layer_windows(cfg, 64)), per)
        np.testing.assert_array_equal(np.float32(layer_scales(tcfg(cfg))),
                                      want_s)
        np.testing.assert_array_equal(layer_windows(tcfg(cfg)), want_w)


