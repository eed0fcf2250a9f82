"""The port's rope models trained, held against the JAX reference: a
GPT-NeoX-shaped config and stablelm-1.6b's smoke config
(``tests/_rope_models.py``), fp32, the reference's weights
(``params_from_jax``) and numpy inputs: loss and gradients on the fused,
chunked and unfused loss routes, the attention routes under rope,
Sophia-G trainer steps under the trajectory contract and Sophia-H's
Hutchinson refresh through rope."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _rope_models import ATTN, CFGS, model, trajectories  # noqa: F401
from _rope_models import tcfg as _t
from repro.models import get_model as jax_get_model
from repro_torch.core.types import flat_tensors, tree_leaves
from repro_torch.models import get_model

torch.set_num_threads(1)


def _batch(cfg, B=3, S=20, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "mask": (rng.random((B, S)) > 0.25).astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


@pytest.mark.parametrize("impl", ["fused", "chunked", "unfused"])
def test_loss_and_grads_match_reference(model, impl):
    """Masked-mean CE with the final norm fused (or applied first) on each
    loss route, rope in every layer: loss within 1e-5 and every gradient
    (``unembed`` and ``w_gate`` among them) within 2e-5, the bounds of the
    GPT-2 routes (tests/test_torch_loss.py)."""
    name, cfg, params, tparams = model
    jb, tb = _batch(cfg)
    attn = ATTN[name]
    (jloss, _), jg = jax.value_and_grad(
        lambda p: jax_get_model(cfg).loss_fn(cfg, p, jb, loss_impl=impl,
                                             attn_impl=attn),
        has_aux=True)(params)
    loss, _ = get_model(_t(cfg)).loss_fn(_t(cfg), tparams, tb,
                                         loss_impl=impl, attn_impl=attn)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)
    tree = tparams.param_tree()
    grads = iter(torch.autograd.grad(loss, flat_tensors(tree)))
    for leaf, want in zip(tree_leaves(tree), jax.tree.leaves(jg)):
        got = (torch.stack([next(grads) for _ in leaf])
               if isinstance(leaf, list) else next(grads))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_attention_routes_agree_under_rope(model):
    """The flash (plain version), chunked and materialized routes of the
    port's trunk give one hidden state under rope: they sum the softmax
    in other orders, so fp32 hidden values of a few units agree within a
    few ulps, 1e-5."""
    _, cfg, _, tparams = model
    _, tb = _batch(cfg, S=24)
    fh = get_model(_t(cfg)).forward_hidden
    ref, _ = fh(_t(cfg), tparams, tb["tokens"], attn_impl="full")
    for impl in ("flash", "chunked"):
        got, _ = fh(_t(cfg), tparams, tb["tokens"], attn_impl=impl)
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


def _trajectories(name, over, steps):
    return trajectories(CFGS[name], ATTN[name], over, steps)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_sophia_g_trajectory_matches_reference_trainer(name):
    """5 Sophia-G steps with the GNB refresh at 0 and 4 (the fused loss,
    the reference's noise seeds): the trajectory contract of
    tests/test_torch_train.py, equal refresh counts, losses to rtol 1e-4 /
    atol 1e-5, every parameter coordinate within 2e-3 and >= 99.95% of
    them within 3e-6 + 1e-5 |a|, m and h within 2e-3."""
    hist, hist_ref, a, b, s_port, s_ref = _trajectories(
        name, dict(optimizer="sophia_g"), 5)
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


def test_hutchinson_refresh_through_rope_matches_reference():
    """One Sophia-H step with the Hutchinson refresh on the NeoX-shaped
    config: its HVP runs forward-over-reverse (``torch.func.jvp`` of
    ``torch.func.grad``) through rope and the loss and flash twins, on the
    reference's probe.  The loss within 1e-5 and the refreshed h (u ⊙ Hu
    folded into the EMA) within 1e-4 of its largest element: the
    estimates differ by summation order alone (the GPT-2 case's median
    relative difference is 1.2e-6, tests/test_torch_train.py)."""
    hist, hist_ref, _, _, s_port, s_ref = _trajectories(
        "neox_tiny", dict(optimizer="sophia_h", estimator="hutchinson"), 1)
    np.testing.assert_allclose(hist[0]["loss"], hist_ref[0]["loss"],
                               atol=1e-5)
    for x, y in zip(s_port.opt_state.h, s_ref.opt_state.h):
        y = np.asarray(y)
        assert np.abs(y).max() > 0
        np.testing.assert_allclose(x.numpy(), y, rtol=0,
                                   atol=1e-4 * np.abs(y).max())
