"""The port's rope models trained, held against the JAX reference: a
GPT-NeoX-shaped config and stablelm-1.6b's smoke config
(``tests/_rope_models.py``), fp32, the reference's weights
(``params_from_jax``) and numpy inputs: loss and gradients on the fused,
chunked and unfused loss routes, the attention routes under rope,
Sophia-G trainer steps under the trajectory contract and Sophia-H's
Hutchinson refresh through rope."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _rope_models import ATTN, CFGS, model, tcfg as _t  # noqa: F401
from repro.core.engine import ravel_shards as jax_ravel_shards
from repro.data import DataConfig as JDataConfig
from repro.data import make_source as jax_make_source
from repro.kernels.fused_ce import seed_from_key
from repro.models import get_model as jax_get_model
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import make_engine as jax_make_engine
from repro.train import make_train_fns as jax_make_train_fns
from repro.train import train_loop as jax_train_loop
from repro.train.trainer import RNG_TAG_HESS
from repro_torch.convert import params_from_jax
from repro_torch.core import build_layout, ravel_shards
from repro_torch.core.types import flat_tensors, tree_leaves
from repro_torch.data import DataConfig, make_source
from repro_torch.models import get_model
from repro_torch.train import TrainerConfig, make_train_fns, train_loop

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


TRAIN = dict(peak_lr=5e-4, total_steps=64, warmup_steps=4, hess_interval=4,
             hess_subbatch=2, seed=0)


def _trajectories(name, over, steps):
    """``steps`` steps of the reference trainer and of the port on its
    weights, batches, noise seeds and Hutchinson probes: (port history,
    reference history, the two parameter vectors, the two states)."""
    cfg = CFGS[name]
    over = dict(TRAIN, fused_loss=True, attn_impl=ATTN[name], **over)
    jtc = JTrainerConfig(**over)
    src_cfg = JDataConfig(seq_len=16, global_batch=4,
                          vocab_size=cfg.vocab_size)
    s0 = jax_make_train_fns(cfg, jtc)[0](jax.random.PRNGKey(0))
    s_ref, hist_ref = jax_train_loop(cfg, jtc, jax_make_source(src_cfg),
                                     num_steps=steps)

    def rng(step):
        return jax.random.fold_in(jax.random.fold_in(s0.rng, RNG_TAG_HESS),
                                  step)

    def probe(step, layout):
        keys = jax.random.split(rng(step), layout.n_shards)
        return tuple(torch.from_numpy(np.array(jax.random.normal(
            k, (n,), jnp.float32))) for k, n in zip(keys, layout.shard_sizes))

    tc = TrainerConfig(**over)
    params = params_from_jax(jax.tree.map(np.asarray, s0.params), _t(cfg))
    state = make_train_fns(_t(cfg), tc, device="cpu")[0](params)
    s_port, hist = train_loop(
        _t(cfg), tc, make_source(DataConfig(**dataclasses.asdict(src_cfg))),
        num_steps=steps, state=state, device="cpu",
        hess_seed_fn=lambda step: np.asarray(seed_from_key(rng(step))),
        probe_fn=probe)
    lay = jax_make_engine(jtc).layout(s_ref.params)
    a = np.asarray(jax_ravel_shards(lay, s_ref.params)[0])[:lay.n_params]
    tree = s_port.params.param_tree()
    b = ravel_shards(build_layout(tree), tree)[0].detach().numpy()[
        :lay.n_params]
    return hist, hist_ref, a, b, s_port, s_ref


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
