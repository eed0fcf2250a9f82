"""The port's per-leaf baselines (repro_torch.core.baselines), chain,
global-norm clipping and schedules against the JAX reference
(repro.core) on the same numpy inputs.  The reference runs eagerly (one
XLA call per operation, each rounding once, as the port's PyTorch
operations do): fp32 within 3e-6.  ``jax.jit`` contracts a*m + b*g into
fused multiply-adds, so the jitted reference is held within one fp32 ulp
a step (of each leaf's largest value), and the schedules, which XLA jits
as a whole, within one ulp of each value."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core import schedule as jschedule
from repro_torch import core
from repro_torch.core import schedule

torch.set_num_threads(1)

TOL = 3e-6
OPTS = {
    "adamw": dict(weight_decay=0.1),
    "lion": dict(weight_decay=0.2),
    "signgd": dict(weight_decay=0.05),
    "adahessian": dict(weight_decay=0.01),
    "sgd": dict(momentum=0.9),
    "sophia_g": dict(),
    "sophia_h": dict(),
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tree(rng, scale=1.0):
    """A params-shaped pair (port tree, reference tree): a stacked leaf of
    3 layers and a plain one."""
    w = (rng.normal(size=(3, 6, 4)) * scale).astype(np.float32)
    b = (rng.normal(size=(5,)) * scale).astype(np.float32)
    return ({"b": torch.from_numpy(b), "w": [torch.from_numpy(x) for x in w]},
            {"b": jnp.asarray(b), "w": jnp.asarray(w)})


def _leaves(t):
    return [_np(torch.stack(v) if isinstance(v, list) else v)
            for _, v in sorted(t.items())]


def _assert_trees(got, want, atol=TOL, ulps=None):
    for a, b in zip(_leaves(got), [_np(want[k]) for k in sorted(want)]):
        if ulps is not None:
            atol = ulps * np.spacing(np.nanmax(np.abs(b)).astype(np.float32))
        both_nan = np.isnan(a) & np.isnan(b)
        diff = np.where(both_nan, 0.0, np.abs(a - b))
        np.testing.assert_array_less(diff, atol + 1e-30)


def _run(name, steps=4, jit=False, nan=False):
    """``steps`` updates of the per-leaf optimizer ``name`` in both
    packages, the hessian-aware ones fed an estimate before steps 0 and 2;
    a warmup-cosine schedule as the lr.  Returns the parameter trees."""
    rng = np.random.default_rng(0)
    params, jparams = _tree(rng)
    opt = core.OPTIMIZERS[name](schedule.linear_warmup_cosine(
        1e-2, 10, warmup_steps=2), **OPTS[name])
    jopt = jcore.OPTIMIZERS[name](jschedule.linear_warmup_cosine(
        1e-2, 10, warmup_steps=2), **OPTS[name])
    jupdate = jax.jit(jopt.update) if jit else jopt.update
    state, jstate = opt.init(params), jopt.init(jparams)
    aware = isinstance(opt, core.HessianAwareTransformation)
    assert aware == isinstance(jopt, jcore.HessianAwareTransformation)
    for t in range(steps):
        if aware and t % 2 == 0:
            est, jest = _tree(rng, 0.1)
            est = {k: ([x.abs() for x in v] if isinstance(v, list)
                       else v.abs()) for k, v in est.items()}
            jest = jax.tree.map(jnp.abs, jest)
            state = opt.update_hessian(est, state)
            jstate = jopt.update_hessian(jest, jstate)
        g, jg = _tree(rng)
        if nan:
            g["b"][1] = float("nan")
            jg["b"] = jg["b"].at[1].set(jnp.nan)
        upd, state = opt.update(g, state, params)
        jupd, jstate = jupdate(jg, jstate, jparams)
        params = core.apply_updates(params, upd)
        jparams = jcore.apply_updates(jparams, jupd)
    assert int(state.count) == int(jstate.count) == steps
    return params, jparams, state, jstate


@pytest.mark.parametrize("name", sorted(OPTS))
def test_per_leaf_optimizer_matches_reference(name):
    """Four steps of every optimizer of ``repro.core.OPTIMIZERS`` (AdaHessian
    and Sophia refreshed twice) on a tree of a stacked and a plain leaf:
    the parameters and every state tree within 3e-6 of the eager
    reference."""
    params, jparams, state, jstate = _run(name)
    _assert_trees(params, jparams)
    for field in ("m", "v", "h"):
        if hasattr(jstate, field):
            _assert_trees(getattr(state, field), getattr(jstate, field))


@pytest.mark.parametrize("name", ["adamw", "lion", "signgd", "adahessian",
                                  "sgd"])
def test_per_leaf_optimizer_within_an_ulp_of_the_jitted_reference(name):
    """The same four steps against the jitted reference, whose EMAs XLA
    contracts into fused multiply-adds: every parameter within one fp32
    ulp of its leaf's largest value per step (4 ulps).  The sign updates of
    Lion and SignGD step by exactly lr wherever the momentum is not near
    0."""
    params, jparams, _, _ = _run(name, jit=True)
    _assert_trees(params, jparams, ulps=4)


@pytest.mark.parametrize("name", ["lion", "signgd"])
def test_sign_puts_nan_where_jnp_sign_does(name):
    """A NaN gradient element: ``jnp.sign`` keeps the NaN, so the
    parameter turns NaN there and nowhere else, in both packages."""
    params, jparams, _, _ = _run(name, steps=1, nan=True)
    got, want = _leaves(params)[0], _np(jparams["b"])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1]) and np.isnan(got).sum() == 1
    _assert_trees(params, jparams)


def test_adahessian_update_hessian_squares_the_estimate():
    """v <- beta2 v + (1 - beta2) hhat^2 in both packages."""
    opt, jopt = core.adahessian(0.1), jcore.adahessian(0.1)
    state = opt.update_hessian(torch.full((3,), 2.0), opt.init(torch.zeros(3)))
    jstate = jopt.update_hessian(jnp.full((3,), 2.0),
                                 jopt.init(jnp.zeros((3,))))
    np.testing.assert_allclose(_np(state.v), 0.01 * 4.0, rtol=1e-6)
    np.testing.assert_array_equal(_np(state.v), _np(jstate.v))


# ---------------------------------------------------------------------------
# chain, clipping, apply_updates


def test_chain_composition_and_global_norm():
    """``chain(clip_by_global_norm(1.0), adamw(1e-2))`` (the reference's
    test_units_extra case): a finite update, the params' dtype kept, and
    the update and the clip state equal to the reference's."""
    opt = core.chain(core.clip_by_global_norm(1.0), core.adamw(1e-2))
    jopt = jcore.chain(jcore.clip_by_global_norm(1.0), jcore.adamw(1e-2))
    p, jp = {"w": torch.ones(4)}, {"w": jnp.ones((4,))}
    u, s = opt.update({"w": torch.full((4,), 100.0)}, opt.init(p), p)
    ju, js = jopt.update({"w": jnp.full((4,), 100.0)}, jopt.init(jp), jp)
    assert np.isfinite(float(core.global_norm(u)))
    p2 = core.apply_updates(p, u)
    assert p2["w"].dtype == p["w"].dtype
    np.testing.assert_allclose(_np(u["w"]), _np(ju["w"]), atol=TOL, rtol=0)
    assert int(s[0].triggers) == int(js[0].triggers) == 1
    np.testing.assert_allclose(float(s[0].last_norm), float(js[0].last_norm),
                               rtol=1e-7)
    assert float(core.clip_trigger_rate(s[0])) == \
        float(jcore.clip_trigger_rate(js[0])) == 1.0


def test_chain_forwards_update_hessian_to_its_members():
    """A chain with a hessian-aware member is hessian-aware and forwards
    the estimate to it alone; without one it is a plain transformation."""
    plain = core.chain(core.clip_by_global_norm(1.0), core.sgd(0.1))
    assert not isinstance(plain, core.HessianAwareTransformation)
    opt = core.chain(core.clip_by_global_norm(1.0), core.sophia_g(0.1))
    jopt = jcore.chain(jcore.clip_by_global_norm(1.0), jcore.sophia_g(0.1))
    assert isinstance(opt, core.HessianAwareTransformation)
    s = opt.update_hessian(torch.full((3,), 5.0), opt.init(torch.zeros(3)))
    js = jopt.update_hessian(jnp.full((3,), 5.0), jopt.init(jnp.zeros((3,))))
    np.testing.assert_array_equal(_np(s[1].h), _np(js[1].h))
    assert int(s[1].hess_count) == 1 and int(s[0].count) == 0


def test_clip_state_lives_on_the_params_device():
    state = core.clip_by_global_norm(1.0).init({"a": torch.zeros(2)})
    assert all(t.device.type == "cpu" for t in state)
    assert state.count.dtype == torch.int32
    assert state.last_norm.dtype == torch.float32


def test_apply_updates_keeps_param_dtypes():
    p = {"a": torch.ones(3, dtype=torch.bfloat16), "b": [torch.ones(2)] * 2}
    u = {"a": torch.full((3,), 0.5), "b": [torch.full((2,), 0.25)] * 2}
    out = core.apply_updates(p, u)
    assert out["a"].dtype == torch.bfloat16 and out["b"][1].dtype == \
        torch.float32
    assert float(out["a"][0]) == 1.5 and float(out["b"][0][0]) == 1.25
    zeros = core.tree_zeros_like(p, torch.float32)
    assert zeros["a"].dtype == torch.float32 and len(zeros["b"]) == 2


# ---------------------------------------------------------------------------
# schedules (the paper's protocol; the reference's test_units_extra cases)


def _ulps(a, b):
    a, b = np.float32(a), np.float32(b)
    return abs(float(a) - float(b)) / float(np.spacing(max(abs(a), abs(b),
                                                           np.float32(1e-30))))


def test_cosine_schedule_endpoints():
    s = schedule.linear_warmup_cosine(3e-4, total_steps=1000,
                                      warmup_steps=100, final_lr_ratio=0.05)
    assert float(s(0)) == 0.0
    np.testing.assert_allclose(float(s(100)), 3e-4, rtol=1e-5)
    np.testing.assert_allclose(float(s(1000)), 0.05 * 3e-4, rtol=1e-4)
    vals = [float(s(t)) for t in range(100, 1000, 100)]
    assert all(a >= b for a, b in zip(vals, vals[1:]))


def test_linear_and_invsqrt_schedules():
    lin = schedule.linear_warmup_linear_decay(1e-3, 100, warmup_steps=10)
    assert float(lin(100)) <= 1e-8
    isq = schedule.inverse_sqrt(1e-3, warmup_steps=100)
    np.testing.assert_allclose(float(isq(400)), 1e-3 / 2, rtol=1e-5)


@pytest.mark.parametrize("name,args", [
    ("linear_warmup_cosine", (3e-4, 1000, 100, 0.05)),
    ("linear_warmup_linear_decay", (1e-3, 100, 10, 0.1)),
    ("inverse_sqrt", (1e-3, 100)),
    ("constant", (2.5e-4,))])
def test_schedules_match_reference(name, args):
    """Every schedule at 40 steps across warmup, decay and the tail, fp32:
    within one ulp of the reference's (XLA fuses the schedule's
    arithmetic into one kernel; the port rounds each operation)."""
    ours = getattr(schedule, name)(*args)
    theirs = getattr(jschedule, name)(*args)
    for step in list(range(0, 30)) + [50, 99, 100, 101, 400, 999, 1000, 5000,
                                      123456]:
        got, want = float(ours(step)), float(theirs(step))
        assert ours(step).dtype == torch.float32
        assert _ulps(got, want) <= 1.0, (name, step, got, want)
