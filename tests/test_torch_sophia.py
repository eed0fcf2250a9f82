"""The port's per-leaf Sophia (repro_torch.core.sophia) against Algorithm 3
and against the JAX reference (repro.core.sophia) on the same numpy
inputs: the reference's tests/test_sophia.py, each case also run through
the reference, which runs eagerly here (one XLA call per operation, as the
port runs one PyTorch operation per rounding): fp32 within 3e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import apply_updates as j_apply_updates
from repro.core import sophia as j_sophia
from repro.core.sophia import scale_by_sophia as j_scale_by_sophia
from repro_torch.core import apply_updates, sophia, sophia_g, sophia_h
from repro_torch.core.schedule import linear_warmup_cosine
from repro_torch.core.sophia import (add_decayed_weights,
                                     scale_by_learning_rate, scale_by_sophia)
from repro.core.schedule import linear_warmup_cosine as j_linear_warmup_cosine
from repro.core.sophia import add_decayed_weights as j_add_decayed_weights
from repro.core.sophia import scale_by_learning_rate as j_scale_by_lr

torch.set_num_threads(1)

TOL = 3e-6  # fp32, the reference eager


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _close(got, want, atol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=atol)


def _manual_sophia_run(grads_seq, hhat_seq, lr, beta1, beta2, gamma, eps, wd,
                       k, theta0):
    """Direct transcription of Algorithm 3 (numpy, float64)."""
    theta = np.array(theta0, dtype=np.float64)
    m = np.zeros_like(theta)
    h = np.zeros_like(theta)
    out = []
    for t, g in enumerate(grads_seq):
        m = beta1 * m + (1 - beta1) * np.asarray(g)
        if t % k == 0:
            h = beta2 * h + (1 - beta2) * np.asarray(hhat_seq[t])
        theta = theta - lr * wd * theta                     # line 12
        u = np.clip(m / np.maximum(gamma * h, eps), -1, 1)  # line 13
        theta = theta - lr * u
        out.append(theta.copy())
    return out


@pytest.mark.parametrize("lr", ["constant", "schedule"])
def test_matches_algorithm3_pseudocode(lr):
    """20 steps with the refresh every 5: the float64 transcription of
    Algorithm 3 within the reference's own bound (rtol 2e-5, atol 2e-6),
    and the reference's trajectory within 3e-6; with a schedule, the lr of
    the pre-increment step."""
    rng = np.random.default_rng(0)
    d, T, k = 16, 20, 5
    grads = [rng.normal(size=d).astype(np.float32) for _ in range(T)]
    hhats = [np.abs(rng.normal(size=d)).astype(np.float32) for _ in range(T)]
    b1, b2, gamma, eps, wd = 0.96, 0.99, 0.05, 1e-12, 0.2
    if lr == "constant":
        t_lr = j_lr = 0.01
    else:
        t_lr = linear_warmup_cosine(0.01, 20, warmup_steps=4)
        j_lr = j_linear_warmup_cosine(0.01, 20, warmup_steps=4)
    kw = dict(beta1=b1, beta2=b2, gamma=gamma, eps=eps, weight_decay=wd)
    opt, jopt = sophia(t_lr, **kw), j_sophia(j_lr, **kw)
    theta, jtheta = torch.ones(d), jnp.ones((d,))
    state, jstate = opt.init(theta), jopt.init(jtheta)
    ours, theirs = [], []
    for t in range(T):
        if t % k == 0:
            state = opt.update_hessian(_t(hhats[t]), state)
            jstate = jopt.update_hessian(jnp.asarray(hhats[t]), jstate)
        updates, state = opt.update(_t(grads[t]), state, theta)
        theta = apply_updates(theta, updates)
        jupd, jstate = jopt.update(jnp.asarray(grads[t]), jstate, jtheta)
        jtheta = j_apply_updates(jtheta, jupd)
        ours.append(theta.numpy())
        theirs.append(np.asarray(jtheta))
    for t in range(T):
        _close(ours[t], theirs[t])
    _close(state.m.numpy(), jstate.m)
    _close(state.h.numpy(), jstate.h)
    assert int(state.count) == int(jstate.count) == T
    assert int(state.hess_count) == int(jstate.hess_count) == T // k
    if lr == "constant":
        ref = _manual_sophia_run(grads, hhats, 0.01, b1, b2, gamma, eps, wd,
                                 k, np.ones(d))
        for t in range(T):
            np.testing.assert_allclose(ours[t], ref[t], rtol=2e-5, atol=2e-6)


def test_negative_curvature_falls_back_to_sign():
    """h < 0 => the update is exactly -lr * sign(m) (the SignSGD backup)."""
    opt, jopt = sophia(0.1, beta1=0.0, weight_decay=0.0), \
        j_sophia(0.1, beta1=0.0, weight_decay=0.0)
    theta = np.array([1.0, -1.0, 2.0], np.float32)
    hhat = np.array([-5.0, -1e-3, -100.0], np.float32)
    g = np.array([0.3, -0.7, 1e-4], np.float32)
    state = opt.update_hessian(_t(hhat), opt.init(_t(theta)))
    updates, _ = opt.update(_t(g), state, _t(theta))
    jstate = jopt.update_hessian(jnp.asarray(hhat), jopt.init(
        jnp.asarray(theta)))
    jupd, _ = jopt.update(jnp.asarray(g), jstate, jnp.asarray(theta))
    np.testing.assert_allclose(updates.numpy(), -0.1 * np.sign(g), rtol=1e-6)
    _close(updates.numpy(), jupd)


def test_clip_bounds_worst_case_update():
    """Tiny curvature and a huge gradient: every coordinate's update is
    at most lr in size, and equal to the reference's."""
    opt, jopt = sophia(1.0, beta1=0.0, weight_decay=0.0), \
        j_sophia(1.0, beta1=0.0, weight_decay=0.0)
    state = opt.update_hessian(torch.full((8,), 1e-8),
                               opt.init(torch.zeros(8)))
    updates, _ = opt.update(torch.ones(8) * 100.0, state, torch.zeros(8))
    jstate = jopt.update_hessian(jnp.full((8,), 1e-8),
                                 jopt.init(jnp.zeros((8,))))
    jupd, _ = jopt.update(jnp.ones((8,)) * 100.0, jstate, jnp.zeros((8,)))
    assert float(updates.abs().max()) <= 1.0 + 1e-6
    _close(updates.numpy(), jupd)


def test_gamma_rescaling_identity():
    """eta clip(m / max(gamma h, eps), 1) == (eta / gamma) clip(m / max(h,
    eps / gamma), gamma), through the port's update (beta1 = 0, no decay,
    h refreshed once with beta2 = 0) and through the reference's."""
    rng = np.random.default_rng(1)
    m = rng.normal(size=32).astype(np.float32)
    h = np.abs(rng.normal(size=32)).astype(np.float32)
    eta, gamma, eps = 0.3, 0.05, 1e-12
    kw = dict(beta1=0.0, beta2=0.0, gamma=gamma, eps=eps, weight_decay=0.0)
    opt, jopt = sophia(eta, **kw), j_sophia(eta, **kw)
    state = opt.update_hessian(_t(h), opt.init(torch.zeros(32)))
    lhs, _ = opt.update(_t(m), state, torch.zeros(32))
    jstate = jopt.update_hessian(jnp.asarray(h), jopt.init(jnp.zeros((32,))))
    jlhs, _ = jopt.update(jnp.asarray(m), jstate, jnp.zeros((32,)))
    rhs = -(eta / gamma) * np.clip(m / np.maximum(h, eps / gamma), -gamma,
                                   gamma)
    np.testing.assert_allclose(lhs.numpy(), rhs, rtol=1e-5)
    _close(lhs.numpy(), jlhs)


def test_clip_fraction_telemetry():
    """One leaf with huge curvature (never clips), one with tiny (always
    clips): the clip fraction is 0.5 in both packages."""
    core, jcore = scale_by_sophia(gamma=1.0), j_scale_by_sophia(gamma=1.0)
    theta = {"a": torch.ones(10), "b": torch.ones(10)}
    h = {"a": torch.full((10,), 1e6), "b": torch.full((10,), 1e-9)}
    state = core.init(theta)
    state = state._replace(h={k: v / (1 - 0.99) for k, v in h.items()})
    g = {"a": torch.ones(10), "b": torch.ones(10)}
    updates, state = core.update(g, state, theta)
    jtheta = {k: jnp.ones((10,)) for k in "ab"}
    jstate = jcore.init(jtheta)
    jstate = jstate._replace(h={k: jnp.asarray(v.numpy() / (1 - 0.99))
                                for k, v in h.items()})
    jupd, jstate = jcore.update({k: jnp.ones((10,)) for k in "ab"}, jstate,
                                jtheta)
    assert abs(float(state.clip_fraction) - 0.5) < 1e-6
    assert float(state.clip_fraction) == float(jstate.clip_fraction)
    for k in "ab":
        _close(updates[k].numpy(), jupd[k])


@pytest.mark.parametrize("name,gamma", [("sophia_h", 0.01),
                                        ("sophia_g", 0.05)])
def test_sophia_h_g_defaults(name, gamma):
    """sophia_h and sophia_g are Sophia at the paper's gamma: one step
    equals ``sophia(lr, gamma=...)``'s and the reference's."""
    from repro import core as jcore
    make = {"sophia_h": sophia_h, "sophia_g": sophia_g}[name]
    rng = np.random.default_rng(2)
    theta = rng.normal(size=12).astype(np.float32)
    g = rng.normal(size=12).astype(np.float32)
    hhat = np.abs(rng.normal(size=12)).astype(np.float32) * 1e-2
    outs = []
    for opt in (make(1e-3), sophia(1e-3, gamma=gamma)):
        state = opt.update_hessian(_t(hhat), opt.init(_t(theta)))
        outs.append(opt.update(_t(g), state, _t(theta))[0].numpy())
    jopt = getattr(jcore, name)(1e-3)
    jstate = jopt.update_hessian(jnp.asarray(hhat),
                                 jopt.init(jnp.asarray(theta)))
    jupd, _ = jopt.update(jnp.asarray(g), jstate, jnp.asarray(theta))
    np.testing.assert_array_equal(outs[0], outs[1])
    _close(outs[0], jupd)


def test_hessian_ema_line9():
    """h <- beta2 h + (1 - beta2) hhat, twice; hess_count counts."""
    opt, jopt = sophia(0.1, beta2=0.9), j_sophia(0.1, beta2=0.9)
    state, jstate = opt.init(torch.zeros(4)), jopt.init(jnp.zeros((4,)))
    for v in (2.0, 1.0):
        state = opt.update_hessian(torch.full((4,), v), state)
        jstate = jopt.update_hessian(jnp.full((4,), v), jstate)
        _close(state.h.numpy(), jstate.h)
    np.testing.assert_allclose(state.h.numpy(), 0.9 * 0.2 + 0.1, rtol=1e-6)
    assert int(state.hess_count) == int(jstate.hess_count) == 2


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_tree_of_stacked_leaves_matches_reference(state_dtype):
    """The port's tree convention (a stacked leaf as a list of per-layer
    tensors) against the reference's stacked arrays: three steps of
    ``sophia`` on a tree of a stacked and a plain leaf, and the decomposed
    form, scale_by_sophia -> scale_by_learning_rate(lr) ->
    add_decayed_weights(wd, lr), which gives the same updates up to the
    order of its roundings.  fp32 state within 3e-6.  With bf16 state the
    EMAs and the update run in bf16, and JAX rounds the Python constants
    (beta1, 1 - beta1, lr, wd) to bf16 first (weak typing) where PyTorch
    keeps them in fp32: each update within one bf16 ulp of the leaf's
    largest (2^-7 of it) of the reference's, the parameters within three
    such steps."""
    from repro.core import chain as j_chain
    from repro_torch.core import chain
    ulp = 2.0 ** -7 if state_dtype == "bfloat16" else 0.0

    def close(got, want, atol=None):
        want = _np(want)
        if atol is None:
            atol = TOL + ulp * np.abs(want).max()
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=atol)

    rng = np.random.default_rng(3)
    stacked = rng.normal(size=(3, 4, 5)).astype(np.float32)
    plain = rng.normal(size=(7,)).astype(np.float32)
    tree = {"w": [_t(x) for x in stacked], "b": _t(plain)}
    jtree = {"w": jnp.asarray(stacked), "b": jnp.asarray(plain)}
    grads = [(rng.normal(size=(3, 4, 5)).astype(np.float32),
              rng.normal(size=(7,)).astype(np.float32)) for _ in range(3)]
    est = (np.abs(rng.normal(size=(3, 4, 5))).astype(np.float32),
           np.abs(rng.normal(size=(7,))).astype(np.float32))
    t_est = {"w": [_t(x) for x in est[0]], "b": _t(est[1])}
    j_est = {"w": jnp.asarray(est[0]), "b": jnp.asarray(est[1])}
    opt = sophia(0.05, state_dtype=getattr(torch, state_dtype))
    jopt = j_sophia(0.05, state_dtype=getattr(jnp, state_dtype))
    state = opt.update_hessian(t_est, opt.init(tree))
    jstate = jopt.update_hessian(j_est, jopt.init(jtree))
    parts = chain(scale_by_sophia(), scale_by_learning_rate(0.05),
                  add_decayed_weights(0.2, 0.05))
    jparts = j_chain(j_scale_by_sophia(), j_scale_by_lr(0.05),
                     j_add_decayed_weights(0.2, 0.05))
    pstate = parts.update_hessian(t_est, parts.init(tree))
    jpstate = jparts.update_hessian(j_est, jparts.init(jtree))
    ptree, jptree = tree, jtree          # the decomposed form's own run
    biggest = 0.0
    for step, (gw, gb) in enumerate(grads):
        g = {"w": [_t(x) for x in gw], "b": _t(gb)}
        jg = {"w": jnp.asarray(gw), "b": jnp.asarray(gb)}
        upd, state = opt.update(g, state, tree)
        jupd, jstate = jopt.update(jg, jstate, jtree)
        pupd, pstate = parts.update(g, pstate, ptree)
        jpupd, jpstate = jparts.update(jg, jpstate, jptree)
        close(torch.stack(upd["w"]), jupd["w"])
        close(upd["b"], jupd["b"])
        _close(torch.stack(pupd["w"]), jpupd["w"])
        if step == 0:
            close(torch.stack(pupd["w"]), torch.stack(upd["w"]))
        biggest = max(biggest, float(np.abs(_np(jupd["w"])).max()))
        tree = apply_updates(tree, upd)
        jtree = j_apply_updates(jtree, jupd)
        ptree = apply_updates(ptree, pupd)
        jptree = j_apply_updates(jptree, jpupd)
    assert state.m["w"][0].dtype == getattr(torch, state_dtype)
    close(torch.stack(tree["w"]), jtree["w"], atol=TOL + 3 * ulp * biggest)
    close(torch.stack(state.m["w"]), jstate.m["w"])
    assert float(state.clip_fraction) == float(jstate.clip_fraction)
