"""How far a 13-step trajectory of the port lies from the reference
trainer's, beside how far the reference lies from itself (jit against
eager), for one optimizer on GPT2_TINY in fp32 with the options of
``test_torch_train.py``; with the Hutchinson estimator also the step-0
estimates of the two packages on the training sub-batch, and the
coordinates beyond 3e-6 after two steps.  A diagnostic behind ROADMAP C,
not a test (pytest does not collect it):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_trajectory_spread.py \\
        --opt adahessian --estimator hutchinson
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_trajectory_spread.py \\
        --opt lion
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_trajectory_spread.py \\
        --grads

``--grads`` prints, per leaf, the step-0 gradients' spread instead: the
reference's eager against its jit, and the port against both.

``--perturb EPS`` runs the reference trainer against itself instead,
each run against the unperturbed jitted one: the same 13 jitted steps
with every step's gradient perturbed (each element of the raveled
gradient multiplied by ``1 + EPS * xi``; then ``EPS * max|g|`` times xi
added to each leaf g; xi standard normal from numpy, ``--perturb-seed``, a
fresh draw each step), and, with the Hutchinson estimator, with each
refresh fed an estimate computed outside the train step at the step's
weights, sub-batch and probe key: by the reference's estimator jitted on
its own, run op by op ("eager"), and by the port's.  A first run with EPS
0 checks that the tool's loop reproduces ``train_loop`` bit for bit.  The
gradient noise and the estimate go in by wrapping the engine that
``make_train_fns`` builds (``ravel_grads``, ``step_with_refresh``), so
``src/repro`` runs as it is.  EPS ~1e-6 is the port's step-0 gradient gap
relative to each element (``--grads``: 6e-7 to 1.4e-6 of each leaf's
scale at most, ~1e-7 of it in rms):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_trajectory_spread.py \\
        --opt adahessian --estimator hutchinson --perturb 1e-6
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/_trajectory_spread.py \\
        --opt sophia_h --estimator hutchinson --perturb 1e-6

Measured on the CPU (seed 0; share of the 889,600 coordinates within 3e-6
+ 1e-5|a| and within 1e-5 + 1e-5|a| after 13 steps):

    run                        AdaHessian           Sophia-H
    g (1 + 1e-6 xi)            99.9988%, 99.9994%   100%, 100%
    g + 1e-6 max|g_leaf| xi    96.5402%, 96.6944%   96.0030%, 96.6849%
    jitted estimate            100%, 100%           100%, 100%
    op-by-op (eager) estimate  80.7882%, 92.1295%   99.9993%, 99.9997%
    the port's estimate        91.2121%, 96.5097%   99.9999%, 99.9999%
    (the port's own run)       91.2104%, 96.5098%   99.9993% (test)

The reference's eager-against-jit trajectory (99.9931%) compiles its
refresh inside ``lax.cond`` in both modes, so its step-0 estimates are
bit-identical; an estimate that differs in summation order alone (eager,
median relative difference 8.7e-7 at step 0; the port's 1.2e-6) moves
AdaHessian, which divides by |u . Hu|, further than the port does, and
leaves Sophia-H, which clips, where it was.
"""
import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_train import (CFG32, RNG_TAG_HESS, TCFG32,  # noqa: E402
                              TRAIN, JTrainerConfig, TrainerConfig, _np,
                              _src, build_layout, jax_make_engine,
                              jax_make_source, jax_make_train_fns,
                              jax_ravel_shards, jax_train_loop,
                              make_train_fns, params_from_jax, ravel_shards,
                              seed_from_key, step0_gradients, train_loop)


def _shares(name, x, a):
    for atol in (3e-6, 1e-5):
        bad = np.abs(x - a) > atol + 1e-5 * np.abs(a)
        print(f"  {name}: within {atol} + 1e-5|a|: "
              f"{100 * (1 - bad.mean()):.4f}% ({bad.sum()} of {bad.size}); "
              f"max abs {np.abs(x - a).max():.3g}")


def run(over, steps):
    """(reference jit, reference eager, port) raveled parameters and loss
    histories after ``steps`` steps, the port on the reference's seeds
    and probes."""
    jtc = JTrainerConfig(fused_loss=True, **over)
    src = jax_make_source(_src())
    s_jit, h_jit = jax_train_loop(CFG32, jtc, src, num_steps=steps)
    s_eag, h_eag = jax_train_loop(CFG32, jtc, src, num_steps=steps,
                                  jit=False)
    s0 = jax_make_train_fns(CFG32, jtc)[0](jax.random.PRNGKey(jtc.seed))

    def rng(step):
        return jax.random.fold_in(jax.random.fold_in(s0.rng, RNG_TAG_HESS),
                                  step)

    def probe(step, layout):
        keys = jax.random.split(rng(step), layout.n_shards)
        return tuple(torch.from_numpy(np.array(jax.random.normal(
            k, (n,), jnp.float32))) for k, n in zip(keys, layout.shard_sizes))

    t_init, _ = make_train_fns(TCFG32, TrainerConfig(**over), device="cpu")
    s_port, h_port = train_loop(
        TCFG32, TrainerConfig(**over), src, num_steps=steps,
        state=t_init(params_from_jax(jax.tree.map(np.asarray, s0.params),
                                     TCFG32)),
        device="cpu", hess_seed_fn=lambda s: np.asarray(seed_from_key(rng(s))),
        probe_fn=probe)
    lay = jax_make_engine(jtc).layout(s_jit.params)
    n = lay.n_params
    tree = s_port.params.param_tree()
    out = [np.asarray(jax_ravel_shards(lay, s.params)[0])[:n]
           for s in (s_jit, s_eag)]
    out.append(_np(ravel_shards(build_layout(tree), tree)[0])[:n])
    return out, (h_jit, h_eag, h_port), (s_jit, s_port)


def _external_estimator(kind, lay):
    """``est(params, sub, rng)``: the Hutchinson estimate u . Hu as flat
    shards of ``lay``, computed outside the train step on the estimator
    sub-batch with the trainer's probe key, the loss and flash twins as
    the trainer takes them: the reference's estimator jitted on its own
    ("jit"), run op by op ("eager"), or the port's on the same weights and
    probes ("port")."""
    from repro.core import estimators as jest
    from repro.models import get_model as jax_get_model
    from repro_torch.core.estimators import (functional_loss,
                                             hutchinson_estimator_flat)
    from repro_torch.core.types import flat_tensors
    from repro_torch.models import get_model

    def ref(params, sub, rng):
        def f(p):
            return jax_get_model(CFG32).loss_fn(
                CFG32, p, sub, attn_impl="flash_jvp",
                loss_impl="fused_jvp")[0]
        return jest.hutchinson_estimator_flat(f, params, rng, lay)

    if kind == "jit":
        return jax.jit(ref)
    if kind == "eager":
        return ref

    def port(params, sub, rng):
        tparams = params_from_jax(jax.tree.map(np.asarray, params), TCFG32)
        tb = {k: torch.from_numpy(np.array(v)) for k, v in sub.items()}
        u = tuple(torch.from_numpy(np.array(jax.random.normal(
            k, (n,), jnp.float32)))
            for k, n in zip(jax.random.split(rng, lay.n_shards),
                            lay.shard_sizes))
        tree = tparams.param_tree()
        est = hutchinson_estimator_flat(
            functional_loss(tparams, flat_tensors(tree),
                            lambda m: get_model(TCFG32).loss_fn(
                                TCFG32, m, tb, attn_impl="flash_jvp",
                                loss_impl="fused_jvp")[0]),
            tree, u, build_layout(tree))
        return tuple(jnp.asarray(e.numpy()) for e in est)

    return port


def run_reference(over, steps, *, eps=0.0, seed=0, mode="relative",
                  estimate=None):
    """The reference's raveled parameters and loss history after
    ``steps`` jitted steps (the loop of ``train_loop`` written out), with
    each step's gradient perturbed by xi (standard normal from ``numpy``
    seed ``seed``, one draw per step) and, with ``estimate``, each refresh
    taking the estimate of :func:`_external_estimator` instead of its
    own.  Mode "relative" multiplies every element of the flat gradient
    shards by ``1 + eps * xi``; mode "leaf" adds ``eps * max|g| * xi`` to
    each leaf g of the gradient tree (the form of the port's step-0 gap,
    a share of each leaf's scale).  Both are put on by wrapping the engine
    that ``make_train_fns`` builds."""
    import repro.train.trainer as jtrainer
    from repro.core.engine import hessian_aware_optimizer

    jtc = JTrainerConfig(fused_loss=True, **over)
    src = jax_make_source(_src())
    make_engine = jtrainer.make_engine
    inject = {}

    def wrapped_engine(tc):
        eng = make_engine(tc)
        ravel, refresh = eng.ravel_grads, eng.step_with_refresh

        def ravel_grads(params, grads):
            xi = inject["xi"]
            if mode == "leaf":
                return ravel(params, jax.tree.map(
                    lambda g, x: g + eps * jnp.abs(g).max() * x, grads, xi))
            return tuple(g * (1.0 + eps * x)
                         for g, x in zip(ravel(params, grads), xi))

        def step_with_refresh(state, params, g_sh, lr, est, *rest):
            if inject["est"] is not None:
                est = inject["est"]
            return refresh(state, params, g_sh, lr, est, *rest)

        eng.ravel_grads = ravel_grads
        eng.step_with_refresh = step_with_refresh
        return eng

    jtrainer.make_engine = wrapped_engine
    try:
        init_fn, train_step = jax_make_train_fns(CFG32, jtc)
        state = init_fn(jax.random.PRNGKey(jtc.seed))
    finally:
        jtrainer.make_engine = make_engine

    @jax.jit
    def step(state, batch, flag, xi, est):
        inject["xi"], inject["est"] = xi, est
        return train_step(state, batch, flag)

    lay = jax_make_engine(jtc).layout(state.params)
    est_fn = None if estimate is None else _external_estimator(estimate, lay)
    zeros = tuple(jnp.zeros(n, jnp.float32) for n in lay.shard_sizes)
    rng = np.random.default_rng(seed)

    def draw(shape):
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32))

    needs_hess = hessian_aware_optimizer(jtc.optimizer)
    hist = []
    for t in range(steps):
        batch = {k: jnp.asarray(v) for k, v in src.batch_at(t).items()}
        xi = (jax.tree.map(lambda p: draw(p.shape), state.params)
              if mode == "leaf" else tuple(draw(n) for n in lay.shard_sizes))
        refresh = needs_hess and t % jtc.hess_interval == 0
        est = None
        if est_fn is not None:
            est = zeros
            if refresh:
                key = jax.random.fold_in(jax.random.fold_in(
                    state.rng, RNG_TAG_HESS), t)
                sub = {k: v[:jtc.hess_subbatch] for k, v in batch.items()}
                est = tuple(est_fn(state.params, sub, key))
        state, metrics = step(state, batch, jnp.asarray(refresh), xi, est)
        hist.append({k: float(v) for k, v in metrics.items()})
    return (np.asarray(jax_ravel_shards(lay, state.params)[0])[:lay.n_params],
            hist)


def perturbed_reference(over, eps, seed, steps=13):
    """The reference trainer against itself: the runs of
    :func:`run_reference` against the unperturbed jitted run."""
    jtc = JTrainerConfig(fused_loss=True, **over)
    s_jit, h_jit = jax_train_loop(CFG32, jtc, jax_make_source(_src()),
                                  num_steps=steps)
    lay = jax_make_engine(jtc).layout(s_jit.params)
    a = np.asarray(jax_ravel_shards(lay, s_jit.params)[0])[:lay.n_params]
    runs = [("g (1 + 0 xi)", dict(eps=0.0)),
            (f"g (1 + {eps:g} xi)", dict(eps=eps)),
            (f"g + {eps:g} max|g_leaf| xi", dict(eps=eps, mode="leaf"))]
    if over["estimator"] == "hutchinson":
        runs += [(f"the estimate from the {kind} estimator",
                  dict(estimate=kind)) for kind in ("jit", "eager", "port")]
    for name, kw in runs:
        x, hist = run_reference(over, steps, seed=seed, **kw)
        rel = max(abs(p["loss"] - q["loss"]) / abs(q["loss"])
                  for p, q in zip(hist, h_jit))
        print(f"  {name}, vs the unperturbed jit: losses within {rel:.3g} "
              "relative")
        _shares(name, x, a)


def estimates_at_step_0():
    """u . Hu of both packages on the first 4 rows of batch 0 (the
    trainer's refresh sub-batch), the loss and flash twins, one probe:
    the port against the reference's jit, and the reference's eager run
    against its jit."""
    from repro.core.engine import build_layout as jax_build_layout
    from repro.models import get_model as jax_get_model

    params = jax_get_model(CFG32).init_params(CFG32, jax.random.PRNGKey(0))
    sub = {k: jnp.asarray(v[:4])
           for k, v in jax_make_source(_src()).batch_at(0).items()}
    lay, rng = jax_build_layout(params), jax.random.PRNGKey(7)
    ref_jit, ref_eager, port = (
        np.asarray(_external_estimator(kind, lay)(params, sub, rng)[0])
        for kind in ("jit", "eager", "port"))
    n = lay.n_params
    ref = np.abs(ref_jit[:n])
    print(f"step-0 u.Hu, largest |value| {ref.max():.3g}:")
    for name, x in (("reference eager vs jit", ref_eager),
                    ("port vs reference jit", port)):
        d = np.abs(x[:n] - ref_jit[:n])
        rel = d / np.maximum(ref, 1e-30)
        print(f"  {name}: max abs {d.max():.3g}, beyond 1e-3 relative "
              f"{100 * (rel > 1e-3).mean():.3f}%, median relative "
              f"{np.median(rel):.3g}")


def grads_at_step_0():
    for attn in ("flash", "full"):
        print(f"step-0 gradients ({attn} attention), relative to each "
              "leaf's largest |g|:")
        for path, a, e, p in step0_gradients(attn):
            scale = np.abs(a).max()
            print(f"  {path:34s} scale {scale:.3g}; eager vs jit "
                  f"{np.abs(e - a).max() / scale:.3g}, port vs jit "
                  f"{np.abs(p - a).max() / scale:.3g}, port vs eager "
                  f"{np.abs(p - e).max() / scale:.3g}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--opt", default="lion")
    ap.add_argument("--estimator", default="gnb")
    ap.add_argument("--grads", action="store_true")
    ap.add_argument("--perturb", type=float, default=None, metavar="EPS")
    ap.add_argument("--perturb-seed", type=int, default=0)
    args = ap.parse_args()
    torch.set_num_threads(4)
    if args.grads:
        grads_at_step_0()
        return
    over = dict(TRAIN, optimizer=args.opt, estimator=args.estimator,
                fused_kernel=True)
    if args.perturb is not None:
        print(f"{args.opt} ({args.estimator}), 13 steps, the reference "
              "against itself:")
        perturbed_reference(over, args.perturb, args.perturb_seed)
        return
    (a, e, b), (h_jit, h_eag, h_port), _ = run(over, 13)
    print(f"{args.opt} ({args.estimator}), 13 steps:")
    for name, hist in (("reference eager vs jit", h_eag),
                       ("port vs reference jit", h_port)):
        rel = max(abs(p["loss"] - q["loss"]) / abs(q["loss"])
                  for p, q in zip(hist, h_jit))
        print(f"  {name}: losses within {rel:.3g} relative")
    _shares("reference eager vs jit", e, a)
    _shares("port vs reference jit", b, a)
    if args.estimator != "hutchinson":
        return
    estimates_at_step_0()
    (a, _, b), _, (s_jit, s_port) = run(over, 2)
    print("2 steps (the refresh at step 0):")
    _shares("port vs reference jit", b, a)
    bad = np.abs(b - a) > 3e-6 + 1e-5 * np.abs(a)
    n = bad.size
    vr = np.asarray(s_jit.opt_state.h[0])[:n]
    vp = _np(s_port.opt_state.h[0])[:n]
    mr = np.asarray(s_jit.opt_state.m[0])[:n]
    mp = _np(s_port.opt_state.m[0])[:n]
    uhu = np.sqrt(vr / (1.0 - over.get("beta2", 0.99)))
    print(f"  |u.Hu| beyond: median {np.median(uhu[bad]):.3g} (all: "
          f"{np.median(uhu):.3g}); v relative difference there: median "
          f"{np.median(np.abs(vp - vr)[bad] / vr[bad]):.3g}, max "
          f"{np.max(np.abs(vp - vr)[bad] / vr[bad]):.3g}; m: median "
          f"{np.median(np.abs(mp - mr)[bad] / np.abs(mr[bad])):.3g}")


if __name__ == "__main__":
    main()
