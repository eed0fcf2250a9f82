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


def estimates_at_step_0():
    """u . Hu of both packages on the first 4 rows of batch 0 (the
    trainer's refresh sub-batch), the loss and flash twins, one probe:
    the port against the reference's jit, and the reference's eager run
    against its jit."""
    from repro.core import estimators as jest
    from repro.core.engine import build_layout as jax_build_layout
    from repro.models import get_model as jax_get_model
    from repro_torch.core.estimators import (functional_loss,
                                             hutchinson_estimator_flat)
    from repro_torch.core.types import flat_tensors
    from repro_torch.models import get_model

    params = jax_get_model(CFG32).init_params(CFG32, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), TCFG32)
    sub = {k: v[:4] for k, v in jax_make_source(_src()).batch_at(0).items()}
    jb = {k: jnp.asarray(v) for k, v in sub.items()}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in sub.items()}
    lay, rng = jax_build_layout(params), jax.random.PRNGKey(7)

    def f(p):
        return jax_get_model(CFG32).loss_fn(CFG32, p, jb,
                                            attn_impl="flash_jvp",
                                            loss_impl="fused_jvp")[0]

    ref_jit = np.asarray(jax.jit(lambda p: jest.hutchinson_estimator_flat(
        f, p, rng, lay))(params)[0])
    ref_eager = np.asarray(jest.hutchinson_estimator_flat(f, params, rng,
                                                          lay)[0])
    u = tuple(torch.from_numpy(np.array(jax.random.normal(
        k, (n,), jnp.float32)))
        for k, n in zip(jax.random.split(rng, lay.n_shards),
                        lay.shard_sizes))
    tree = tparams.param_tree()
    port = hutchinson_estimator_flat(
        functional_loss(tparams, flat_tensors(tree),
                        lambda m: get_model(TCFG32).loss_fn(
                            TCFG32, m, tb, attn_impl="flash_jvp",
                            loss_impl="fused_jvp")[0]),
        tree, u, build_layout(tree))[0].numpy()
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
    args = ap.parse_args()
    torch.set_num_threads(4)
    if args.grads:
        grads_at_step_0()
        return
    over = dict(TRAIN, optimizer=args.opt, estimator=args.estimator,
                fused_kernel=True)
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
