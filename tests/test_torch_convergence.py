"""The paper's motivating toy (Fig 2) and theory (Section 4) through the
port (repro_torch.core: exact_diag_hessian, the per-leaf sophia and
signgd), held against the JAX reference's tests/test_convergence.py on the
same inputs, and GPT2_TINY trained end to end: with the trainer (the
engine) and with the per-leaf API, which follow one trajectory."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import exact_diag_hessian as j_exact_diag_hessian
from repro_torch.configs.gpt2 import GPT2_TINY
from repro_torch.core import (apply_updates, chain, clip_by_global_norm,
                              exact_diag_hessian, gnb_estimator, signgd,
                              sophia_g)
from repro_torch.core.types import flat_tensors, tree_unflatten
from repro_torch.data import DataConfig, make_source
from repro_torch.models import get_model
from repro_torch.train import (TrainerConfig, hess_generator, make_schedule,
                               train_key, train_loop)
from repro_torch.train.trainer import to_device_batch

torch.set_num_threads(1)


def paper_toy_loss(theta, lib=torch):
    """Footnote 1: L1 sharp, L2 flat."""
    t1, t2 = theta[0], theta[1]
    L1 = 8 * (t1 - 1) ** 2 * (1.3 * t1 ** 2 + 2 * t1 + 1)
    L2 = 0.5 * (t2 - 4) ** 2
    return L1 + L2


def _run(update_fn, theta0, steps):
    theta = torch.tensor(theta0, dtype=torch.float32)
    for _ in range(steps):
        theta = update_fn(theta)
    return theta


def test_toy_2d_paper_fig2():
    """Sophia-style clipped Newton beats GD, SignGD and Newton on the
    paper's toy (the reference's test), each run also held against the
    reference's own run from the same start within 1e-5."""
    theta0 = [0.23, 0.0]
    steps = 50
    grad = torch.func.grad(paper_toy_loss)
    jgrad = jax.grad(lambda t: paper_toy_loss(t, jnp))

    def jrun(update_fn):
        update_fn = jax.jit(update_fn)
        theta = jnp.asarray(theta0, jnp.float32)
        for _ in range(steps):
            theta = update_fn(theta)
        return np.asarray(theta)

    gd = _run(lambda t: t - 0.01 * grad(t), theta0, steps)
    sg = _run(lambda t: t - 0.1 * torch.sign(grad(t)), theta0, steps)

    def newton_step(t):
        return t - grad(t) / exact_diag_hessian(paper_toy_loss, t)

    def sophia_step(t):
        h = exact_diag_hessian(paper_toy_loss, t)
        return t - 0.5 * torch.clamp(grad(t) / torch.clamp_min(h, 1e-12),
                                     -1.0, 1.0)

    nw = _run(newton_step, theta0, steps)
    so = _run(sophia_step, theta0, steps)

    def j_h(t):
        return j_exact_diag_hessian(lambda x: paper_toy_loss(x, jnp), t)

    j_nw = jrun(lambda t: t - jgrad(t) / j_h(t))
    j_so = jrun(lambda t: t - 0.5 * jnp.clip(
        jgrad(t) / jnp.maximum(j_h(t), 1e-12), -1.0, 1.0))
    np.testing.assert_allclose(so.numpy(), j_so, atol=1e-5)
    np.testing.assert_allclose(nw.numpy(), j_nw, atol=1e-5)

    l_gd = float(paper_toy_loss(gd))
    l_sg = float(paper_toy_loss(sg))
    l_so = float(paper_toy_loss(so))
    assert l_so < 1e-3, l_so
    assert l_so < l_gd and l_so < l_sg
    np.testing.assert_allclose(so.numpy(), [1.0, 4.0], atol=0.05)
    # Newton is trapped at the sharp dimension's local max (t1 ~ 0)
    assert abs(float(nw[0])) < 0.05


@pytest.mark.parametrize("kappa", [1e2, 1e6])
def test_condition_number_free_convergence(kappa):
    """Theorem 4.3's flavour: clipped-Newton steps do not grow with kappa;
    the diagonal from the port's exact_diag_hessian, the step count equal
    to the reference's."""
    def loss(t):
        return 0.5 * (kappa * t[0] ** 2 + 1.0 * t[1] ** 2)

    def count(grad, hess, clip, theta, lossf):
        steps = 0
        while float(lossf(theta)) > 1e-8 and steps < 200:
            u = clip(grad(theta) / hess(theta))
            theta = theta - 0.5 * u
            steps += 1
        return steps

    steps = count(torch.func.grad(loss),
                  lambda t: torch.clamp_min(exact_diag_hessian(loss, t),
                                            1e-12),
                  lambda u: torch.clamp(u, -10.0, 10.0),
                  torch.tensor([1.0, 1.0]), loss)
    j_steps = count(jax.grad(loss), lambda t: jnp.maximum(
        jnp.array([kappa, 1.0]), 1e-12), lambda u: jnp.clip(u, -10.0, 10.0),
        jnp.array([1.0, 1.0]), loss)
    assert steps <= 40, (kappa, steps)
    assert steps == j_steps


def test_signgd_depends_on_condition_number():
    """Theorem D.12: SignGD's steps scale with sqrt(beta / mu), through the
    port's per-leaf ``signgd`` (momentum 0): its updates are the
    reference's ``-lr * sign(grad)`` exactly, step for step."""
    def steps_to(eps, kappa, lr):
        def loss(t):
            return 0.5 * (kappa * t[0] ** 2 + t[1] ** 2)
        grad = torch.func.grad(loss)
        jgrad = jax.grad(loss)
        opt = signgd(lr, beta1=0.0)
        t = torch.tensor([0.0, float(np.sqrt(np.float32(2.0)))])
        jt = jnp.array([0.0, jnp.sqrt(2.0)])
        state = opt.init(t)
        for i in range(10000):
            if float(loss(t)) <= eps:
                return i
            upd, state = opt.update(grad(t), state, t)
            t = apply_updates(t, upd)
            if i < 20:
                jt = jt - lr * jnp.sign(jgrad(jt))
                np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
        return 10000

    s_small = steps_to(1e-2, 1e2, lr=float(np.sqrt(8 * 1e-2 / 1e2)))
    s_large = steps_to(1e-2, 1e4, lr=float(np.sqrt(8 * 1e-2 / 1e4)))
    assert s_large > 5 * s_small, (s_small, s_large)


# ---------------------------------------------------------------------------
# GPT2_TINY end to end


def test_sophia_trains_tiny_lm():
    """End to end: Sophia-G with GNB reduces GPT2_TINY's loss quickly (the
    reference's test and configuration: 60 steps, S=64, B=8)."""
    tc = TrainerConfig(optimizer="sophia_g", peak_lr=1e-3, total_steps=60,
                       warmup_steps=5, hess_interval=10, hess_subbatch=4,
                       grad_clip=1.0, seed=0)
    src = make_source(DataConfig(seq_len=64, global_batch=8,
                                 vocab_size=GPT2_TINY.vocab_size, seed=0))
    _, hist = train_loop(GPT2_TINY, tc, src, num_steps=60, device="cpu")
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first - 0.5, (first, last)


def test_per_leaf_api_follows_the_trainer():
    """The per-leaf API, ``chain(clip_by_global_norm(1.0), sophia_g(lr))``
    with ``gnb_estimator`` fed to ``update_hessian`` every 4 steps, trains
    GPT2_TINY (fp32) along the trainer's trajectory with
    ``fused_loss=False`` (the same loss, the same estimator from the same
    generator, the engine in place of the per-leaf update): 10 steps,
    losses within 1e-5 relative; the parameters under the trajectory
    contract of tests/test_torch_train.py with its shares measured here
    (0.050% of the coordinates beyond 3e-6 + 1e-5 |a|, 0.014% beyond 1e-5 +
    1e-5 |a|) held with a margin of 2x, at most 0.1% and 0.03%, and every
    coordinate within 2 lr (a clipped coordinate's step flips); the clip
    fraction of step 0 equal and the later ones within 2e-5 (18 of the
    889,600 coordinates).  The two round the update in another order (p +
    lr (u - wd p) against p (1 - lr wd) - lr u), and Sophia divides the
    momentum by gamma h, so a coordinate near the clip threshold can land
    on either side of it (the amplification of ROADMAP C)."""
    cfg = dataclasses.replace(GPT2_TINY, dtype="float32")
    tc = TrainerConfig(optimizer="sophia_g", peak_lr=1e-3, total_steps=10,
                       warmup_steps=2, hess_interval=4, hess_subbatch=2,
                       fused_loss=False, seed=0)
    src = make_source(DataConfig(seq_len=32, global_batch=4,
                                 vocab_size=cfg.vocab_size, seed=0))
    state, hist = train_loop(cfg, tc, src, num_steps=10, device="cpu")

    model = get_model(cfg)
    params = model.init_params(cfg, torch.Generator().manual_seed(tc.seed))
    tree = params.param_tree()
    opt = chain(clip_by_global_norm(tc.grad_clip),
                sophia_g(make_schedule(tc), beta1=tc.beta1, beta2=tc.beta2,
                         eps=tc.eps, weight_decay=tc.weight_decay))
    with torch.no_grad():
        opt_state = opt.init(tree)
    losses, clips = [], []
    for t in range(10):
        batch = to_device_batch(src.batch_at(t), "cpu")
        if t % tc.hess_interval == 0:
            sub = {k: v[:tc.hess_subbatch] for k, v in batch.items()}
            est = gnb_estimator(
                lambda _: model.logits_fn(cfg, params, sub, attn_impl="flash"),
                tree, hess_generator(train_key(tc.seed), t, "cpu"))
            opt_state = opt.update_hessian(est, opt_state)
        loss, _ = model.loss_fn(cfg, params, batch, attn_impl="flash",
                                loss_impl="chunked")
        grads = tree_unflatten(tree, torch.autograd.grad(
            loss, flat_tensors(tree)))
        with torch.no_grad():
            updates, opt_state = opt.update(grads, opt_state, tree)
            new = apply_updates(tree, updates)
            for p, v in zip(flat_tensors(tree), flat_tensors(new)):
                p.copy_(v)
        losses.append(float(loss.detach()))
        clips.append(float(opt_state[1].clip_fraction))
    np.testing.assert_allclose(losses, [h["loss"] for h in hist], rtol=1e-5)
    want = [h["sophia_clip_fraction"] for h in hist]
    assert clips[0] == want[0]
    np.testing.assert_allclose(clips, want, rtol=0, atol=2e-5)
    a = torch.cat([t.detach().reshape(-1) for t in flat_tensors(tree)])
    b = torch.cat([t.detach().reshape(-1) for t in
                   flat_tensors(state.params.param_tree())])
    off = (a - b).abs()
    assert float(off.max()) <= 2 * tc.peak_lr, float(off.max())
    for atol, share in ((3e-6, 1e-3), (1e-5, 3e-4)):
        bad = float((off > atol + 1e-5 * b.abs()).float().mean())
        assert bad <= share, (atol, bad)
    assert int(opt_state[1].hess_count) == int(state.opt_state.hess_count) \
        == 3
