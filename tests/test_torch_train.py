"""The port's training slice (repro_torch.train) held against the JAX
reference's trainer: a Sophia-G trajectory on GPT2_TINY (fp32) over three
full Hessian-refresh intervals with the reference's weights, batches and
noise seeds (and on the chunked loss with the reference's Gumbel noise);
bit-identical data batches; checkpoint save / restore / continue; remat;
the launcher on the CPU; and the options the port does not have yet."""
import dataclasses
import io
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from repro.configs.gpt2 import GPT2_TINY
from repro.core.engine import ravel_shards as jax_ravel_shards
from repro.data import DataConfig as JDataConfig
from repro.data import MemmapTokens as JMemmapTokens
from repro.data import make_source as jax_make_source
from repro.kernels.fused_ce import seed_from_key, vocab_chunk
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import make_engine as jax_make_engine
from repro.train import make_train_fns as jax_make_train_fns
from repro.train import train_loop as jax_train_loop
from repro.train.trainer import RNG_TAG_HESS
from repro_torch.convert import params_from_jax
from repro_torch.core import build_layout, ravel_shards
from repro_torch.data import DataConfig, MemmapTokens, make_source
from repro_torch.launch import train as torch_launch
from repro_torch.models import ModelConfig, get_model
from repro_torch.train import (TrainerConfig, checkpoint, make_train_fns,
                               train_loop)

# One intra-op thread per process: the suite runs six pytest-xdist workers
# on the machine's cores, and torch's default pool in every worker
# oversubscribes them, slowing every test beside it (JAX's too) severalfold.
torch.set_num_threads(1)

CFG32 = dataclasses.replace(GPT2_TINY, dtype="float32")
TCFG32 = ModelConfig(**dataclasses.asdict(CFG32))
TRAIN = dict(optimizer="sophia_g", peak_lr=5e-4, total_steps=64,
             warmup_steps=4, hess_interval=4, hess_subbatch=4, seed=0)


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _src(B=8, S=32, seed=0):
    return JDataConfig(seq_len=S, global_batch=B,
                       vocab_size=GPT2_TINY.vocab_size, seed=seed)


# ---------------------------------------------------------------------------
# data


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_batches_bit_identical(seed):
    cfg = _src(B=3, S=17, seed=seed)
    ref = jax_make_source(cfg)
    port = make_source(DataConfig(**dataclasses.asdict(cfg)))
    for step in (0, 1, 7, 1000):
        a, b = ref.batch_at(step), port.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_memmap_batches_bit_identical(tmp_path):
    path = tmp_path / "train.bin"
    np.random.default_rng(0).integers(0, 500, 4096).astype(
        np.uint16).tofile(path)
    cfg = dict(seq_len=16, global_batch=4, vocab_size=500, seed=2,
               source="memmap", path=str(path))
    ref, port = JMemmapTokens(JDataConfig(**cfg)), MemmapTokens(
        DataConfig(**cfg))
    for step in (0, 5):
        for k, v in ref.batch_at(step).items():
            np.testing.assert_array_equal(port.batch_at(step)[k], v)


# ---------------------------------------------------------------------------
# the trajectory


@pytest.mark.parametrize("fused_attn", [False, True],
                         ids=["materialized_attn", "flash_attn"])
def test_trajectory_matches_reference_trainer(fused_attn):
    """13 steps with the refresh every 4 (at 0, 4, 8, 12: three full
    intervals), fused loss, flash attention (the reference's Pallas kernels
    in interpret mode against the port's plain versions) or the
    materialized-scores route, reference engine backend, the reference's
    weights, batches and noise seeds.
    Contract of tests/test_unified_step.py: equal hess_count; losses to
    rtol 1e-4 / atol 1e-5; all parameter coordinates within 2e-3; m and h
    within 2e-3.  Its quantile (>= 99.99% of coordinates within 3e-6 +
    1e-5 |a|) sits at the rounding floor of one framework: the reference
    against itself, jit against eager on this very run, keeps 99.990%
    within it.  The gradients of the two packages agree to ~1e-6 of each
    leaf's scale (sums in another order), and Sophia divides the momentum
    by gamma * h, which is below 1e-6 on most coordinates here, so those
    differences are amplified by up to 1e10 on the few coordinates whose
    momentum is itself at that level.  Across frameworks 99.97% stay
    within 3e-6 and 99.99% within 1e-5 + 1e-5 |a| (ROADMAP C); the test
    holds 99.95% at 3e-6 and 99.99% at 1e-5."""
    s_port, _ = _check_trajectory(dict(TRAIN, fused_attn=fused_attn))
    assert int(s_port.opt_state.hess_count) == 4


def test_adamw_trajectory_matches_reference_trainer():
    """The same 13 steps with AdamW on the engine kernels (``fused_kernel
    =True``: the reference's Pallas kernel in interpret mode against the
    port's plain version), flash attention, under the same contract as
    :func:`test_trajectory_matches_reference_trainer`."""
    s_port, _ = _check_trajectory(dict(TRAIN, optimizer="adamw",
                                       fused_kernel=True))
    assert int(s_port.opt_state.hess_count) == 0


def test_sgd_trajectory_holds_every_coordinate():
    """SGD on the engine kernels, 13 steps: the contract of
    :func:`test_trajectory_matches_reference_trainer` and AdamW's margin,
    every parameter coordinate within 3e-6."""
    s_port, _ = _check_trajectory(dict(TRAIN, optimizer="sgd",
                                       fused_kernel=True), every=3e-6)
    assert s_port.opt_state.h == ()


def test_adahessian_hutchinson_trajectory_matches_reference_trainer():
    """AdaHessian with the Hutchinson estimator (the loss and flash twins,
    the reference's probes passed in) on the engine kernels, 13 steps,
    refreshing at 0, 4, 8, 12.  Both packages take H u forward-over-
    reverse, and the step-0 estimates differ by summation order alone
    (median relative difference 1.2e-6; the reference's op-by-op run
    against its jit, 8.7e-7), but AdaHessian divides by |u ⊙ Hu|: a
    coordinate with |u ⊙ Hu| ~ 5e-6 takes a step of ~0.1 whose size
    moves with the last bits of its estimate.  The reference against
    itself shows it (``tests/_trajectory_spread.py --perturb``, ROADMAP
    C): fed its own op-by-op estimate at each refresh it keeps only
    80.79% of the coordinates within 3e-6 + 1e-5 |a| and 92.13% within
    1e-5 + 1e-5 |a| of its jitted run; fed the port's, 91.21% and 96.51%,
    the port's own trajectory; with the gradient alone perturbed by 1e-6
    of each element, 99.9988%.  The test holds the measured state with a
    margin of about 1.5x on the losses and 3% on the share: equal refresh
    counts, the losses within 3e-3 relative (measured 2.04e-3), finite
    parameters, at most 3.6% of the coordinates beyond 1e-5 + 1e-5 |a|
    (measured 3.49%)."""
    over = dict(TRAIN, optimizer="adahessian", estimator="hutchinson",
                fused_kernel=True)
    s_port, s_ref, hist, hist_ref, a, b = _run_trajectories(over)
    assert int(s_port.opt_state.hess_count) == \
        int(s_ref.opt_state.hess_count) == 4
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in hist_ref], rtol=3e-3)
    assert np.isfinite(b).all()
    bad = np.abs(b - a) > (1e-5 + 1e-5 * np.abs(a))
    assert bad.mean() <= 0.036, bad.mean()


@pytest.mark.parametrize("over,shares", [
    pytest.param(dict(optimizer="lion", fused_kernel=True),
                 ((3e-6, 5e-4), (1e-5, 5e-4)), id="lion"),
    pytest.param(dict(optimizer="signgd", fused_kernel=True), None,
                 id="signgd"),
    pytest.param(dict(optimizer="sophia_h", estimator="hutchinson",
                      fused_kernel=True), ((3e-6, 1e-5), (1e-5, 1e-5)),
                 id="sophia_h-hutchinson")])
def test_sign_trajectory_matches_reference_trainer(over, shares):
    """Lion, SignGD and Sophia-H (Hutchinson, the reference's probes) on
    the engine kernels, 13 steps, under Sophia-G's contract
    (:func:`test_trajectory_matches_reference_trainer`): their updates
    take the sign of a momentum (Sophia-H's clip mostly), so a coordinate
    whose sign argument sits at the rounding level steps +-lr apart.
    Lion signs every coordinate: 148 of 889,600 (0.017%) flip, each by
    2 lr, so it holds 99.95% at both tolerances (ROADMAP C).  Sophia-H,
    its HVP forward-over-reverse as the reference's, puts 6 of 889,600
    coordinates beyond either tolerance, as many as the reference's own
    eager run against its jit: it holds at most 1e-5 of them at both
    (1.5x the measured 6.7e-6)."""
    s_port, _ = _check_trajectory(dict(TRAIN, **over), shares=shares)
    assert int(s_port.opt_state.hess_count) == \
        (4 if over["optimizer"] == "sophia_h" else 0)


def test_unfused_loss_trajectory_matches_reference_trainer():
    """Sophia-G with ``fused_loss=False`` (the reference's chunked loss, and
    its GNB refresh from the sub-batch's materialized logits through
    ``logits_fn`` and ``gnb_ghat_flat``), flash attention, 3 steps with the
    refresh at step 0, the reference's Gumbel noise passed in through
    ``noise_fn``: the contract of
    :func:`test_trajectory_matches_reference_trainer`."""
    s_port, _ = _check_trajectory(dict(TRAIN, fused_loss=False), steps=3)
    assert int(s_port.opt_state.hess_count) == 1


@pytest.mark.parametrize("estimator", ["hutchinson", "gnb"])
def test_refresh_is_identical_under_remat(estimator):
    """One Sophia step with a refresh at remat "full" and at "none", the
    same probe: the same loss, Hessian EMA and parameters, bit for bit.
    The Hutchinson HVP runs its trunk without remat
    (``torch.utils.checkpoint`` does not compose with ``torch.func``), GNB
    through the checkpointed trunk."""
    src = make_source(DataConfig(**dataclasses.asdict(_src(B=2, S=16))))
    out = []
    for remat in ("none", "full"):
        over = dict(TRAIN, hess_subbatch=1, remat=remat,
                    optimizer="sophia_h" if estimator == "hutchinson"
                    else "sophia_g", estimator=estimator)
        state, hist = train_loop(TCFG32, TrainerConfig(**over), src,
                                 num_steps=1, device="cpu")
        out.append((hist[0]["loss"], state))
    (l0, s0), (l1, s1) = out
    assert l0 == l1 and int(s0.opt_state.hess_count) == 1
    for a, b in zip(s0.opt_state.h + s0.opt_state.m,
                    s1.opt_state.h + s1.opt_state.m):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(s0.params.parameters(), s1.params.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def step0_gradients(attn="flash"):
    """Per leaf of GPT2_TINY (fp32, the trainer's initial weights, batch
    0 of the trajectory's source, the fused loss on ``attn``): (path,
    the reference's jit gradient, its eager gradient, the port's), as
    numpy arrays, stacked leaves stacked."""
    from repro.models import get_model as jax_get_model
    from repro_torch.core.types import flat_tensors, tree_leaves

    jtc = JTrainerConfig(fused_loss=True, **TRAIN)
    params = jax_make_train_fns(CFG32, jtc)[0](jax.random.PRNGKey(0)).params
    batch = jax_make_source(_src()).batch_at(0)
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}

    def f(p):
        return jax_get_model(CFG32).loss_fn(CFG32, p, jb, attn_impl=attn,
                                            loss_impl="fused")[0]

    g_jit = jax.jit(jax.grad(f))(params)
    g_eager = jax.grad(f)(params)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), TCFG32)
    tree = tparams.param_tree()
    grads = iter(torch.autograd.grad(
        get_model(TCFG32).loss_fn(TCFG32, tparams, tb, attn_impl=attn)[0],
        flat_tensors(tree)))
    port = [_np(torch.stack([next(grads) for _ in leaf])
                if isinstance(leaf, list) else next(grads))
            for leaf in tree_leaves(tree)]
    paths = [jax.tree_util.keystr(path) for path, _ in
             jax.tree_util.tree_flatten_with_path(g_jit)[0]]
    return [(path, np.asarray(a), np.asarray(e), p) for path, a, e, p in
            zip(paths, jax.tree.leaves(g_jit), jax.tree.leaves(g_eager),
                port)]


def test_step0_gradients_match_reference_within_its_own_spread():
    """The step-0 gradient of every leaf (GPT2_TINY, fp32, the trainer's
    batch and flash attention: the reference's Pallas kernels in
    interpret mode, the port's plain versions) against the reference's
    jit, held to the reference's own spread, its eager gradient against
    its jit: within 3x that spread per leaf, the spread floored at 2^-22
    of the leaf's largest element (the final norm's eager and jit
    gradients are identical).  Measured: 1.3-2.5x on every leaf (embedding,
    attention, MLP, both norms, the CE), 6e-7 to 1.4e-6 of each leaf's
    scale; no module stands out, so the trajectory quantile misses of
    Lion and Sophia-G are amplification of summation-order differences
    (ROADMAP C)."""
    for path, a, e, p in step0_gradients():
        scale = np.abs(a).max()
        spread = max(np.abs(e - a).max(), 2.0 ** -22 * scale)
        assert np.abs(p - a).max() <= 3.0 * spread, \
            (path, np.abs(p - a).max() / scale, spread / scale)


def _run_trajectories(over, steps=13):
    """13 steps of the reference trainer and of the port on its weights,
    batches, noise seeds, Gumbel noise and Hutchinson probes with the
    options ``over`` (the fused loss unless they say otherwise): (port
    state, reference state, the two histories, the reference's and the
    port's parameters raveled)."""
    jtc = JTrainerConfig(**dict(dict(fused_loss=True), **over))
    src = jax_make_source(_src())
    init_fn, _ = jax_make_train_fns(CFG32, jtc)
    s0 = init_fn(jax.random.PRNGKey(jtc.seed))
    s_ref, hist_ref = jax_train_loop(CFG32, jtc, src, num_steps=steps)

    def ref_rng(step):
        return jax.random.fold_in(jax.random.fold_in(s0.rng, RNG_TAG_HESS),
                                  step)

    def ref_seed(step):
        return np.asarray(seed_from_key(ref_rng(step)))

    def ref_probe(step, layout):
        keys = jax.random.split(ref_rng(step), layout.n_shards)
        return tuple(torch.from_numpy(np.array(
            jax.random.normal(k, (n,), jax.numpy.float32)))
            for k, n in zip(keys, layout.shard_sizes))

    def ref_noise(step, shape):
        # the chunked sweep of gnb_ghat_flat: chunk c from fold_in(rng, c)
        n_rows, vp = int(np.prod(shape[:-1])), shape[-1]
        bv = vocab_chunk(vp, 4096)
        return torch.from_numpy(np.concatenate([np.asarray(
            jax.random.gumbel(jax.random.fold_in(ref_rng(step), c),
                              (n_rows, bv), jax.numpy.float32))
            for c in range(vp // bv)], axis=1)).reshape(shape)

    tc = TrainerConfig(**over)
    params = params_from_jax(jax.tree.map(np.asarray, s0.params), TCFG32)
    t_init, _ = make_train_fns(TCFG32, tc, device="cpu")
    s_port, hist = train_loop(TCFG32, tc, src, num_steps=steps,
                              state=t_init(params), device="cpu",
                              hess_seed_fn=ref_seed, probe_fn=ref_probe,
                              noise_fn=ref_noise)
    lay = jax_make_engine(jtc).layout(s_ref.params)
    a = np.asarray(jax_ravel_shards(lay, s_ref.params)[0])[:lay.n_params]
    tree = s_port.params.param_tree()
    b = _np(ravel_shards(build_layout(tree), tree)[0])[:lay.n_params]
    return s_port, s_ref, hist, hist_ref, a, b


def _check_trajectory(over, every=None, shares=None, steps=13):
    """The trajectories of :func:`_run_trajectories` under the contract of
    :func:`test_trajectory_matches_reference_trainer` (``shares``: the
    largest share of coordinates beyond each tolerance), and with
    ``every`` each parameter coordinate within it."""
    s_port, s_ref, hist, hist_ref, a, b = _run_trajectories(over, steps)
    assert int(s_port.opt_state.hess_count) == \
        int(s_ref.opt_state.hess_count)
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in hist_ref],
                               rtol=1e-4, atol=1e-5)
    for key in ("grad_norm", "lr", "sophia_clip_fraction"):
        if key in hist_ref[0]:
            np.testing.assert_allclose([h[key] for h in hist],
                                       [h[key] for h in hist_ref],
                                       rtol=1e-3, atol=1e-6, err_msg=key)
    for atol, share in shares or ((3e-6, 5e-4), (1e-5, 1e-4)):
        bad = np.abs(b - a) > (atol + 1e-5 * np.abs(a))
        assert bad.mean() <= share, \
            f"{bad.sum()} / {bad.size} coordinates beyond {atol}"
    np.testing.assert_allclose(b, a, rtol=1e-2, atol=2e-3)
    if every is not None:
        assert np.abs(b - a).max() <= every, np.abs(b - a).max()
    for x, y in zip(s_port.opt_state.m + s_port.opt_state.h,
                    s_ref.opt_state.m + s_ref.opt_state.h):
        np.testing.assert_allclose(_np(x), np.asarray(y, np.float32),
                                   rtol=1e-2, atol=2e-3)
    return s_port, s_ref


@pytest.mark.parametrize("bucket", [None, 1536])
def test_flat_clip_is_the_tree_clip(bucket):
    """``trainer.clip_reduced`` on the raveled gradients (one rank) against
    ``clip_by_global_norm`` on the tree: over whole shards the norm and
    the clipped values bit for bit; over buckets that split leaves (the
    compressed pipeline's pieces) the norm within 1e-6 relative."""
    from repro_torch.core import clip_by_global_norm
    from repro_torch.core.types import tree_map
    from repro_torch.train import make_engine
    from repro_torch.train.trainer import clip_reduced, norm_parts

    params = get_model(TCFG32).init_params(TCFG32,
                                           torch.Generator().manual_seed(0))
    tree = params.param_tree()
    gen = torch.Generator().manual_seed(1)
    grads = tree_map(lambda t: torch.randn(t.shape, generator=gen), tree)
    clip = clip_by_global_norm(1.0)
    want, c_want = clip.update(grads, clip.init(tree))
    engine = make_engine(TrainerConfig())
    lay = engine.layout(tree)
    g_sh = engine.ravel_grads(tree, grads)
    if bucket is None:
        pieces = [(g, False, i, 0) for i, g in enumerate(g_sh)]
    else:
        pieces = [(g[a:a + bucket], False, i, a) for i, g in enumerate(g_sh)
                  for a in range(0, g.numel(), bucket)]
    c_got = clip_reduced(pieces, norm_parts(lay, tree), clip.init(tree), 1.0)
    if bucket is None:
        assert torch.equal(c_got.last_norm, c_want.last_norm)
        for a, b in zip(g_sh, engine.ravel_grads(tree, want)):
            assert torch.equal(a, b)
    else:
        torch.testing.assert_close(c_got.last_norm, c_want.last_norm,
                                   rtol=1e-6, atol=0)
    assert int(c_got.triggers) == int(c_want.triggers) == 1


def test_grad_accumulation_averages_microbatches():
    """grad_accum=2 on one batch: the mean of the two microbatches' losses
    and gradients, so the loss, the pre-clip gradient norm and the update
    match a single full-batch step (no mask: the means coincide)."""
    src = make_source(DataConfig(**dataclasses.asdict(_src(B=4, S=16))))
    out = []
    for accum in (1, 2):
        tc = TrainerConfig(**dict(TRAIN, grad_accum=accum))
        state, hist = train_loop(TCFG32, tc, src, num_steps=2, device="cpu")
        out.append((hist, torch.cat([p.detach().reshape(-1)
                                     for p in state.params.parameters()])))
    (h1, p1), (h2, p2) = out
    for key in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in h2],
                                   [h[key] for h in h1], rtol=1e-5,
                                   err_msg=key)
    torch.testing.assert_close(p2, p1, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# checkpoint


@pytest.mark.parametrize("state_dtype,over", [
    pytest.param("float32", {}, id="float32"),
    pytest.param("bfloat16", {}, id="bfloat16"),
    pytest.param("float32", dict(optimizer="adamw", fused_kernel=True),
                 id="adamw-fused_kernel-float32")])
def test_checkpoint_resume_matches_uninterrupted(tmp_path, state_dtype,
                                                 over):
    """Save after 3 of 6 steps (a refresh on each side of the cut),
    restore into a fresh state, continue: the same state, bit for bit, as
    six steps without the cut.  AdamW keeps v in the h slot and its bias
    correction on the restored count."""
    tc = TrainerConfig(**dict(TRAIN, hess_interval=2, hess_subbatch=2,
                              state_dtype=state_dtype, **over))
    src = make_source(DataConfig(**dataclasses.asdict(_src(B=4, S=16))))
    straight, _ = train_loop(TCFG32, tc, src, num_steps=6, device="cpu")
    half, _ = train_loop(TCFG32, tc, src, num_steps=3, device="cpu")
    checkpoint.save(str(tmp_path), 3, half, keep=2)
    assert checkpoint.latest_step(str(tmp_path)) == 3
    init_fn, _ = make_train_fns(TCFG32, tc, device="cpu")
    fresh = init_fn()
    with torch.no_grad():
        for p in fresh.params.parameters():
            p.zero_()
    restored, step = checkpoint.restore(str(tmp_path), fresh)
    assert step == restored.step == 3
    resumed, _ = train_loop(TCFG32, tc, src, num_steps=3, state=restored,
                            device="cpu", start_step=3)
    assert resumed.step == straight.step == 6
    for a, b in zip(resumed.params.parameters(),
                    straight.params.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(resumed.opt_state[:4], straight.opt_state[:4]):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert x.dtype == y.dtype
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    for a, b in zip(resumed.clip_state, straight.clip_state):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for s in (4, 5):
        checkpoint.save(str(tmp_path), s, resumed, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000004", "step_00000005"]


# ---------------------------------------------------------------------------
# the launcher


def test_launcher_smoke_on_cpu(tmp_path):
    out = io.StringIO()
    args = ["--smoke", "--device", "cpu", "--steps", "3", "--seq-len", "16",
            "--global-batch", "2", "--hess-subbatch", "1",
            "--hess-interval", "2", "--log-every", "1",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    with redirect_stdout(out):
        state = torch_launch.main(args)
    lines = out.getvalue().splitlines()
    assert [ln.split()[:2] for ln in lines if ln.startswith("step")] == [
        ["step", "0"], ["step", "1"], ["step", "2"]]
    assert all("loss" in ln and "gnorm" in ln
               for ln in lines if ln.startswith("step"))
    assert state.step == 3 and int(state.opt_state.hess_count) == 2
    assert checkpoint.latest_step(str(tmp_path)) == 3
    manifest = checkpoint.read_manifest(str(tmp_path))
    assert manifest["extra"]["optimizer"] == "sophia_g"
    with redirect_stdout(io.StringIO()) as again:
        torch_launch.main(args[:4] + ["5"] + args[5:])
    assert "[resume] restored step 3" in again.getvalue()
    with pytest.raises(SystemExit, match="refusing to resume"):
        torch_launch.main(args + ["--state-dtype", "bfloat16"])


def test_launcher_no_fused_attn_trains_on_materialized_route(monkeypatch):
    """--no-fused-attn trains on the materialized-scores attention and the
    default on the flash route: the launcher hands the trainer
    fused_attn False or True, and two steps give finite losses.  The smoke
    config computes in bf16, where the two routes round differently (the
    flash route keeps p in fp32 until o), so step 0's losses agree only to
    ~1e-4 relative."""
    seen = []
    real = torch_launch.make_train_fns

    def spy(cfg, tc, **kw):
        seen.append(tc.fused_attn)
        return real(cfg, tc, **kw)

    monkeypatch.setattr(torch_launch, "make_train_fns", spy)
    args = ["--smoke", "--device", "cpu", "--steps", "2", "--seq-len", "16",
            "--global-batch", "2", "--hess-subbatch", "1", "--log-every",
            "1"]
    losses = []
    for extra in (["--no-fused-attn"], []):
        with redirect_stdout(io.StringIO()) as out:
            state = torch_launch.main(args + extra)
        assert state.step == 2
        losses.append([float(ln.split()[3]) for ln in
                       out.getvalue().splitlines() if ln.startswith("step")])
    assert seen == [False, True]
    assert all(np.isfinite(losses).ravel())
    np.testing.assert_allclose(losses[0][0], losses[1][0], rtol=1e-3)


@pytest.mark.parametrize("extra", [["--fused-kernel"], ["--opt", "adamw"],
                                   ["--opt", "adamw", "--fused-kernel"]])
def test_launcher_fused_kernel_and_adamw_on_cpu(tmp_path, extra):
    """--fused-kernel and --opt adamw train on the CPU.  --fused-kernel
    logs the default run's losses digit for digit (the engine kernels'
    plain versions are the reference backend's operations); AdamW has no
    refresh, resumes from its checkpoint and refuses one of Sophia-G."""
    args = ["--smoke", "--device", "cpu", "--steps", "3", "--seq-len", "16",
            "--global-batch", "2", "--hess-subbatch", "1",
            "--hess-interval", "2", "--log-every", "1"]

    def run(argv):
        with redirect_stdout(io.StringIO()) as out:
            state = torch_launch.main(argv)
        return state, [ln.split()[3] for ln in out.getvalue().splitlines()
                       if ln.startswith("step")]

    state, losses = run(args + extra)
    assert state.step == 3 and all(np.isfinite(np.float64(losses)))
    adamw = "adamw" in extra
    assert int(state.opt_state.hess_count) == (0 if adamw else 2)
    if not adamw:
        assert losses == run(args)[1]
        return
    ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    run(args + extra + ckpt)
    with redirect_stdout(io.StringIO()) as again:
        torch_launch.main(args[:4] + ["5"] + args[5:] + extra + ckpt)
    assert "[resume] restored step 3" in again.getvalue()
    assert checkpoint.read_manifest(str(tmp_path))["extra"]["optimizer"] \
        == "adamw"
    with pytest.raises(SystemExit, match="refusing to resume"):
        torch_launch.main(args + ckpt)


@pytest.mark.parametrize("flag", [["--compress-grads"],
                                  ["--comm-telemetry"]])
def test_launcher_unported_flags_raise(flag, capsys):
    """The flags the launcher refused before the data-parallel slice
    (``NotImplementedError``) now train: a finite loss, and with
    ``--comm-telemetry`` the ``comm`` field on the step line."""
    torch_launch.main(["--smoke", "--device", "cpu", "--steps", "1",
                       "--seq-len", "16", "--global-batch", "2",
                       "--hess-subbatch", "1", *flag])
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("step")][0]
    assert np.isfinite(float(line.split()[3]))
    assert ("% of step)" in line) == (flag == ["--comm-telemetry"])


@pytest.mark.parametrize("extra,refreshes", [
    (["--opt", "lion"], 0),
    (["--opt", "adahessian", "--estimator", "hutchinson", "--fused-kernel"],
     2),
    (["--estimator", "hutchinson"], 2),
    (["--opt", "sophia_h", "--estimator", "hutchinson", "--no-fused-attn"],
     2),
    (["--no-fused-loss"], 2),
    (["--remat", "full"], 2)])
def test_launcher_baselines_and_estimators_on_cpu(tmp_path, monkeypatch,
                                                  extra, refreshes):
    """The paper's other optimizers, the Hutchinson estimator, the chunked
    loss (``--no-fused-loss``) and remat train from the launcher: finite
    losses, a refresh at steps 0 and 2 for the hessian-aware ones, and a
    resume under another --opt refused."""
    args = ["--smoke", "--device", "cpu", "--steps", "3", "--seq-len", "16",
            "--global-batch", "2", "--hess-subbatch", "1",
            "--hess-interval", "2", "--log-every", "1",
            "--ckpt-dir", str(tmp_path)]
    seen = []
    real = torch_launch.make_train_fns

    def spy(cfg, tc, **kw):
        seen.append(tc)
        return real(cfg, tc, **kw)

    monkeypatch.setattr(torch_launch, "make_train_fns", spy)
    with redirect_stdout(io.StringIO()) as out:
        state = torch_launch.main(args + extra)
    losses = [float(ln.split()[3]) for ln in out.getvalue().splitlines()
              if ln.startswith("step")]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert state.step == 3
    assert int(state.opt_state.hess_count) == refreshes
    opt = extra[1] if extra[0] == "--opt" else "sophia_g"
    assert ("--remat" in extra) == (seen[-1].remat == "full")
    assert ("--no-fused-loss" in extra) != seen[-1].fused_loss
    assert checkpoint.read_manifest(str(tmp_path))["extra"]["optimizer"] \
        == opt
    other = "sgd" if opt != "sgd" else "lion"
    with pytest.raises(SystemExit, match="refusing to resume"):
        torch_launch.main(args + ["--opt", other])


@pytest.mark.parametrize("over", [dict(compress_hess=True)])
def test_trainer_unported_options_raise(over):
    """``compress_hess``, refused before the data-parallel slice
    (``NotImplementedError``), now trains: two steps with a refresh at
    step 0, finite losses; an unknown estimator still raises."""
    src = make_source(DataConfig(**dataclasses.asdict(_src(B=2, S=16))))
    tc = TrainerConfig(**dict(TRAIN, hess_subbatch=1, **over))
    state, hist = train_loop(TCFG32, tc, src, num_steps=2, device="cpu")
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert int(state.opt_state.hess_count) == 1
    with pytest.raises(ValueError):
        make_train_fns(TCFG32, TrainerConfig(**over, estimator="nope"),
                       device="cpu")


@pytest.mark.parametrize("over", [
    dict(attn_impl="flash_jvp"), dict(optimizer="lion"),
    dict(estimator="empirical_fisher"),
    dict(optimizer="sophia_h", estimator="hutchinson"),
    dict(attn_impl="chunked"), dict(fused_loss=False), dict(remat="dots"),
    dict(remat="scan2", fused_loss=False, estimator="empirical_fisher"),
    dict(optimizer="sophia_h", estimator="hutchinson", fused_loss=False,
         remat="full")])
def test_trainer_takes_the_ported_options(over):
    """Options the trainer refused before (the attention twin, the other
    optimizers and estimators, chunked attention, the chunked loss, every
    remat policy) train two steps on the CPU (a refresh at step 0 for the
    hessian-aware ones): finite losses, and the loss of the attention twin,
    of remat and of the chunked loss equals the default route's at step
    0 (chunked attention's within 1e-6)."""
    src = make_source(DataConfig(**dataclasses.asdict(_src(B=2, S=16))))
    tc = TrainerConfig(**dict(TRAIN, hess_subbatch=1, **over))
    state, hist = train_loop(TCFG32, tc, src, num_steps=2, device="cpu")
    assert all(np.isfinite(h["loss"]) for h in hist)
    aware = tc.optimizer != "lion"
    assert int(state.opt_state.hess_count) == int(aware)
    _, ref = train_loop(TCFG32, TrainerConfig(**dict(TRAIN,
                                                     hess_subbatch=1)),
                        src, num_steps=1, device="cpu")
    if over.get("attn_impl") == "chunked":
        np.testing.assert_allclose(hist[0]["loss"], ref[0]["loss"],
                                   rtol=1e-6)
    elif "optimizer" not in over and "estimator" not in over or \
            over.get("attn_impl") == "flash_jvp":
        assert hist[0]["loss"] == ref[0]["loss"]


def test_trainer_refuses_an_unknown_estimator():
    with pytest.raises(ValueError, match="estimator"):
        make_train_fns(TCFG32, TrainerConfig(estimator="nope"), device="cpu")
    for over in (dict(remat="nope"), dict(attn_impl="nope")):
        with pytest.raises(ValueError):
            make_train_fns(TCFG32, TrainerConfig(**over), device="cpu")


def test_hess_seed_is_a_pure_function_of_seed_and_step():
    from repro_torch.train import hess_seed
    seeds = {hess_seed(0, step) for step in range(64)}
    assert len(seeds) == 64
    assert hess_seed(0, 5) == hess_seed(0, 5) != hess_seed(1, 5)
    assert all(0 <= v < 2 ** 32 for pair in seeds for v in pair)


def test_trainer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_fns(TCFG32, TrainerConfig())
