"""The RWKV-6 family's training held against the JAX reference trainer on
rwkv6-7b's smoke config (fp32; the reference's weights, batches, GNB
noise seeds and Hutchinson probes passed to the port): every optimizer of
the engine, GNB and Hutchinson refreshes (the HVP forward-over-reverse
through the chunked WKV with ``torch.func``), and checkpoints across the
two packages, fp32 state both ways and bf16 state into the port."""
import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

from _rope_models import tcfg, trajectories
from _rwkv_models import ref_params, rwkv_cfg
from repro.data import DataConfig as JDataConfig
from repro.data import make_source as jax_make_source
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import checkpoint as jax_checkpoint
from repro.train import make_train_fns as jax_make_train_fns
from repro_torch.data import DataConfig, make_source
from repro_torch.train import (TrainerConfig, checkpoint, make_train_fns,
                               train_loop)
# the trajectory contract and the checkpoint helpers of the other families
from test_torch_checkpoint import (_hold_trajectory, _port_leaves,
                                   _ref_noise_of)
from test_torch_moe_train import _hold

torch.set_num_threads(1)


@pytest.mark.parametrize("over,steps,refreshes", [
    (dict(optimizer="sophia_g"), 6, 2),
    (dict(optimizer="adamw"), 3, 0),
    (dict(optimizer="lion"), 3, 0),
    (dict(optimizer="signgd"), 3, 0),
    (dict(optimizer="sgd"), 3, 0)])
def test_trajectory_matches_reference_trainer(over, steps, refreshes):
    """Sophia-G 6 steps with GNB refreshes at 0 and 4, and AdamW, Lion,
    SignGD and SGD, on the fused loss: the trajectory contract and equal
    refresh counts."""
    cfg = rwkv_cfg()
    hist, hist_ref, a, b, s_port, s_ref = trajectories(
        cfg, "full", over, steps, params=ref_params(cfg))
    assert int(s_port.opt_state.hess_count) == \
        int(s_ref.opt_state.hess_count) == refreshes
    _hold(hist, hist_ref, a, b, s_port, s_ref)


def test_adahessian_hutchinson_trajectory_matches_reference_trainer():
    """AdaHessian with a Hutchinson refresh at step 0 (the reference's
    probe), 3 steps, under the contract of tests/test_torch_train.py's
    AdaHessian test: AdaHessian divides by |u * Hu|, so a coordinate with a
    tiny estimate moves with its last bits (the reference against itself
    keeps only 80.79% of the coordinates within 3e-6 + 1e-5 |a| there).
    Equal refresh counts, the losses within 3e-3 relative, finite
    parameters, at most 3.6% of the coordinates beyond 1e-5 + 1e-5 |a|."""
    cfg = rwkv_cfg()
    hist, hist_ref, a, b, s_port, s_ref = trajectories(
        cfg, "full", dict(optimizer="adahessian", estimator="hutchinson"),
        3, params=ref_params(cfg))
    assert int(s_port.opt_state.hess_count) == \
        int(s_ref.opt_state.hess_count) == 1
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in hist_ref], rtol=3e-3)
    assert np.isfinite(b).all()
    bad = np.abs(b - a) > (1e-5 + 1e-5 * np.abs(a))
    print(f"AdaHessian: {bad.mean():.4%} of the coordinates beyond "
          f"1e-5 + 1e-5 |a|")
    assert bad.mean() <= 0.036, bad.mean()


def test_hutchinson_estimate_matches_reference():
    """Sophia-H's Hutchinson refresh at step 0 (the reference's probe;
    the HVP through the fused-loss twin and the chunked WKV): the loss
    within 1e-5 and the refreshed h within 1e-4 of its largest element,
    the dense family's bound."""
    cfg = rwkv_cfg()
    hist, hist_ref, _, _, s_port, s_ref = trajectories(
        cfg, "full", dict(optimizer="sophia_h", estimator="hutchinson"), 1,
        params=ref_params(cfg))
    np.testing.assert_allclose(hist[0]["loss"], hist_ref[0]["loss"],
                               atol=1e-5)
    for x, y in zip(s_port.opt_state.h, s_ref.opt_state.h):
        y = np.asarray(y)
        assert np.abs(y).max() > 0
        np.testing.assert_allclose(x.numpy(), y, rtol=0,
                                   atol=1e-4 * np.abs(y).max())


# ---------------------------------------------------------------------------
# checkpoints


TRAIN = dict(optimizer="sophia_g", peak_lr=5e-4, total_steps=64,
             warmup_steps=4, hess_interval=4, hess_subbatch=2,
             fused_loss=True, seed=0)
CUT, STEPS = 3, 6


def _src():
    return JDataConfig(seq_len=32, global_batch=4,
                       vocab_size=rwkv_cfg().vocab_size)


@functools.lru_cache(maxsize=None)
def _ref_fns(state_dtype):
    init_fn, step = jax_make_train_fns(
        rwkv_cfg(), JTrainerConfig(**TRAIN, state_dtype=state_dtype))
    return init_fn, jax.jit(step)


def _ref_steps(state_dtype, state, start, stop):
    _, step = _ref_fns(state_dtype)
    src = jax_make_source(_src())
    losses = []
    for t in range(start, stop):
        batch = {k: jax.numpy.asarray(v) for k, v in src.batch_at(t).items()}
        state, met = step(state, batch, t % TRAIN["hess_interval"] == 0)
        losses.append(float(met["loss"]))
    return state, losses


def _port_steps(state_dtype, state, start, stop):
    tc = TrainerConfig(**TRAIN, state_dtype=state_dtype)
    src = make_source(DataConfig(**dataclasses.asdict(_src())))
    state, hist = train_loop(tcfg(rwkv_cfg()), tc, src,
                             num_steps=stop - start, state=state,
                             device="cpu", start_step=start,
                             hess_seed_fn=_ref_noise_of(state.rng))
    return state, [h["loss"] for h in hist]


def _fresh(state_dtype):
    tc = TrainerConfig(**TRAIN, state_dtype=state_dtype)
    return make_train_fns(tcfg(rwkv_cfg()), tc, device="cpu")[0]()


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_and_continues(tmp_path, state_dtype):
    """The reference trains 3 steps and saves; the port restores into a
    fresh state, every leaf bit for bit (the stacked ``tm``/``cm`` leaves
    in the reference's sorted order; bf16 state from numpy's void); then
    both continue 3 steps (a GNB refresh at step 4 on the reference's
    noise seeds): the trajectory contract."""
    init_fn, _ = _ref_fns(state_dtype)
    ref, _ = _ref_steps(state_dtype, init_fn(jax.random.PRNGKey(0)), 0, CUT)
    jax_checkpoint.save(str(tmp_path), CUT, ref)
    restored, step = checkpoint.restore(str(tmp_path), _fresh(state_dtype))
    assert step == restored.step == CUT
    got, want = _port_leaves(restored), jax.tree.leaves(ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    port, port_losses = _port_steps(state_dtype, restored, CUT, STEPS)
    ref, ref_losses = _ref_steps(state_dtype, ref, CUT, STEPS)
    _hold_trajectory(port_losses, ref_losses, port, ref)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """The port trains 3 steps and saves (fp32 state): its files are the
    reference's own save of the same state, leaf for leaf, the reference's
    ``restore`` reads them back bit for bit, and both continue 3 steps
    under the trajectory contract."""
    port, _ = _port_steps("float32", _fresh("float32"), 0, CUT)
    ours, theirs = tmp_path / "port", tmp_path / "reference"
    checkpoint.save(str(ours), CUT, port)
    like = _ref_fns("float32")[0](jax.random.PRNGKey(0))
    leaves = _port_leaves(port)
    jax_checkpoint.save(str(theirs), CUT, jax.tree.unflatten(
        jax.tree.structure(like), leaves))
    m_ours = checkpoint.read_manifest(str(ours))
    m_theirs = jax_checkpoint.read_manifest(str(theirs))
    for key in ("step", "n_leaves", "shapes", "dtypes"):
        assert m_ours[key] == m_theirs[key], key
    step_dir = f"step_{CUT:08d}"
    for i in range(m_ours["n_leaves"]):
        a = np.load(os.path.join(ours, step_dir, f"leaf_{i:05d}.npy"))
        b = np.load(os.path.join(theirs, step_dir, f"leaf_{i:05d}.npy"))
        assert a.tobytes() == b.tobytes(), i
    ref, step = jax_checkpoint.restore(str(ours), like)
    assert step == CUT
    for g, w in zip(leaves, jax.tree.leaves(ref)):
        np.testing.assert_array_equal(np.asarray(w), g)
    ref, ref_losses = _ref_steps("float32", ref, CUT, STEPS)
    port, port_losses = _port_steps("float32", port, CUT, STEPS)
    _hold_trajectory(port_losses, ref_losses, port, ref)
