"""The encoder-decoder family's training held against the JAX reference
trainer on seamless-m4t-medium's smoke config (fp32; the reference's
weights, batches with frames, GNB noise seeds and Hutchinson probes passed
to the port): Sophia-G with GNB refreshes through the flash route (the
encoder's bidirectional attention and the cross-attention of Sq 16 over
Sk 24 frames among it), Sophia-H's Hutchinson refresh (the HVP
forward-over-reverse through the flash twin at ``causal=False`` and Sq !=
Sk, ``torch.func``), and checkpoints across the two packages (the stacked
``encoder`` and ``decoder`` leaves)."""
import functools

import jax
import numpy as np
import torch

from _encdec_models import FrameSource, encdec_cfg, ref_params
from _rope_models import tcfg, trajectories
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import checkpoint as jax_checkpoint
from repro.train import make_train_fns as jax_make_train_fns
from repro_torch.train import (TrainerConfig, checkpoint, make_train_fns,
                               train_loop)
# the trajectory contract and the checkpoint helpers of the other families
from test_torch_checkpoint import (_hold_trajectory, _port_leaves,
                                   _ref_noise_of)
from test_torch_moe_train import _hold

torch.set_num_threads(1)


def _cfg():
    return encdec_cfg(name="seamless-train")


def test_sophia_g_trajectory_matches_reference_trainer():
    """Sophia-G 6 steps with GNB refreshes at 0 and 4 on the fused loss and
    the flash route, batches of 4 x 16 target tokens over 24 frames: the
    trajectory contract and equal refresh counts."""
    cfg = _cfg()
    hist, hist_ref, a, b, s_port, s_ref = trajectories(
        cfg, "flash", dict(optimizer="sophia_g"), 6, params=ref_params(cfg),
        source=FrameSource(cfg))
    assert int(s_port.opt_state.hess_count) == \
        int(s_ref.opt_state.hess_count) == 2
    _hold(hist, hist_ref, a, b, s_port, s_ref)


def test_hutchinson_estimate_matches_reference():
    """Sophia-H's Hutchinson refresh at step 0 (the reference's probe; the
    HVP through the fused-loss twin and the flash twin, bidirectional in
    the encoder and over Sq != Sk in the cross-attention): the loss within
    1e-5 and the refreshed h within 1e-4 of its largest element, the dense
    family's bound."""
    cfg = _cfg()
    hist, hist_ref, _, _, s_port, s_ref = trajectories(
        cfg, "flash", dict(optimizer="sophia_h", estimator="hutchinson"), 1,
        params=ref_params(cfg), source=FrameSource(cfg))
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
             warmup_steps=4, hess_interval=2, hess_subbatch=2,
             fused_loss=True, seed=0)
CUT, STEPS = 2, 4


@functools.lru_cache(maxsize=None)
def _ref_fns():
    init_fn, step = jax_make_train_fns(_cfg(), JTrainerConfig(**TRAIN))
    return init_fn, jax.jit(step)


def _ref_steps(state, start, stop):
    _, step = _ref_fns()
    src = FrameSource(_cfg())
    losses = []
    for t in range(start, stop):
        batch = {k: jax.numpy.asarray(v) for k, v in src.batch_at(t).items()}
        state, met = step(state, batch, t % TRAIN["hess_interval"] == 0)
        losses.append(float(met["loss"]))
    return state, losses


def _port_steps(state, start, stop):
    state, hist = train_loop(tcfg(_cfg()), TrainerConfig(**TRAIN),
                             FrameSource(_cfg()), num_steps=stop - start,
                             state=state, device="cpu", start_step=start,
                             hess_seed_fn=_ref_noise_of(state.rng))
    return state, [h["loss"] for h in hist]


def _fresh():
    return make_train_fns(tcfg(_cfg()), TrainerConfig(**TRAIN),
                          device="cpu")[0]()


def test_reference_checkpoint_restores_and_continues(tmp_path):
    """The reference trains 2 steps and saves; the port restores into a
    fresh state, every leaf bit for bit (``encoder`` and ``decoder``
    stacked in the reference's sorted order); then both continue 2 steps
    (a GNB refresh at step 2 on the reference's noise seeds): the
    trajectory contract."""
    init_fn, _ = _ref_fns()
    ref, _ = _ref_steps(init_fn(jax.random.PRNGKey(0)), 0, CUT)
    jax_checkpoint.save(str(tmp_path), CUT, ref)
    restored, step = checkpoint.restore(str(tmp_path), _fresh())
    assert step == restored.step == CUT
    got, want = _port_leaves(restored), jax.tree.leaves(ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    port, port_losses = _port_steps(restored, CUT, STEPS)
    ref, ref_losses = _ref_steps(ref, CUT, STEPS)
    _hold_trajectory(port_losses, ref_losses, port, ref)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """The port trains 2 steps and saves: the manifest's shapes and dtypes
    are those of the reference's own save of the same state, and the
    reference's ``restore`` reads every leaf back bit for bit."""
    port, _ = _port_steps(_fresh(), 0, CUT)
    ours, theirs = tmp_path / "port", tmp_path / "reference"
    checkpoint.save(str(ours), CUT, port)
    like = _ref_fns()[0](jax.random.PRNGKey(0))
    leaves = _port_leaves(port)
    jax_checkpoint.save(str(theirs), CUT, jax.tree.unflatten(
        jax.tree.structure(like), leaves))
    m_ours = checkpoint.read_manifest(str(ours))
    m_theirs = jax_checkpoint.read_manifest(str(theirs))
    for key in ("step", "n_leaves", "shapes", "dtypes"):
        assert m_ours[key] == m_theirs[key], key
    ref, step = jax_checkpoint.restore(str(ours), like)
    assert step == CUT
    for g, w in zip(leaves, jax.tree.leaves(ref)):
        np.testing.assert_array_equal(np.asarray(w), g)
