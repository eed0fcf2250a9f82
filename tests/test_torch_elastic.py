"""Elastic data-parallel training of the port on the CPU: checkpoints
written by 2 gloo ranks resumed by 1 (``restore_resharded``), the
launcher degrading 2 -> 1 ranks, a digest mismatch across ranks, a
refused ``--compress-grads`` flip, a dead peer classified as a
distributed failure, ``run_resumable`` and the straggler detector as the
reference's unit tests have them (``tests/test_distributed_engine.py``,
``tests/test_overlap.py``), and checkpoints with ``comp_state`` across
the two packages.  Helpers and tolerances: ``test_torch_distributed.py``.
"""
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import make_source as jax_make_source
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import checkpoint as jax_checkpoint
from repro.train import make_train_fns as jax_make_train_fns
from repro.train.elastic import StragglerDetector as JStraggler
from repro.train.elastic import is_distributed_failure as jax_is_failure
from repro_torch.data import DataConfig, make_source
from repro_torch.launch import train as torch_launch
from repro_torch.models import ModelConfig
from repro_torch.train import TrainerConfig, checkpoint, make_train_fns, \
    train_loop
from repro_torch.train.elastic import (MeshDegraded, NodeLoss,
                                       StragglerDetector,
                                       is_distributed_failure, run_resumable)
from test_torch_distributed import (CFG32, COMPRESS, DP_TRAIN, DRIVER,
                                    LOSS_SPREAD, STEPS, _src, port_run,
                                    reference_run, reference_seeds, spawn)

torch.set_num_threads(1)

TCFG32 = ModelConfig(**CFG32.__dict__)
CUT = 3


def test_two_rank_checkpoint_resumes_on_one_rank(tmp_path):
    """Node loss: 2 ranks train steps 0-2 with compression and save
    collectively (the error-feedback segments gathered into whole
    shards); 1 rank resumes at step 3 through ``restore_resharded`` and
    its losses follow an uninterrupted 1-rank run within 10x the
    reference's measured spread (``LOSS_SPREAD``)."""
    over = dict(DP_TRAIN, **COMPRESS)
    ck = tmp_path / "ck"
    two, _ = port_run(tmp_path, over, 2, steps=CUT, save_dir=ck)
    assert checkpoint.latest_step(str(ck)) == CUT
    assert len(checkpoint.read_manifest(str(ck))["dtypes"]) == len(
        os.listdir(ck / f"step_{CUT:08d}")) - 1
    resumed, _ = port_run(tmp_path, over, 1, steps=STEPS - CUT,
                          resume_dir=ck)
    whole, ref = port_run(tmp_path, over, 1)
    np.testing.assert_array_equal(two[0]["loss"], two[1]["loss"])
    got = np.concatenate([two[0]["loss"], resumed[0]["loss"]])
    rel = np.abs(got - whole[0]["loss"]) / whole[0]["loss"]
    assert rel.max() <= 10 * LOSS_SPREAD[True], rel


LAUNCH = ["--smoke", "--device", "cpu", "--seq-len", "16",
          "--global-batch", "4", "--hess-subbatch", "2", "--hess-interval",
          "4", "--log-every", "1", "--compress-grads", "--comm-telemetry",
          "--comm-bucket-elems", "60000"]


def test_launcher_degrades_two_ranks_to_one(tmp_path, capfd, monkeypatch):
    """``--devices 2 --elastic --degrade-after 1`` with every step past
    its warm-up flagged (each rank is the launcher under
    ``tests/_torch_dist_driver.py launch-straggling``, spawned by the
    launcher's own ``--devices`` spawner): at step 6 (the first after the
    detector's five warm-up samples) the ranks checkpoint step 7 together
    and exit; the launcher relaunches one rank, which resumes at step 7
    and finishes; every logged loss is finite."""
    popen = subprocess.Popen

    def straggling(cmd, *a, **kw):
        assert cmd[1:3] == ["-m", "repro_torch.launch.train"], cmd
        return popen([cmd[0], DRIVER, "launch-straggling", *cmd[3:]], *a,
                     **kw)

    monkeypatch.setattr(torch_launch.subprocess, "Popen", straggling)
    torch_launch.main([*LAUNCH, "--steps", "9", "--devices", "2",
                       "--elastic", "--degrade-after", "1", "--ckpt-dir",
                       str(tmp_path)])
    out = capfd.readouterr().out
    assert "[degrade] persistent straggler at step 6" in out, out
    assert "[degrade] relaunching on 1 rank(s)" in out
    assert "[resume] restored step 7" in out and "onto 1 process" in out
    assert "done: 2 steps" in out
    lines = [ln.split() for ln in out.splitlines() if ln.startswith("step")]
    # step 6 checkpoints before its log line, as the reference's does
    assert [int(ln[1]) for ln in lines] == [0, 1, 2, 3, 4, 5, 7, 8]
    assert np.isfinite([float(ln[3]) for ln in lines]).all()
    assert checkpoint.latest_step(str(tmp_path)) == 9


def test_compress_grads_flip_is_refused(tmp_path):
    """A checkpoint written with ``--compress-grads`` refuses a resume
    without it (and the reverse): the leaf count differs."""
    plain = [a for a in LAUNCH if a != "--compress-grads"]
    torch_launch.main([*LAUNCH, "--steps", "2", "--ckpt-dir",
                       str(tmp_path / "a")])
    with pytest.raises(SystemExit, match="compress_grads=True"):
        torch_launch.main([*plain, "--steps", "3", "--ckpt-dir",
                           str(tmp_path / "a")])
    torch_launch.main([*plain, "--steps", "2", "--ckpt-dir",
                       str(tmp_path / "b")])
    with pytest.raises(SystemExit, match="compress_grads=False"):
        torch_launch.main([*LAUNCH, "--steps", "3", "--ckpt-dir",
                           str(tmp_path / "b")])


def test_digest_mismatch_across_ranks_raises(tmp_path):
    """Two ranks resolving different manifests (each its own directory):
    ``restore_resharded`` raises on both before loading a leaf."""
    res = spawn(tmp_path, "digest", ckpt_dir=tmp_path / "ck")
    assert [int(r["raised"]) for r in res] == [1, 1]


def test_dead_peer_is_a_distributed_failure(tmp_path):
    """Rank 1 exits; rank 0's next all-reduce fails with an error that
    ``is_distributed_failure`` classifies as a lost peer."""
    res = spawn(tmp_path, "peer")
    assert int(res[0]["classified"]) == 1, res[0].get("message")


# ---------------------------------------------------------------------------
# the reference's unit tests of the elastic machinery


@pytest.mark.parametrize("exc,want", [
    (RuntimeError("gloo: connection reset by peer"), True),
    (RuntimeError("DEADLINE_EXCEEDED: barrier timed out"), True),
    (ValueError("connection refused"), False),
    (RuntimeError("shape mismatch"), False),
    (torch.distributed.DistBackendError("NCCL error: unhandled"), True),
    (torch.distributed.DistNetworkError("whatever"), True),
    (torch.distributed.DistStoreError("store"), True)])
def test_is_distributed_failure_classification(exc, want):
    """The reference's classification (``test_overlap.py``), and torch's
    ``DistError`` family always a distributed failure."""
    assert is_distributed_failure(exc) is want
    if not isinstance(exc, torch.distributed.DistError):
        assert jax_is_failure(exc) is want
    assert issubclass(NodeLoss, RuntimeError)


def test_run_resumable_reraises_node_loss():
    calls = {"n": 0}

    def run(state, start):
        calls["n"] += 1
        raise NodeLoss("peer died")

    with pytest.raises(NodeLoss):
        run_resumable(lambda: 0, run, lambda: None, max_restarts=3)
    assert calls["n"] == 1  # no in-process retry against a dead peer


def test_run_resumable_retries_before_first_checkpoint():
    calls = {"run": 0, "restore": 0}

    def restore_latest():
        calls["restore"] += 1
        raise FileNotFoundError("no checkpoints yet")

    def run(state, start):
        calls["run"] += 1
        if calls["run"] < 3:
            raise RuntimeError("failure before any checkpoint")
        return state, start

    state, start = run_resumable(lambda: {"fresh": True}, run,
                                 restore_latest, max_restarts=5)
    assert calls["run"] == 3 and calls["restore"] == 3
    assert start == 0 and state == {"fresh": True}


def test_run_resumable_mesh_degrade_is_a_free_retry():
    calls = {"run": 0}

    def run(state, start):
        calls["run"] += 1
        if calls["run"] < 4:
            raise MeshDegraded("straggler; shrinking")
        return "done"

    assert run_resumable(lambda: {}, run, lambda: None,
                         max_restarts=0) == "done"
    assert calls["run"] == 4


def test_run_resumable_does_not_mask_corrupt_restore():
    def restore_latest():
        raise ValueError("checkpoint flat-shard layout mismatch")

    with pytest.raises(ValueError, match="layout mismatch"):
        run_resumable(lambda: {}, lambda s, t: "done", restore_latest,
                      max_restarts=5)


@pytest.mark.parametrize("seq", [
    [1.0, 1.0, 1.0, 50.0],                 # still warming up: no flag
    [1.0] * 5 + [50.0],                     # n 5 > warm-up 3: flags
    list(np.random.default_rng(0).lognormal(0.0, 0.3, 40)) + [9.0, 1.0]])
def test_straggler_detector_is_the_reference(seq):
    """The same flags, EWMA and variance as the reference's detector on a
    sequence (the baseline sample does not count toward the warm-up)."""
    a, b = StragglerDetector(z_thresh=3.0, warmup=3), JStraggler(
        z_thresh=3.0, warmup=3)
    for dt in seq:
        assert a.observe(dt) == b.observe(dt)
    assert (a.flagged, a.n, a.mean, a.var) == (b.flagged, b.n, b.mean, b.var)


# ---------------------------------------------------------------------------
# checkpoints with comp_state across the two packages


def _leaves_equal(port_state, ref_state):
    got = [arr for arr, _ in checkpoint._state_leaves(port_state)]
    want = jax.tree.leaves(ref_state)
    assert len(got) == len(want)
    return got, want


def test_reference_checkpoint_with_comp_state_continues_in_the_port(
        tmp_path):
    """The reference trains 3 compressed steps and saves; the port
    restores it (the error feedback leaf for leaf) and continues 3 steps
    on the reference's seeds, its losses within 10x the reference's
    spread of the reference's own continuation."""
    over = dict(DP_TRAIN, **COMPRESS)
    jtc = JTrainerConfig(**over)
    init_fn, step = jax_make_train_fns(CFG32, jtc)
    step = jax.jit(step)
    src = jax_make_source(_src())
    state = init_fn(jax.random.PRNGKey(0))
    for t in range(CUT):
        batch = {k: jnp.asarray(v) for k, v in src.batch_at(t).items()}
        state, _ = step(state, batch, t % jtc.hess_interval == 0)
    jax_checkpoint.save(str(tmp_path), CUT, state)
    _, ref_losses = reference_run(over)
    tc = TrainerConfig(**over)
    like = make_train_fns(TCFG32, tc, device="cpu")[0]()
    port, start = checkpoint.restore(str(tmp_path), like)
    assert start == CUT
    for e, w in zip(port.comp_state.error, state.comp_state.error):
        np.testing.assert_array_equal(e.numpy(), np.asarray(w))
    seeds = reference_seeds(init_fn(jax.random.PRNGKey(0)).rng)
    _, hist = train_loop(
        TCFG32, tc, make_source(DataConfig(seq_len=16, global_batch=4,
                                           vocab_size=CFG32.vocab_size)),
        num_steps=STEPS - CUT, state=port, device="cpu", start_step=CUT,
        hess_seed_fn=lambda s: seeds["hess"][s],
        compress_seed_fn=lambda tag, s: int(
            seeds["comp" if tag == 2 else "hcomp"][s]))
    got = np.array([h["loss"] for h in hist])
    rel = np.abs(got - ref_losses[CUT:]) / np.array(ref_losses[CUT:])
    assert rel.max() <= 10 * LOSS_SPREAD[True], rel


def test_port_checkpoint_with_comp_state_restores_in_the_reference(
        tmp_path):
    """2 port ranks train 3 compressed steps and save (the segments
    gathered); the reference restores every leaf as saved, its error
    feedback included, and continues 3 steps to losses within 10x its
    spread of its own uninterrupted run."""
    over = dict(DP_TRAIN, **COMPRESS)
    ck = tmp_path / "ck"
    port_run(tmp_path, over, 2, steps=CUT, save_dir=ck)
    jtc = JTrainerConfig(**over)
    init_fn, step = jax_make_train_fns(CFG32, jtc)
    like = init_fn(jax.random.PRNGKey(0))
    state, start = jax_checkpoint.restore(str(ck), like)
    assert start == CUT
    saved = checkpoint.read_manifest(str(ck))
    assert saved["n_leaves"] == len(jax.tree.leaves(like))
    errors = state.comp_state.error
    for i, e in enumerate(errors):
        k = saved["n_leaves"] - len(errors) + i
        leaf = np.load(ck / f"step_{CUT:08d}" / f"leaf_{k:05d}.npy")
        np.testing.assert_array_equal(np.asarray(e), leaf)
    step = jax.jit(step)
    src = jax_make_source(_src())
    losses = []
    for t in range(CUT, STEPS):
        batch = {k: jnp.asarray(v) for k, v in src.batch_at(t).items()}
        state, met = step(state, batch, t % jtc.hess_interval == 0)
        losses.append(float(met["loss"]))
    _, ref_losses = reference_run(over)
    rel = np.abs(np.array(losses) - ref_losses[CUT:]) / np.array(
        ref_losses[CUT:])
    assert rel.max() <= 10 * LOSS_SPREAD[True], rel
