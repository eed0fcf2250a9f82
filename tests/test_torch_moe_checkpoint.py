"""Checkpoints across the two packages for the MoE family: the reference
trainer's checkpoint of deepseek-moe-16b's and llama4-maverick's smoke
configs (fp32) restores in the port leaf for leaf, and the port's is the
reference's own save of the same state, which the reference restores.
The nested, stacked ``moe`` leaves (and llama4's ``dense``/``moe`` groups)
sit in the reference's sorted order."""
import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

from _rope_models import tcfg
from repro.configs import get_config as jax_get_config
from repro.data import DataConfig as JDataConfig
from repro.data import make_source as jax_make_source
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import checkpoint as jax_checkpoint
from repro.train import make_train_fns as jax_make_train_fns
from repro_torch.data import DataConfig, make_source
from repro_torch.train import (TrainerConfig, checkpoint, make_train_fns,
                               train_loop)

torch.set_num_threads(1)

NAMES = ("deepseek-moe-16b", "llama4-maverick-400b-a17b")


def _cfg(arch):
    return dataclasses.replace(jax_get_config(arch, smoke=True),
                               dtype="float32")


TRAIN = dict(optimizer="sophia_g", peak_lr=5e-4, total_steps=64,
             warmup_steps=4, hess_interval=4, hess_subbatch=2,
             fused_attn=False, fused_loss=True, seed=0)
CUT = 3


def _src(cfg):
    return JDataConfig(seq_len=16, global_batch=4, vocab_size=cfg.vocab_size)


@functools.lru_cache(maxsize=None)
def _ref_fns(arch):
    init_fn, step = jax_make_train_fns(_cfg(arch), JTrainerConfig(**TRAIN))
    return init_fn, jax.jit(step)


def _ref_state(arch):
    """The reference trainer after CUT steps from seed 0."""
    init_fn, step = _ref_fns(arch)
    state = init_fn(jax.random.PRNGKey(0))
    src = jax_make_source(_src(_cfg(arch)))
    for t in range(CUT):
        batch = {k: jax.numpy.asarray(v) for k, v in src.batch_at(t).items()}
        state, _ = step(state, batch, t % TRAIN["hess_interval"] == 0)
    return state


def _port_leaves(state):
    return [arr for arr, _ in checkpoint._state_leaves(state)]


@pytest.mark.parametrize("arch", NAMES)
def test_checkpoints_restore_across_the_packages(tmp_path, arch):
    """The reference's checkpoint after 3 steps restores in the port leaf
    for leaf, bit for bit (the nested, stacked ``moe`` leaves in the
    reference's sorted order); the port's checkpoint after 3 steps is the
    reference's own save of the same state, file for file, and the
    reference's ``restore`` reads it back bit for bit."""
    cfg = tcfg(_cfg(arch))
    tc = TrainerConfig(**TRAIN)
    ref = _ref_state(arch)
    jax_checkpoint.save(str(tmp_path / "reference"), CUT, ref)
    fresh = make_train_fns(cfg, tc, device="cpu")[0]()
    restored, step = checkpoint.restore(str(tmp_path / "reference"), fresh)
    assert step == restored.step == CUT
    got, want = _port_leaves(restored), jax.tree.leaves(ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()

    port = make_train_fns(cfg, tc, device="cpu")[0]()
    port, _ = train_loop(cfg, tc, make_source(DataConfig(
        **dataclasses.asdict(_src(cfg)))), num_steps=CUT, state=port,
        device="cpu")
    ours, theirs = tmp_path / "port", tmp_path / "again"
    checkpoint.save(str(ours), CUT, port)
    like = _ref_fns(arch)[0](jax.random.PRNGKey(0))
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
    back, step = jax_checkpoint.restore(str(ours), like)
    assert step == CUT
    for g, w in zip(leaves, jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(w), g)
