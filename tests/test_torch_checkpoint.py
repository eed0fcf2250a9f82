"""Checkpoints across the two packages: a checkpoint that the reference
trainer saved restores in the port, leaf for leaf, and the port continues
the reference's trajectory from it; one that the port saved restores in
the reference (fp32 state) and continues there, and its bf16 leaves are
the files the reference's own save writes.  GPT2_TINY, a NeoX-shaped
config with untied embeddings and rope, and the smoke configs of
qwen1.5-110b (RMSNorm, QKV bias) and gemma2-9b (sandwich norms, GeGLU,
the embedding scale), whose extra leaves must sit in the reference's
sorted order; fp32 and bf16 optimizer state."""
import dataclasses
import functools
import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.gpt2 import GPT2_TINY, NEOX_1_5B
from repro.data import DataConfig as JDataConfig
from repro.data import make_source as jax_make_source
from repro.kernels.fused_ce import seed_from_key
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import checkpoint as jax_checkpoint
from repro.train import make_train_fns as jax_make_train_fns
from repro.train.trainer import RNG_TAG_HESS
from repro_torch.models import ModelConfig
from repro_torch.train import (TrainerConfig, checkpoint, make_train_fns,
                               train_key, train_loop)

torch.set_num_threads(1)

NEOX_TINY = dataclasses.replace(NEOX_1_5B, name="neox-tiny", d_model=128,
                                n_layers=2, n_heads=4, n_kv_heads=4,
                                d_ff=512, vocab_size=512)
CFGS = {"gpt2_tiny": dataclasses.replace(GPT2_TINY, dtype="float32"),
        "neox_tiny": dataclasses.replace(NEOX_TINY, dtype="float32"),
        "qwen_smoke": dataclasses.replace(
            jax_get_config("qwen1.5-110b", smoke=True), dtype="float32"),
        "gemma2_smoke": dataclasses.replace(
            jax_get_config("gemma2-9b", smoke=True), dtype="float32")}
# materialized attention and the fused loss (the reference's Pallas CE in
# interpret mode), a refresh at steps 0 and 4: one on each side of the cut
TRAIN = dict(optimizer="sophia_g", peak_lr=5e-4, total_steps=64,
             warmup_steps=4, hess_interval=4, hess_subbatch=2,
             fused_attn=False, fused_loss=True, seed=0)
CUT, STEPS = 3, 6


def _src(cfg):
    return JDataConfig(seq_len=16, global_batch=4, vocab_size=cfg.vocab_size)


@functools.lru_cache(maxsize=None)
def _ref_fns(name, state_dtype):
    init_fn, step = jax_make_train_fns(
        CFGS[name], JTrainerConfig(**TRAIN, state_dtype=state_dtype))
    return init_fn, jax.jit(step)


def _ref_steps(name, state_dtype, state, start, stop):
    """The reference trainer from ``state`` over steps start..stop-1:
    (state, losses)."""
    _, step = _ref_fns(name, state_dtype)
    src = jax_make_source(_src(CFGS[name]))
    losses = []
    for t in range(start, stop):
        batch = {k: jax.numpy.asarray(v) for k, v in src.batch_at(t).items()}
        state, met = step(state, batch, t % TRAIN["hess_interval"] == 0)
        losses.append(float(met["loss"]))
    return state, losses


def _port(name, state_dtype):
    cfg = ModelConfig(**dataclasses.asdict(CFGS[name]))
    tc = TrainerConfig(**TRAIN, state_dtype=state_dtype)
    return cfg, tc


def _ref_noise_of(key):
    """The reference's GNB noise seed of each step under ``key`` (the rng
    leaf's two words)."""
    k = jax.numpy.asarray(np.asarray(key, np.uint32))

    def seed(step):
        return np.asarray(seed_from_key(jax.random.fold_in(
            jax.random.fold_in(k, RNG_TAG_HESS), step)))
    return seed


def _port_steps(name, state_dtype, state, start, stop):
    cfg, tc = _port(name, state_dtype)
    src_cfg = _src(CFGS[name])
    from repro_torch.data import DataConfig, make_source
    src = make_source(DataConfig(**dataclasses.asdict(src_cfg)))
    state, hist = train_loop(cfg, tc, src, num_steps=stop - start,
                             state=state, device="cpu", start_step=start,
                             hess_seed_fn=_ref_noise_of(state.rng))
    return state, [h["loss"] for h in hist]


def _port_leaves(state):
    """The port's state as the reference's leaves (numpy), in checkpoint
    order, bf16 as ml_dtypes' bf16."""
    out = []
    for arr, dt in checkpoint._state_leaves(state):
        out.append(arr.view(ml_dtypes.bfloat16) if dt == "bfloat16" else arr)
    return out


def _as_f32(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


def _hold_trajectory(port_losses, ref_losses, port_state, ref_state):
    """The contract of tests/test_torch_train.py's trajectory tests over
    the continued steps: losses to rtol 1e-4 / atol 1e-5, every parameter
    and m and h coordinate within 2e-3, and >= 99.95% of the parameter
    coordinates within 3e-6 + 1e-5 |a|."""
    np.testing.assert_allclose(port_losses, ref_losses, rtol=1e-4,
                               atol=1e-5)
    got = _port_leaves(port_state)[1:]
    want = jax.tree.leaves(ref_state)[1:]
    n_par = len(jax.tree.leaves(ref_state.params))
    a = np.concatenate([_as_f32(w).ravel() for w in want[:n_par]])
    b = np.concatenate([_as_f32(g).ravel() for g in got[:n_par]])
    bad = np.abs(b - a) > (3e-6 + 1e-5 * np.abs(a))
    assert bad.mean() <= 5e-4, f"{bad.sum()} / {bad.size} beyond 3e-6"
    for g, w in zip(got, want):
        np.testing.assert_allclose(_as_f32(g), _as_f32(w), rtol=1e-2,
                                   atol=2e-3)


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2 ** 31 - 1])
def test_train_key_is_the_reference_key(seed):
    """``train_key`` (a numpy Threefry) is the reference trainer's rng
    leaf, ``split(PRNGKey(seed))[1]``, bit for bit."""
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed))[1])
    assert train_key(seed) == tuple(int(v) for v in want)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_reference_checkpoint_restores_and_continues(tmp_path, name,
                                                     state_dtype):
    """The reference trains 3 steps and saves; the port restores into a
    fresh state: every leaf equal to the reference's, bit for bit (bf16
    leaves come back from numpy's void, the rng as the key's words).
    Then both continue 3 steps (a refresh at step 4, the port given the
    reference's noise seeds from the restored key): the trajectory
    contract."""
    init_fn, _ = _ref_fns(name, state_dtype)
    ref, _ = _ref_steps(name, state_dtype, init_fn(jax.random.PRNGKey(0)),
                        0, CUT)
    jax_checkpoint.save(str(tmp_path), CUT, ref)
    cfg, tc = _port(name, state_dtype)
    fresh = make_train_fns(cfg, tc, device="cpu")[0]()
    restored, step = checkpoint.restore(str(tmp_path), fresh)
    assert step == restored.step == CUT
    got, want = _port_leaves(restored), jax.tree.leaves(ref)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    port, port_losses = _port_steps(name, state_dtype, restored, CUT, STEPS)
    ref, ref_losses = _ref_steps(name, state_dtype, ref, CUT, STEPS)
    _hold_trajectory(port_losses, ref_losses, port, ref)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CFGS))
def test_port_checkpoint_restores_in_the_reference(tmp_path, name,
                                                   state_dtype):
    """The port trains 3 steps and saves.  Its files are the reference's:
    the manifest's dtypes and shapes, and each leaf's dtype and bytes,
    equal those of the reference's own save of the same state (bf16 as
    2-byte void, the rng as the (2,) uint32 key).  With fp32 state the
    reference's ``restore`` reads it back bit for bit and both continue 3
    steps under the trajectory contract.  The reference's ``restore``
    cannot read bf16 leaves, its own included (``jnp.asarray`` refuses
    numpy's void); read as its manifest says, with ml_dtypes' bf16, they
    are the port's values."""
    cfg, tc = _port(name, state_dtype)
    port = make_train_fns(cfg, tc, device="cpu")[0]()
    port, _ = _port_steps(name, state_dtype, port, 0, CUT)
    ours, theirs = tmp_path / "port", tmp_path / "reference"
    checkpoint.save(str(ours), CUT, port)
    init_fn, _ = _ref_fns(name, state_dtype)
    like = init_fn(jax.random.PRNGKey(0))
    leaves = _port_leaves(port)
    jax_checkpoint.save(str(theirs), CUT, jax.tree.unflatten(
        jax.tree.structure(like), leaves))
    m_ours = checkpoint.read_manifest(str(ours))
    m_theirs = jax_checkpoint.read_manifest(str(theirs))
    for key in ("step", "n_leaves", "shapes", "dtypes"):
        assert m_ours[key] == m_theirs[key], key
    step_dir = f"step_{CUT:08d}"
    for i, dt in enumerate(m_ours["dtypes"]):
        a = np.load(os.path.join(ours, step_dir, f"leaf_{i:05d}.npy"))
        b = np.load(os.path.join(theirs, step_dir, f"leaf_{i:05d}.npy"))
        assert (a.dtype.kind, a.dtype.itemsize) == \
            (b.dtype.kind, b.dtype.itemsize), (i, a.dtype, b.dtype)
        assert a.tobytes() == b.tobytes(), i
        if dt == "bfloat16":
            assert a.dtype.kind == "V"
            np.testing.assert_array_equal(
                a.view(ml_dtypes.bfloat16).astype(np.float32),
                leaves[i].astype(np.float32))
    if state_dtype == "bfloat16":
        return
    ref, step = jax_checkpoint.restore(str(ours), like)
    assert step == CUT
    for g, w in zip(leaves, jax.tree.leaves(ref)):
        np.testing.assert_array_equal(np.asarray(w), g)
    ref, ref_losses = _ref_steps(name, state_dtype, ref, CUT, STEPS)
    port, port_losses = _port_steps(name, state_dtype, port, CUT, STEPS)
    _hold_trajectory(port_losses, ref_losses, port, ref)


def test_manifest_names_the_reference_dtypes(tmp_path):
    """The step, the rng and bf16 state under the reference's dtype names
    (``str(np.asarray(leaf).dtype)`` there)."""
    cfg, tc = _port("gpt2_tiny", "bfloat16")
    state = make_train_fns(cfg, tc, device="cpu")[0]()
    checkpoint.save(str(tmp_path), 0, state)
    with open(tmp_path / "step_00000000" / "manifest.json") as f:
        dtypes = json.load(f)["dtypes"]
    assert dtypes[0] == "int32" and dtypes[-1] == "uint32"
    assert dtypes.count("bfloat16") == 2       # one m and one h shard
