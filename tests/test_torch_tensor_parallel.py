"""Tensor parallelism on a (2, 2) grid of gloo ranks on the CPU
(``tests/_torch_dist_driver.py --mode grid``, one process a rank, a
``file://`` rendezvous under the test's tmp dir) against the reference's
single process: GPT2_TINY (LayerNorm, GELU, tied) and yi-6b's smoke config
(rope, GQA 8/2, SwiGLU, untied), fp32, from the reference's initial state
on its seeds.

  * step 0: the loss and every gradient, summed over data and gathered
    over model, within 1e-5 of the reference's ``loss_fn`` (relative to
    each leaf's largest element: the row-parallel sums add in another
    order);
  * 7 Sophia-G steps with two GNB refreshes: the losses within rtol = atol
    = 2e-4, the reference's own 1-vs-8-device bound
    (``tests/test_distributed_engine.py:223``), and the gathered
    parameters within ``PARAM_BOUND`` of the reference's;
  * checkpoints: a (2, 2) checkpoint restores into a one-process port and
    into the reference's ``restore`` bit for bit to the gathered state; a
    one-process checkpoint resumes on (2, 2) and on (2, 1).
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import DataConfig as JDataConfig
from repro.data import make_source as jax_make_source
from repro.kernels.fused_ce import seed_from_key
from repro.models import get_model as jax_get_model
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import checkpoint as jax_checkpoint
from repro.train import make_train_fns as jax_make_train_fns
from repro.train.trainer import RNG_TAG_HESS
from repro.train.trainer import train_loop as jax_train_loop

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
DRIVER = os.path.join(HERE, "_torch_dist_driver.py")
ROOT = os.path.dirname(HERE)
STEPS = 7
CFGS = {"gpt2_tiny": dataclasses.replace(
            jax_get_config("gpt2-small", smoke=True), dtype="float32"),
        "yi_smoke": dataclasses.replace(
            jax_get_config("yi-6b", smoke=True), dtype="float32")}
# Sophia-G + GNB, refreshes at steps 0 and 4, materialized attention and
# the fused loss; B 4 x S 16, two rows a data rank
TRAIN = dict(optimizer="sophia_g", peak_lr=5e-4, total_steps=64,
             warmup_steps=4, hess_interval=4, hess_subbatch=2,
             fused_attn=False, fused_loss=True, seed=0)
# The gathered parameters after 7 steps against the reference's, as a
# share of each leaf's largest element.  The reference against itself
# with every step's raveled gradient multiplied by 1 + 1e-6 xi (a
# summation-order rounding, ``tests/_grid_spread.py``, three draws) moved
# its parameters by at most 9.88e-4 (GPT2_TINY: Sophia's clipped update
# flips sign with m's) and 1.52e-5 (yi) of a leaf's largest element; the
# port on (2, 2) measured 3.34e-4 and 1.97e-5.  The bound is 10x the
# reference's spread.
PARAM_BOUND = {"gpt2_tiny": 9.88e-3, "yi_smoke": 1.52e-4}


def _src():
    return JDataConfig(seq_len=16, global_batch=4, vocab_size=512)


def spawn(tmp_path, shape, cfg, world=None, **kw):
    """Run the driver's grid mode on a ``shape`` grid; the ranks' npz
    results in rank order."""
    world = world or shape[0] * shape[1]
    out = tmp_path / f"grid-{len(list(tmp_path.iterdir()))}"
    out.mkdir()
    extra = []
    for k, v in kw.items():
        extra += [f"--{k.replace('_', '-')}", str(v)]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen(
        [sys.executable, DRIVER, "--mode", "grid", "--store",
         f"file://{out}/store", "--world", str(world), "--rank", str(r),
         "--out", str(out), "--shape", f"{shape[0]},{shape[1]}",
         "--cfg", cfg, *extra], env=env) for r in range(world)]
    try:
        codes = [p.wait(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0] * world, codes
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


@functools.lru_cache(maxsize=None)
def reference(name):
    """(initial state, its step-0 loss and gradients, the 7 losses, the
    final raveled parameters) of the reference's jitted trainer."""
    cfg = CFGS[name]
    jtc = JTrainerConfig(**TRAIN)
    init_fn, _ = jax_make_train_fns(cfg, jtc)
    s0 = init_fn(jax.random.PRNGKey(jtc.seed))
    batch = jax_make_source(_src()).batch_at(0)
    model = jax_get_model(cfg)
    (loss, _), grads = jax.value_and_grad(
        lambda p: model.loss_fn(cfg, p, batch, attn_impl="auto",
                                loss_impl="fused"), has_aux=True)(s0.params)
    state, hist = jax_train_loop(cfg, jtc, jax_make_source(_src()),
                                 num_steps=STEPS)
    params = np.concatenate([np.asarray(x).reshape(-1)
                             for x in jax.tree.leaves(state.params)])
    return (s0, float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)],
            np.array([h["loss"] for h in hist]), params, state)


def seeds(rng):
    def fold(step):
        return jax.random.fold_in(jax.random.fold_in(rng, RNG_TAG_HESS),
                                  step)
    return np.array([np.asarray(seed_from_key(fold(s)))
                     for s in range(STEPS)])


def init_checkpoint(tmp_path, name):
    s0 = reference(name)[0]
    ck = tmp_path / "init"
    jax_checkpoint.save(str(ck), 0, s0)
    np.savez(tmp_path / "seeds.npz", hess=seeds(s0.rng))
    return ck


def leaf_sizes(name):
    return [int(np.prod(g.shape)) for g in reference(name)[2]]


def assert_leaves_close(got, want, sizes, rel):
    off = 0
    for n in sizes:
        a, b = got[off:off + n], want[off:off + n]
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=rel * np.abs(b).max())
        off += n


@pytest.mark.parametrize("name", sorted(CFGS))
def test_grid_follows_the_reference(tmp_path, name):
    """(2, 2): step 0's loss and gradients within 1e-5, 7 Sophia-G steps
    within 2e-4, the parameters within PARAM_BOUND; the ranks agree on
    the losses and the gathered parameters bit for bit."""
    _, loss0, grads, losses, params, _ = reference(name)
    ck = init_checkpoint(tmp_path, name)
    res = spawn(tmp_path, (2, 2), name, ckpt_dir=ck,
                seeds=tmp_path / "seeds.npz", tc=json.dumps(TRAIN),
                steps=STEPS, grads=1)
    for r in res[1:]:
        np.testing.assert_array_equal(r["loss"], res[0]["loss"])
        np.testing.assert_array_equal(r["params"], res[0]["params"])
    assert abs(float(res[0]["loss0"]) - loss0) <= 1e-5 * abs(loss0)
    for i, want in enumerate(grads):
        got = res[0][f"g{i}"]
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(res[0]["loss"], losses, rtol=2e-4, atol=2e-4)
    assert_leaves_close(res[0]["params"], params, leaf_sizes(name),
                        PARAM_BOUND[name])


def test_checkpoints_cross_grids_and_packages(tmp_path):
    """A (2, 2) checkpoint restores into a one-process port and into the
    reference's ``restore``, bit for bit to the gathered state (the flat
    m/h in the whole tree's layout); a one-process checkpoint resumes on
    (2, 2) and on (2, 1), on one trajectory."""
    from repro_torch.configs import get_config
    from repro_torch.train import TrainerConfig, checkpoint, make_train_fns
    name = "yi_smoke"
    ck = init_checkpoint(tmp_path, name)
    grid_ck = tmp_path / "grid"
    res = spawn(tmp_path, (2, 2), name, ckpt_dir=ck,
                seeds=tmp_path / "seeds.npz", tc=json.dumps(TRAIN),
                steps=3, save_dir=grid_ck)
    cfg = dataclasses.replace(get_config("yi-6b", smoke=True),
                              dtype="float32")
    like = make_train_fns(cfg, TrainerConfig(**TRAIN), device="cpu")[0]()
    state, step = checkpoint.restore(str(grid_ck), like)
    assert step == 3
    flat = torch.cat([t.detach().reshape(-1) for t in
                      _leaves(state.params.param_tree())]).numpy()
    np.testing.assert_array_equal(flat, res[0]["params"])
    s0 = reference(name)[0]
    jstate = jax_checkpoint.restore(str(grid_ck), s0)[0]
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(x).reshape(-1)
                        for x in jax.tree.leaves(jstate.params)]), flat)
    for a, b in zip(jstate.opt_state.m + jstate.opt_state.h,
                    state.opt_state.m + state.opt_state.h):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert float(np.abs(np.asarray(jstate.opt_state.h[0])).max()) > 0
    # the one-process state, saved, resumes on (2, 2) and on (2, 1): the
    # two grids' next steps agree with each other
    one = tmp_path / "one"
    checkpoint.save(str(one), 3, state)
    a = spawn(tmp_path, (2, 2), name, resume_dir=one, tc=json.dumps(TRAIN),
              steps=2)
    b = spawn(tmp_path, (2, 1), name, resume_dir=one, tc=json.dumps(TRAIN),
              steps=2)
    np.testing.assert_allclose(a[0]["loss"], b[0]["loss"], rtol=1e-5)
    np.testing.assert_allclose(a[0]["params"], b[0]["params"], rtol=0,
                               atol=1e-5)


def _leaves(tree):
    from repro_torch.core.types import leaf_parts, tree_leaves
    return [torch.stack(leaf_parts(x)) if isinstance(x, list) else x
            for x in tree_leaves(tree)]
