"""Data-parallel training of the port across processes on the CPU: two
gloo ranks (``tests/_torch_dist_driver.py``, one process each, a
``file://`` rendezvous under the test's tmp dir), GPT2_TINY.

  * the collective: ranks fed g0 and g1 dequantize, bit for bit, what the
    reference's mesh-less call gives on g0 + g1, monolithic and bucketed,
    over three error-feedback steps, and their gathered error feedback is
    the reference's;
  * the trainer: Sophia-G with GNB and one refresh, 6 steps on 2 ranks,
    with compression and without, from the reference's initial state and
    on its seeds, against the reference's single-process trainer; the two
    ranks' parameters bit for bit equal;

Elastic resume and checkpoints: ``test_torch_elastic.py``.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gpt2 import GPT2_TINY
from repro.data import DataConfig as JDataConfig
from repro.data import make_source as jax_make_source
from repro.distributed.compression import GradCompressor as JCompressor
from repro.distributed.compression import FlatCompressionState as JFlat
from repro.kernels.fused_ce import seed_from_key
from repro.quant import _as_seed as jax_as_seed
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import checkpoint as jax_checkpoint
from repro.train import make_train_fns as jax_make_train_fns
from repro.train.trainer import (RNG_TAG_COMPRESS, RNG_TAG_HESS,
                                 RNG_TAG_HESS_COMPRESS)
from repro.train.trainer import train_loop as jax_train_loop

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
DRIVER = os.path.join(HERE, "_torch_dist_driver.py")
ROOT = os.path.dirname(HERE)
CFG32 = dataclasses.replace(GPT2_TINY, dtype="float32")
STEPS = 6
# Sophia-G + GNB, one refresh (step 0) in 6 steps, materialized attention
# and the fused loss (the reference's Pallas CE in interpret mode); B 4 x S
# 16, so two rows a rank and one of the refresh's two
DP_TRAIN = dict(optimizer="sophia_g", peak_lr=5e-4, total_steps=64,
                warmup_steps=4, hess_interval=STEPS, hess_subbatch=2,
                fused_attn=False, fused_loss=True, seed=0)
COMPRESS = dict(compress_grads=True, compress_hess=True,
                comm_bucket_elems=60_000)


def _src():
    return JDataConfig(seq_len=16, global_batch=4,
                       vocab_size=GPT2_TINY.vocab_size)


def spawn(tmp_path, mode, world=2, **kw):
    """Run the driver on ``world`` ranks; their npz results in rank
    order."""
    out = tmp_path / f"{mode}-{len(list(tmp_path.iterdir()))}"
    out.mkdir()
    extra = []
    for k, v in kw.items():
        extra += [f"--{k.replace('_', '-')}", str(v)]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen(
        [sys.executable, DRIVER, "--mode", mode, "--store",
         f"file://{out}/store", "--world", str(world), "--rank", str(r),
         "--out", str(out), *extra], env=env) for r in range(world)]
    try:
        codes = [p.wait(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0] * world, codes
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


# ---------------------------------------------------------------------------
# the collective


SHARDS = (256 * 96, 256 * 40 + 0)        # two shards, 512-aligned
BUCKETS = (0, 512 * 7, 512 * 13 + 100)   # monolithic, aligned, straddling


def test_two_rank_reduction_is_the_reference_on_the_sum(tmp_path):
    """Rank r reduces its own g_r; every rank's dequantized shards and the
    gathered error feedback equal, bit for bit, the reference's mesh-less
    call on g0 + g1 over three error-feedback steps, at each bucket size,
    and the stateless call's too.  (g0 + g1 in fp32 is the sum the
    reduce-scatter forms: two operands add the same in either order.)"""
    rs = np.random.default_rng(3)
    data = {"n_shards": np.array(len(SHARDS))}
    for r in range(2):
        for step in range(3):
            for i, n in enumerate(SHARDS):
                data[f"g{r}_{step}_{i}"] = (rs.standard_normal(n) * (i + 1)
                                            ).astype(np.float32)
    inp = tmp_path / "grads.npz"
    np.savez(inp, **data)
    res = spawn(tmp_path, "collective", inp=inp,
                buckets=",".join(map(str, BUCKETS)))
    jc = JCompressor()
    for be in BUCKETS:
        state = JFlat(error=tuple(jnp.zeros(n, jnp.float32) for n in SHARDS))
        for step in range(3):
            g = tuple(jnp.asarray(data[f"g0_{step}_{i}"]
                                  + data[f"g1_{step}_{i}"])
                      for i in range(len(SHARDS)))
            deq, state = jc.allreduce_shards(g, state, jnp.uint32(1000 + step),
                                             bucket_elems=be)
            for i in range(len(SHARDS)):
                for r in range(2):
                    np.testing.assert_array_equal(
                        res[r][f"deq_{be}_{step}_{i}"], np.asarray(deq[i]))
                np.testing.assert_array_equal(
                    res[0][f"err_{be}_{step}_{i}"], np.asarray(state.error[i]))
        g = tuple(jnp.asarray(data[f"g0_0_{i}"] + data[f"g1_0_{i}"])
                  for i in range(len(SHARDS)))
        sl = jc.allreduce_shards_stateless(g, jnp.uint32(77))
        for i in range(len(SHARDS)):
            np.testing.assert_array_equal(res[1][f"stateless_{be}_{i}"],
                                          np.asarray(sl[i]))


# ---------------------------------------------------------------------------
# the trainer against the reference's single process


@functools.lru_cache(maxsize=None)
def _reference_run(items):
    jtc = JTrainerConfig(**dict(items))
    init_fn, _ = jax_make_train_fns(CFG32, jtc)
    s0 = init_fn(jax.random.PRNGKey(jtc.seed))
    _, hist = jax_train_loop(CFG32, jtc, jax_make_source(_src()),
                             num_steps=STEPS)
    return s0, [h["loss"] for h in hist]


def reference_run(over):
    """(initial state, losses) of the reference's jitted trainer."""
    return _reference_run(tuple(sorted(over.items())))


def reference_seeds(rng):
    """The reference's per-step seeds under key ``rng``: GNB's (2,) noise
    seed and the two rounding streams' uint32 seeds."""
    def fold(tag, step):
        return jax.random.fold_in(jax.random.fold_in(rng, tag), step)

    return dict(
        hess=np.array([np.asarray(seed_from_key(fold(RNG_TAG_HESS, s)))
                       for s in range(STEPS)]),
        comp=np.array([int(jax_as_seed(fold(RNG_TAG_COMPRESS, s)))
                       for s in range(STEPS)], np.uint64),
        hcomp=np.array([int(jax_as_seed(fold(RNG_TAG_HESS_COMPRESS, s)))
                        for s in range(STEPS)], np.uint64))


def port_run(tmp_path, over, world, steps=STEPS, **kw):
    """The port's trainer on ``world`` ranks from the reference's initial
    state (restored from the reference's checkpoint) on its seeds, and
    the reference's losses."""
    s0, ref_losses = reference_run(over)
    ck = tmp_path / "init"
    if not ck.exists():
        jax_checkpoint.save(str(ck), 0, s0)
        np.savez(tmp_path / "seeds.npz", **reference_seeds(s0.rng))
    res = spawn(tmp_path, "train", world=world, steps=steps,
                tc=json.dumps(over), seeds=tmp_path / "seeds.npz",
                ckpt_dir=ck, **kw)
    return res, ref_losses


# The reference's own spread, measured on the CPU by ``tests/_dp_spread.py``
# (the reference against itself with every step's raveled gradient
# multiplied by 1 + 1e-6 xi, xi standard normal, three draws): its 6
# losses moved by at most these (relative); one fp32 ulp of the loss
# without compression.  The port on 1 and on 2 ranks measured 7.72e-8 and
# 7.72e-8 without compression, 3.87e-7 and 3.1e-7 with it.  The bound is
# 10x the spread.
LOSS_SPREAD = {False: 7.75e-8, True: 7.75e-7}


@pytest.mark.parametrize("route", ["fused", "chunked"])
def test_a_ranks_rows_draw_the_single_process_labels(route):
    """GNB's draws at a rank's rows of the refresh sub-batch (rows 1 and 3
    of 4, as rank 1 of 2 holds them) are the single process's at those
    rows, bit for bit: the fused route's hash keyed on ``row_ids``, the
    chunked route's generator draws kept at ``draw_rows``."""
    from repro_torch.core.estimators import chunked_sampled_stats
    from repro_torch.kernels.fused_ce import ce_forward_sampled_plain

    B, S, D, V = 4, 8, 32, 300
    rng = np.random.default_rng(3)
    h = torch.from_numpy(rng.standard_normal((B * S, D), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((384, D), dtype=np.float32))
    index = torch.arange(1, B, 2)
    row_ids = (index[:, None] * S + torch.arange(S)).reshape(-1)
    if route == "fused":
        normp = torch.zeros((2, D))
        whole = ce_forward_sampled_plain(h, w, normp, (7, 2 ** 31 + 9),
                                         vocab=V)
        mine = ce_forward_sampled_plain(h[row_ids], w, normp,
                                        (7, 2 ** 31 + 9), vocab=V,
                                        row_ids=row_ids)
    else:
        logits = h @ w[:V].T
        whole = chunked_sampled_stats(
            logits, torch.Generator().manual_seed(5), chunk=128)
        mine = chunked_sampled_stats(
            logits[row_ids], torch.Generator().manual_seed(5), chunk=128,
            draw_rows=(B * S, row_ids))
    for a, b in zip(mine, whole):
        assert torch.equal(a, b[row_ids])


@pytest.mark.parametrize("compress", [False, True])
def test_two_ranks_follow_the_reference_trainer(tmp_path, compress):
    """Sophia-G + GNB on 2 ranks, with the int8 error-feedback reduction
    and without: the losses follow the reference's single-process trainer
    within 10x its own measured spread, and the two ranks' parameters are
    bit for bit equal."""
    over = dict(DP_TRAIN, **(COMPRESS if compress else {}))
    res, ref = port_run(tmp_path, over, 2)
    np.testing.assert_array_equal(res[0]["params"], res[1]["params"])
    np.testing.assert_array_equal(res[0]["loss"], res[1]["loss"])
    rel = np.abs(res[0]["loss"] - np.asarray(ref)) / np.abs(ref)
    assert rel.max() <= 10 * LOSS_SPREAD[compress], (rel, ref)
