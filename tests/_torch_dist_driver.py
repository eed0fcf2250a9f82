"""One rank of a multi-process ``torch.distributed`` run on the CPU (gloo),
for tests/test_torch_distributed.py.  The test starts W copies with the
same ``--store`` (a ``file://`` rendezvous under its tmp dir, so that
parallel test workers never share a port) and distinct ``--rank``; each
writes ``<out>/rank<r>.npz``.  Imports no JAX: the test passes in what it
needs from the reference (the gradients, the seeds) as files.

Modes:
  collective  each rank reduces its own gradient shards (``--in``:
              ``g<r>_<step>_<shard>``) through ``GradCompressor`` for
              three error-feedback steps at each bucket size of
              ``--buckets``, and the stateless call once; writes every
              step's dequantized shards and the gathered error feedback.
  train       ``train_loop`` on the rank's rows of GPT2_TINY's batches for
              ``--steps`` steps under the trainer config of ``--tc`` (JSON),
              from the checkpoint in ``--ckpt-dir`` (the reference's) or,
              with ``--resume-dir``, from the newest one there through
              ``restore_resharded``, saving into ``--save-dir`` at the end,
              the refresh and rounding seeds of ``--seeds`` (npz: ``hess``
              (steps, 2), ``comp`` (steps,), ``hcomp`` (steps,)); writes
              the losses, grad norms and the flat parameters.
  digest      rank r saves a checkpoint into its own ``--ckpt-dir`` + r
              (rank-specific ``extra``) and restores it through
              ``restore_resharded``; writes whether that raised.
  peer        rank 1 exits after a barrier; rank 0's next all-reduce
              fails, and it writes whether ``is_distributed_failure``
              classifies the error.

``_torch_dist_driver.py launch-straggling ARGS`` instead runs
``repro_torch.launch.train`` with ARGS, its straggler detector flagging
every step past the warm-up (tests/test_torch_elastic.py's degrade test
starts the ranks so from the launcher's own ``--devices`` spawner).
"""
import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.launch.mesh import initialize_distributed  # noqa: E402

if sys.argv[1:2] == ["launch-straggling"]:
    from repro_torch.launch import train as launch_train
    from repro_torch.train import elastic

    torch.set_num_threads(1)
    launch_train.StragglerDetector = (
        lambda: elastic.StragglerDetector(z_thresh=-1e9))
    launch_train.main(sys.argv[2:])
    raise SystemExit(0)

ap = argparse.ArgumentParser()
ap.add_argument("--mode", required=True)
ap.add_argument("--store", required=True)
ap.add_argument("--world", type=int, required=True)
ap.add_argument("--rank", type=int, required=True)
ap.add_argument("--out", required=True)
ap.add_argument("--inp", default=None)
ap.add_argument("--buckets", default="0")
ap.add_argument("--steps", type=int, default=6)
ap.add_argument("--tc", default="{}")
ap.add_argument("--seeds", default=None)
ap.add_argument("--ckpt-dir", default=None)
ap.add_argument("--save-dir", default=None)
ap.add_argument("--resume-dir", default=None)
args = ap.parse_args()

torch.set_num_threads(1)
initialize_distributed(args.store, args.world, args.rank, "cpu",
                       timeout_s=60)
out = {}

if args.mode == "collective":
    from repro_torch.distributed import GradCompressor

    data = np.load(args.inp)
    n_shards = int(data["n_shards"])
    comp = GradCompressor()
    for be in [int(b) for b in args.buckets.split(",")]:
        g0 = [torch.from_numpy(data[f"g{args.rank}_0_{i}"])
              for i in range(n_shards)]
        layout = type("L", (), {"shard_sizes": [g.numel() for g in g0]})
        state = comp.init_shards(layout)
        for step in range(3):
            g = tuple(torch.from_numpy(data[f"g{args.rank}_{step}_{i}"])
                      for i in range(n_shards))
            deq, state = comp.allreduce_shards(g, state, 1000 + step,
                                               bucket_elems=be)
            for i, d in enumerate(deq):
                out[f"deq_{be}_{step}_{i}"] = d.numpy()
            for i, e in enumerate(state.error):
                full = torch.empty((g[i].numel(),))
                dist.all_gather_into_tensor(full, e)
                out[f"err_{be}_{step}_{i}"] = full.numpy()
        sl = comp.allreduce_shards_stateless(g0, 77, bucket_elems=be)
        for i, d in enumerate(sl):
            out[f"stateless_{be}_{i}"] = d.numpy()

elif args.mode == "train":
    from repro_torch.configs.gpt2 import GPT2_TINY
    from repro_torch.data import DataConfig, make_source
    from repro_torch.train import (TrainerConfig, checkpoint,
                                   make_train_fns, train_loop)

    cfg = dataclasses.replace(GPT2_TINY, dtype="float32")
    tc = TrainerConfig(**json.loads(args.tc))
    seeds = np.load(args.seeds)
    src = make_source(DataConfig(seq_len=16, global_batch=4,
                                 vocab_size=cfg.vocab_size))
    state = make_train_fns(cfg, tc, device="cpu")[0]()
    start = 0
    if args.resume_dir:
        state, start = checkpoint.restore_resharded(args.resume_dir, state)
    elif args.ckpt_dir:
        state, _ = checkpoint.restore(args.ckpt_dir, state)
    state, hist = train_loop(
        cfg, tc, src, num_steps=args.steps, device="cpu", state=state,
        start_step=start,
        hess_seed_fn=lambda step: seeds["hess"][step],
        compress_seed_fn=lambda tag, step: int(
            seeds["comp" if tag == 2 else "hcomp"][step]))
    if args.save_dir:
        checkpoint.save(args.save_dir, start + args.steps, state)
    out["loss"] = np.array([h["loss"] for h in hist])
    out["grad_norm"] = np.array([h["grad_norm"] for h in hist])
    out["params"] = torch.cat([t.detach().reshape(-1) for t in
                               state.params.parameters()]).numpy()

elif args.mode == "digest":
    from repro_torch.configs.gpt2 import GPT2_TINY
    from repro_torch.train import TrainerConfig, checkpoint, make_train_fns

    cfg = dataclasses.replace(GPT2_TINY, dtype="float32")
    init_fn, _ = make_train_fns(cfg, TrainerConfig(), device="cpu")
    state = init_fn()
    mine = f"{args.ckpt_dir}{args.rank}"
    # each rank writes a directory of its own, with its rank in the extra
    checkpoint._write(checkpoint._state_leaves(state), 1, mine,
                      {"rank": args.rank})
    try:
        checkpoint.restore_resharded(mine, init_fn())
        out["raised"] = np.array(0)
    except ValueError as e:
        out["raised"] = np.array(int("differs across ranks" in str(e)))

elif args.mode == "peer":
    from repro_torch.train.elastic import is_distributed_failure

    dist.barrier()
    if args.rank == 1:
        np.savez(os.path.join(args.out, "rank1.npz"), gone=np.array(1))
        os._exit(0)
    try:
        for _ in range(100):
            dist.all_reduce(torch.ones(4))
        out["classified"] = np.array(-1)
    except Exception as e:  # the failure under test, whatever its type
        out["classified"] = np.array(int(is_distributed_failure(e)))
        out["message"] = np.array(f"{type(e).__name__}: {e}"[:500])
    np.savez(os.path.join(args.out, f"rank{args.rank}.npz"), **out)
    os._exit(0)

np.savez(os.path.join(args.out, f"rank{args.rank}.npz"), **out)
dist.destroy_process_group()
