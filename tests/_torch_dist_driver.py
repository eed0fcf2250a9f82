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
  grid        the ranks as a ``--shape`` D,M grid (``make_mesh``) train
              ``--cfg`` (``GRID_CFGS``) from the reference's checkpoint in
              ``--ckpt-dir`` (or fresh, or from ``--resume-dir``) for
              ``--steps`` steps on the seeds of ``--seeds``: writes the
              step-0 loss and gathered gradients (``--grads 1``: the loss
              of the rank's rows, its gradient summed over data and
              gathered over model, leaf by leaf), the losses, grad norms
              and the gathered parameters; ``--save-dir`` checkpoints at
              the end.
  retune      ``launch/train.py``'s ``retune`` on a stand-in card, each
              rank's stand-in tuner picking differently: writes how many
              shapes the rank measured and its lookups' picks afterwards.
  moe         each rank runs the MoE FFN of ``--cfg`` on the ``--inp``
              input (x, a cotangent, the parameters) as the ``--shape``
              grid's rank, dispatch ``--impl``, on its data coordinate's
              rows (``gspmd``: rows d, d + D, ... as the trainer gives
              them; ``a2a``: the d-th block, as the reference's shard_map
              does): writes the output, aux and the gradients of
              ``sum(out * ct) + aux``, summed over data and gathered over
              model.

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
ap.add_argument("--shape", default="1,1")
ap.add_argument("--cfg", default="gpt2_tiny")
ap.add_argument("--grads", type=int, default=0)
ap.add_argument("--impl", default="gspmd")
args = ap.parse_args()


def grid_cfg(name):
    """The port's fp32 configs of the grid tests (their reference twins
    are ``tests/test_torch_tensor_parallel.py:CFGS``)."""
    from repro_torch.configs import get_config
    arch = {"gpt2_tiny": "gpt2-small", "yi_smoke": "yi-6b",
            "deepseek_smoke": "deepseek-moe-16b",
            "llama4_smoke": "llama4-maverick-400b-a17b"}[name]
    return dataclasses.replace(get_config(arch, smoke=True), dtype="float32")

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
    # each rank writes a directory of its own, with its rank in the extra,
    # of the leaves that the collective _state_leaves gives rank 0
    leaves = [checkpoint._state_leaves(state)]
    dist.broadcast_object_list(leaves, src=0)
    checkpoint._write(leaves[0], 1, mine, {"rank": args.rank})
    try:
        checkpoint.restore_resharded(mine, init_fn())
        out["raised"] = np.array(0)
    except ValueError as e:
        out["raised"] = np.array(int("differs across ranks" in str(e)))

elif args.mode == "grid":
    from repro_torch.convert import gather_params
    from repro_torch.core.types import flat_tensors, tree_leaves
    from repro_torch.data import DataConfig, host_slice, make_source
    from repro_torch.distributed.sharding import gather_leaf, set_grid
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import get_model
    from repro_torch.train import (TrainerConfig, checkpoint,
                                   make_train_fns, train_loop)
    from repro_torch.train.trainer import to_device_batch

    D, M = (int(x) for x in args.shape.split(","))
    grid = make_mesh((D, M))
    cfg = grid_cfg(args.cfg)
    tc = TrainerConfig(**json.loads(args.tc))
    src = make_source(DataConfig(seq_len=16, global_batch=4,
                                 vocab_size=cfg.vocab_size))
    state = make_train_fns(cfg, tc, device="cpu", grid=grid)[0]()
    start = 0
    if args.resume_dir:
        state, start = checkpoint.restore_resharded(args.resume_dir, state)
    elif args.ckpt_dir:
        state, _ = checkpoint.restore(args.ckpt_dir, state)
    if args.grads:
        set_grid(grid)
        params = state.params
        batch = to_device_batch(host_slice(src.batch_at(0), grid.d, D),
                                "cpu")
        attn = "flash" if tc.fused_attn else "auto"
        loss, _ = get_model(cfg).loss_fn(cfg, params, batch, attn_impl=attn,
                                         loss_impl="fused")
        tree = params.param_tree()
        grads = iter(torch.autograd.grad(loss / D, flat_tensors(tree)))
        loss = loss.detach() / D
        dg = grid.data_group
        dist.all_reduce(loss, group=dg)
        out["loss0"] = loss.numpy()
        for i, (leaf, pl) in enumerate(zip(tree_leaves(tree),
                                           tree_leaves(params.placements))):
            g = [next(grads) for _ in leaf] if isinstance(leaf, list) \
                else next(grads)
            for t in (g if isinstance(g, list) else [g]):
                dist.all_reduce(t, group=dg)
            g = gather_leaf(g, pl, grid)
            out[f"g{i}"] = (torch.stack(g) if isinstance(g, list)
                            else g).numpy()
    seeds = np.load(args.seeds) if args.seeds else None
    kw = {}
    if seeds is not None:
        kw = dict(hess_seed_fn=lambda step: seeds["hess"][step])
    state, hist = train_loop(cfg, tc, src, num_steps=args.steps,
                             device="cpu", state=state, start_step=start,
                             grid=grid, **kw)
    if args.save_dir:
        checkpoint.save(args.save_dir, start + args.steps, state)
    out["loss"] = np.array([h["loss"] for h in hist])
    out["grad_norm"] = np.array([h["grad_norm"] for h in hist])
    full = gather_params(state.params, grid)
    out["params"] = torch.cat([t.detach().reshape(-1)
                               for t in tree_leaves(full)]).numpy()

elif args.mode == "moe":
    from repro_torch.distributed.sharding import (gather_leaf,
                                                  partition_params, set_grid,
                                                  shard_tree)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.moe import moe_ffn, set_moe_impl

    D, M = (int(x) for x in args.shape.split(","))
    grid = make_mesh((D, M))
    data = np.load(args.inp)
    cfg = dataclasses.replace(grid_cfg(args.cfg),
                              capacity_factor=float(data["cf"]))
    full = {k[2:]: torch.from_numpy(data[k]) for k in data if k[:2] == "p_"}
    shared = {k[7:]: v for k, v in full.items() if k.startswith("shared_")}
    full = {k: v for k, v in full.items() if not k.startswith("shared_")}
    if shared:
        full["shared"] = shared
    pl = partition_params({"moe": full}, grid, cfg=cfg)["moe"]
    local = shard_tree(full, pl, grid)
    for t in [v for v in local.values() if torch.is_tensor(v)] + \
            list(local.get("shared", {}).values()):
        t.requires_grad_(True)
    set_grid(grid)
    set_moe_impl(args.impl)
    # the default dispatch takes the trainer's rows (data.host_slice: rows
    # d, d + D, ...), the all-to-all the reference's shard_map's (a block)
    B = data["x"].shape[0]
    rows = (slice(grid.d, None, D) if args.impl == "gspmd" else
            slice(grid.d * (B // D), (grid.d + 1) * (B // D)))
    x = torch.from_numpy(data["x"])[rows].clone()
    x.requires_grad_(True)
    ct = torch.from_numpy(data["ct"])[rows]
    y, aux = moe_ffn(local, x, cfg)
    # every data rank's share of aux: the default dispatch's is the global
    # batch's, the all-to-all's mean over data the reference's pmean
    ((y * ct).sum() + aux / D).backward()
    out["out"] = y.detach().numpy()
    out["aux"] = aux.detach().numpy()
    gx = x.grad
    out["gx"] = gx.numpy()

    def leaves(tree, pls, pre=""):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                yield from leaves(tree[k], pls[k], pre + k + "_")
            else:
                yield pre + k, tree[k], pls[k]
    for name, t, p in leaves(local, pl):
        g = t.grad.clone()
        dist.all_reduce(g, group=grid.data_group)
        out[f"g_{name}"] = gather_leaf(g, p, grid).numpy()

elif args.mode == "retune":
    from repro_torch.configs import get_config
    from repro_torch.kernels import autotune as at
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.train import TrainerConfig

    # a stand-in card, and stand-in tuners whose picks differ by rank
    # (rank r's: r + 1 of every choice)
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(
        args.out, "autotune.json")
    card = ("NVIDIA H100 80GB HBM3", 132)
    at.device_info = lambda index: card
    at._device = lambda device: torch.device("cuda", 0)
    torch.cuda.mem_get_info = lambda device: (1 << 30, 1 << 30)
    torch.cuda.reset_peak_memory_stats = lambda device: None
    measured = []
    r1 = args.rank + 1

    def tune_shape(N, D, Vp, *, device, refresh, ws_limit, **kw):
        measured.append("ce")
        key = at.cache_key(N, D, Vp, **kw, device_name=card[0], sms=card[1])
        return at._remember(at._CE, key, at.TunedCE(
            r1, r1, 128 * r1, "measured", measured_ms=1.0, seed_ms=2.0))

    def tune_attn_shape(B, H, Hkv, Sq, Sk, hd, *, device, refresh, **kw):
        measured.append("attn")
        key = at.attn_cache_key(B, H, Hkv, Sq, Sk, hd, **kw,
                                device_name=card[0], sms=card[1])
        return at._remember(at._ATTN, key, at.TunedAttn(
            16 * r1, 16 * r1, 16 * r1, 16 * r1, "measured", measured_ms=1.0,
            seed_ms=2.0))

    at.tune_shape, at.tune_attn_shape = tune_shape, tune_attn_shape
    cli = launch_train.parse_args(["--arch", "gpt2-small", "--smoke",
                                   "--seq-len", "16", "--global-batch", "4",
                                   "--retune"])
    cfg, tc, grid = get_config("gpt2-small", smoke=True), TrainerConfig(), \
        build_mesh()
    launch_train.retune(cli, cfg, tc, torch.device("cpu"), grid,
                        args.rank == 0)
    ce_shape, attn = launch_train._retune_shapes(cli, cfg, tc, grid)
    t = at.get_tuned(**ce_shape, device="cpu")
    a = at.get_tuned_attn(**attn[0], device="cpu")
    out.update(measured=np.array(len(measured)),
               ce=np.array([t.pieces, t.group, t.cw]),
               attn=np.array([a.fwd, a.dq, a.dkv_bq, a.dkv_ho]),
               source=np.array(t.source if t.source == a.source else "mixed"))

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
# every rank done before any tears its gloo pairs down: a rank that exits
# while a peer still reads from it can abort the peer at exit
dist.barrier()
dist.destroy_process_group()
