"""Training launcher: the counterpart of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gpt2-small \\
        --steps 400 --global-batch 8 --seq-len 1024 --ckpt-dir /tmp/run1

``--arch`` takes every architecture of ``configs.ARCHS`` (the dense, MoE,
RWKV and Griffin families; ``--smoke`` their small configurations) but the
encoder-decoder's: its loss needs ``frames`` beside the tokens, which the
data pipeline does not yield (the reference's launcher has no frame source
either and fails inside its ``loss_fn``), so ``--arch
seamless-m4t-medium`` raises ``ValueError`` before the first step; train
it through ``train.train_loop`` with a source whose batches carry frames.

Trains with ``--opt`` sophia_g (the default), sophia_h, adamw, lion,
signgd, sgd or adahessian, the hessian-aware ones (Sophia, AdaHessian)
with ``--estimator`` gnb (the default), hutchinson or empirical_fisher,
through flash attention and the logits-free fused loss (the CUDA kernels
on the GPU, their plain versions with ``--device cpu``;
``--no-fused-attn`` takes the materialized-scores attention;
``--no-fused-loss`` the plain chunked loss sweep, with the GNB refresh
from the sub-batch's materialized logits; ``--remat full|dots|scan2``
recomputes the trunk's activations in the backward; ``--fused-kernel``
runs the optimizer step on the engine kernels) and prints the
reference's ``step N loss ... gnorm ... ms`` lines (with
``--comm-telemetry`` a ``comm ...ms (...% of step)`` field), and at the
end, on the GPU, the peak device memory.  ``--compress-grads`` reduces the
gradients through the int8 error-feedback pipeline in buckets of
``--comm-bucket-elems``; ``--compress-hess`` the refresh's gradient-valued
pieces too.

``--retune`` measures the CE and flash kernels' tiles at this run's exact
shapes on the card before the first step (``kernels/autotune.py``: the
loss's rows a step, d_model, the padded vocabulary, tied or untied, the
softcap and the fused norm; each distinct attention window's (B, H, Hkv,
S, hd)), prints a ``[retune]`` line for each with the pick, its source and
its time against the seed's, and writes the picks to the tuner's cache
(``$REPRO_TORCH_AUTOTUNE_CACHE``, default
``~/.cache/repro_torch/autotune.json``), which later runs read.  On
several ranks, rank 0 measures and writes the cache and the other ranks
take its picks.  With ``--device cpu`` it raises ``ValueError``: the CPU runs the plain
versions, which have nothing to tune.

Several processes: launch the SAME command once per rank, adding

    --coordinator host:port --num-processes N --process-id <rank>

(NCCL on the card of the rank's local index; gloo with ``--device cpu``),
or pass ``--devices N`` to have this process spawn the N local ranks,
one per card (gloo processes with ``--device cpu``).  The ranks form the
reference's auto ``(data, model)`` grid (``launch/mesh.py:build_mesh``:
2 ranks -> (2, 1), 4 -> (2, 2), 8 -> (4, 2), 16 -> (4, 4)); each rank
trains on the rows of its data coordinate, holds its blocks of the
parameters over the model axis (tensor and expert parallelism, the dense
and MoE families; another family raises ``NotImplementedError`` on a model
axis above one) and its slices of the optimizer's m and h over the data
axis.  Checkpoints are collective (every leaf gathered whole, rank 0
writes the one-process format, manifests checked across ranks).

With ``--ckpt-dir`` it checkpoints every ``--ckpt-every`` steps
(asynchronously on one process) and at the end, and resumes from the
newest complete checkpoint there, on any number of ranks
(``checkpoint.restore_resharded``); resuming with another optimizer,
state dtype or ``--compress-grads`` setting is refused.  A failed
collective (a lost peer) raises ``NodeLoss``: the ranks exit non-zero and
are relaunched with the surviving count.  ``--elastic`` retries a failed
step from the latest checkpoint (``--max-restarts``); with
``--degrade-after N`` and ``--devices``, N straggler flags (a step's time
4 sigma over its EWMA) checkpoint the run, and this
process spawns half the ranks, which resume from that step.  SIGTERM
checkpoints and exits at the next step boundary.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from ..configs import ARCHS, get_config
from ..core.engine import FAMILIES
from ..data import DataConfig, host_slice, make_source
from ..distributed import world
from ..distributed.overlap import comm_device
from ..kernels import KERNEL_LAUNCHES
from ..models.transformer import REMATS
from ..serve.engine import resolve_device
from ..train import TrainerConfig, checkpoint as ckpt, make_engine, \
    make_train_fns
from ..train.elastic import (NodeLoss, PreemptionGuard, StragglerDetector,
                             is_distributed_failure, run_resumable)
from ..train.trainer import ESTIMATORS, to_device_batch
from .mesh import build_mesh, initialize_distributed

#: a rank's exit code when it checkpointed for a restart on fewer ranks
EXIT_DEGRADE = 75


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-small", choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--opt", default="sophia_g", choices=list(FAMILIES))
    ap.add_argument("--estimator", default="gnb", choices=list(ESTIMATORS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--peak-lr", type=float, default=4e-4)
    ap.add_argument("--weight-decay", type=float, default=0.2)
    ap.add_argument("--gamma", type=float, default=0.05)
    ap.add_argument("--hess-interval", type=int, default=10)
    ap.add_argument("--hess-subbatch", type=int, default=8)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--remat", default="none", choices=list(REMATS))
    ap.add_argument("--fused-kernel", action="store_true",
                    help="the optimizer step on the engine kernels "
                         "(kernels/sophia_update.py)")
    ap.add_argument("--fused-loss", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="logits-free fused CE + in-sweep GNB sampling "
                         "(kernels/fused_ce.py); --no-fused-loss takes the "
                         "plain chunked sweep")
    ap.add_argument("--fused-attn", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="flash attention on the train path (the CUDA "
                         "kernels of kernels/flash_attention.py); "
                         "--no-fused-attn trains on the materialized-scores "
                         "attention")
    ap.add_argument("--retune", action="store_true",
                    help="measure the CE and flash kernels' tiles at this "
                         "run's shapes on the card before training "
                         "(kernels/autotune.py; refreshes the cache's "
                         "entries)")
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 error-feedback gradient reduction "
                         "(distributed/compression.py)")
    ap.add_argument("--comm-bucket-elems", type=int, default=None,
                    help="bucket size (elements) of the gradient "
                         "collective (distributed/overlap.py): unset = "
                         "roofline, 0 = one bucket, N = explicit")
    ap.add_argument("--comm-telemetry", action="store_true",
                    help="logs comm_seconds and exposed_comm_fraction")
    ap.add_argument("--compress-hess", action="store_true",
                    help="int8-compress the estimator's gradient-valued "
                         "pieces too (stateless)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port (or file:// URL) of the rendezvous; "
                         "presence turns on torch.distributed")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--devices", type=int, default=None,
                    help="spawn this many local ranks, one per card "
                         "(gloo processes with --device cpu)")
    ap.add_argument("--state-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--data", default="synthetic")
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--elastic", action="store_true",
                    help="retry-with-restore on failure (run_resumable)")
    ap.add_argument("--max-restarts", type=int, default=None,
                    help="restart budget (default: 3 with --elastic, else 0)")
    ap.add_argument("--degrade-after", type=int, default=0,
                    help="with --elastic, --ckpt-dir and --devices: after N "
                         "straggler flags, checkpoint and resume on half "
                         "the ranks (0 = off)")
    ap.add_argument("--metrics-out", default=None,
                    help="append each step's metrics as a JSON line here "
                         "(rank 0), and a last line with the peak device "
                         "memory and the kernels' launch counts")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    return ap.parse_args(argv)


def _append(path, record) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def _final_save(ckpt_dir, step, state, extra):
    """The save at exit; skipped if the periodic save already wrote this
    step (drained first: its tmp dir would be shared)."""
    ckpt.wait_for_pending()
    if ckpt.latest_step(ckpt_dir) != step:
        ckpt.save(ckpt_dir, step, state, extra=extra)


def spawn_ranks(argv, n: int, degrade: bool) -> int:
    """Run the command as ``n`` local ranks (``--devices``): one process
    each, a fresh rendezvous file each round; when every rank exits with
    ``EXIT_DEGRADE`` (a straggler checkpoint), run again on half of them.
    Returns the exit code."""
    argv = list(argv)
    i = argv.index("--devices")
    del argv[i:i + 2]
    with tempfile.TemporaryDirectory() as tmp:
        for attempt in range(64):
            store = f"file://{os.path.join(tmp, f'store{attempt}')}"
            procs = [subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.train", *argv,
                 "--coordinator", store, "--num-processes", str(n),
                 "--process-id", str(r)]) for r in range(n)]
            codes = [p.wait() for p in procs]
            if degrade and n > 1 and all(c == EXIT_DEGRADE for c in codes):
                n = max(1, n // 2)
                print(f"[degrade] relaunching on {n} rank(s)", flush=True)
                continue
            return max(codes, key=abs)
    return 1


def main(argv=None):
    args = parse_args(argv)
    if args.retune and torch.device(args.device or "cuda").type != "cuda":
        raise ValueError(
            f"--retune measures the CUDA kernels on the card; --device "
            f"{args.device} runs their plain versions, which are never tuned")
    if args.devices and not args.coordinator:
        code = spawn_ranks(sys.argv[1:] if argv is None else argv,
                           args.devices, bool(args.degrade_after))
        if code:
            raise SystemExit(code)
        return None
    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family == "encdec":
        raise ValueError(
            f"--arch {args.arch}: the encoder-decoder's loss needs frames "
            f"beside the tokens, and the data pipeline yields tokens and "
            f"labels only (so does the reference's, whose launcher fails "
            f"inside loss_fn); train it through train.train_loop with a "
            f"source whose batches carry frames")
    if args.coordinator:
        device = initialize_distributed(args.coordinator, args.num_processes,
                                        args.process_id, args.device)
    else:
        device = resolve_device(args.device)
    try:
        return _train(args, cfg, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _retune_shapes(args, cfg, tc, grid):
    """(the loss's CE shape, [each attention shape]) of this run on one
    rank: its data coordinate's rows a step and, on a model axis, its
    heads; the unembedding is whole on every rank."""
    D, M = (grid.data, grid.model) if grid is not None else (1, 1)
    rows = args.global_batch // D // max(1, tc.grad_accum) * args.seq_len
    ce_shape = dict(
        N=rows, D=cfg.d_model, Vp=cfg.padded_vocab, h_dtype=cfg.compute_dtype,
        w_dtype=getattr(torch, cfg.param_dtype),
        transpose_w=not cfg.tie_embeddings, softcap=cfg.final_logit_softcap,
        norm=cfg.norm_type if cfg.family in ("dense", "moe") else "rms")
    attn = []
    if tc.fused_attn and tc.attn_impl == "auto" and cfg.family in (
            "dense", "moe", "griffin"):
        from ..kernels.flash_attention import WINDOW_NONE
        from ..models.transformer import layer_windows
        windows = (layer_windows(cfg) if cfg.family != "griffin"
                   else [cfg.local_window])
        B = args.global_batch // D // max(1, tc.grad_accum)
        for w in sorted(set(windows)):
            attn.append(dict(
                B=B, H=cfg.n_heads // M, Hkv=max(1, cfg.n_kv_heads // M),
                Sq=args.seq_len, Sk=args.seq_len, hd=cfg.hd,
                dtype=cfg.compute_dtype, causal=True,
                window=None if w >= WINDOW_NONE else w,
                softcap=cfg.attn_logit_softcap))
    return ce_shape if tc.fused_loss else None, attn


def retune(args, cfg, tc, device, grid, p0) -> None:
    """Measure the CE and flash kernels' candidates at this run's shapes
    (``kernels/autotune.py``, refreshing the cache) and print the picks.
    Rank 0 alone measures and writes the cache; the other ranks take its
    picks over the process group (``autotune.adopt``), so that every rank
    launches the same tiles: model peers compute the same loss (a chunk
    width changes dh's summation order), and a resume reads picks that
    every rank ran.  The tuning's launches and memory are not the run's:
    the launch counts are restored by the tuner and rank 0's peak-memory
    count reset here."""
    from ..kernels import autotune

    ce_shape, attn = _retune_shapes(args, cfg, tc, grid)
    shapes = ([ce_shape] if ce_shape is not None else []) + attn
    picks = None
    if p0:
        picks = []
        if ce_shape is not None:
            # the step's activations need the rest of the free memory
            picks.append(autotune.tune_shape(
                **ce_shape, device=device, refresh=True,
                ws_limit=torch.cuda.mem_get_info(device)[0] // 2))
        picks += [autotune.tune_attn_shape(**shape, device=device,
                                           refresh=True) for shape in attn]
        torch.cuda.reset_peak_memory_stats(device)
    if dist.is_initialized() and dist.get_world_size() > 1:
        box = [picks]
        dist.broadcast_object_list(box, src=0)
        if not p0:
            for shape, t in zip(shapes, box[0]):
                autotune.adopt(t, device, **shape)
    if not p0:
        return
    for shape, t in zip(shapes, picks):
        if isinstance(t, autotune.TunedCE):
            print(f"[retune] fused CE N={shape['N']} D={shape['D']} "
                  f"Vp={shape['Vp']} "
                  f"{'untied' if shape['transpose_w'] else 'tied'} "
                  f"softcap={shape['softcap']} norm={shape['norm']}: "
                  f"pieces={t.pieces} group={t.group} cw={t.cw} "
                  f"({t.source}): {t.measured_ms:.3f} ms forward + "
                  f"backward against the seed's {t.seed_ms:.3f}", flush=True)
        else:
            print(f"[retune] flash attention B={shape['B']} H={shape['H']} "
                  f"Hkv={shape['Hkv']} S={shape['Sq']} hd={shape['hd']} "
                  f"window={shape['window']}: forward BN={t.fwd} dQ "
                  f"BN={t.dq} dK/dV BQ={t.dkv_bq} HO={t.dkv_ho} "
                  f"({t.source}): {t.measured_ms:.3f} ms for the three "
                  f"against the seed's {t.seed_ms:.3f}", flush=True)


def _train(args, cfg, device):
    nproc, rank = world()
    p0 = rank == 0
    grid = build_mesh()
    # the rows of the rank's data coordinate (model ranks share them)
    ndev, drank = (grid.data, grid.d) if grid is not None else (1, 0)
    tc = TrainerConfig(
        optimizer=args.opt, estimator=args.estimator, peak_lr=args.peak_lr,
        total_steps=args.steps, warmup_steps=max(2, args.steps // 20),
        weight_decay=args.weight_decay, gamma=args.gamma,
        hess_interval=args.hess_interval, hess_subbatch=args.hess_subbatch,
        grad_accum=args.grad_accum, remat=args.remat,
        fused_kernel=args.fused_kernel, fused_loss=args.fused_loss,
        fused_attn=args.fused_attn, compress_grads=args.compress_grads,
        compress_hess=args.compress_hess,
        comm_bucket_elems=args.comm_bucket_elems,
        comm_telemetry=args.comm_telemetry, state_dtype=args.state_dtype,
        seed=args.seed)
    init_fn, train_step = make_train_fns(cfg, tc, device=device, grid=grid)
    src = make_source(DataConfig(
        seq_len=args.seq_len, global_batch=args.global_batch,
        vocab_size=cfg.vocab_size, seed=args.seed, source=args.data,
        path=args.data_path))
    engine = make_engine(tc)
    like = init_fn()
    if args.retune:
        retune(args, cfg, tc, device, grid, p0)
    layout_meta = dict(ckpt.layout_manifest(like.params),
                       optimizer=args.opt, state_dtype=args.state_dtype,
                       compress_grads=bool(args.compress_grads))
    fresh = [like]       # the first attempt trains from the state built

    def make_state():
        return fresh.pop() if fresh else init_fn()

    def restore_latest():
        if not args.ckpt_dir or ckpt.latest_step(args.ckpt_dir) is None:
            return None
        prev = ckpt.read_manifest(args.ckpt_dir).get("extra") or {}
        for field in ("optimizer", "state_dtype", "compress_grads"):
            # the optimizer families and state dtypes share the flat (m, h)
            # layout, so a silent restore would reinterpret the curvature
            # state; compress_grads changes the leaf count.  SystemExit is
            # not retried by run_resumable
            if prev.get(field) not in (None, layout_meta[field]):
                raise SystemExit(
                    f"[resume] checkpoint in {args.ckpt_dir} was written "
                    f"with {field}={prev[field]!r}; refusing to resume with "
                    f"{layout_meta[field]!r} (use a fresh --ckpt-dir)")
        state, start = ckpt.restore_resharded(
            args.ckpt_dir, make_state(), expect_layout=layout_meta)
        if p0:
            print(f"[resume] restored step {start} from {args.ckpt_dir} "
                  f"onto {nproc} process(es) on {device}", flush=True)
        return state, start

    guard = PreemptionGuard()

    def run(state, start):
        straggler = StragglerDetector()
        degrade = bool(args.elastic and args.degrade_after
                       and args.ckpt_dir and nproc > 1)
        t_start = time.time()
        for t in range(start, args.steps):
            t0 = time.time()
            # every rank computes the identical global batch (stateless
            # source) and takes its rows
            batch = src.batch_at(t)
            if ndev > 1:
                batch = host_slice(batch, drank, ndev)
            batch = to_device_batch(batch, device)
            try:
                state, metrics = train_step(
                    state, batch,
                    engine.hessian_aware and t % tc.hess_interval == 0)
                loss = float(metrics["loss"])
            except Exception as e:
                if nproc > 1 and is_distributed_failure(e):
                    # a peer died: unrecoverable in-process; the relaunch
                    # resumes the survivors from the last manifest
                    raise NodeLoss(
                        f"distributed failure at step {t}: {e}") from e
                raise
            dt = time.time() - t0
            flagged = straggler.observe(dt)
            if flagged and p0:
                print(f"[straggler] step {t} took {dt:.2f}s "
                      f"(mean {straggler.mean:.2f}s)", flush=True)
            preempt = guard.requested
            if nproc > 1:
                # the ranks decide together (a save is collective): any
                # rank past the straggler limit, any rank preempted
                votes = torch.tensor(
                    [float(degrade and straggler.flagged
                           >= args.degrade_after), float(preempt)],
                    device=comm_device())
                dist.all_reduce(votes, op=dist.ReduceOp.MAX)
                if votes[0].item() > 0:
                    # checkpoint, then exit for the spawner to restart on
                    # half the ranks (the group cannot shrink in-process)
                    _final_save(args.ckpt_dir, t + 1, state, layout_meta)
                    if p0:
                        print(f"[degrade] persistent straggler at step {t};"
                              f" checkpointed step {t + 1}", flush=True)
                    raise SystemExit(EXIT_DEGRADE)
                preempt = votes[1].item() > 0
            if args.metrics_out and p0:
                _append(args.metrics_out, dict(
                    {k: float(v) for k, v in metrics.items()}, step=t,
                    wall_s=dt))
            if t % args.log_every == 0 and p0:
                comm = ""
                if "comm_seconds" in metrics:
                    cs = float(metrics["comm_seconds"]) * 1e3
                    cf = float(metrics["exposed_comm_fraction"]) * 100
                    comm = f" comm {cs:.1f}ms ({cf:.0f}% of step)"
                print(f"step {t:6d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"{dt * 1e3:.0f}ms{comm}", flush=True)
            if args.ckpt_dir and (t + 1) % args.ckpt_every == 0:
                ckpt.save(args.ckpt_dir, t + 1, state, async_=True,
                          extra=layout_meta)
            if preempt:
                if p0:
                    print(f"[preempt] checkpointing at step {t + 1} "
                          "and exiting", flush=True)
                if args.ckpt_dir:
                    _final_save(args.ckpt_dir, t + 1, state, layout_meta)
                return state
        if args.ckpt_dir:
            _final_save(args.ckpt_dir, args.steps, state, layout_meta)
        peak_bytes = (torch.cuda.max_memory_allocated(device)
                      if device.type == "cuda" else None)
        peak = ("" if peak_bytes is None else
                f"; peak device memory {peak_bytes / 2 ** 30:.2f} GiB")
        if args.metrics_out and p0:
            _append(args.metrics_out, dict(
                done=args.steps - start, start=start, peak_bytes=peak_bytes,
                launches=dict(KERNEL_LAUNCHES), ranks=nproc,
                hess_count=int(state.opt_state.hess_count)))
        if p0:
            print(f"done: {args.steps - start} steps in "
                  f"{time.time() - t_start:.1f}s (hess refreshes: "
                  f"{int(state.opt_state.hess_count)}; straggler flags: "
                  f"{straggler.flagged}){peak}", flush=True)
        return state

    max_restarts = (args.max_restarts if args.max_restarts is not None
                    else (3 if args.elastic else 0))
    return run_resumable(make_state, run, restore_latest,
                         max_restarts=max_restarts)


if __name__ == "__main__":
    main()
