"""Training launcher, single process: the counterpart of
``repro/launch/train.py``.

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
reference's ``step N loss ... gnorm ...`` lines, and at the end, on the
GPU, the peak device memory.  With ``--ckpt-dir`` it
checkpoints every ``--ckpt-every`` steps and at the end, and resumes from
the newest complete checkpoint there; resuming with another optimizer or
state dtype is refused.  The reference's flags of options the port does
not have yet (``--compress-grads``, ``--compress-hess``,
``--comm-telemetry``) raise ``NotImplementedError``; the multi-host and
elastic flags are not offered.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import ARCHS, get_config
from ..core.engine import FAMILIES
from ..data import DataConfig, make_source
from ..models.transformer import REMATS
from ..serve.engine import resolve_device
from ..train import TrainerConfig, checkpoint as ckpt, make_engine, \
    make_train_fns
from ..train.trainer import ESTIMATORS, to_device_batch


def main(argv=None):
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
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--compress-hess", action="store_true")
    ap.add_argument("--comm-telemetry", action="store_true")
    ap.add_argument("--state-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--data", default="synthetic")
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family == "encdec":
        raise ValueError(
            f"--arch {args.arch}: the encoder-decoder's loss needs frames "
            f"beside the tokens, and the data pipeline yields tokens and "
            f"labels only (so does the reference's, whose launcher fails "
            f"inside loss_fn); train it through train.train_loop with a "
            f"source whose batches carry frames")
    device = resolve_device(args.device)
    tc = TrainerConfig(
        optimizer=args.opt, estimator=args.estimator, peak_lr=args.peak_lr,
        total_steps=args.steps, warmup_steps=max(2, args.steps // 20),
        weight_decay=args.weight_decay, gamma=args.gamma,
        hess_interval=args.hess_interval, hess_subbatch=args.hess_subbatch,
        grad_accum=args.grad_accum, remat=args.remat,
        fused_kernel=args.fused_kernel, fused_loss=args.fused_loss,
        fused_attn=args.fused_attn, compress_grads=args.compress_grads,
        compress_hess=args.compress_hess,
        comm_telemetry=args.comm_telemetry, state_dtype=args.state_dtype,
        seed=args.seed)
    init_fn, train_step = make_train_fns(cfg, tc, device=device)
    src = make_source(DataConfig(
        seq_len=args.seq_len, global_batch=args.global_batch,
        vocab_size=cfg.vocab_size, seed=args.seed, source=args.data,
        path=args.data_path))

    state = init_fn()
    engine = make_engine(tc)
    layout_meta = dict(engine.describe(state.params.param_tree()),
                       optimizer=args.opt, state_dtype=args.state_dtype)
    start = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        prev = ckpt.read_manifest(args.ckpt_dir).get("extra") or {}
        for field in ("optimizer", "state_dtype"):
            if prev.get(field) not in (None, layout_meta[field]):
                raise SystemExit(
                    f"[resume] checkpoint in {args.ckpt_dir} was written "
                    f"with {field}={prev[field]!r}; refusing to resume with "
                    f"{layout_meta[field]!r} (use a fresh --ckpt-dir)")
        for key in ("block", "shards"):
            if key in prev and prev[key] != layout_meta[key]:
                raise SystemExit(f"[resume] flat-shard layout mismatch on "
                                 f"{key!r}: checkpoint {prev[key]!r}, "
                                 f"engine {layout_meta[key]!r}")
        state, start = ckpt.restore(args.ckpt_dir, state)
        print(f"[resume] restored step {start} from {args.ckpt_dir} "
              f"on {device}")

    t_start = time.time()
    for t in range(start, args.steps):
        t0 = time.time()
        batch = to_device_batch(src.batch_at(t), device)
        state, metrics = train_step(state, batch,
                                    engine.hessian_aware
                                    and t % tc.hess_interval == 0)
        if t % args.log_every == 0:
            loss = float(metrics["loss"])
            dt = time.time() - t0
            print(f"step {t:6d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"{dt * 1e3:.0f}ms", flush=True)
        if args.ckpt_dir and (t + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, t + 1, state, extra=layout_meta)
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) != args.steps:
        ckpt.save(args.ckpt_dir, args.steps, state, extra=layout_meta)
    peak = (f"; peak device memory "
            f"{torch.cuda.max_memory_allocated(device) / 2 ** 30:.2f} GiB"
            if device.type == "cuda" else "")
    print(f"done: {args.steps - start} steps in {time.time() - t_start:.1f}s"
          f" (hess refreshes: {int(state.opt_state.hess_count)}){peak}")
    return state


if __name__ == "__main__":
    main()
