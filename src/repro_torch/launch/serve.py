"""Serving driver: a request stream over the continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt2-small \
        --requests 16 --slots 8 --prompt-len 64 --max-new 32 --mixed

The counterpart of ``repro/launch/serve.py``, with its flags except
``--decode-kernel`` (the device decides the route: the CUDA kernel on the
GPU, its plain version on the CPU) and ``--prefix-pool-pages`` (the prefix
cache is not ported; ``--prefix-cache`` raises).  ``--device`` defaults to
the GPU; ``--device cpu`` runs the plain path.  Prompts are drawn with
numpy from ``--seed``.  A warmup pass is timed separately, so first-call
costs never enter tok/s; latency percentiles and slot utilization come
from the engine's telemetry.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCHS, get_config
from ..models import get_model
from ..serve import Request, ServeEngine
from ..serve.engine import resolve_device


def _make_requests(cfg, n, prompt_len, max_new, mixed, seed,
                   shared_prefix=0):
    """Deterministic request stream; --mixed varies both lengths;
    ``shared_prefix`` prepends a common preamble."""
    prefix = (np.random.default_rng(seed + 7).integers(
        0, cfg.vocab_size, shared_prefix) if shared_prefix else None)
    reqs = []
    for i in range(n):
        if mixed:
            sp = max(1, prompt_len // 2 + (i * 7) % prompt_len)
            mn = max(1, max_new // 2 + (i * 5) % max_new)
        else:
            sp, mn = prompt_len, max_new
        toks = np.random.default_rng(seed + 100 + i).integers(
            0, cfg.vocab_size, sp).astype(np.int32)
        if prefix is not None:
            toks = np.concatenate([prefix, toks]).astype(np.int32)
        reqs.append(Request(uid=i, tokens=toks, max_new=mn))
    return reqs


def _new_engine(cfg, params, args, device):
    return ServeEngine(cfg, params, n_slots=args.slots,
                       cache_len=2 * (args.prompt_len + args.shared_prefix
                                      + args.max_new),
                       page_len=args.page_len,
                       steps_per_tick=args.steps_per_tick, seed=args.seed,
                       prefix_cache=args.prefix_cache,
                       kv_dtype=args.kv_dtype, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-small", choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--mixed", action="store_true",
                    help="vary prompt/output lengths across requests")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="common preamble tokens prepended to every prompt")
    ap.add_argument("--page-len", type=int, default=16)
    ap.add_argument("--steps-per-tick", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=False, help="shared-prefix KV page reuse "
                    "(not ported: raises)")
    ap.add_argument("--kv-dtype", default=None, choices=["bf16", "int8"],
                    help="KV cache dtype; int8 stores 1-byte payloads "
                         "with fp32 per-token scales")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain PyTorch path)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = get_model(cfg)
    params = model.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed))

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # --- warmup: first calls (library handles, kernel build) off the clock
    t0 = time.perf_counter()
    warm = _new_engine(cfg, params, args, device)
    for r in _make_requests(cfg, min(2, args.requests), args.prompt_len,
                            args.max_new, args.mixed, args.seed + 999,
                            args.shared_prefix):
        warm.submit(r)
    warm.run()
    sync()
    warmup_s = time.perf_counter() - t0

    # --- measured request stream ---
    eng = _new_engine(cfg, params, args, device)
    for r in _make_requests(cfg, args.requests, args.prompt_len,
                            args.max_new, args.mixed, args.seed,
                            args.shared_prefix):
        r.temperature = args.temperature
        eng.submit(r)
    t0 = time.perf_counter()
    results = eng.run()
    sync()
    dt = time.perf_counter() - t0

    stats = eng.stats()
    toks = stats["tokens_emitted"]
    kernel = "cuda" if device.type == "cuda" else "plain"
    print(f"arch={cfg.name} slots={args.slots} requests={args.requests} "
          f"page_len={args.page_len} kernel={kernel} "
          f"kv_dtype={eng.cfg.kv_dtype} prefix_cache={args.prefix_cache} "
          f"device={device}")
    print(f"warmup {warmup_s:.2f}s — excluded from tok/s")
    print(f"steady state: {toks} tokens in {dt:.2f}s = {toks / dt:.1f} tok/s")
    print(f"per-token latency p50={stats['token_lat_p50_s'] * 1e3:.2f}ms "
          f"p95={stats['token_lat_p95_s'] * 1e3:.2f}ms  "
          f"slot_utilization={stats['slot_utilization']:.2f}")
    print(f"mean request latency {stats['mean_request_latency_s']:.3f}s  "
          f"mean ttft {stats['mean_ttft_s']:.3f}s")
    print(f"ttft p50/p95/p99 {stats['ttft_p50_s']:.3f}/"
          f"{stats['ttft_p95_s']:.3f}/{stats['ttft_p99_s']:.3f}s  "
          f"tpot p50/p99 {stats['tpot_p50_s'] * 1e3:.2f}/"
          f"{stats['tpot_p99_s'] * 1e3:.2f}ms  "
          f"queue wait p99 {stats['queue_wait_p99_s']:.3f}s")
    by_uid = {r.uid: r for r in results}
    print("sample (uid 0):", by_uid[0].tokens[:16])
    return results


if __name__ == "__main__":
    main()
