"""Where a serving step's time goes: ``torch.profiler`` over one decode
burst and one prefill chunk of the engine, on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        --arch gpt2-small --kv-dtype bf16

Drives the engine through its public ``submit`` and ``tick`` only.  Fills
every slot with a request (prompt ``--prompt-len``, budget ``--max-new``),
ticks until they all decode, then profiles one tick that is a decode burst
of ``--steps-per-tick`` steps with all slots active, and one tick that is
a single prefill chunk of a fresh request.  For each window it prints one JSON line: host wall time,
device busy time (the union of kernel intervals), the device's idle share
of the wall time, the number of kernels launched, the device time of the
port's decode-attention kernel, and the kernels that took the most device
time.  Needs a GPU; weights are random from
``--seed``.  An encoder-decoder arch's requests carry ``ENC_SRC_LEN``
frames beside the prompt (its decoder prefix), as ``launch.serve``'s.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..configs import ARCHS, get_config
from ..models import get_model
from ..serve import Request, ServeEngine
from .serve import ENC_SRC_LEN


def _device_events(prof):
    """(name, start_us, end_us) of every kernel the profiler saw."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def _busy_us(intervals) -> float:
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _idle_gaps(kernels, top=3):
    """The ``top`` longest device idle gaps between kernels: [gap us, the
    kernel that ended last before it, the kernel after it]."""
    gaps, end, last = [], None, None
    for name, s, e in sorted(kernels, key=lambda k: k[1]):
        if end is not None and s > end:
            gaps.append([s - end, last[:60], name[:60]])
        if end is None or e > end:
            end, last = e, name
    return sorted(gaps, key=lambda g: -g[0])[:top]


def profile_window(label, fn, top=8, match="decode_attention",
                   also=()) -> dict:
    """Profile ``fn()``: wall time, device busy (union of kernel
    intervals), idle share, kernel count, the device time of kernels whose
    name contains ``match`` (key ``matched_us``; for each string of
    ``also``, key ``also_us``), the ``top`` kernels by device time, the
    longest idle gaps between kernels (``idle_gaps_us``) and the device
    idle before the window's first kernel, from its first host operation
    (``lead_us``, on the profiler's clock)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = _device_events(prof)
    busy = _busy_us([(s, e) for _, s, e in kernels])
    by_name: dict = {}
    for name, s, e in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    host_start = min((e.time_range.start for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CPU),
                     default=None)
    first = min((s for _, s, _ in kernels), default=None)
    return {"window": label, "wall_us": wall_us, "device_busy_us": busy,
            "device_idle_share": 1.0 - busy / wall_us if wall_us else None,
            "kernels_launched": len(kernels),
            "match": match,
            "matched_us": sum(t for n, t in by_name.items() if match in n),
            "also_us": {m: sum(t for n, t in by_name.items() if m in n)
                        for m in also},
            "top_kernels_us": [[n[:80], t] for n, t in ranked],
            "idle_gaps_us": _idle_gaps(kernels),
            "lead_us": (None if first is None or host_start is None
                        else first - host_start)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt2-small", choices=list(ARCHS))
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--max-new", type=int, default=64)
    ap.add_argument("--page-len", type=int, default=16)
    ap.add_argument("--steps-per-tick", type=int, default=8)
    ap.add_argument("--cache-len", type=int, default=512)
    ap.add_argument("--kv-dtype", default="bf16", choices=["bf16", "int8"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a GPU")

    cfg = get_config(args.arch)
    params = get_model(cfg).init_params(
        cfg, torch.Generator(device="cuda").manual_seed(args.seed))
    rng = np.random.default_rng(args.seed)

    if args.prompt_len <= 2 * args.page_len:
        raise SystemExit("--prompt-len must exceed two pages: the profiled "
                         "prefill tick is a prompt's second chunk")

    src_len = ENC_SRC_LEN if cfg.family == "encdec" else 0

    def engine(n_slots):
        eng = ServeEngine(cfg, params, n_slots=n_slots,
                          cache_len=args.cache_len, page_len=args.page_len,
                          steps_per_tick=args.steps_per_tick, seed=args.seed,
                          src_len=src_len, kv_dtype=args.kv_dtype,
                          device="cuda")
        for i in range(n_slots):
            frames = (rng.standard_normal((src_len, cfg.d_model),
                                          dtype=np.float32)
                      if src_len else None)
            eng.submit(Request(uid=i, tokens=rng.integers(
                0, cfg.vocab_size, args.prompt_len), max_new=args.max_new,
                frames=frames))
        return eng

    # every slot prefilled and decoding; one more tick warms the burst, and
    # from then on a tick is one decode burst and nothing else
    dec = engine(args.slots)
    while dec.tokens_emitted < args.slots:
        dec.tick()
    dec.tick()
    # one slot mid-prompt: its first tick warms the prefill, and its second
    # is one chunk (no slot decodes yet, so the tick runs no burst)
    pre = engine(1)
    pre.tick()
    reports = [
        profile_window(f"decode burst ({args.steps_per_tick} steps x "
                       f"{args.slots} slots, kv={args.kv_dtype})", dec.tick),
        profile_window(f"prefill chunk ({args.page_len} tokens, 1 slot, "
                       f"kv={args.kv_dtype})", pre.tick),
    ]
    card = torch.cuda.get_device_name(0)
    for r in reports:
        r["device"] = card
        print(json.dumps(r))
    return reports


if __name__ == "__main__":
    main()
