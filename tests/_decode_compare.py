"""Decode attention on the card: the split-cluster kernel as committed
against the one-block-per-(slot, head) kernel it replaced (commit 598b43c),
in turns (old, new, new, old) in one process, and the committed kernel at
every split count.  A diagnostic behind PERF.md, not a test (pytest does
not collect it); it needs an NVIDIA GPU and nvcc.  Extract the old kernel
and its wrapper first, into the ignored ``build/``:

    mkdir -p build/old_decode
    git show 598b43c:src/repro_torch/kernels/csrc/decode_attention.cu \\
        > build/old_decode/decode_attention_old.cu
    git show 598b43c:src/repro_torch/kernels/decode_attention.py \\
        > build/old_decode/decode_attention_old.py
    python3 tests/_decode_compare.py [--no-profile] [--out FILE.json]

The timing harness's floor first (a one-element add timed the same way).
At the three shapes ``chip_smoke.py`` times (``DECODE_SHAPES``) and at a
served burst's (8 slots, C = 512, positions 64-71), for a bf16 and an int8
cache: each kernel's device time as ``chip_smoke.time_ms`` takes it (CUDA
events, the L2 flushed, median of 200), in turns, its duration alone as
``torch.profiler`` records it (median of 50, the L2 flushed) and its host
issue time (median of 2000, the two kernels issued in alternation); the
committed kernel at S = 1, 2, 4, 8 (its C entry point called with that
split count); then ``repro_torch.launch.profile_serve`` with each kernel,
bf16 and int8.
"""
import argparse
import ctypes
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
OLD = os.path.join(ROOT, "build", "old_decode")
BURST = ((8, 12, 12, 512, 64), [64 + i for i in range(8)])


def build_old(source):
    from repro_torch.kernels import _build
    lib = os.path.join(os.path.dirname(source), "libdecode_old.so")
    t0 = time.perf_counter()
    proc = subprocess.run(["/usr/local/cuda/bin/nvcc", *_build.NVCC_FLAGS,
                           "-o", lib, source], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for the old kernel:\n{proc.stdout}"
                           f"{proc.stderr}")
    return lib, time.perf_counter() - t0


def build_new():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build("decode_attention")
    return time.perf_counter() - t0


def old_module(wrapper, lib):
    """The old wrapper, as a module of the package (its relative imports
    resolve), launching the old library."""
    spec = importlib.util.spec_from_file_location(
        "repro_torch.kernels._decode_attention_old", wrapper)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn = ctypes.CDLL(lib).decode_attention_launch
    fn.argtypes = mod._ARGTYPES
    fn.restype = ctypes.c_int
    mod._launch_fn = lambda: fn
    return mod


def with_splits(torch, da, a, splits):
    """The committed kernel on inputs ``a`` at a given split count."""
    fn = da._launch_fn()
    N, H, hd = a["q"].shape
    C, Hkv = a["k_cache"].shape[1:3]
    quant = a["k_scale"] is not None
    out = torch.empty_like(a["q"])
    stream = torch.cuda.current_stream().cuda_stream
    args = (a["q"].data_ptr(), a["k_cache"].data_ptr(),
            a["v_cache"].data_ptr(),
            a["k_scale"].data_ptr() if quant else None,
            a["v_scale"].data_ptr() if quant else None,
            a["positions"].data_ptr(), out.data_ptr(), N, H, Hkv, C, hd,
            int(a["q"].dtype == torch.bfloat16), int(quant), splits, 1.0,
            da.GLOBAL_WINDOW, 0.0, stream)

    def go():
        err = fn(*args)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out
    return go


def host_turns(torch, calls, reps=2000):
    """Median host time to issue one call of each kernel, the two measured
    in alternation, each first in every other round, so that both see the
    same host."""
    times = {w: [] for w in calls}
    order = list(calls)
    for i in range(reps):
        for w in order[::-1] if i % 2 else order:
            t0 = time.perf_counter()
            calls[w]()
            times[w].append(time.perf_counter() - t0)
            torch.cuda.synchronize()
    return {w: statistics.median(ts) * 1e3 for w, ts in times.items()}


def kernel_us(torch, fn, flush, reps=50):
    """Median device duration of the decode kernel over ``reps`` calls, the
    L2 flushed before each, as ``torch.profiler`` (CUPTI) records it: the
    kernel alone, without the events' and launch's share."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.sum()
            fn()
        torch.cuda.synchronize()
    durations = [e.time_range.end - e.time_range.start
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "decode_attention" in e.name]
    return statistics.median(durations) if durations else None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-source",
                    default=os.path.join(OLD, "decode_attention_old.cu"))
    ap.add_argument("--old-wrapper",
                    default=os.path.join(OLD, "decode_attention_old.py"))
    ap.add_argument("--no-profile", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import decode_attention as da

    card = cs.card_line()
    print(card, flush=True)
    with ThreadPoolExecutor(2) as pool:
        f_old = pool.submit(build_old, args.old_source)
        f_new = pool.submit(build_new)
        (lib, t_old), t_new = f_old.result(), f_new.result()
    print(f"[build] old {t_old:.1f}s, committed {t_new:.1f}s", flush=True)
    old = old_module(args.old_wrapper, lib)
    flush = torch.empty(128 * 2 ** 20 // 4, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = dict(cs.DECODE_SHAPES, burst_c512=BURST)
    # the harness's own floor: one one-element kernel between the events
    one = torch.zeros(1, device="cuda")
    floor_ms = cs.time_ms(torch, lambda: one.add_(1), flush)
    print(f"[floor] one-element add: {floor_ms * 1e3:.2f} us", flush=True)
    result = {"card": card, "floor_ms": floor_ms, "turns": [], "splits": []}
    for quant in (False, True):
        for key, (shape, pos) in shapes.items():
            N, H, Hkv, C, hd = shape
            a = cs._decode_inputs(torch, N, H, Hkv, C, hd, torch.bfloat16,
                                  pos, quant, seed=0)
            kw = dict(k_scale=a["k_scale"], v_scale=a["v_scale"], scale=1.0)
            calls = {
                "new": lambda: da.decode_attention(
                    a["q"], a["k_cache"], a["v_cache"], a["positions"], **kw),
                "old": lambda: old.decode_attention(
                    a["q"], a["k_cache"], a["v_cache"], a["positions"], **kw)}
            diff = (calls["new"]().float()
                    - calls["old"]().float()).abs().max().item()
            entry = {"shape": key, "kv": "int8" if quant else "bf16",
                     "splits": da.split_count(N, Hkv, C, sms),
                     "new_vs_old_max_abs": diff,
                     "ms": {"old": [], "new": []}}
            for which in ("old", "new", "new", "old"):
                entry["ms"][which].append(cs.time_ms(torch, calls[which],
                                                     flush))
            entry["host_ms"] = host_turns(torch, calls)
            entry["kernel_us"] = {w: kernel_us(torch, calls[w], flush)
                                  for w in ("old", "new")}
            result["turns"].append(entry)
            us = {w: [round(x * 1e3, 2) for x in entry["ms"][w]]
                  for w in ("old", "new")}
            hus = {w: round(entry["host_ms"][w] * 1e3, 2)
                   for w in ("old", "new")}
            print(f"[turns] {key} kv={entry['kv']} S={entry['splits']}: "
                  f"device old {us['old']} new {us['new']} us; host old "
                  f"{hus['old']} new {hus['new']} us; kernel alone old "
                  f"{entry['kernel_us']['old']:.2f} new "
                  f"{entry['kernel_us']['new']:.2f} us; |new - old| {diff:.3g}",
                  flush=True)
            for S in (1, 2, 4, 8):
                go = with_splits(torch, da, a, S)
                ms = cs.time_ms(torch, go, flush)
                result["splits"].append({"shape": key, "kv": entry["kv"],
                                         "S": S, "ms": ms})
                print(f"[splits] {key} kv={entry['kv']} S={S}: "
                      f"{ms * 1e3:.2f} us", flush=True)

    if not args.no_profile:
        from repro_torch.launch import profile_serve
        from repro_torch.models import layers
        committed = layers.decode_attention
        result["profile"] = []
        for kv in ("bf16", "int8"):
            for which in ("new", "old"):
                layers.decode_attention = (committed if which == "new"
                                           else old.decode_attention)
                try:
                    reports = profile_serve.main(["--kv-dtype", kv])
                finally:
                    layers.decode_attention = committed
                for r in reports:
                    r["kernel"] = which
                    print(f"[profile] {which} {r['window']}: wall "
                          f"{r['wall_us']:.1f} us, busy "
                          f"{r['device_busy_us']:.1f} us, idle "
                          f"{r['device_idle_share']:.4f}, kernels "
                          f"{r['kernels_launched']}, decode attention "
                          f"{r['matched_us']:.1f} us", flush=True)
                result["profile"].extend(reports)
    result["card_after"] = cs.card_line()
    print(result["card_after"])
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
