"""The CE backward on the card: the ``wgmma``/TMA kernels as committed
against the ``mma.sync`` kernels they replaced (commit 4479893), in turns
(old, new, new, old) in one process, at GPT-2 small's loss shape and
gemma2-9b's; and the committed kernels at the chunk widths of other
d-workspace budgets (``fused_ce.backward_plan``'s budget; the seed's is
``fused_ce.WS_BUDGET``).  A diagnostic behind
PERF.md, not a test (pytest does not collect it); it needs an NVIDIA GPU
and nvcc.  Extract the old kernel and its wrapper first, into the ignored
``build/``:

    mkdir -p build/old_ce
    git show 4479893:src/repro_torch/kernels/csrc/fused_ce.cu \\
        > build/old_ce/fused_ce_old.cu
    git show 4479893:src/repro_torch/kernels/fused_ce.py \\
        > build/old_ce/fused_ce_old.py
    python3 tests/_ce_backward_compare.py [--budgets 64,128,512] \\
        [--out FILE.json]

Each time is ``chip_smoke.time_ms``'s (CUDA events around each call, the L2
flushed before it, the median).  Per shape: the old pair (its dh and dW
calls, each with its own prep and logits; rows 14 + 15) and the new
combined call (row 13), each also alone (rows 14, 15), in the order old,
new, new, old; then the new combined call at the chunk width of each
other budget of MiB.  TFLOP/s on the three products and on the bf16 passes each call runs.
``torch.profiler`` splits three calls of each side by part (prep, logits,
dh, dW) and gives each call's span and busy time.
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
OLD = os.path.join(ROOT, "build", "old_ce")
SHAPES = {
    "gpt2-small": dict(N=8192, D=768, V=50304, Vp=50304, tied=True,
                       norm="ln", softcap=None),
    "gemma2-9b": dict(N=8192, D=3584, V=256000, Vp=256000, tied=True,
                      norm="rms", softcap=30.0),
}
REPS = {"gpt2-small": 20, "gemma2-9b": 4}


def nvcc(source, lib):
    from repro_torch.kernels import _build
    proc = subprocess.run(["/usr/local/cuda/bin/nvcc", *_build.NVCC_FLAGS,
                           "-o", lib, source], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return lib


def wrapper_module(wrapper, lib, name):
    """A wrapper module of the package (its relative imports resolve)
    launching the library ``lib``."""
    spec = importlib.util.spec_from_file_location(
        f"repro_torch.kernels.{name}", wrapper)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    cdll = ctypes.CDLL(lib)

    def launch_fn(fn_name):
        fn = getattr(cdll, fn_name)
        fn.argtypes = mod._SIGNATURES[fn_name]
        fn.restype = (ctypes.c_longlong if fn_name.endswith("_ws_bytes")
                      else ctypes.c_int)
        return fn
    mod._launch_fn = launch_fn
    return mod


def kind_of(name):
    """A kernel's part of the backward, from its (demangled) name."""
    for key, kind in (("ce_wgmma_kernel<0", "logits"),
                      ("ce_wgmma_kernel<1", "dh"),
                      ("ce_wgmma_kernel<2", "dw"),
                      ("ce_mma_kernel", "old_mma"),
                      ("ce_prep_hn", "prep"), ("ce_split", "prep"),
                      ("row_stats", "prep")):
        if key in name:
            return kind
    return "other"


def profile_call(torch, fn, flush, reps=3, kind=kind_of):
    """``torch.profiler`` over ``reps`` calls (the L2 flushed before each):
    per call, the device time of each part (``kind``), the kernel
    count, and the span from its first kernel's start to its last one's
    end (the span minus the busy time is the device's idle time inside
    the call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.sum()
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    # the flush's reduction separates the calls
    calls, cur = [], []
    for e in events:
        if "reduce" in e.name.lower() or "sum" in e.name.lower():
            if cur:
                calls.append(cur)
            cur = []
        else:
            cur.append(e)
    if cur:
        calls.append(cur)
    out = []
    for evs in calls:
        parts = {}
        for e in evs:
            k = kind(e.name)
            parts[k] = parts.get(k, 0.0) + (e.time_range.end
                                            - e.time_range.start) / 1e3
        span = (evs[-1].time_range.end - evs[0].time_range.start) / 1e3
        out.append({"ms": parts, "kernels": len(evs), "span_ms": span,
                    "busy_ms": sum(parts.values()),
                    "each": [(kind(e.name), round((e.time_range.end
                              - e.time_range.start) / 1e3, 4))
                             for e in evs]})
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-source",
                    default=os.path.join(OLD, "fused_ce_old.cu"))
    ap.add_argument("--old-wrapper",
                    default=os.path.join(OLD, "fused_ce_old.py"))
    ap.add_argument("--budgets", default="64,128,512",
                    help="other d-workspace budgets to time, MiB")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_ce as ce

    card = cs.card_line()
    print(card, flush=True)
    budgets = [int(b) for b in args.budgets.split(",") if b]
    t0 = time.perf_counter()
    jobs = {"old": (args.old_source, os.path.join(OLD, "libfused_ce_old.so"))}
    with ThreadPoolExecutor(len(jobs) + 1) as pool:
        new_build = pool.submit(_build.build, "fused_ce")
        libs = dict(zip(jobs, pool.map(lambda j: nvcc(*j), jobs.values())))
        new_build.result()
    print(f"built {len(jobs) + 1} libraries in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    old = wrapper_module(args.old_wrapper, libs["old"], "_fused_ce_old")
    flush = torch.empty(128 * 2 ** 20 // 4, device="cuda")
    report = {"card": card, "shapes": {}}
    for label in args.shapes.split(","):
        spec = dict(SHAPES[label], h="bfloat16", w="float32", mask=False)
        h, w, normp, labels, rs, opts = cs._ce_inputs(torch, **spec)
        lse, _ = ce.ce_forward_plain(h, w, normp, labels, **opts)
        N, D, Vp = spec["N"], spec["D"], spec["Vp"]
        args_ = (h, w, normp, labels, rs, lse)
        reps = REPS[label]

        def t(fn):
            return cs.time_ms(torch, fn, flush, reps=reps, warmup=1)

        # equal answers first: the combined call against the standalone
        # ones bit for bit, and the old pair against the new one
        dh_n, dw_n = ce.ce_backward(*args_, **opts)
        dh_o, dw_o = old.ce_backward(*args_, **opts)
        same = (torch.equal(dh_n, ce.ce_backward_dh(*args_, **opts))
                and torch.equal(dw_n, ce.ce_backward_dw(*args_, **opts)))
        gap = {"dh": (dh_n.float() - dh_o.float()).abs().max().item()
               / max(dh_o.float().abs().max().item(), 1e-30),
               "dw": (dw_n.float() - dw_o.float()).abs().max().item()
               / max(dw_o.float().abs().max().item(), 1e-30)}
        del dh_n, dw_n, dh_o, dw_o
        calls = {
            "old_pair": lambda: (old.ce_backward_dh(*args_, **opts),
                                 old.ce_backward_dw(*args_, **opts)),
            "new_combined": lambda: ce.ce_backward(*args_, **opts),
            "old_dh": lambda: old.ce_backward_dh(*args_, **opts),
            "new_dh": lambda: ce.ce_backward_dh(*args_, **opts),
            "old_dw": lambda: old.ce_backward_dw(*args_, **opts),
            "new_dw": lambda: ce.ce_backward_dw(*args_, **opts),
        }
        times = {k: [] for k in calls}
        for first, second in (("old", "new"), ("new", "old")):
            for what in ("pair", "dh", "dw"):
                for side in (first, second):
                    key = f"{side}_{what}" if what != "pair" else (
                        "old_pair" if side == "old" else "new_combined")
                    times[key].append(t(calls[key]))
        med = {k: statistics.median(v) for k, v in times.items()}
        at_budget = {mib: (lambda cw=ce.backward_plan(N, Vp, mib << 20):
                           ce._backward_kernel("both", *args_, **opts,
                                               cw=cw))
                     for mib in budgets}
        budget_ms = {mib: t(fn) for mib, fn in at_budget.items()}
        prof = {"new_combined": profile_call(torch, calls["new_combined"],
                                             flush),
                "old_pair": profile_call(torch, calls["old_pair"], flush)}
        for mib, fn in at_budget.items():
            prof[f"budget{mib}"] = profile_call(torch, fn, flush)
        unit = 2 * N * D * Vp / 1e9      # GFLOP of one pass; ms -> TFLOP/s
        passes = {k: ce.ce_passes(n, w_bf16=False) for k, n in (
            ("combined", "ce_backward"), ("dh", "ce_backward_dh"),
            ("dw", "ce_backward_dw"))}
        entry = {
            "shape": spec, "times_ms": times, "median_ms": med,
            "combined_equals_standalone": same,
            "new_vs_old_rel_max": gap,
            "budget_ms": budget_ms, "profile": prof,
            "new_combined_tflops_products": 3 * unit / med["new_combined"],
            "new_combined_tflops_passes":
                passes["combined"] * unit / med["new_combined"],
            "old_pair_tflops_passes": 7 * unit / med["old_pair"],
        }
        report["shapes"][label] = entry
        print(f"[{label}] N={N} D={D} Vp={Vp}: old pair "
              f"{med['old_pair']:.3f} ms (dh {med['old_dh']:.3f}, dW "
              f"{med['old_dw']:.3f}); new combined "
              f"{med['new_combined']:.3f} ms (dh {med['new_dh']:.3f}, dW "
              f"{med['new_dw']:.3f}); turns {json.dumps(times)}; new "
              f"combined {entry['new_combined_tflops_products']:.1f} "
              f"TFLOP/s on 3 products, "
              f"{entry['new_combined_tflops_passes']:.1f} on its "
              f"{passes['combined']} passes (old pair "
              f"{entry['old_pair_tflops_passes']:.1f} on 7); combined = "
              f"standalone bit for bit: {same}; new vs old, largest "
              f"difference relative to the largest element {gap}; other "
              f"budgets (MiB: ms) {budget_ms}; profile {json.dumps(prof)}",
              flush=True)
        del h, w, normp, labels, rs, lse
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)


if __name__ == "__main__":
    main()
