"""The CE forward on the card: the ``wgmma``/TMA kernel as committed
(``ce_fwd_wgmma_kernel``) against the ``mma.sync`` kernel it replaced
(``ce_mma_kernel``, commit 7188079), in turns (old, new, ..., new, old) in
one process, at GPT-2 small's loss shape (N 8192, and the refresh's N 4096
for the draw), qwen2-vl-7b's, gemma2-9b's and qwen1.5-110b's; and variants
of the committed source built beside it.  A diagnostic behind PERF.md, not
a test (pytest does not collect it); it needs an NVIDIA GPU and nvcc.
Extract the old kernel and its wrapper first, into the ignored ``build/``:

    mkdir -p build/old_ce
    git show 7188079:src/repro_torch/kernels/csrc/fused_ce.cu \\
        > build/old_ce/fused_ce_fwd_old.cu
    git show 7188079:src/repro_torch/kernels/fused_ce.py \\
        > build/old_ce/fused_ce_fwd_old.py
    python3 tests/_ce_forward_compare.py [--out FILE.json]

The variants (``--variants``, all by default): ``cooperative`` and
``pingpong`` (the sections of ``tests/_ce_forward_variants.cu``: the
kernel before its producer warp, and the ping-pong with one part; each
must equal the committed kernel bit for bit, which the run checks),
``pingpong_2part`` (the ping-pong with two parts), ``no_fold`` (the
committed kernel without its fold: what the fold costs) and ``no_mma``
(without its wgmmas: what the feed and the fold cost; garbage answers).
Each variant's register and spill report, and ptxas's notes on serialized
wgmmas, are printed.

Each time is ``chip_smoke.time_ms``'s (CUDA events around each call, the
L2 flushed before it, the median).  Per shape: row 11 (``ce_forward``) and
row 12 (``ce_forward_sampled``) of each side; TFLOP/s on the logits
product; both sides' lse, label and drawn logits against the plain version
(largest gap; the drawn logit at rows drawn alike) and their draws against
the plain version's (rows that differ, and how many of them are near ties,
``chip_smoke``'s gap); new against old: lse's gap, whether the label
logits are equal bit for bit, the draws that differ and whether the drawn
logits of the rows drawn alike are equal bit for bit; ``torch.profiler``
splits three calls of each side into prep, sweep and combine (helpers of
``tests/_ce_backward_compare.py``).
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _ce_backward_compare as bc  # noqa: E402  (its paths and helpers)

OLD = bc.OLD
HERE = os.path.dirname(os.path.abspath(__file__))
SHAPES = {
    "gpt2-small": dict(N=8192, D=768, V=50304, Vp=50304, tied=True,
                       norm="ln", softcap=None),
    "qwen2-vl-7b": dict(N=4096, D=3584, V=152064, Vp=152064, tied=False,
                        norm="rms", softcap=None, mask="patches"),
    "gemma2-9b": dict(N=8192, D=3584, V=256000, Vp=256000, tied=True,
                      norm="rms", softcap=30.0),
    "qwen1.5-110b": dict(N=2048, D=8192, V=152064, Vp=152064, tied=False,
                         norm="rms", softcap=None),
}
REPS = {"gpt2-small": 20, "qwen2-vl-7b": 6, "gemma2-9b": 4,
        "qwen1.5-110b": 6}
VARIANT = "// ==== variant "
KERNEL = "// ---- the forward's feed, products and kernel"
SECTION_END = "// h_n, the normed rows rounded to bf16, in an (Np, D) plane"
WGMMAS = """#pragma unroll
  for (int s = 0; s < kWgBK / 16; ++s)
    wgmma_n128<0, B_MN>(d, da + 1024 * h + 2 * s,
                        db + 1024 * h + (B_MN ? 128 : 2) * s, s > 0);"""
FOLD = "fold_rows<SAMPLE>(acc, a, col, lab, rmix, fr);"
NO_FOLD = "fr[0] = fr[1] = Fold{acc[0], acc[21], acc[42], acc[63], 0};"
# the variants that keep the committed arithmetic: equal to it bit for bit
EXACT = ("cooperative", "pingpong", "pingpong_2part")


def kind_of(name):
    """A kernel's part of the forward, from its (demangled) name."""
    for key, kind in (("ce_fwd_wgmma_kernel", "sweep"),
                      ("ce_mma_kernel", "sweep"),
                      ("ce_combine", "combine"),
                      ("ce_prep_hn", "prep"), ("ce_split", "prep"),
                      ("row_stats", "prep")):
        if key in name:
            return kind
    return "other"


def _sub(src, old, new):
    if src.count(old) != 1:
        raise RuntimeError(f"variant anchor not found once: {old[:60]!r}")
    return src.replace(old, new)


def kernel_variants():
    """{name: kernel text} of ``_ce_forward_variants.cu``'s sections."""
    with open(os.path.join(HERE, "_ce_forward_variants.cu")) as f:
        parts = f.read().split(VARIANT)[1:]
    return {p.split("\n", 1)[0].strip(): p.split("\n", 1)[1] for p in parts}


def variant_sources(src):
    """{name: source} of the variants: the committed source without its
    wgmmas (``no_mma``) or its fold (``no_fold``), and with each section of
    ``_ce_forward_variants.cu`` in place of its kernel."""
    out = {"no_mma": _sub(src, WGMMAS, ""), "no_fold": _sub(src, FOLD, NO_FOLD)}
    a, b = src.index(KERNEL), src.index(SECTION_END)
    for name, text in kernel_variants().items():
        out[name] = src[:a] + text + src[b:]
    out["pingpong_2part"] = _sub(out["pingpong"], "kFwdParts = 1;",
                                 "kFwdParts = 2;")
    return out


def nvcc(source, lib):
    """(lib, the compiler's output), lib None where nvcc failed."""
    from repro_torch.kernels import _build
    proc = subprocess.run(["/usr/local/cuda/bin/nvcc", *_build.NVCC_FLAGS,
                           "-o", lib, source], capture_output=True, text=True)
    return (None if proc.returncode else lib), proc.stdout + proc.stderr


def ptxas_lines(report):
    """The register and spill lines of the forward's sweep kernels."""
    lines = report.splitlines()
    return [f"{lines[i][-40:]}: {lines[i + 1].strip()}; "
            f"{lines[i + 2].strip()}"
            for i, ln in enumerate(lines[:-2])
            if "Function properties for" in ln and "ce_fwd_wgmma" in ln] + [
                ln.strip() for ln in lines if "Potential Performance" in ln]


def gaps(torch, cs, side, h, w, normp, labels, opts, plain):
    """``side``'s lse / logits against the plain version's, and its draws
    (rows that differ; of them, rows near a tie)."""
    lse_p, ll_p, lse_sp, ll_sp, y_p, near = plain
    lse, ll = side.ce_forward(h, w, normp, labels, **opts)
    lse_s, ll_s, y = side.ce_forward_sampled(h, w, normp, cs.CE_SEED,
                                             **opts)
    torch.cuda.synchronize()
    same = y == y_p
    return {"lse": (lse - lse_p).abs().max().item(),
            "ll": (ll - ll_p).abs().max().item(),
            "lse_sampled": (lse_s - lse_sp).abs().max().item(),
            "ll_sampled": (ll_s - ll_sp)[same].abs().max().item(),
            "draws_differ": int((~same).sum()),
            "draws_differ_near_tie": int((~same & near).sum()),
            "padded_drawn": int((y >= opts["vocab"]).sum())}, (
                lse, ll, lse_s, ll_s, y)


def against(torch, a, b):
    """Two sides' (lse, ll, lse_s, ll_s, y): lse's largest gap, whether the
    label logits are equal bit for bit, the draws that differ, and whether
    the drawn logits of the rows drawn alike are equal bit for bit."""
    lse, ll, lse_s, ll_s, y = a
    lse2, ll2, lse_s2, ll_s2, y2 = b
    same = y == y2
    return {"lse": (lse - lse2).abs().max().item(),
            "lse_sampled": (lse_s - lse_s2).abs().max().item(),
            "ll_equal": bool(torch.equal(ll, ll2)),
            "draws_differ": int((~same).sum()),
            "drawn_ll_equal": bool(torch.equal(ll_s[same], ll_s2[same]))}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--old-source",
                    default=os.path.join(OLD, "fused_ce_fwd_old.cu"))
    ap.add_argument("--old-wrapper",
                    default=os.path.join(OLD, "fused_ce_fwd_old.py"))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--variants",
                    default="cooperative,pingpong,pingpong_2part,no_fold,"
                    "no_mma")
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused_ce as ce

    card = cs.card_line()
    print(card, flush=True)
    os.makedirs(OLD, exist_ok=True)
    src = (_build.CSRC / "fused_ce.cu").read_text()
    wanted = [v for v in args.variants.split(",") if v]
    jobs = {"old": (args.old_source, os.path.join(OLD,
                                                  "libfused_ce_fwd_old.so"))}
    for name, text in variant_sources(src).items():
        if name in wanted:
            path = os.path.join(OLD, f"fused_ce_fwd_{name}.cu")
            with open(path, "w") as f:
                f.write(text)
            jobs[name] = (path, os.path.join(OLD,
                                             f"libfused_ce_fwd_{name}.so"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs) + 1) as pool:
        new_build = pool.submit(_build.build, "fused_ce")
        built = dict(zip(jobs, pool.map(lambda j: nvcc(*j), jobs.values())))
        reports = {"new": new_build.result()}
    libs = {}
    for name, (lib, report) in built.items():
        reports[name] = report
        if lib is None:
            print(f"[{name}] failed to build:\n{report[-4000:]}", flush=True)
        else:
            libs[name] = lib
    print(f"built {len(jobs) + 1} libraries in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    for name, report in reports.items():
        print(f"[{name}] ptxas: {' | '.join(ptxas_lines(report))}",
              flush=True)
    old = bc.wrapper_module(args.old_wrapper, libs.pop("old"),
                            "_fused_ce_fwd_old")
    sides = {"old": old, "new": ce}
    for name, lib in libs.items():
        sides[name] = bc.wrapper_module(ce.__file__, lib,
                                        f"_fused_ce_fwd_{name}")
    flush = torch.empty(128 * 2 ** 20 // 4, device="cuda")
    out = {"card": card, "shapes": {}}
    for label in args.shapes.split(","):
        spec = dict(SHAPES[label], h="bfloat16", w="float32")
        spec.setdefault("mask", False)
        h, w, normp, labels, _, opts = cs._ce_inputs(torch, **spec)
        N, D, Vp = spec["N"], spec["D"], spec["Vp"]
        reps = REPS[label]
        lse_p, ll_p = ce.ce_forward_plain(h, w, normp, labels, **opts)
        lse_sp, ll_sp, y_p = ce.ce_forward_sampled_plain(
            h, w, normp, cs.CE_SEED, **opts)
        near = cs._draw_gaps(torch, h, w, normp, opts) < cs.NEAR_TIE
        plain = (lse_p, ll_p, lse_sp, ll_sp, y_p, near)
        g_new, out_n = gaps(torch, cs, ce, h, w, normp, labels, opts,
                            plain)
        g_old, out_o = gaps(torch, cs, old, h, w, normp, labels, opts,
                            plain)
        vs_old = against(torch, out_n, out_o)
        # the variants that keep the committed arithmetic: bit for bit
        vs_new = {s: against(torch, gaps(torch, cs, sides[s], h, w, normp,
                                         labels, opts, plain)[1], out_n)
                  for s in sides if s in EXACT}
        del plain, lse_p, ll_p, lse_sp, ll_sp, y_p

        h_r = h[:N // 2].contiguous()
        calls = {
            "fwd": lambda m: m.ce_forward(h, w, normp, labels, **opts),
            "sampled": lambda m: m.ce_forward_sampled(h, w, normp,
                                                      cs.CE_SEED, **opts)}
        if label == "gpt2-small":
            calls["sampled_refresh"] = lambda m: m.ce_forward_sampled(
                h_r, w, normp, cs.CE_SEED, **opts)
        order = list(sides)
        times = {f"{s}_{what}": [] for what in calls for s in order}
        for seq in (order, order[::-1]):
            for what, fn in calls.items():
                for s in seq:
                    times[f"{s}_{what}"].append(cs.time_ms(
                        torch, lambda m=sides[s]: fn(m), flush, reps=reps,
                        warmup=1))
        med = {k: statistics.median(v) for k, v in times.items()}
        gflop = 2 * N * D * Vp / 1e9
        tflops = {k: (gflop / 2 if k.endswith("refresh") else gflop) / v
                  for k, v in med.items()}
        prof = {f"{s}_{what}": bc.profile_call(
            torch, lambda m=sides[s]: fn(m), flush, kind=kind_of)
            for what, fn in calls.items()
            for s in ("old", "new", *(x for x in sides if x in EXACT))}
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        plan = ce.forward_plan(N, Vp, D, sms)
        entry = {"shape": spec, "times_ms": times, "median_ms": med,
                 "tflops": tflops, "gaps_new": g_new, "gaps_old": g_old,
                 "new_vs_old": vs_old, "variants_vs_new": vs_new,
                 "plan": plan._asdict(),
                 "profile": prof}
        out["shapes"][label] = entry
        split = {k: {part: round(ms, 4) for part, ms in v[-1]["ms"].items()}
                 for k, v in prof.items()}
        print(f"[{label}] N={N} D={D} Vp={Vp}: medians "
              f"{json.dumps({k: round(v, 4) for k, v in med.items()})}; "
              f"TFLOP/s "
              f"{json.dumps({k: round(v, 1) for k, v in tflops.items()})}; "
              f"gaps to plain new {json.dumps(g_new)} old "
              f"{json.dumps(g_old)}; new vs old {json.dumps(vs_old)}; "
              f"variants vs new {json.dumps(vs_new)}; plan "
              f"{json.dumps(plan._asdict())}; profile (last call, ms) "
              f"{json.dumps(split)}", flush=True)
        del h, w, normp, labels, h_r
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
