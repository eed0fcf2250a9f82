#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Runs from the root of a checkout on a machine with one NVIDIA H100 and
exits non-zero on the first failure.  It needs the repository's sources
(it builds the CUDA kernels from them) and a CUDA device: without either
it fails and prints no result.  Phases, in order:

  1. card and build: the card's name and power limit as nvidia-smi gives
     them; the CUDA kernel of the serving path built from
     ``src/repro_torch/kernels/csrc``;
  2. each kernel against its plain PyTorch version on the card, at the
     serving shape and at the edge cases (GQA, window + softcap, ring
     wraparound, an unwritten ring, a ring length off the kernel's tile);
     fp32 within 1e-5, bf16 within 2e-2;
  3. GPT-2 small served at full width and depth with random weights from a
     seeded generator: 16 mixed-length requests over 8 slots, once with a
     bf16 KV cache and once with int8.  Launch counts are zeroed just
     before each run and read just after: every decode step must launch
     the decode-attention kernel once per layer.  Then the decode path is
     held against the port's plain path on the CPU (same weights, fp32);
  4. numbers: serving throughput and latency, and a JSON line of kernel
     times (CUDA events, median over 200 launches with the 50 MB L2 cache
     flushed between launches) beside their bound (the bytes and flops of
     the ring rows the call's positions make valid: masked rows cannot
     change the output), their plain version and the library call that
     computes the same function.

The last line of standard output is the JSON result
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DECODE_ATTN = ("src/repro_torch/kernels/csrc/decode_attention.cu",
               {"decode_attention": "src/repro/kernels/decode_attention.py:47",
                "decode_attention_q8": "src/repro/kernels/decode_attention.py:96"})


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 1: build


def phase_build():
    from repro_torch.kernels import _build

    source = os.path.splitext(os.path.basename(DECODE_ATTN[0]))[0]
    t0 = time.perf_counter()
    report = _build.build(source)
    secs = time.perf_counter() - t0
    # ptxas -v prints "<n> bytes spill stores" for every kernel instance
    spilling = sum("spill stores" in ln and " 0 bytes spill stores" not in ln
                   for ln in report.splitlines())
    log(f"[build] {source} built in {secs:.1f}s into {_build.build_dir()}; "
        f"{spilling} kernel instance(s) spill")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def _decode_inputs(torch, N, H, Hkv, C, hd, dtype, positions, quant, seed,
                   v_gain=1.0):
    from repro_torch.quant import quantize_kv

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((N, H, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((N, C, Hkv, hd), generator=gen, device="cuda")
    v = torch.randn((N, C, Hkv, hd), generator=gen, device="cuda") * v_gain
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    if quant:
        k8, ks = quantize_kv(k)
        v8, vs = quantize_kv(v)
        return dict(q=q, k_cache=k8, v_cache=v8, positions=pos,
                    k_scale=ks, v_scale=vs)
    return dict(q=q, k_cache=k.to(dtype), v_cache=v.to(dtype), positions=pos,
                k_scale=None, v_scale=None)


def check_decode_attention(torch, args, **kw):
    """Kernel vs plain on the same inputs; returns the max abs error."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                       decode_attention_plain)

    got = decode_attention(args["q"], args["k_cache"], args["v_cache"],
                           args["positions"], k_scale=args["k_scale"],
                           v_scale=args["v_scale"], **kw)
    want = decode_attention_plain(args["q"], args["k_cache"], args["v_cache"],
                                  args["positions"], k_scale=args["k_scale"],
                                  v_scale=args["v_scale"], **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[str(args["q"].dtype).split(".")[1]]
    if not torch.isfinite(got).all() or not err <= tol:
        raise AssertionError(f"decode attention differs from its plain "
                             f"version: max abs err {err} > {tol}")
    return err, got


MAIN_POS = [0, 5, 100, 511, 512, 700, 1023, 1500]   # wraps past C = 512


def phase_kernels(torch):
    """Returns {kernel name: max abs err at the main bf16 shape}."""
    cases = [
        # name, (N, H, Hkv, C, hd), positions, extra kwargs
        ("main", (8, 12, 12, 512, 64), MAIN_POS, {}),
        ("gqa", (4, 8, 2, 256, 128), [3, 77, 255, 300], {}),
        ("gqa8", (2, 32, 4, 64, 128), [10, 63], {}),
        ("gqa5", (2, 40, 8, 64, 128), [40, 90], {}),
        ("window12_softcap50_hd256", (3, 4, 2, 64, 256), [9, 40, 100],
         {"window": 12, "softcap": 50.0}),
        ("wraparound", (4, 4, 4, 32, 64), [35, 171, 64, 95], {}),
        ("ring_len48", (4, 4, 4, 48, 64), [47, 20, 60, 95], {}),
    ]
    main_err = {}
    for dtype in (torch.float32, torch.bfloat16):
        for quant in (False, True):
            name = "decode_attention_q8" if quant else "decode_attention"
            for i, (case, (N, H, Hkv, C, hd), pos, kw) in enumerate(cases):
                args = _decode_inputs(torch, N, H, Hkv, C, hd, dtype, pos,
                                      quant, seed=i)
                err, _ = check_decode_attention(torch, args, **kw)
                log(f"[kernels] {name} {case} {str(dtype)[6:]} "
                    f"N={N} H={H} Hkv={Hkv} C={C} hd={hd} {kw or ''}: "
                    f"max abs err {err:.3g}")
                if case == "main" and dtype == torch.bfloat16:
                    main_err[name] = err
            # position 0 over a garbage ring: only the token just written
            # counts, so the output is exactly v[:, 0] of each head's group
            args = _decode_inputs(torch, 2, 4, 2, 32, 64, dtype, [0, 0],
                                  quant, seed=99, v_gain=100.0)
            err, got = check_decode_attention(torch, args)
            v0 = args["v_cache"][:, 0].float()
            if quant:
                v0 = (v0 * args["v_scale"][:, 0, None, None]).to(dtype).float()
            want = v0.repeat_interleave(2, dim=1).to(dtype).float()
            exact = (got.float() - want).abs().max().item()
            if not exact <= TOL[str(dtype)[6:]]:
                raise AssertionError(f"pos 0 garbage ring: {exact}")
            log(f"[kernels] {name} pos0_garbage_ring {str(dtype)[6:]}: "
                f"max abs err {err:.3g}, vs v[:, 0] {exact:.3g}")
    return main_err


# ---------------------------------------------------------------------------
# phase 3: serve GPT-2 small


def _requests(cfg, n=16, seed=1):
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        sp = int(rng.integers(32, 129))
        mn = int(rng.integers(16, 65))
        toks = rng.integers(0, cfg.vocab_size, sp).astype(np.int32)
        reqs.append(Request(uid=i, tokens=toks, max_new=mn))
    return reqs


def serve_once(torch, cfg, params, kv_dtype):
    """One measured run; returns (engine, seconds, launch counts)."""
    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
    from repro_torch.serve import ServeEngine

    def engine():
        return ServeEngine(cfg, params, n_slots=8, cache_len=512,
                           page_len=16, steps_per_tick=8, seed=0,
                           kv_dtype=kv_dtype, device="cuda")

    warm = engine()                      # first calls off the clock
    for r in _requests(cfg, n=2, seed=7):
        warm.submit(r)
    warm.run()
    torch.cuda.synchronize()

    eng = engine()
    reqs = _requests(cfg)
    for r in reqs:
        eng.submit(r)
    reset_launch_counts()
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(KERNEL_LAUNCHES)

    budget = {r.uid: r.max_new for r in reqs}
    got = {r.uid: r.tokens for r in results}
    if sorted(got) != sorted(budget):
        raise AssertionError("not every request finished")
    for uid, toks in got.items():
        if len(toks) != budget[uid]:
            raise AssertionError(f"request {uid}: {len(toks)} tokens for a "
                                 f"budget of {budget[uid]}")
        if not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {uid}: token out of vocabulary")
    name = "decode_attention_q8" if kv_dtype == "int8" else "decode_attention"
    steps = eng.decode_ticks * eng.steps_per_tick
    want = {name: cfg.n_layers * steps}
    if launches != want:
        raise AssertionError(f"launches {launches} != {want} "
                             f"({cfg.n_layers} layers x {steps} decode steps)")
    return eng, secs, launches


def check_engine_cache(torch, eng):
    """The kernel against its plain version on the engine's own layer-0
    cache and slot positions after the run."""
    st = eng.state
    N, cfg = eng.n_slots, eng.cfg
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((N, cfg.n_heads, cfg.hd), generator=gen,
                    device="cuda").to(cfg.compute_dtype)
    args = dict(q=q, k_cache=st["k"][0], v_cache=st["v"][0],
                positions=torch.from_numpy(eng._pos).cuda(),
                k_scale=st["k_scale"][0] if "k_scale" in st else None,
                v_scale=st["v_scale"][0] if "v_scale" in st else None)
    return check_decode_attention(torch, args, scale=1.0)[0]


def check_against_cpu(torch, cfg, params, kv_dtype):
    """Decode on the card (kernel route) against the port's plain path on
    the CPU, same weights, fp32 compute: 3 slots prefilled with 24-token
    prompts, then 6 teacher-forced decode steps.  Returns the max abs logit
    difference.  Tolerance: 1e-3 for an fp32 cache (12 layers of fp32 sums
    in another order on each side), 2e-2 for int8 (a K/V element that
    lands on the other side of a rounding boundary on one device moves by
    one quantization step)."""
    import numpy as np

    from repro_torch.models import get_model

    cfg32 = dataclasses.replace(cfg, dtype="float32", kv_dtype=kv_dtype)
    model = get_model(cfg32)
    cpu_params = copy.deepcopy(params).cpu()
    N, C, P = 3, 64, 16
    caches = {"cuda": model.init_slots(cfg32, N, C, "cuda"),
              "cpu": model.init_slots(cfg32, N, C, "cpu")}
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (N, 24)).astype(np.int32)
    err = 0.0
    last = {}
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        for s in range(N):
            for start in range(0, 24, P):
                chunk = prompts[s, start:start + P]
                n_valid = len(chunk)
                chunk = np.pad(chunk, (0, P - n_valid))
                lg = model.prefill_into_slot(
                    cfg32, p, caches[dev], s,
                    torch.from_numpy(chunk)[None].to(dev), start, n_valid)
            last[(dev, s)] = lg.float().cpu()
    for s in range(N):
        err = max(err, (last[("cuda", s)] - last[("cpu", s)]).abs().max().item())
    tokens = np.array([[int(last[("cpu", s)].argmax())] for s in range(N)],
                      np.int32)
    pos = np.full((N,), 24, np.int32)
    for _ in range(6):
        out = {}
        for dev, p in (("cuda", params), ("cpu", cpu_params)):
            out[dev] = model.decode_slots(
                cfg32, p, caches[dev], torch.from_numpy(tokens).to(dev),
                torch.from_numpy(pos).to(dev))[:, 0].float().cpu()
        if not torch.isfinite(out["cuda"]).all():
            raise AssertionError("non-finite logits on the card")
        err = max(err, (out["cuda"] - out["cpu"]).abs().max().item())
        tokens = out["cpu"].argmax(-1).numpy().astype(np.int32)[:, None]
        pos = pos + 1
    tol = 2e-2 if kv_dtype == "int8" else 1e-3
    if not err <= tol:
        raise AssertionError(f"card vs CPU logits ({kv_dtype} cache): max "
                             f"abs err {err} > {tol}")
    return err


def phase_serve(torch):
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    cfg = get_config("gpt2-small")
    params = get_model(cfg).init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    report = {}
    for kv_dtype in ("bf16", "int8"):
        eng, secs, launches = serve_once(torch, cfg, params, kv_dtype)
        st = eng.stats()
        cache_err = check_engine_cache(torch, eng)
        ref_err = check_against_cpu(torch, cfg, params, kv_dtype)
        name = "decode_attention_q8" if kv_dtype == "int8" else "decode_attention"
        report[name] = dict(launches=launches[name])
        log(f"[serve] gpt2-small kv={kv_dtype}: {len(eng.results)} requests, "
            f"{st['tokens_emitted']} tokens in {secs:.3f}s = "
            f"{st['tokens_emitted'] / secs:.1f} tok/s; token p50 "
            f"{st['token_lat_p50_s'] * 1e3:.3f} ms; ttft p50 "
            f"{st['ttft_p50_s'] * 1e3:.1f} ms; tpot p50 "
            f"{st['tpot_p50_s'] * 1e3:.3f} ms; decode steps "
            f"{eng.decode_ticks * eng.steps_per_tick}; launches {launches}; "
            f"engine-cache kernel err {cache_err:.3g}; card vs CPU logits "
            f"err {ref_err:.3g}")
    return report


# ---------------------------------------------------------------------------
# phase 4: kernel timings


def time_ms(torch, fn, flush, reps=200):
    """Median per-call device time: CUDA events around each call, the L2
    flushed before it by reading a buffer larger than the cache, and the
    stream held by a device-side sleep (~0.5 ms) so that the host has
    enqueued the whole call before the start event fires — the events then
    time the device's work, not the wrapper's host code."""
    for _ in range(10):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in ev:
        flush.sum()
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def host_ms(torch, fn, reps=200):
    """Median host time to issue one call (no device wait inside)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def phase_timings(torch, main_err, served):
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain, ring_mask)

    flush = torch.empty(128 * 2 ** 20 // 4, device="cuda")
    rows = []
    for name, replaces in DECODE_ATTN[1].items():
        quant = name.endswith("q8")
        a = _decode_inputs(torch, 8, 12, 12, 512, 64, torch.bfloat16,
                           MAIN_POS, quant, seed=0)
        N, H, hd = a["q"].shape
        C, Hkv = a["k_cache"].shape[1:3]
        kw = dict(k_scale=a["k_scale"], v_scale=a["v_scale"], scale=1.0)
        def kernel():
            return decode_attention(a["q"], a["k_cache"], a["v_cache"],
                                    a["positions"], **kw)

        ms = time_ms(torch, kernel, flush)
        issue_ms = host_ms(torch, kernel)
        plain_ms = time_ms(torch, lambda: decode_attention_plain(
            a["q"], a["k_cache"], a["v_cache"], a["positions"], **kw), flush)
        library_ms = None
        if not quant:
            q4 = a["q"][:, :, None, :]
            k4 = a["k_cache"].permute(0, 2, 1, 3)
            v4 = a["v_cache"].permute(0, 2, 1, 3)
            mask = ring_mask(a["positions"], C)[:, None, None, :]
            sdpa = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                                  scale=1.0)
            ref = decode_attention(a["q"], a["k_cache"], a["v_cache"],
                                   a["positions"], scale=1.0)
            sdpa_err = (sdpa[:, :, 0].float() - ref.float()).abs().max().item()
            log(f"[timing] SDPA yardstick vs kernel: max abs err {sdpa_err:.3g}")
            library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask, scale=1.0), flush)
        # the bound counts what this call's data needs: q read and the
        # output written once, the positions, and only the ring rows the
        # positions make valid (K and V, int8: plus their two fp32 scales),
        # with 4 flops per element per query head (q.k and p.v); a masked
        # row cannot change the output
        valid_rows = int(ring_mask(a["positions"], C).sum())
        row_bytes = 2 * Hkv * hd * a["k_cache"].element_size() + 8 * quant
        nbytes = (2 * a["q"].numel() * a["q"].element_size()
                  + a["positions"].numel() * 4 + valid_rows * row_bytes)
        flops = 4 * H * hd * valid_rows
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        rows.append({
            "name": name, "route": "cuda", "source": DECODE_ATTN[0],
            "replaces": replaces, "launches": served[name]["launches"],
            "max_abs_err": main_err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_us": bound_ms * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "host_issue_ms": issue_ms,
            "shape": f"N={N} H={H} Hkv={Hkv} C={C} hd={hd} q=bf16 "
                     f"kv={'int8' if quant else 'bf16'} positions={MAIN_POS}"})
        log(f"[timing] {name}: kernel {ms * 1e3:.2f} us, plain "
            f"{plain_ms * 1e3:.2f} us, library "
            f"{'n/a' if library_ms is None else f'{library_ms * 1e3:.2f} us'}"
            f", bound {bound_ms * 1e3:.2f} us ({nbytes} bytes, {flops} flops; "
            f"{valid_rows} valid rows of {N * C})")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    phase_build()
    main_err = phase_kernels(torch)
    served = phase_serve(torch)
    rows = phase_timings(torch, main_err, served)
    name, power = [s.strip() for s in card.split(",", 1)]
    log(card)
    log(json.dumps({"kernels": rows, "card": name, "power_limit": power}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
