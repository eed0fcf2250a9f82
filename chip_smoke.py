#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Runs from the root of a checkout on a machine with one NVIDIA H100 and
exits non-zero on the first failure.  It needs the repository's sources
(it builds the CUDA kernels from them) and a CUDA device: without either
it fails and prints no result.  Phases, in order:

  1. card and build: the card's name and power limit as nvidia-smi gives
     them; every CUDA source under ``src/repro_torch/kernels/csrc`` (four)
     built at once (one nvcc each, in parallel), with ptxas's spill count;
  2. each kernel against its plain PyTorch version on the card: decode
     attention at the serving shape and its edge cases (GQA, window +
     softcap, ring wraparound, an unwritten ring, a ring length off the
     kernel's tile, GPT-2's full 1024-token context over 8 and over 64
     slots, negative positions, positions below the split count, the
     dense configs' heads: yi's and qwen1.5's group of 8 at hd 128,
     gemma2's hd 256 with its softcap, and its window in a ring of 8192);
     the fused CE kernels (forward, sampled forward, dh,
     dW) at GPT-2 small's loss shape (D=768, Vp=50304, tied, ln fused,
     bf16 h, fp32 W) with N=2048 and with the training run's N=8192 and
     4096, and its edge cases (untied, softcap 30, rms, no norm, padded
     vocab, ragged masked rows, fp32 h, bf16 W, D=128 and 1280 with fp32
     h and with bf16 h), the rope models' loss shapes (untied W, bf16 h:
     NeoX-1.5B N=8192 D=1536 Vp=50432, stablelm-1.6b N=8192 D=2048
     Vp=100352, NeoX-6.6B N=4096 D=4096 Vp=50432) and D=1536, 2048 and
     4096 tied and untied with bf16 h and with fp32 h (whose backward
     runs in D-slabs), and the dense configs' loss shapes with RMSNorm
     fused (yi N=4096 D=4096 Vp=64000 untied, qwen1.5 N=2048 D=8192
     Vp=152064 untied, gemma2 N=8192 D=3584 Vp=256000 tied with softcap
     30; and each width with fp32 h at 130 rows).  The forwards within
     1e-5 (fp32) or 2e-2 (bf16);
     dh and dW within 1e-5 of their largest element in fp32 and, with bf16
     h or W, element by element against each element's sum of absolute
     terms (``check_bf16_grad``; bf16 h takes the tensor-core kernels,
     forward and backward, and each case logs its share beyond 2^-16);
     the sampled labels identical except on rows whose two best perturbed
     logits lie within 1e-5, never a padded column; the flash-attention
     kernels (forward, dQ, dK/dV) at GPT-2 small's training shape (B=8,
     H=12, S=1024, hd=64, causal) and the refresh's B=4, and the edge
     cases (GQA 8/2, window 48 + softcap 20, q_offset with Sq < Sk,
     non-causal, S=1000 off the tile, hd=128, rows with no key) and the
     rope models' S=2048 (hd 64, 24 heads; hd 128, 32 heads), hd 256
     (gemma2's training shape, B=1 H=16 Hkv=8 S=8192 softcap 50, a local
     layer with its window of 4096 and a global one; and GQA 2 with window
     and softcap off the tile, q_offset, non-causal, a row with no key),
     fp32 and bf16, o, lse, dq, dk and dv within 1e-5 (fp32) or 2e-2
     (bf16) of their largest element, and in bf16 (all three on the
     tensor cores) every element of o, dq, dk and dv within 2^-7 of its
     absolute sum (the share beyond 2^-9 logged); the engine kernels (the
     Sophia step, the Hessian EMA with square off and on, the
     refresh-fused step with flag 0 and 1, AdamW at steps 1, 2 and 1000,
     the AdaHessian refresh-fused step with flag 0 and 1 at steps 1, 2 and
     1000, the AdaHessian step at those steps, Lion, SignGD and SGD, the
     last three also with m = g = 0 on every 7th element, where the sign
     argument is exactly 0, and Lion and SignGD with NaN in g and m, NaN
     exactly where their plain versions put it) at GPT-2 small's flat
     shard (n=124,518,400, block 131072) with fp32 and with bf16 state,
     and the edge cases (3 blocks of 128, one block, h with zeros and
     negative entries, rho=1e9, bf16 p, the zero tail pad), every output
     and every per-block clip count bit-identical to the plain version;
     and rows 2-4 launched on the shard of each dense config phase 4d
     trains (yi-6b at 8 layers, 1,908,539,392 elements; gemma2-9b at 4,
     1,710,358,528), the plain versions over slices;
  3. GPT-2 small served at full width and depth with random weights from a
     seeded generator: 16 mixed-length requests over 8 slots, once with a
     bf16 KV cache and once with int8.  Launch counts are zeroed just
     before each run and read just after: every decode step must launch
     the decode-attention kernel once per layer.  Then the decode path is
     held against the port's plain path on the CPU (same weights, fp32);
  4. GPT-2 small trained at full width and depth with Sophia-G (bf16
     compute, B=8 x S=1024, 12 steps, Hessian refresh every 5 on 4 rows)
     through ``train/trainer.py`` on the default flash-attention route
     with the engine kernels (``fused_kernel=True``).  Launch counts are
     zeroed just before the run and read just after: each step launches
     the CE forward, dh and dW once, each refresh step one more of each
     with the sampled forward, each step and each refresh launches every
     attention kernel once per layer, each refresh step the refresh-fused
     engine kernel and each other step the Sophia step kernel.  Step
     times, tokens/s, peak memory and a torch.profiler window over a plain
     and a refresh step (the CE's, attention's and engine kernels' device
     time and share); the engine's out-of-band ``update_hessian`` on the
     trained state (one EMA launch per shard); 4 AdamW steps at the same
     shape (one AdamW kernel launch per step, no sampled CE); the paper's
     other optimizers at the same shape on the engine kernels: Sophia-H
     with the Hutchinson estimator (12 steps, refresh every 5 on 4 rows:
     its HVP runs forward-over-reverse through the loss and attention
     twins, which launch the CE and attention forwards and no backward
     kernel), AdaHessian with Hutchinson (6 steps, refresh at 0 and 5),
     Lion, SignGD and SGD (4 steps each), with exact launch counts, step
     times (the refresh p50 over the refresh steps after step 0, which
     carries the first-call costs and is logged on its own), peak memory
     and a profile window of a Sophia-H refresh step;
     then fp32 steps at B=2 x S=128 held against the port's plain path on
     the CPU seven ways: the flash route with the engine kernels, the
     materialized-scores route (``fused_attn=False``) on the reference
     backend, AdamW, Sophia-H (Hutchinson, the same probe on both sides)
     and Lion with the engine kernels (3 steps each), AdaHessian
     (Hutchinson; 2 steps and its refreshed v), and one Sophia-G step with
     the empirical-Fisher estimator (its refreshed h too);
  4b. the trainer's other routes at the same shape (Sophia-G, GNB refresh
     at step 0, engine kernels): remat "none", "full", "dots" and "scan2"
     (3 steps each; step 0's loss and every gradient against "none",
     bit-identity logged; the flash forward launched again for every
     recomputed layer, 24 a plain step under "full" and "dots", 33 under
     "scan2"), Sophia-H with Hutchinson under "full" (2 steps; its HVP
     runs the trunk without remat), ``fused_loss=False`` (3 steps: the chunked loss and the
     GNB refresh from the sub-batch's materialized logits, no CE kernel;
     step 0's loss within 1e-4 of the fused route's) and
     ``attn_impl="chunked"`` (2 steps, no attention kernel; step 0's
     loss within 1e-3 of the flash route's), each with its plain-step
     p50, step 0 and peak memory; then the per-leaf API,
     ``chain(clip_by_global_norm(1.0), sophia_g(lr))`` on GPT-2 small's
     parameter tree, 5 steps after one ``gnb_estimator`` estimate, against
     the engine on both backends fed the same gradients and estimate:
     the parameters within 1e-5, the clip fractions within 1e-5 (the
     per-leaf form sums its leaves' counts in fp32, as the reference), the
     step p50s;
  4c. the rope models (GPT-NeoX 1.5B and 6.6B, the paper's own larger
     models, and stablelm-1.6b through ``get_config``: rope, untied
     embeddings, SwiGLU for stablelm), random weights from a seed: each
     one's step-0 loss and gradients at full width and 2 layers, fp32,
     B=1 x S=64, on the card against the CPU's plain path (loss within
     1e-5 relative, every gradient within 1e-4 of its leaf's largest
     element); Sophia-G trained at B x S=2048 (B=4; NeoX-6.6B B=2 at 8
     of its 32 layers: its full depth's ~110 GB of state does not fit
     one card) for 7 steps, bf16, engine kernels, peak lr 1e-5, GNB
     refresh at steps 0, 3 and 6 on half the batch, exact launch counts,
     the loss finite and falling, plain and refresh p50, tokens/s, peak
     memory; served at
     full depth (8 mixed requests over 8 slots, bf16 and int8 KV
     caches), the 2-layer model's decode on the card against the CPU.
     Counts are zeroed before each model's runs and read after: decode
     attention, the Sophia step and the refresh-fused step, the four CE
     kernels and the three flash kernels must each have launched;
  4d. the dense configs (``get_config``: yi-6b, RMSNorm and GQA 32/4;
     qwen1.5-110b, RMSNorm and QKV bias; gemma2-9b, RMSNorm with sandwich
     norms, GeGLU, the embedding scale, hd 256, the alternating window of
     4096 and the softcaps 50 and 30), random weights from a seed: each
     one's step-0 loss and gradients at full width, fp32, B=1 x S=64 on
     the card against the CPU (2 layers; qwen1.5 at 1 layer, 3.85 B
     parameters, with the host's memory logged); Sophia-G trained for 7
     steps as in 4c, yi-6b at 8 of 32 layers (B=2 x S=2048) and gemma2-9b
     at 4 of 42 (B=1 x S=8192, its context, where the local layers'
     window masks keys); qwen1.5-110b not trained (its embeddings alone,
     2.49 B parameters, take ~80 GB at the ~32 bytes a parameter a step
     needs); served (bf16 and int8 caches) at full depth, qwen1.5 at 6 of
     80 layers.  Each cut and its reason is logged.  Counts are zeroed
     before each run and read after: the step-0 check launches the CE and
     flash kernels, training the path's kernels exactly, serving decode
     attention once a layer a step;
  5. numbers: serving throughput and latency, and a JSON line of kernel
     times (CUDA events, median over 200 launches for decode attention,
     at the serving shape and under ``shapes`` at 8 and 64 slots of a
     1024-token context, each with its host issue time, split count and
     the occupancy in clusters, and 20 for the CE, flash and engine
     kernels, the 50 MB L2 cache
     flushed before each launch) beside their bound (decode attention:
     the bytes of the ring rows the call's positions make valid; the CE
     and flash kernels: the larger of their flops at the bf16 tensor-core
     peak and their bytes; the engine kernels: their bytes at GPT-2
     small's shard), their plain version and the library call (for the CE
     kernels the library composition, not one call; for the flash
     kernels SDPA's forward, and its backward for dQ and dK/dV together;
     for the Hessian EMA ``h.lerp_(e, 1 - beta2)``, for AdamW
     ``torch.optim.AdamW(fused=True).step()``, for SGD
     ``torch.optim.SGD(momentum=0.9, dampening=0, fused=True).step()``
     beside the kernel at the same momentum) that computes the same
     function; each CE and flash row names
     the units its bf16 products run on (tensor cores or FMA); the CE
     kernels at N=8192, the sampled forward also at the refresh's
     N=4096; under each CE and flash row's ``shapes`` the rope models'
     shapes, and under decode attention's NeoX-6.6B's heads (hd 128,
     32 heads) and the dense configs' heads; the CE kernels also at the
     dense configs' loss shapes, the flash kernels at gemma2's local and
     global layers (SDPA beside them without the softcap); each row's
     ``launches_models`` the launches of each model's runs.  A JSON line
     of the models' step times, memory, served tok/s and cuts comes
     before it.

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
# the rope models' steps allocate parameter-sized buffers (6-8 GB) after
# their backward frees many smaller ones: growable segments keep the
# allocator from fragmenting (set before torch first touches the card)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DECODE_ATTN = ("src/repro_torch/kernels/csrc/decode_attention.cu",
               {"decode_attention": "src/repro/kernels/decode_attention.py:47",
                "decode_attention_q8": "src/repro/kernels/decode_attention.py:96"})
FUSED_CE = ("src/repro_torch/kernels/csrc/fused_ce.cu",
            {"ce_forward": "src/repro/kernels/fused_ce.py:521",
             "ce_forward_sampled": "src/repro/kernels/fused_ce.py:544",
             "ce_backward_dh": "src/repro/kernels/fused_ce.py:601 "
                               "(and the dh half of :583)",
             "ce_backward_dw": "src/repro/kernels/fused_ce.py:621 "
                               "(and the dW half of :583)"})
FLASH_ATTN = ("src/repro_torch/kernels/csrc/flash_attention.cu",
              {"attn_fwd": "src/repro/kernels/flash_attention.py:198",
               "attn_bwd_dq": "src/repro/kernels/flash_attention.py:333",
               "attn_bwd_dkv": "src/repro/kernels/flash_attention.py:374"})
SOPHIA_UPDATE = ("src/repro_torch/kernels/csrc/sophia_update.cu",
                 {"sophia_step": "src/repro/kernels/sophia_update.py:72",
                  "hessian_ema": "src/repro/kernels/sophia_update.py:105",
                  "sophia_refresh": "src/repro/kernels/sophia_update.py:157",
                  "adahessian_refresh":
                      "src/repro/kernels/sophia_update.py:202",
                  "adamw_step": "src/repro/kernels/sophia_update.py:243",
                  "adahessian_step":
                      "src/repro/kernels/sophia_update.py:277",
                  "lion_step": "src/repro/kernels/sophia_update.py:306",
                  "signgd_step": "src/repro/kernels/sophia_update.py:333",
                  "sgd_step": "src/repro/kernels/sophia_update.py:356"})
SOURCES = (DECODE_ATTN[0], FUSED_CE[0], FLASH_ATTN[0], SOPHIA_UPDATE[0])


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


def _build_one(name):
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    report = _build.build(name)
    return time.perf_counter() - t0, report


def phase_build():
    """Every source at once: one nvcc each, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build

    names = [os.path.splitext(os.path.basename(src))[0] for src in SOURCES]
    with ThreadPoolExecutor(len(names)) as pool:
        done = dict(zip(names, pool.map(_build_one, names)))
    for name, (secs, report) in done.items():
        # ptxas -v prints "Function properties for <f>" and then "<n> bytes
        # spill stores" for every kernel instance
        spilling, func = [], None
        for ln in report.splitlines():
            if "Function properties for " in ln:
                func = ln.split("Function properties for ", 1)[1].strip()
            elif "spill stores" in ln and " 0 bytes spill stores" not in ln:
                spilling.append(f"{func}: {ln.strip()}")
        log(f"[build] {name} built in {secs:.1f}s into {_build.build_dir()}; "
            f"{len(spilling)} kernel instance(s) spill"
            + "".join(f"\n[build]   {entry}" for entry in spilling))


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
# decode attention's timed shapes, (N, H, Hkv, C, hd) and positions: (a) the
# serving shape, the kernels line's row; (b) GPT-2's full 1024-token context
# over 8 slots; (c) 64 slots at that context, every position >= 1023
DECODE_SHAPES = {
    "serving_c512": ((8, 12, 12, 512, 64), MAIN_POS),
    "full_ctx_c1024": ((8, 12, 12, 1024, 64),
                       [1023, 1024, 1500, 2047, 3000, 1023, 1100, 4095]),
    "batch64_c1024": ((64, 12, 12, 1024, 64),
                      [1023 + 37 * i for i in range(64)]),
    "neox66_hd128_c512": ((8, 32, 32, 512, 128), MAIN_POS),
    "yi_hd128_c512": ((8, 32, 4, 512, 128), MAIN_POS),
    "qwen_hd128_c512": ((8, 64, 8, 512, 128), MAIN_POS),
    "gemma2_hd256_c512": ((8, 16, 8, 512, 256), MAIN_POS),
}
# the options a timed shape's model calls the kernel with (gemma2: its
# softcap and window, which a ring of 512 never reaches)
DECODE_KW = {"gemma2_hd256_c512": {"window": 4096, "softcap": 50.0}}


def phase_kernels(torch):
    """Returns {kernel name: max abs err at the main bf16 shape}."""
    from repro_torch.kernels.decode_attention import split_count

    sms = torch.cuda.get_device_properties(0).multi_processor_count
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
        # GPT-2's full context: every split walks its whole share
        ("full_ctx_c1024", DECODE_SHAPES["full_ctx_c1024"][0],
         DECODE_SHAPES["full_ctx_c1024"][1], {}),
        # 64 slots x 12 heads fill the card alone: one block per walk
        ("batch64_c1024", DECODE_SHAPES["batch64_c1024"][0],
         DECODE_SHAPES["batch64_c1024"][1], {}),
        # every row masked: the merge of S = 4 splits must give the
        # uniform average over the ring
        ("negative_pos", (3, 12, 12, 64, 64), [-1, -7, 3], {}),
        # positions below the split count (S = 4): splits with no rows
        ("splits_past_rows", (4, 12, 12, 512, 64), [0, 1, 2, 3], {}),
        # the rope models' serving shapes: stablelm (hd 64, 32 heads) and
        # NeoX-6.6B (hd 128, 32 heads, new on a served path)
        ("stablelm_hd64_H32", (8, 32, 32, 512, 64), MAIN_POS, {}),
        ("neox66_hd128_H32", DECODE_SHAPES["neox66_hd128_c512"][0],
         DECODE_SHAPES["neox66_hd128_c512"][1], {}),
        # the dense configs' serving shapes (phase 4d): yi (hd 128, 32
        # heads over 4 KV heads) and qwen1.5 (64 over 8), group 8; gemma2
        # (hd 256, 16 over 8) with its softcap 50, and its window 4096
        # binding in a ring of 8192 with positions past 4096
        ("yi_hd128_H32_Hkv4", DECODE_SHAPES["yi_hd128_c512"][0],
         DECODE_SHAPES["yi_hd128_c512"][1], {}),
        ("qwen_hd128_H64_Hkv8", DECODE_SHAPES["qwen_hd128_c512"][0],
         DECODE_SHAPES["qwen_hd128_c512"][1], {}),
        ("gemma2_hd256_H16_Hkv8_softcap50", DECODE_SHAPES[
            "gemma2_hd256_c512"][0], DECODE_SHAPES["gemma2_hd256_c512"][1],
         DECODE_KW["gemma2_hd256_c512"]),
        ("gemma2_hd256_window4096_C8192", (4, 16, 8, 8192, 256),
         [4095, 5000, 8191, 12000], DECODE_KW["gemma2_hd256_c512"]),
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
                    f"N={N} H={H} Hkv={Hkv} C={C} hd={hd} "
                    f"S={split_count(N, Hkv, C, sms)} {kw or ''}: "
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


# the CE kernels: GPT-2 small's loss shape and the edge cases
# the rope models' loss shapes: the training batch's rows, untied W
CE_MODEL_SHAPES = (
    ("neox-1.5b", dict(N=8192, D=1536, V=50432, Vp=50432, tied=False)),
    ("stablelm-1.6b", dict(N=8192, D=2048, V=100352, Vp=100352,
                           tied=False)),
    ("neox-6.6b", dict(N=4096, D=4096, V=50432, Vp=50432, tied=False)),
)
# the dense configs' loss shapes (phase 4d), RMSNorm fused: yi's training
# batch (B 2 x S 2048, untied), qwen1.5's width and vocab at one 2048-token
# row (untied; it is not trained on the card), gemma2's training batch (B 1
# x S 8192, tied, final softcap 30)
CE_DENSE_SHAPES = (
    ("yi-6b", dict(N=4096, D=4096, V=64000, Vp=64000, tied=False,
                   norm="rms")),
    ("qwen1.5-110b", dict(N=2048, D=8192, V=152064, Vp=152064, tied=False,
                          norm="rms")),
    ("gemma2-9b", dict(N=8192, D=3584, V=256000, Vp=256000, tied=True,
                       norm="rms", softcap=30.0)),
)
CE_MAIN = dict(N=2048, D=768, V=50304, Vp=50304, tied=True, norm="ln",
               softcap=None, h="bfloat16", w="float32", mask=False)
CE_CASES = [
    ("main", {}),
    # the shapes the training run gives the kernels: every step's loss
    # (B=8 x S=1024 rows) and the refresh's sampled loss (4 x 1024 rows)
    ("train_step_N8192", dict(N=8192)),
    ("refresh_N4096", dict(N=4096)),
    ("untied", dict(tied=False)),
    ("softcap30", dict(softcap=30.0)),
    ("rms", dict(norm="rms")),
    ("no_norm", dict(norm=None)),
    ("padded_vocab_50257", dict(V=50257)),
    ("ragged_masked_rows_N1000", dict(N=1000, mask=True)),
    ("fp32_h", dict(h="float32")),
    ("bf16_w", dict(w="bfloat16")),
    ("fp32_D128_untied_padded", dict(N=200, D=128, V=1000, Vp=1024,
                                     tied=False, h="float32")),
    # the tensor-core route (bf16 h) from the narrowest width up
    ("bf16_D128_untied_padded_no_norm", dict(N=200, D=128, V=1000, Vp=1024,
                                             tied=False, norm=None)),
    ("bf16_D1280_untied_softcap_rms_masked", dict(N=1000, D=1280, V=2000,
                                                  Vp=2048, tied=False,
                                                  softcap=30.0, norm="rms",
                                                  mask=True)),
    ("fp32_D1280_softcap_rms_masked", dict(N=130, D=1280, V=2000, Vp=2048,
                                           h="float32", softcap=30.0,
                                           norm="rms", mask=True)),
    # the rope models' loss shapes (untied W, bf16 h: the training path)
    # and the widths 1536, 2048, 4096 tied, untied, bf16 h and fp32 h (the
    # fp32-h backward in D-slabs of at most 1280 columns)
] + [(f"{name}_N{sp['N']}_D{sp['D']}_Vp{sp['Vp']}_untied", sp)
     for name, sp in CE_MODEL_SHAPES] + [
    (f"{h}_D{D}_{'tied' if tied else 'untied_softcap_masked'}",
     dict(N=1000 if h == "bf16" else 130, D=D, V=2000, Vp=2048, tied=tied,
          h="bfloat16" if h == "bf16" else "float32",
          softcap=None if tied else 30.0, mask=not tied))
    for D in (1536, 2048, 4096) for h in ("bf16", "fp32")
    for tied in (True, False)] + [
    # the dense configs' loss shapes (bf16 h, the training path), and
    # their widths and vocabularies with fp32 h at 130 ragged rows (the
    # step-0 checks' route; the backward in 4, 7 and 3 D-slabs)
    (f"{name}_N{sp['N']}_D{sp['D']}_Vp{sp['Vp']}_rms", sp)
    for name, sp in CE_DENSE_SHAPES] + [
    (f"fp32_{name}_D{sp['D']}_Vp{sp['Vp']}_rms_masked",
     dict(sp, N=130, h="float32", mask=True))
    for name, sp in CE_DENSE_SHAPES]
CE_SEED = (1234567, 89101112)      # the sampled forward's noise seed
NEAR_TIE = 1e-5


def _ce_inputs(torch, *, N, D, V, Vp, tied, norm, softcap, h, w, mask,
               seed=0):
    from repro_torch.kernels.fused_ce import rowscale

    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    hid = (randn(N, D) * 2.0 + 0.5).to(getattr(torch, h))
    wt = (randn(*((Vp, D) if tied else (D, Vp))) * 0.02).to(getattr(torch, w))
    if norm is None:
        normp = torch.zeros((2, D), device="cuda")
    else:
        normp = torch.stack([(1.0 if norm == "ln" else 0.0) + 0.1 * randn(D),
                             0.1 * randn(D)])
    labels = torch.randint(0, V, (N,), generator=gen, device="cuda",
                           dtype=torch.int32)
    m = ((torch.rand((N,), generator=gen, device="cuda") > 0.3).float()
         if mask else None)
    rs, _ = rowscale(N, m, device="cuda")
    opts = dict(vocab=V, transpose_w=not tied, softcap=softcap, norm=norm,
                eps=1e-6)
    return hid, wt, normp, labels, rs, opts


def _draw_gaps(torch, h2, w, normp, opts):
    """Per row, the gap between the two best perturbed logits of the
    plain sweep (a smaller gap is a near-tie the kernel may break the
    other way: its sums run in another order)."""
    from repro_torch.kernels.fused_ce import (_chunk_logits, apply_norm,
                                              hash_gumbel)

    hn = apply_norm(h2, normp, opts["norm"], opts["eps"])
    h32 = hn.float()
    N = h2.shape[0]
    Vp = w.shape[1] if opts["transpose_w"] else w.shape[0]
    rows = torch.arange(N, device="cuda")[:, None]
    top = torch.full((N, 2), float("-inf"), device="cuda")
    for c0 in range(0, Vp, 2048):
        bv = min(2048, Vp - c0)
        s, valid, cols, _ = _chunk_logits(h32, w, hn.dtype, c0, bv,
                                          opts["transpose_w"],
                                          opts["softcap"], opts["vocab"])
        z = torch.where(valid, s + hash_gumbel(CE_SEED, rows, cols[None]),
                        float("-inf"))
        top = torch.cat([top, z], 1).topk(2, dim=1).values
    return top[:, 0] - top[:, 1]


def _abs_sums(torch, h, w, normp, labels, rs, lse, opts, stats=None):
    """(S_dh, S_dW): each gradient element's sum of absolute terms,
    |d|.|W| and |d|^T.|h_n|, by the plain sweep's chunks (h_n normalized
    with ``stats`` when given, as ``fused_ce.apply_norm``)."""
    from repro_torch.kernels.fused_ce import _chunk_logits, apply_norm

    hn = apply_norm(h, normp, opts["norm"], opts["eps"], stats).float()
    tw = opts["transpose_w"]
    Vp = w.shape[1] if tw else w.shape[0]
    s_dh = torch.zeros(hn.shape, device="cuda")
    s_dw = torch.zeros(w.shape, device="cuda")
    for c0 in range(0, Vp, 2048):
        bv = min(2048, Vp - c0)
        s, _, cols, dcap = _chunk_logits(hn, w, h.dtype, c0, bv, tw,
                                         opts["softcap"], opts["vocab"])
        onehot = (cols[None] == labels.long()[:, None]).float()
        d = (torch.exp(s - lse[:, None]) - onehot) * rs[:, None]
        d = (d if dcap is None else d * dcap).abs()
        wc = (w[:, c0:c0 + bv].T if tw else w[c0:c0 + bv]).float().abs()
        s_dh += d @ wc
        if tw:
            s_dw[:, c0:c0 + bv] = hn.abs().T @ d
        else:
            s_dw[c0:c0 + bv] = d.T @ hn.abs()
    return s_dh, s_dw


BF16_TIGHT_SHARE = 1e-3


def check_bf16_grad(torch, name, got, want, sums, tight=None):
    """dh or dW against the plain version where h or W is bf16, element by
    element.  Both round h_n to bf16; where the two sides' norm statistics
    differ in the last bit, an element of h_n may land one bf16 ulp (at
    most 2^-7 of it) apart, so each term of a gradient element may move by
    2^-7 of itself: every element must lie within 2^-7 of its sum of
    absolute terms S (plus one ulp of a bf16 output, plus 2^-24 max S).
    ``tight``, (want, sums) of the plain version normalizing with the
    kernels' own row statistics (``fused_ce.row_stats``), removes those
    flips: against it only fp32 sums in another order remain, and at most
    0.1% of the elements may lie beyond 2^-16 S.  (Against the plain
    statistics the flips alone put 0.16% of dW beyond it at qwen1.5's D
    8192, and up to 1.3e-4 at D <= 4096.)  Dropping the softmax term,
    skipping the rounding of h_n or rounding W in d.W puts 0.4-100% of
    the elements beyond it.  Returns (elements beyond 2^-7 S, share
    beyond 2^-16 S)."""
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs()
    base = ((2 ** -7 if want.dtype == torch.bfloat16 else 0.0) * mag
            + 2 ** -24 * sums.max())
    n_hard = int((diff > 2 ** -7 * sums + base).sum())
    if tight is not None:
        want, sums = tight
        diff = (got.float() - want.float()).abs()
        base = ((2 ** -7 if want.dtype == torch.bfloat16 else 0.0)
                * want.float().abs() + 2 ** -24 * sums.max())
    share = float((diff > 2 ** -16 * sums + base).float().mean())
    if n_hard or not share <= BF16_TIGHT_SHARE:
        raise AssertionError(
            f"{name}: {n_hard} elements beyond 2^-7 of their absolute sum, "
            f"{share:.3g} of them beyond 2^-16 (limit {BF16_TIGHT_SHARE})")
    return n_hard, share


STATS_ULPS = 16


def _kernel_row_stats(torch, h, opts):
    """The norm statistics the CE kernels normalize with, held against the
    plain version's: 1/sqrt(var + eps) (and ln's mean, relative to the
    row's largest |x|) within STATS_ULPS fp32 ulps (the two sum D terms in
    other orders, and torch's rsqrt is approximate).  Returns (stats, the
    largest difference in ulps)."""
    from repro_torch.kernels import fused_ce as ce

    got = ce.row_stats(h, norm=opts["norm"], eps=opts["eps"])
    want = torch.cat(ce._row_stats_plain(h.float(), opts["norm"],
                                         opts["eps"]), dim=-1)
    ulp = 2.0 ** -23
    rstd = ((got[:, 1] - want[:, 1]).abs() / (want[:, 1].abs() * ulp))
    scale = h.float().abs().amax(-1)
    mu = (got[:, 0] - want[:, 0]).abs() / (scale * ulp)
    worst = max(rstd.max().item(), mu.max().item())
    if not worst <= STATS_ULPS:
        raise AssertionError(f"CE row statistics differ from the plain "
                             f"ones by {worst:.3g} fp32 ulps (> "
                             f"{STATS_ULPS})")
    return got, worst


def check_ce_case(torch, name, spec):
    """Every CE kernel against its plain version on one input; returns
    {kernel: max abs error}.  The forwards are held at an absolute
    tolerance; dh and dW at 1e-5 of their largest element in fp32, and
    element by element (:func:`check_bf16_grad`) where h or W is bf16."""
    from repro_torch.kernels import fused_ce as ce

    h, w, normp, labels, rs, opts = _ce_inputs(torch, **spec)
    fp32 = spec["h"] == spec["w"] == "float32"
    tol = TOL["float32" if fp32 else "bfloat16"]
    errs = {}
    lse_k, ll_k = ce.ce_forward(h, w, normp, labels, **opts)
    lse_p, ll_p = ce.ce_forward_plain(h, w, normp, labels, **opts)
    torch.cuda.synchronize()
    errs["ce_forward"] = max((lse_k - lse_p).abs().max().item(),
                             (ll_k - ll_p).abs().max().item())

    lse_s, ll_s, y_k = ce.ce_forward_sampled(h, w, normp, CE_SEED, **opts)
    lse_sp, ll_sp, y_p = ce.ce_forward_sampled_plain(h, w, normp, CE_SEED,
                                                     **opts)
    torch.cuda.synchronize()
    same = y_k == y_p
    near = _draw_gaps(torch, h, w, normp, opts) < NEAR_TIE
    n_near, n_diff = int(near.sum()), int((~same).sum())
    if bool((~same & ~near).any()):
        raise AssertionError(f"ce_forward_sampled {name}: {n_diff} drawn "
                             "labels differ from the plain version's off a "
                             "near-tie")
    if int(y_k.max()) >= opts["vocab"]:
        raise AssertionError(f"ce_forward_sampled {name}: drew a padded "
                             "column")
    errs["ce_forward_sampled"] = max(
        (lse_s - lse_sp).abs().max().item(),
        (ll_s - ll_sp)[same].abs().max().item())

    dh_k = ce.ce_backward_dh(h, w, normp, labels, rs, lse_p, **opts)
    dw_k = ce.ce_backward_dw(h, w, normp, labels, rs, lse_p, **opts)
    dh_p, dw_p = ce.ce_backward_plain(h, w, normp, labels, rs, lse_p, **opts)
    torch.cuda.synchronize()
    if dh_k.dtype != dh_p.dtype or dw_k.dtype != w.dtype:
        raise AssertionError(f"{name}: dh/dW dtypes {dh_k.dtype}, "
                             f"{dw_k.dtype}")
    pad = dw_k[:, opts["vocab"]:] if opts["transpose_w"] else \
        dw_k[opts["vocab"]:]
    if pad.numel() and bool((pad != 0).any()):
        raise AssertionError(f"{name}: padded vocab columns got gradient")
    for t in (lse_k, ll_k, lse_s, ll_s, dh_k, dw_k):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: non-finite kernel output")
    bad = {k: e for k, e in errs.items() if not e <= tol}
    if bad:
        raise AssertionError(f"CE kernels differ from their plain versions "
                             f"({name}): {bad} > {tol}")
    grads = {"ce_backward_dh": (dh_k, dh_p), "ce_backward_dw": (dw_k, dw_p)}
    rel = {}
    for k, (got, want) in grads.items():
        errs[k] = (got.float() - want.float()).abs().max().item()
        rel[k] = errs[k] / max(want.float().abs().max().item(), 1e-30)
    if fp32:
        if not max(rel.values()) <= tol:
            raise AssertionError(f"{name}: dh/dW relative errors {rel} > "
                                 f"{tol}")
        grad_note = f"dh/dW within {tol} of their largest element"
    else:
        sums = dict(zip(grads, _abs_sums(torch, h, w, normp, labels, rs,
                                         lse_p, opts)))
        tight, stats_note = {k: None for k in grads}, ""
        if opts["norm"] is not None:
            stats, stats_ulps = _kernel_row_stats(torch, h, opts)
            tight = dict(zip(grads, zip(
                ce.ce_backward_plain(h, w, normp, labels, rs, lse_p,
                                     **opts, stats=stats),
                _abs_sums(torch, h, w, normp, labels, rs, lse_p, opts,
                          stats))))
            stats_note = (f"; the kernels' row statistics within "
                          f"{stats_ulps:.3g} fp32 ulps of the plain ones, "
                          f"the share against the plain version fed them")
        shares = {k: check_bf16_grad(torch, f"{k} {name}", *grads[k],
                                     sums[k], tight[k])[1] for k in grads}
        grad_note = ("dh/dW element by element: none beyond 2^-7 of the "
                     "absolute sum, share beyond 2^-16 "
                     + ", ".join(f"{s:.3g}" for s in shares.values())
                     + f" (limit {BF16_TIGHT_SHARE}){stats_note}")
    log(f"[kernels] fused_ce {name} N={spec['N']} D={spec['D']} "
        f"V={spec['V']} Vp={spec['Vp']} tied={spec['tied']} "
        f"norm={spec['norm']} softcap={spec['softcap']} h={spec['h']} "
        f"w={spec['w']} mask={spec['mask']}: max abs errors "
        + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
        + f" (forwards within {tol}); dh/dW relative to their largest "
        f"element " + ", ".join(f"{e:.3g}" for e in rel.values())
        + f"; {grad_note}; sampled labels: {n_diff} differ, {n_near} rows "
        f"near a tie (< {NEAR_TIE})")
    return errs


def phase_ce_kernels(torch):
    """Returns {kernel name: max abs error at the shape the training run
    gives it}: N=8192, and N=4096 for the sampled forward."""
    errs = {name: check_ce_case(torch, name, dict(CE_MAIN, **over))
            for name, over in CE_CASES}
    out = dict(errs["train_step_N8192"])
    out["ce_forward_sampled"] = errs["refresh_N4096"]["ce_forward_sampled"]
    return out


# the flash-attention kernels: GPT-2 small's training shape (and the
# refresh's half batch) and the edge cases
# the rope models' training attention: S = 2048, hd 64 with 24 and 32
# heads, hd 128 with 32
ATTN_MODEL_SHAPES = (
    ("neox-1.5b", dict(B=4, H=24, Hkv=24, Sq=2048, Sk=2048)),
    ("stablelm-1.6b", dict(B=4, H=32, Hkv=32, Sq=2048, Sk=2048)),
    ("neox-6.6b", dict(B=2, H=32, Hkv=32, Sq=2048, Sk=2048, hd=128)),
)
# gemma2's training attention (phase 4d: B 1 x S 8192, hd 256, GQA 16/8,
# softcap 50): its local layers' window of 4096 and its global layers
GEMMA2_ATTN = dict(B=1, H=16, Hkv=8, Sq=8192, Sk=8192, hd=256,
                   softcap=50.0)
ATTN_DENSE_SHAPES = (
    ("gemma2-9b-local", dict(GEMMA2_ATTN, window=4096)),
    ("gemma2-9b-global", GEMMA2_ATTN),
)
ATTN_MAIN = dict(B=8, H=12, Hkv=12, Sq=1024, Sk=1024, hd=64, causal=True,
                 window=None, softcap=None, q_offset=0)
ATTN_CASES = [
    ("train_step", {}),
    ("refresh_B4", dict(B=4)),
    ("gqa_H8_Hkv2", dict(B=2, H=8, Hkv=2, Sq=512, Sk=512)),
    ("window48_softcap20", dict(B=2, Sq=512, Sk=512, window=48,
                                softcap=20.0)),
    ("q_offset256_Sq256_Sk512", dict(B=2, Sq=256, Sk=512, q_offset=256)),
    ("noncausal", dict(B=2, Sq=384, Sk=512, causal=False)),
    ("S1000_off_tile", dict(B=2, Sq=1000, Sk=1000)),
    ("hd128", dict(B=2, H=8, Hkv=8, Sq=512, Sk=512, hd=128)),
    ("row_with_no_key", dict(B=2, H=4, Hkv=4, Sq=64, Sk=96, window=16,
                             q_offset=64)),
] + [(f"{name}_S2048_hd{sp.get('hd', 64)}", sp)
     for name, sp in ATTN_MODEL_SHAPES] + [
    # hd 256 (gemma2): its two layer kinds at its training shape, and the
    # edges at small sizes
    (f"{name}_S8192_hd256", sp) for name, sp in ATTN_DENSE_SHAPES] + [
    ("hd256_gqa2_window40_softcap50_S300_off_tile",
     dict(B=2, H=4, Hkv=2, Sq=300, Sk=300, hd=256, window=40, softcap=50.0)),
    ("hd256_q_offset96_Sq160_Sk256", dict(B=1, H=4, Hkv=2, Sq=160, Sk=256,
                                          hd=256, q_offset=96)),
    ("hd256_noncausal_Sq100_Sk130", dict(B=1, H=2, Hkv=1, Sq=100, Sk=130,
                                         hd=256, causal=False)),
    ("hd256_row_with_no_key", dict(B=1, H=2, Hkv=2, Sq=64, Sk=96, hd=256,
                                   window=16, q_offset=64))]


def _attn_inputs(torch, spec, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    B, H, Hkv, Sq, Sk, hd = (spec[n] for n in ("B", "H", "Hkv", "Sq", "Sk",
                                               "hd"))
    q, g = randn(B, H, Sq, hd), randn(B, H, Sq, hd)
    k, v = randn(B, Hkv, Sk, hd), randn(B, Hkv, Sk, hd)
    kw = dict(causal=spec["causal"], window=spec["window"],
              softcap=spec["softcap"], q_offset=spec["q_offset"],
              scale=1.0 / hd ** 0.5)
    return q, k, v, g, kw


def check_flash_case(torch, name, spec, dtype):
    """The three kernels against their plain versions on one input (the
    backward's on the kernel forward's lse and delta); each output within
    TOL of its largest element.  lse is compared on the rows that attend
    some key; a row that attends none must give o = 0 and lse <= -1e29 on
    both sides.  In bf16 (the tensor-core kernels) also every element of
    o, dq, dk and dv within 2^-7 of its absolute sum
    (``flash_attention.contract_sums``), the share beyond 2^-9 logged.
    Returns {kernel: max abs error}."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, g, kw = _attn_inputs(torch, spec, dtype)
    o, lse = fa.flash_forward(q, k, v, **kw)
    delta = (g.float() * o.float()).sum(-1)
    dq = fa.flash_backward_dq(q, k, v, g, lse, delta, **kw)
    dk, dv = fa.flash_backward_dkv(q, k, v, g, lse, delta, **kw)
    o_p, lse_p = fa.flash_forward_plain(q, k, v, **kw)
    dq_p = fa.flash_backward_dq_plain(q, k, v, g, lse, delta, **kw)
    dk_p, dv_p = fa.flash_backward_dkv_plain(q, k, v, g, lse, delta, **kw)
    torch.cuda.synchronize()
    has_key = fa.band_mask(spec["Sq"], spec["Sk"], causal=spec["causal"],
                           window=spec["window"], q_offset=spec["q_offset"],
                           device="cuda").any(-1)
    empty = ~has_key
    if bool(empty.any()):
        for side, (oo, ll) in (("kernel", (o, lse)), ("plain", (o_p, lse_p))):
            if (bool((oo[:, :, empty] != 0).any())
                    or not bool((ll[:, :, empty] <= -1e29).all())):
                raise AssertionError(f"flash {name}: a row with no key gets "
                                     f"o != 0 or lse > -1e29 ({side})")
    pairs = {"o": (o, o_p), "lse": (lse[:, :, has_key], lse_p[:, :, has_key]),
             "dq": (dq, dq_p), "dk": (dk, dk_p), "dv": (dv, dv_p)}
    tol = TOL[str(dtype)[6:]]
    errs, rel = {}, {}
    for key, (got, want) in pairs.items():
        if got.dtype != want.dtype or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash {name}: {key} is {got.dtype} (want "
                                 f"{want.dtype}) or not finite")
        errs[key] = (got.float() - want.float()).abs().max().item()
        rel[key] = errs[key] / max(want.float().abs().max().item(), 1e-30)
    bad = {key: r for key, r in rel.items() if not r <= tol}
    if bad:
        raise AssertionError(f"flash kernels differ from their plain "
                             f"versions ({name}, {str(dtype)[6:]}): errors "
                             f"relative to the largest element {bad} > {tol}")
    contract = ""
    if dtype == torch.bfloat16:
        shares = {}
        sums = fa.contract_sums(q, k, v, g, lse, delta, **kw)
        for key, s in sums.items():
            n_hard, shares[key] = fa.contract_misses(*pairs[key], s)
            if n_hard:
                raise AssertionError(
                    f"flash {name} bf16: {n_hard} elements of {key} beyond "
                    f"2^-7 of their absolute sum (the tensor-core route's "
                    f"contract)")
        del sums
        contract = ("; every element of o, dq, dk, dv within 2^-7 of its "
                    "absolute sum, share beyond 2^-9: "
                    + ", ".join(f"{n} {x:.3g}" for n, x in shares.items()))
    log(f"[kernels] flash_attention {name} {str(dtype)[6:]} "
        + " ".join(f"{n}={spec[n]}" for n in ATTN_MAIN)
        + ": max abs errors " + ", ".join(f"{n} {e:.3g}"
                                          for n, e in errs.items())
        + "; relative to the largest element "
        + ", ".join(f"{r:.3g}" for r in rel.values()) + f" (within {tol})"
        + contract
        + (f"; {int(empty.sum())} rows with no key" if bool(empty.any())
           else ""))
    return {"attn_fwd": max(errs["o"], errs["lse"]),
            "attn_bwd_dq": errs["dq"],
            "attn_bwd_dkv": max(errs["dk"], errs["dv"])}


def phase_flash_kernels(torch):
    """Returns {kernel name: max abs error at the training shape, bf16}."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, over in ATTN_CASES:
            errs = check_flash_case(torch, name, dict(ATTN_MAIN, **over),
                                    dtype)
            if name == "train_step" and dtype == torch.bfloat16:
                out = errs
    return out


# the engine kernels: GPT-2 small's flat shard (build_layout: one fp32
# shard of 124,518,400 elements, 950 blocks of 131072) and the edge cases
SHARD_N, SHARD_BLOCK = 124_518_400, 131_072
SOPHIA_HP = dict(beta1=0.96, gamma=0.05, eps=1e-12, weight_decay=0.2)
ADAMW_HP = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.2)
# the trainer's table (train/trainer.py:make_engine); SGD with momentum so
# that m' is not g
ADAHESSIAN_HP = dict(beta1=0.92, beta2=0.99, eps=1e-8, weight_decay=0.2)
LION_HP = dict(beta1=0.95, beta2=0.98, weight_decay=0.2)
SIGNGD_HP = dict(beta1=0.96, weight_decay=0.2)
SGD_HP = dict(momentum=0.9)


def _engine_operands(torch, n, pdt, sdt, *, seed=0, h_kind="positive"):
    """p, m, h, g, e on the card at a trained model's scales (p ~ 0.02,
    m and g ~ 1e-3, h and e ~ 1e-6).  ``h_kind`` "mixed" puts zeros and
    negative entries in h (Hutchinson-style estimates), "tail_pad" zeroes
    the last quarter of every operand (the engine's pad)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(scale):
        return torch.randn((n,), generator=gen, device="cuda") * scale

    p, m, g = randn(0.02), randn(1e-3), randn(1e-3)
    h, e = randn(1e-3).square(), randn(1e-3).square()
    if h_kind == "mixed":
        h = randn(1e-6)
        h[::5] = 0.0
    ops = [p.to(pdt), m.to(sdt), h.to(sdt), g, e]
    if h_kind == "tail_pad":
        for t in ops:
            t[3 * n // 4:] = 0
    return ops


def _bits(torch, t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def check_engine_case(torch, name, n, block, pdt, sdt, *, h_kind="positive",
                      rho=1.0, flags=(0, 1), steps=(1, 2, 1000)):
    """Rows 2, 3 (square off and on), 4 (each flag), 6 (each step), 5
    (each flag and step), 7 (each step) and 8-10 against their plain
    versions on the same card tensors: every output and every per-block
    clip count bit for bit.  AdaHessian's v is |h| (zeros where h has
    them), its estimate e signed; Lion and SignGD also run with m = g = 0
    on every 7th element, where their sign argument is exactly 0.
    Returns {kernel: max abs error} (0.0 when bit-identical) and logs the
    clip counts."""
    from repro_torch.kernels import sophia_update as su

    p, m, h, g, e = _engine_operands(torch, n, pdt, sdt, h_kind=h_kind)
    lr = torch.tensor(6e-4, device="cuda")
    scale = torch.tensor(4096.0, device="cuda")       # GNB's B: 4 x 1024
    sk = dict(SOPHIA_HP, clip_threshold=rho, block=block)
    calls = [("sophia_step", su.sophia_fused_block,
              su.sophia_fused_block_plain, (p, m, h, g, lr), sk)]
    calls += [("hessian_ema", su.hessian_ema_block,
               su.hessian_ema_block_plain, (h, e),
               dict(beta2=0.99, scale=scale, square=sq, block=block))
              for sq in (False, True)]
    calls += [("sophia_refresh", su.sophia_refresh_fused_block,
               su.sophia_refresh_fused_block_plain,
               (p, m, h, g, e, lr, flag, scale), dict(sk, beta2=0.99))
              for flag in flags]
    v = h.abs()
    calls += [("adamw_step", su.adamw_fused_block, su.adamw_fused_block_plain,
               (p, m, v, g, lr, torch.tensor(float(st), device="cuda")),
               dict(ADAMW_HP, block=block)) for st in steps]
    one = torch.tensor(1.0, device="cuda")            # Hutchinson's scale
    e_signed = e.clone()                # u . Hu is signed; the pad stays 0
    e_signed[::3] *= -1
    ak = dict(ADAHESSIAN_HP, block=block)
    calls += [("adahessian_refresh", su.adahessian_refresh_fused_block,
               su.adahessian_refresh_fused_block_plain,
               (p, m, v, g, e_signed, lr, flag, one,
                torch.tensor(float(st), device="cuda")), ak)
              for flag in flags for st in steps]
    calls += [("adahessian_step", su.adahessian_fused_block,
               su.adahessian_fused_block_plain,
               (p, m, v, g, lr, torch.tensor(float(st), device="cuda")), ak)
              for st in steps]
    m0, g0 = m.clone(), g.clone()
    m0[::7] = 0
    g0[::7] = 0
    for mm, gg in ((m, g), (m0, g0)):
        calls += [
            ("lion_step", su.lion_fused_block, su.lion_fused_block_plain,
             (p, mm, gg, lr), dict(LION_HP, block=block)),
            ("signgd_step", su.signgd_fused_block,
             su.signgd_fused_block_plain, (p, mm, gg, lr),
             dict(SIGNGD_HP, block=block)),
            ("sgd_step", su.sgd_fused_block, su.sgd_fused_block_plain,
             (p, mm, gg, lr), dict(SGD_HP, block=block))]
    errs, clips = {}, []
    for kname, kernel, plain, args, kw in calls:
        got = kernel(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = 0.0
        for a, b in zip(got, want):
            if a.dtype != b.dtype or a.shape != b.shape:
                raise AssertionError(f"engine {kname} {name}: {a.dtype} "
                                     f"{tuple(a.shape)} vs {b.dtype} "
                                     f"{tuple(b.shape)}")
            if not bool(torch.isfinite(a.float()).all()):
                raise AssertionError(f"engine {kname} {name}: non-finite")
            if not torch.equal(_bits(torch, a), _bits(torch, b)):
                diff = (a.float() - b.float()).abs().max().item()
                raise AssertionError(
                    f"engine kernel {kname} ({name}) is not bit-identical "
                    f"to its plain version: max abs err {diff}")
            err = max(err, (a.float() - b.float()).abs().max().item())
        if kname in ("sophia_step", "sophia_refresh"):
            clips.append(int(got[-1].sum()))
        if h_kind == "tail_pad" and any(
                bool((t[3 * n // 4:] != 0).any()) if t.dtype != torch.int32
                else bool(t[-1] != 0) for t in got):
            raise AssertionError(f"engine {kname} {name}: the zero pad is "
                                 "not a fixed point")
        errs[kname] = max(errs.get(kname, 0.0), err)
    fl, st = "/".join(map(str, flags)), "/".join(map(str, steps))
    log(f"[kernels] sophia_update {name} n={n} block={block} "
        f"p={str(pdt)[6:]} state={str(sdt)[6:]} h={h_kind} rho={rho}: rows "
        f"2, 3 (square 0/1), 4 (flag {fl}), 6 (steps {st}), 5 (flag {fl} x "
        f"steps {st}), 7 (steps {st}) and 8-10 (with and without exact-zero "
        f"sign arguments) bit-identical to their plain versions, clip "
        f"counts {clips} equal")
    return errs


def check_sign_nan(torch, sdt):
    """Rows 8-9 with NaN in g (every 11th element) and in m (every 13th
    from the 5th): the sign is ``jnp.sign``'s, NaN at NaN, so p' and m'
    are NaN exactly where the plain versions' are (wherever m or g is),
    and bit-identical to them everywhere else."""
    from repro_torch.kernels import sophia_update as su

    n, block = 3 * 4096, 4096
    p, m, _, g, _ = _engine_operands(torch, n, torch.float32, sdt, seed=5)
    g[::11] = float("nan")
    m[5::13] = float("nan")
    lr = torch.tensor(6e-4, device="cuda")
    for kname, kernel, plain, hp in (
            ("lion_step", su.lion_fused_block, su.lion_fused_block_plain,
             LION_HP),
            ("signgd_step", su.signgd_fused_block,
             su.signgd_fused_block_plain, SIGNGD_HP)):
        got = kernel(p, m, g, lr, block=block, **hp)
        want = plain(p, m, g, lr, block=block, **hp)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            nan = torch.isnan(b.float())
            if not (bool(nan[::11].all()) and bool(nan[5::13].all())
                    and torch.equal(torch.isnan(a.float()), nan)):
                raise AssertionError(f"engine {kname} NaN: the kernel's NaN "
                                     "positions differ from the plain "
                                     "version's")
            if not torch.equal(_bits(torch, a)[~nan], _bits(torch, b)[~nan]):
                raise AssertionError(f"engine {kname} NaN: not bit-identical"
                                     " off the NaN positions")
    log(f"[kernels] sophia_update sign_nan n={n} block={block} "
        f"state={str(sdt)[6:]}: rows 8-9 with NaN in g and m put NaN where "
        f"their plain versions do ({int(nan.sum())} of {n} elements) and "
        "are bit-identical elsewhere")


def param_count(cfg) -> int:
    """Parameters of a dense config (the port's ``init_params`` leaves):
    the engine's one fp32 shard is this rounded up to its block."""
    D, F, hd = cfg.d_model, cfg.d_ff, cfg.hd
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    norm = D * (2 if cfg.norm_type == "ln" else 1)
    attn = 2 * D * H * hd + 2 * D * Hkv * hd
    attn += (H + 2 * Hkv) * hd if cfg.qkv_bias else 0
    mlp = (3 * D * F if cfg.activation in ("swiglu", "geglu")
           else 2 * D * F + F + D)
    layer = attn + mlp + norm * (4 if cfg.post_norms else 2)
    embed = cfg.padded_vocab * D * (1 if cfg.tie_embeddings else 2)
    embed += cfg.max_position_embeddings * D if cfg.learned_pos else 0
    return embed + norm + cfg.n_layers * layer


def shard_size(cfg) -> int:
    from repro_torch.core.engine import BLOCK

    return -(-param_count(cfg) // BLOCK) * BLOCK


# the engine's rows 2-4 on the dense configs' trained shards (phase 4d:
# yi-6b at 8 layers, gemma2-9b at 4), 1.7-1.9 B elements of fp32 state
SLICE = 1 << 27                     # elements of a plain slice, 1024 blocks


def check_engine_shard(torch, name, n):
    """Rows 2 (the Sophia step), 3 (the Hessian EMA, square off and on)
    and 4 (the refresh-fused step, flag 1) launched once each on a whole
    shard of ``n`` elements at a trained model's scales, against their
    plain versions bit for bit.  The plain versions run over block-aligned
    slices of SLICE elements (each output element and each block's clip
    count depends on its own block only), so that the inputs, the
    kernel's outputs and one slice's plain outputs fit the card
    together."""
    from repro_torch.kernels import sophia_update as su

    f32 = torch.float32
    p, m, h, g, e = _engine_operands(torch, n, f32, f32, seed=2)
    lr = torch.tensor(6e-4, device="cuda")
    scale = torch.tensor(2048.0, device="cuda")
    sk = dict(SOPHIA_HP, clip_threshold=1.0, block=SHARD_BLOCK)
    calls = [("sophia_step", su.sophia_fused_block,
              su.sophia_fused_block_plain, (p, m, h, g, lr), sk)]
    calls += [("hessian_ema", su.hessian_ema_block,
               su.hessian_ema_block_plain, (h, e),
               dict(beta2=0.99, scale=scale, square=sq, block=SHARD_BLOCK))
              for sq in (False, True)]
    calls += [("sophia_refresh", su.sophia_refresh_fused_block,
               su.sophia_refresh_fused_block_plain,
               (p, m, h, g, e, lr, 1, scale),
               dict(sk, beta2=0.99))]
    clips = []
    for kname, kernel, plain, args, kw in calls:
        got = kernel(*args, **kw)
        got = got if isinstance(got, tuple) else (got,)
        for a in range(0, n, SLICE):
            b = min(n, a + SLICE)
            part = tuple(t[a:b] if isinstance(t, torch.Tensor)
                         and t.numel() == n else t for t in args)
            want = plain(*part, **kw)
            want = want if isinstance(want, tuple) else (want,)
            for out, ref in zip(got, want):
                lo, hi = ((a, b) if out.numel() == n else
                          (a // SHARD_BLOCK, b // SHARD_BLOCK))
                if not torch.equal(_bits(torch, out[lo:hi]),
                                   _bits(torch, ref)):
                    raise AssertionError(
                        f"engine kernel {kname} on {name}'s shard (n={n}) "
                        f"is not bit-identical to its plain version in "
                        f"elements {a}..{b}")
            del want
        if kname in ("sophia_step", "sophia_refresh"):
            clips.append(int(got[-1].sum()))
        del got
    del p, m, h, g, e
    torch.cuda.empty_cache()
    log(f"[kernels] sophia_update {name}_shard n={n} block={SHARD_BLOCK} "
        f"fp32: rows 2, 3 (square 0/1) and 4 (flag 1) launched on the whole "
        f"shard, bit-identical to their plain versions over slices of "
        f"{SLICE}; clip counts {clips}")


def phase_engine_kernels(torch):
    """Returns {kernel name: max abs error at GPT-2 small's shard with
    fp32 state, the training run's}."""
    f32, bf16 = torch.float32, torch.bfloat16
    out = check_engine_case(torch, "gpt2_small_shard", SHARD_N, SHARD_BLOCK,
                            f32, f32)
    check_engine_case(torch, "gpt2_small_shard_bf16_state", SHARD_N,
                      SHARD_BLOCK, f32, bf16)
    edges = [
        ("block128_x3", dict(n=384, block=128, pdt=f32, sdt=f32)),
        ("one_block", dict(n=128, block=128, pdt=f32, sdt=bf16)),
        ("h_zero_and_negative", dict(n=3 * 4096, block=4096, pdt=f32,
                                     sdt=f32, h_kind="mixed")),
        ("rho_1e9", dict(n=3 * 4096, block=4096, pdt=f32, sdt=f32,
                         rho=1e9)),
        ("bf16_p", dict(n=2 * SHARD_BLOCK, block=SHARD_BLOCK, pdt=bf16,
                        sdt=bf16)),
        ("bf16_p_fp32_state", dict(n=2 * SHARD_BLOCK, block=SHARD_BLOCK,
                                   pdt=bf16, sdt=f32)),
        ("tail_pad_fixed_point", dict(n=4 * 1024, block=1024, pdt=f32,
                                      sdt=bf16, h_kind="tail_pad")),
    ]
    for name, spec in edges:
        check_engine_case(torch, name, spec.pop("n"), spec.pop("block"),
                          spec.pop("pdt"), spec.pop("sdt"), **spec)
    for sdt in (f32, bf16):
        check_sign_nan(torch, sdt)
    for name, cfg, _, layers, _, _ in _dense_runs():
        if layers:
            check_engine_shard(torch, name, shard_size(
                dataclasses.replace(cfg, n_layers=layers)))
    return out


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


def serve_once(torch, cfg, params, kv_dtype, n_requests=16):
    """One measured run of ``n_requests`` mixed requests over 8 slots;
    returns (engine, seconds, launch counts)."""
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
    reqs = _requests(cfg, n=n_requests)
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
# phase 4: train GPT-2 small


TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_K, TRAIN_SUB = 8, 1024, 12, 5, 4


def _train_fns(torch, cfg, tc, device, params=None):
    from repro_torch.train import make_train_fns

    init_fn, step = make_train_fns(cfg, tc, device=device)
    return init_fn(params), step


def phase_train(torch):
    """Returns the report: launch counts, step times, memory, profile."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_source
    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
    from repro_torch.launch.profile_serve import profile_window
    from repro_torch.train import TrainerConfig
    from repro_torch.train.trainer import to_device_batch

    cfg = get_config("gpt2-small")
    tc = TrainerConfig(peak_lr=6e-4, total_steps=TRAIN_STEPS, warmup_steps=2,
                       hess_interval=TRAIN_K, hess_subbatch=TRAIN_SUB, seed=0,
                       fused_kernel=True)
    state, train_step = _train_fns(torch, cfg, tc, "cuda")
    src = make_source(DataConfig(seq_len=TRAIN_S, global_batch=TRAIN_B,
                                 vocab_size=cfg.vocab_size, seed=0))
    batches = [to_device_batch(src.batch_at(t), "cuda")
               for t in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, losses = [], []
    for t in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = train_step(state, batches[t], t % TRAIN_K == 0)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(KERNEL_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_ref = len(range(0, TRAIN_STEPS, TRAIN_K))
    attn = cfg.n_layers * (TRAIN_STEPS + n_ref)
    # the engine kernels: the refresh-fused step on each refresh step, the
    # plain step on the others, never the out-of-band EMA
    want = {"ce_forward": TRAIN_STEPS, "ce_forward_sampled": n_ref,
            "ce_backward_dh": TRAIN_STEPS + n_ref,
            "ce_backward_dw": TRAIN_STEPS + n_ref,
            "attn_fwd": attn, "attn_bwd_dq": attn, "attn_bwd_dkv": attn,
            "sophia_step": TRAIN_STEPS - n_ref, "sophia_refresh": n_ref}
    if launches != want:
        raise AssertionError(f"training launches {launches} != {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if int(state.opt_state.hess_count) != n_ref:
        raise AssertionError(f"hess_count {int(state.opt_state.hess_count)}"
                             f" != {n_ref}")
    # step 0 (a refresh) carries the first-call costs: the refresh p50
    # reads the refresh steps after it
    plain = [dt for t, dt in enumerate(times) if t % TRAIN_K]
    refresh = [dt for t, dt in enumerate(times) if t and t % TRAIN_K == 0]
    tokens = TRAIN_B * TRAIN_S
    p50 = statistics.median(plain)
    report = dict(launches=launches, losses=losses,
                  plain_p50_ms=p50 * 1e3,
                  refresh_p50_ms=statistics.median(refresh) * 1e3,
                  step0_ms=times[0] * 1e3,
                  tokens_per_s=tokens * TRAIN_STEPS / sum(times),
                  tokens_per_s_plain_p50=tokens / p50,
                  peak_mem_gib=peak / 2 ** 30, step_ms=[x * 1e3 for x in times])
    log(f"[train] gpt2-small bf16 B={TRAIN_B} S={TRAIN_S} Sophia-G "
        f"fused_kernel=True k="
        f"{TRAIN_K} sub={TRAIN_SUB}: {TRAIN_STEPS} steps, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; hess_count "
        f"{int(state.opt_state.hess_count)}; step p50 plain "
        f"{report['plain_p50_ms']:.1f} ms, refresh (steps "
        f"{TRAIN_K}, {2 * TRAIN_K}) {report['refresh_p50_ms']:.1f} ms; "
        f"{report['tokens_per_s']:.0f} "
        f"tok/s over the run ({report['tokens_per_s_plain_p50']:.0f} at the "
        f"plain p50); peak memory {report['peak_mem_gib']:.2f} GiB "
        f"({resident / 2 ** 30:.2f} GiB resident at the start); "
        f"launches {launches}")
    log(f"[train] step ms: {[round(x, 1) for x in report['step_ms']]}")
    log(f"[train] Sophia-G step 0 (a refresh with the first-call costs): "
        f"{report['step0_ms']:.1f} ms")

    windows = []
    for label, flag in (("plain step", False), ("refresh step", True)):
        holder = {}

        def one_step():
            holder["out"] = train_step(state, batches[1], flag)

        win = profile_window(f"train {label} (gpt2-small B={TRAIN_B} "
                             f"S={TRAIN_S} bf16)", one_step, match="::ce_",
                             also=("flash_attn::", "sophia_update::"))
        state = holder["out"][0]
        busy = win["device_busy_us"]
        win["matched_share"] = win["matched_us"] / busy if busy else None
        win["attn_us"] = win["also_us"]["flash_attn::"]
        win["attn_share"] = win["attn_us"] / busy if busy else None
        win["engine_us"] = win["also_us"]["sophia_update::"]
        win["engine_share"] = win["engine_us"] / busy if busy else None
        if not win["engine_us"] > 0:
            raise AssertionError(f"profile of the {label}: no sophia_update "
                                 "kernel on the device")
        windows.append(win)
        log("[profile] " + json.dumps(win))
    report["profile"] = windows
    report["hessian_ema_launches"] = out_of_band_refresh(torch, tc, state)
    del state
    report["adamw"] = train_adamw(torch, cfg, batches)
    report["baselines"] = {name: train_baseline(torch, cfg, batches, name,
                                                over, steps)
                           for name, over, steps in BASELINE_RUNS}
    report["cpu_check_max_rel"] = {
        name: check_train_against_cpu(torch, cfg, name, over, steps=steps)
        for name, over, steps in (
            ("flash+fused_kernel", dict(fused_kernel=True), 3),
            ("materialized+reference", dict(fused_attn=False), 3),
            ("adamw+fused_kernel", dict(optimizer="adamw",
                                        fused_kernel=True), 3),
            ("sophia_h+hutchinson", dict(optimizer="sophia_h",
                                         estimator="hutchinson",
                                         fused_kernel=True), 3),
            ("adahessian+hutchinson", dict(optimizer="adahessian",
                                           estimator="hutchinson",
                                           fused_kernel=True), 2),
            ("lion+fused_kernel", dict(optimizer="lion",
                                       fused_kernel=True), 3),
            ("sophia_g+empirical_fisher", dict(estimator="empirical_fisher",
                                               fused_kernel=True), 1))}
    return report


def out_of_band_refresh(torch, tc, state):
    """The engine's out-of-band refresh (``update_hessian``, what tests and
    tooling call) on the trained state at GPT-2 small's shard: counts
    zeroed before, read after; one ``hessian_ema`` launch per shard and
    hess_count one up.  Returns the launch count."""
    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
    from repro_torch.train import make_engine

    engine = make_engine(tc)
    tree = state.params.param_tree()
    gen = torch.Generator(device="cuda").manual_seed(11)
    est = tuple((torch.randn(h.shape, generator=gen, device="cuda")
                 * 1e-3).square() for h in state.opt_state.h)
    scale = torch.tensor(float(TRAIN_SUB * TRAIN_S), device="cuda")
    torch.cuda.synchronize()
    reset_launch_counts()
    new = engine.update_hessian(state.opt_state, est, scale=scale,
                                params=tree)
    torch.cuda.synchronize()
    launches = dict(KERNEL_LAUNCHES)
    want = {"hessian_ema": len(est)}
    if launches != want:
        raise AssertionError(f"update_hessian launches {launches} != {want}")
    if (int(new.hess_count) != int(state.opt_state.hess_count) + 1
            or not all(bool(torch.isfinite(h.float()).all())
                       for h in new.h)):
        raise AssertionError("update_hessian: hess_count or h is wrong")
    log(f"[train] out-of-band update_hessian on the trained state "
        f"({[h.numel() for h in new.h]} elements): launches {launches}")
    return launches["hessian_ema"]


ADAMW_STEPS = 4


def train_adamw(torch, cfg, batches):
    """AdamW on the engine kernels at the same shape, 4 steps: one
    ``adamw_step`` per step, the CE forward, dh and dW and the attention
    kernels per step, no sampled CE (no refresh); finite losses."""
    import numpy as np

    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
    from repro_torch.train import TrainerConfig

    tc = TrainerConfig(optimizer="adamw", fused_kernel=True, peak_lr=6e-4,
                       total_steps=ADAMW_STEPS, warmup_steps=2, seed=0)
    state, train_step = _train_fns(torch, cfg, tc, "cuda")
    torch.cuda.synchronize()
    reset_launch_counts()
    times, losses = [], []
    for t in range(ADAMW_STEPS):
        t0 = time.perf_counter()
        state, metrics = train_step(state, batches[t], False)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(KERNEL_LAUNCHES)
    attn = cfg.n_layers * ADAMW_STEPS
    want = {"ce_forward": ADAMW_STEPS, "ce_backward_dh": ADAMW_STEPS,
            "ce_backward_dw": ADAMW_STEPS, "attn_fwd": attn,
            "attn_bwd_dq": attn, "attn_bwd_dkv": attn,
            "adamw_step": ADAMW_STEPS}
    if launches != want:
        raise AssertionError(f"AdamW launches {launches} != {want}")
    if not all(np.isfinite(losses)) or int(state.opt_state.hess_count):
        raise AssertionError(f"AdamW: losses {losses}, hess_count "
                             f"{int(state.opt_state.hess_count)}")
    report = dict(launches=launches, losses=losses,
                  step_p50_ms=statistics.median(times) * 1e3,
                  step_ms=[x * 1e3 for x in times])
    log(f"[train] gpt2-small bf16 B={TRAIN_B} S={TRAIN_S} AdamW "
        f"fused_kernel=True: {ADAMW_STEPS} steps, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; step p50 {report['step_p50_ms']:.1f} ms, step "
        f"ms {[round(x * 1e3, 1) for x in times]}; launches {launches}")
    return report


# the paper's other optimizers at the same shape on the engine kernels:
# (name, trainer options, steps); the hessian-aware ones refresh every
# TRAIN_K steps on TRAIN_SUB rows with the Hutchinson estimator
BASELINE_RUNS = (
    ("sophia_h", dict(optimizer="sophia_h", estimator="hutchinson"),
     TRAIN_STEPS),
    ("adahessian", dict(optimizer="adahessian", estimator="hutchinson"), 6),
    ("lion", dict(optimizer="lion"), 4),
    ("signgd", dict(optimizer="signgd"), 4),
    ("sgd", dict(optimizer="sgd"), 4),
)
_ENGINE_COUNTS = {"sophia_h": ("sophia_step", "sophia_refresh"),
                  "adahessian": ("adahessian_step", "adahessian_refresh"),
                  "lion": ("lion_step", None), "signgd": ("signgd_step", None),
                  "sgd": ("sgd_step", None)}


def train_baseline(torch, cfg, batches, name, over, steps):
    """``steps`` steps of one of the paper's other optimizers at B=8 x
    S=1024 with ``fused_kernel=True``, counts zeroed before and read
    after.  Each step launches the CE forward, dh and dW once and each
    attention kernel once per layer; a Hutchinson refresh adds one CE
    forward and one attention forward per layer (the twins' primals) and
    NO backward kernel (the HVP, forward-over-reverse, runs the twins'
    backward and tangent rules, plain PyTorch); the engine
    launches the refresh-fused kernel on each refresh step and the plain
    step kernel on the others.  Logs the losses, the plain and refresh
    step p50, the peak memory and the launches; for Sophia-H also a
    profile window of one refresh step."""
    import numpy as np

    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
    from repro_torch.launch.profile_serve import profile_window
    from repro_torch.train import TrainerConfig

    tc = TrainerConfig(peak_lr=6e-4, total_steps=steps, warmup_steps=2,
                       hess_interval=TRAIN_K, hess_subbatch=TRAIN_SUB,
                       seed=0, fused_kernel=True, **over)
    state, train_step = _train_fns(torch, cfg, tc, "cuda")
    aware = name in ("sophia_h", "adahessian")
    refresh_at = [t for t in range(steps) if aware and t % TRAIN_K == 0]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, losses, per_step = [], [], []
    for t in range(steps):
        before = dict(KERNEL_LAUNCHES)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batches[t], t in refresh_at)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_step.append({k: v - before.get(k, 0)
                         for k, v in KERNEL_LAUNCHES.items()
                         if v - before.get(k, 0)})
    launches = dict(KERNEL_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_ref = len(refresh_at)
    L = cfg.n_layers
    plain_k, refresh_k = _ENGINE_COUNTS[name]
    want = {"ce_forward": steps + n_ref, "ce_backward_dh": steps,
            "ce_backward_dw": steps, "attn_fwd": L * (steps + n_ref),
            "attn_bwd_dq": L * steps, "attn_bwd_dkv": L * steps,
            plain_k: steps - n_ref}
    if n_ref:
        want[refresh_k] = n_ref
    if launches != want:
        raise AssertionError(f"{name} launches {launches} != {want}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: non-finite loss: {losses}")
    if int(state.opt_state.hess_count) != n_ref:
        raise AssertionError(f"{name}: hess_count "
                             f"{int(state.opt_state.hess_count)} != {n_ref}")
    # step 0 carries the first-call costs: the refresh p50 reads the
    # refresh steps after it, and step 0 is logged on its own
    plain = [dt for t, dt in enumerate(times) if t not in refresh_at]
    refresh = [dt for t, dt in enumerate(times) if t in refresh_at and t]
    report = dict(launches=launches, losses=losses,
                  plain_p50_ms=statistics.median(plain) * 1e3,
                  refresh_p50_ms=(statistics.median(refresh) * 1e3
                                  if refresh else None),
                  step0_ms=times[0] * 1e3,
                  peak_mem_gib=peak / 2 ** 30,
                  step_ms=[x * 1e3 for x in times],
                  refresh_step_launches=(per_step[refresh_at[0]]
                                         if refresh else None))
    log(f"[train] gpt2-small bf16 B={TRAIN_B} S={TRAIN_S} {name} "
        f"({', '.join(f'{k}={v}' for k, v in over.items())}) "
        f"fused_kernel=True: {steps} steps, losses "
        f"{[round(x, 4) for x in losses]}; hess_count {n_ref}; step p50 "
        f"plain {report['plain_p50_ms']:.1f} ms"
        + (f", refresh (steps {refresh_at[1:]}) "
           f"{report['refresh_p50_ms']:.1f} ms" if refresh else "")
        + f"; peak memory {report['peak_mem_gib']:.2f} GiB "
        f"({resident / 2 ** 30:.2f} GiB resident at the start); launches "
        f"{launches}; step ms {[round(x * 1e3, 1) for x in times]}")
    log(f"[train] {name} step 0 ({'a refresh ' if refresh_at else ''}with "
        f"the first-call costs): {report['step0_ms']:.1f} ms")
    if refresh:
        log(f"[train] {name} refresh step launches {per_step[refresh_at[0]]}"
            f" (a plain step: {per_step[1]}): the HVP adds a CE and an "
            "attention forward per layer and no backward kernel")
    if name == "sophia_h":
        holder = {}

        def one_step():
            holder["out"] = train_step(state, batches[1], True)

        win = profile_window(f"train sophia_h refresh step (gpt2-small "
                             f"B={TRAIN_B} S={TRAIN_S} bf16)", one_step,
                             match="::ce_",
                             also=("flash_attn::", "sophia_update::"))
        busy = win["device_busy_us"]
        win["matched_share"] = win["matched_us"] / busy if busy else None
        log("[profile] " + json.dumps(win))
        report["profile"] = win
        del holder
    del state
    torch.cuda.empty_cache()
    return report


def _cpu_probe(torch, seed, device):
    """Hutchinson's probe drawn on the CPU and moved to ``device``: the
    card and the CPU run then see the same u."""
    from repro_torch.train import hess_probe

    def probe(step, layout):
        return tuple(u.to(device)
                     for u in hess_probe(seed, step, layout, "cpu"))
    return probe


def check_train_against_cpu(torch, cfg, name, over, steps=3):
    """``steps`` fp32 steps at B=2 x S=128 (refresh every 2 on 1 row) on
    the card (the kernels) and on the CPU (their plain versions), same
    weights, batches and Hutchinson probes, with the trainer options
    ``over`` (the attention route, the engine backend, the optimizer, the
    estimator): the losses must agree within 1e-4 relative, and the card
    run must launch the attention kernels exactly when ``fused_attn`` is
    set and an engine kernel exactly when ``fused_kernel`` is.  When only
    the first step refreshed, the refreshed h (v) is held against the
    CPU's too, within 1e-4 of its largest element.  AdaHessian runs 2
    steps: its third step's loss rides on updates lr m / |u . Hu| whose
    small denominators the card and the CPU round apart (ROADMAP C)."""
    import copy

    from repro_torch.data import DataConfig, make_source
    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
    from repro_torch.train import TrainerConfig, train_loop

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    tc = TrainerConfig(peak_lr=6e-4, total_steps=3, warmup_steps=1,
                       hess_interval=2, hess_subbatch=1, seed=0, **over)
    state, _ = _train_fns(torch, cfg32, tc, "cuda")
    cpu_params = copy.deepcopy(state.params).cpu()
    src = make_source(DataConfig(seq_len=128, global_batch=2,
                                 vocab_size=cfg.vocab_size, seed=1))
    reset_launch_counts()
    s_card, h_card = train_loop(cfg32, tc, src, num_steps=steps,
                                state=state, device="cuda",
                                probe_fn=_cpu_probe(torch, tc.seed, "cuda"))
    attn = KERNEL_LAUNCHES["attn_fwd"]
    engine = sum(KERNEL_LAUNCHES[k] for k in SOPHIA_UPDATE[1])
    if (attn > 0) != tc.fused_attn or (engine > 0) != tc.fused_kernel:
        raise AssertionError(f"{name}: {attn} attention and {engine} engine "
                             "kernel launches in the card run")
    cpu_state, _ = _train_fns(torch, cfg32, tc, "cpu", cpu_params)
    s_cpu, h_cpu = train_loop(cfg32, tc, src, num_steps=steps,
                              state=cpu_state, device="cpu",
                              probe_fn=_cpu_probe(torch, tc.seed, "cpu"))
    card = [h["loss"] for h in h_card]
    cpu = [h["loss"] for h in h_cpu]
    rel = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    h_rel = None
    if (steps <= tc.hess_interval and s_cpu.opt_state.h
            and int(s_cpu.opt_state.hess_count)):
        h_rel = max(float((a.cpu().float() - b.float()).abs().max()
                          / b.float().abs().max())
                    for a, b in zip(s_card.opt_state.h, s_cpu.opt_state.h))
        if not h_rel <= 1e-4:
            raise AssertionError(f"card vs CPU refreshed h differs by "
                                 f"{h_rel} of its largest element ({name})")
    log(f"[train] card vs CPU plain path, {name}, fp32 B=2 S=128, {steps} "
        f"step(s) (refresh at 0, 2 for the hessian-aware): losses {card} vs "
        f"{cpu}, max relative diff {rel:.3g}"
        + ("" if h_rel is None else
           f"; refreshed h within {h_rel:.3g} of its largest element"))
    if not rel <= 1e-4:
        raise AssertionError(f"card vs CPU training losses differ by {rel} "
                             f"({name})")
    return rel


# ---------------------------------------------------------------------------
# phase 4b: the trainer's other routes and the per-leaf optimizer API


ROUTE_STEPS, PERLEAF_STEPS = 3, 5


def _run_steps(torch, train_step, state, batches, refresh_at):
    """Steps on ``batches`` from a zeroed peak and zeroed counts: (state,
    losses, step seconds, launches per step, peak bytes, bytes resident at
    the start)."""
    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times, per_step = [], [], []
    for t, batch in enumerate(batches):
        before = dict(KERNEL_LAUNCHES)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, t in refresh_at)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_step.append({k: v - before.get(k, 0)
                         for k, v in KERNEL_LAUNCHES.items()
                         if v - before.get(k, 0)})
    return (state, losses, times, per_step,
            torch.cuda.max_memory_allocated(), resident)


def _step0_grads(torch, cfg, params, batch, **kw):
    """(loss, gradients) of the trainer's loss at the initial weights."""
    from repro_torch.core.types import flat_tensors
    from repro_torch.models import get_model

    loss, _ = get_model(cfg).loss_fn(cfg, params, batch, **kw)
    return loss.detach(), torch.autograd.grad(
        loss, flat_tensors(params.param_tree()))


def phase_routes(torch):
    """GPT-2 small at B=8 x S=1024, bf16, Sophia-G with GNB on the engine
    kernels, on the trainer's routes that are not the default: the remat
    policies, ``fused_loss=False`` and ``attn_impl="chunked"``; then the
    per-leaf optimizer API against the engine.  Counts are zeroed before
    each run and read after each step."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, make_source
    from repro_torch.launch.profile_serve import profile_window
    from repro_torch.train import TrainerConfig
    from repro_torch.train.trainer import to_device_batch

    cfg = get_config("gpt2-small")
    src = make_source(DataConfig(seq_len=TRAIN_S, global_batch=TRAIN_B,
                                 vocab_size=cfg.vocab_size, seed=0))
    batches = [to_device_batch(src.batch_at(t), "cuda")
               for t in range(PERLEAF_STEPS)]
    base = dict(peak_lr=6e-4, total_steps=TRAIN_STEPS, warmup_steps=2,
                hess_interval=TRAIN_K, hess_subbatch=TRAIN_SUB, seed=0,
                fused_kernel=True)
    L = cfg.n_layers
    report = {}

    def run(label, over, steps, want_plain, want_step0=None,
            profile=False):
        tc = TrainerConfig(**dict(base, **over))
        state, train_step = _train_fns(torch, cfg, tc, "cuda")
        state, losses, times, per_step, peak, resident = _run_steps(
            torch, train_step, state, batches[:steps], (0,))
        if not all(np.isfinite(losses)) or int(state.opt_state.hess_count) \
                != 1:
            raise AssertionError(f"{label}: losses {losses}, hess_count "
                                 f"{int(state.opt_state.hess_count)}")
        for t in range(1, steps):
            if per_step[t] != want_plain:
                raise AssertionError(f"{label}: step {t} launches "
                                     f"{per_step[t]} != {want_plain}")
        if want_step0 is not None and per_step[0] != want_step0:
            raise AssertionError(f"{label}: step 0 launches {per_step[0]} "
                                 f"!= {want_step0}")
        out = dict(losses=losses, step_ms=[x * 1e3 for x in times],
                   plain_p50_ms=statistics.median(times[1:]) * 1e3,
                   refresh_step0_ms=times[0] * 1e3,
                   peak_mem_gib=peak / 2 ** 30,
                   resident_gib=resident / 2 ** 30, launches=per_step)
        log(f"[routes] {label}: {steps} steps (a refresh at step 0), "
            f"losses {[round(x, 4) for x in losses]}; plain step p50 "
            f"{out['plain_p50_ms']:.1f} ms, step 0 (the refresh) "
            f"{out['refresh_step0_ms']:.1f} ms; peak memory "
            f"{out['peak_mem_gib']:.2f} GiB ({out['resident_gib']:.2f} GiB "
            f"resident at the start: parameters, optimizer state and what "
            f"earlier phases hold); launches step 0 {per_step[0]}, a plain "
            f"step {per_step[1]}")
        if profile:
            holder = {}

            def one_step():
                holder["out"] = train_step(state, batches[1], False)

            win = profile_window(f"train plain step, {label}", one_step,
                                 match="flash_attn::",
                                 also=("::ce_", "sophia_update::"))
            del holder
            out["profile"] = win
            log("[profile] " + json.dumps(win))
        del state
        return out

    # 1. remat: the flash forward runs again for each recomputed layer
    scan_g = next(d for d in (8, 5, 4, 2) if L % d == 0)
    fwd = {"none": L, "full": 2 * L, "dots": 2 * L,
           "scan2": 2 * L + L - L // scan_g}   # scan2: the outer recompute
    #                                            stops before a group's last
    #                                            layer (its input is saved)
    tc0 = TrainerConfig(**base)
    state0, _ = _train_fns(torch, cfg, tc0, "cuda")
    loss0, g0 = _step0_grads(torch, cfg, state0.params, batches[0],
                             attn_impl="flash", loss_impl="fused")
    agree = {}
    for remat in ("none", "full", "dots", "scan2"):
        loss_r, g_r = _step0_grads(torch, cfg, state0.params, batches[0],
                                   attn_impl="flash", loss_impl="fused",
                                   remat=remat)
        same = bool(torch.equal(loss_r, loss0)) and all(
            torch.equal(a, b) for a, b in zip(g_r, g0))
        worst = max(float((a - b).abs().max() / b.abs().max().clamp_min(
            1e-30)) for a, b in zip(g_r, g0))
        del g_r
        agree[remat] = dict(step0_bit_identical=same,
                            step0_grad_max_rel=worst)
        log(f"[routes] remat={remat}: step 0 loss and every gradient "
            f"bit-identical to remat=none: {same} (largest gradient "
            f"difference {worst:.3g} of its leaf's largest element)")
        if not worst <= 1e-6:
            raise AssertionError(f"remat={remat}: a gradient differs from "
                                 f"remat=none by {worst} of its largest")
    del g0, state0
    report["remat"] = {}
    for remat in ("none", "full", "dots", "scan2"):
        want = {"ce_forward": 1, "ce_backward_dh": 1, "ce_backward_dw": 1,
                "attn_fwd": fwd[remat], "attn_bwd_dq": L, "attn_bwd_dkv": L,
                "sophia_step": 1}
        out = run(f"remat={remat}", dict(remat=remat), ROUTE_STEPS, want,
                  profile=remat in ("none", "full", "dots"))
        out.update(agree[remat])
        log(f"[routes] remat={remat}: flash forward launches per plain step "
            f"{fwd[remat]}")
        report["remat"][remat] = out
    # the Hutchinson HVP runs its trunk without remat (torch.func and
    # torch.utils.checkpoint do not compose): its peak under remat="full"
    report["hutchinson_remat_full"] = run(
        "sophia_h+hutchinson remat=full",
        dict(optimizer="sophia_h", estimator="hutchinson", remat="full"), 2,
        {"ce_forward": 1, "ce_backward_dh": 1, "ce_backward_dw": 1,
         "attn_fwd": 2 * L, "attn_bwd_dq": L, "attn_bwd_dkv": L,
         "sophia_step": 1},
        {"ce_forward": 2, "ce_backward_dh": 1, "ce_backward_dw": 1,
         "attn_fwd": 3 * L, "attn_bwd_dq": L, "attn_bwd_dkv": L,
         "sophia_refresh": 1})

    # 2. fused_loss=False: the chunked loss and the GNB refresh from the
    # sub-batch's materialized logits; no CE kernel
    out = run("fused_loss=False", dict(fused_loss=False), ROUTE_STEPS,
              {"attn_fwd": L, "attn_bwd_dq": L, "attn_bwd_dkv": L,
               "sophia_step": 1},
              {"attn_fwd": 2 * L, "attn_bwd_dq": 2 * L,
               "attn_bwd_dkv": 2 * L, "sophia_refresh": 1})
    fused_loss0 = report["remat"]["none"]["losses"][0]
    out["step0_rel_to_fused"] = abs(out["losses"][0] - fused_loss0) \
        / abs(fused_loss0)
    log(f"[routes] fused_loss=False step 0 loss {out['losses'][0]!r} vs the "
        f"fused CE's {fused_loss0!r}: relative {out['step0_rel_to_fused']:.3g}"
        f" (bound 1e-4)")
    if not out["step0_rel_to_fused"] <= 1e-4:
        raise AssertionError("fused_loss=False: step 0 loss off the fused "
                             "route's")
    report["unfused_loss"] = out

    # 3. chunked attention: one KV block at S=1024; no attention kernel
    out = run("attn_impl=chunked", dict(attn_impl="chunked"), 2,
              {"ce_forward": 1, "ce_backward_dh": 1, "ce_backward_dw": 1,
               "sophia_step": 1},
              {"ce_forward": 1, "ce_forward_sampled": 1,
               "ce_backward_dh": 2, "ce_backward_dw": 2,
               "sophia_refresh": 1})
    out["step0_rel_to_flash"] = abs(out["losses"][0] - fused_loss0) \
        / abs(fused_loss0)
    log(f"[routes] attn_impl=chunked step 0 loss {out['losses'][0]!r} vs the "
        f"flash route's {fused_loss0!r}: relative "
        f"{out['step0_rel_to_flash']:.3g} (bound 1e-3: the chunked route "
        f"rounds the softmax weights to bf16 before p.v, flash keeps them "
        f"in fp32)")
    if not out["step0_rel_to_flash"] <= 1e-3:
        raise AssertionError("attn_impl=chunked: step 0 loss off the flash "
                             "route's")
    report["chunked_attn"] = out
    report["per_leaf"] = per_leaf_against_engine(torch, cfg, batches, base)
    return report


def per_leaf_against_engine(torch, cfg, batches, base):
    """``chain(clip_by_global_norm(1.0), sophia_g(lr))`` on GPT-2 small's
    parameter tree on the card, 5 steps, against the engine on its
    ``reference`` and ``fused`` backends: all three are fed the same five
    gradient trees (taken at the initial weights on five batches) and,
    before step 0, the same ``gnb_estimator`` estimate (B · ĝ², the
    sub-batch's logits materialized).  Logs the largest parameter
    difference after 5 steps, the clip fractions and the step p50s."""
    from repro_torch.core import (apply_updates, chain, clip_by_global_norm,
                                  gnb_estimator, ravel_shards, sophia_g,
                                  tree_map)
    from repro_torch.core.types import flat_tensors, tree_unflatten
    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
    from repro_torch.models import get_model
    from repro_torch.train import TrainerConfig, hess_generator, make_engine
    from repro_torch.train.trainer import make_schedule

    tc = TrainerConfig(**base)
    model = get_model(cfg)
    state, _ = _train_fns(torch, cfg, tc, "cuda")
    params = state.params
    tree = params.param_tree()
    tensors = flat_tensors(tree)
    grads = []
    for batch in batches[:PERLEAF_STEPS]:
        loss, _ = model.loss_fn(cfg, params, batch, attn_impl="flash")
        grads.append(tree_unflatten(tree, torch.autograd.grad(loss,
                                                              tensors)))
    sub = {k: v[:TRAIN_SUB] for k, v in batches[0].items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    est = gnb_estimator(
        lambda _: model.logits_fn(cfg, params, sub, attn_impl="flash"),
        tree, hess_generator(tc.seed, 0, "cuda"))
    torch.cuda.synchronize()
    est_ms = (time.perf_counter() - t0) * 1e3
    est_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    schedule = make_schedule(tc)
    start = tree_map(lambda t: t.detach().clone(), tree)
    del state, params, tree, tensors

    # the per-leaf chain
    opt = chain(clip_by_global_norm(tc.grad_clip),
                sophia_g(schedule, beta1=tc.beta1, beta2=tc.beta2,
                         gamma=tc.gamma, eps=tc.eps,
                         weight_decay=tc.weight_decay,
                         clip_threshold=tc.clip_threshold))
    p_leaf = tree_map(lambda t: t.clone(), start)
    s_leaf = opt.init(p_leaf)
    s_leaf = opt.update_hessian(est, s_leaf)
    leaf_ms, leaf_clip = [], []
    for g in grads:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        updates, s_leaf = opt.update(g, s_leaf, p_leaf)
        p_leaf = apply_updates(p_leaf, updates)
        torch.cuda.synchronize()
        leaf_ms.append((time.perf_counter() - t0) * 1e3)
        leaf_clip.append(float(s_leaf[1].clip_fraction))
    del updates

    # the engine on each backend, the trainer's clip in front
    runs = {}
    for backend, fused in (("reference", False), ("fused", True)):
        engine = make_engine(dataclasses.replace(tc, fused_kernel=fused))
        clipper = clip_by_global_norm(tc.grad_clip)
        p_eng = tree_map(lambda t: t.clone(), start)
        lay = engine.layout(p_eng)
        e_state = engine.init(p_eng)
        c_state = clipper.init(p_eng)
        torch.cuda.synchronize()
        reset_launch_counts()
        e_state = engine.update_hessian(
            e_state, ravel_shards(lay, est, dtype=torch.float32), scale=1.0,
            params=p_eng)
        ms, clip = [], []
        for g in grads:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g_c, c_state = clipper.update(g, c_state)
            _, e_state = engine.step_shards(
                e_state, p_eng, engine.ravel_grads(p_eng, g_c),
                schedule(e_state.count))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            clip.append(float(e_state.clip_fraction))
        launches = dict(KERNEL_LAUNCHES)
        want = ({"hessian_ema": 1, "sophia_step": PERLEAF_STEPS} if fused
                else {})
        if launches != want:
            raise AssertionError(f"engine ({backend}) launches {launches} "
                                 f"!= {want}")
        diff = max(float((a - b).abs().max()) for a, b in
                   zip(flat_tensors(p_leaf), flat_tensors(p_eng)))
        runs[backend] = dict(max_abs_param_diff=diff, clip_fraction=clip,
                             step_p50_ms=statistics.median(ms),
                             step_ms=ms, launches=launches, params=p_eng)
    ref_vs_fused = max(float((a - b).abs().max()) for a, b in zip(
        flat_tensors(runs["reference"].pop("params")),
        flat_tensors(runs["fused"].pop("params"))))
    out = dict(per_leaf_step_p50_ms=statistics.median(leaf_ms),
               per_leaf_step_ms=leaf_ms, per_leaf_clip_fraction=leaf_clip,
               engines=runs, engine_reference_vs_fused=ref_vs_fused,
               estimate_ms=est_ms, estimate_peak_gib=est_peak)
    log(f"[per-leaf] chain(clip_by_global_norm(1.0), sophia_g) on GPT-2 "
        f"small's tree, {PERLEAF_STEPS} steps after one gnb_estimator "
        f"estimate (sub-batch {TRAIN_SUB}x{TRAIN_S}, logits materialized: "
        f"{est_ms:.1f} ms, peak {est_peak:.2f} GiB): per-leaf step p50 "
        f"{out['per_leaf_step_p50_ms']:.2f} ms, clip fraction "
        f"{[round(x, 6) for x in leaf_clip]}")
    for backend, r in runs.items():
        log(f"[per-leaf] engine ({backend} backend): step p50 "
            f"{r['step_p50_ms']:.2f} ms (clip, ravel and the update), clip "
            f"fraction {[round(x, 6) for x in r['clip_fraction']]}, launches "
            f"{r['launches']}; max |per-leaf - engine| over the parameters "
            f"after {PERLEAF_STEPS} steps {r['max_abs_param_diff']:.3g}")
    log(f"[per-leaf] engine reference vs fused backend after "
        f"{PERLEAF_STEPS} steps: max |diff| {ref_vs_fused:.3g}")
    if not all(r["max_abs_param_diff"] <= 1e-5 for r in runs.values()):
        raise AssertionError("per-leaf Sophia-G drifted from the engine")
    # the per-leaf form sums its leaves' clip counts in fp32, as the
    # reference's does, inexact beyond 2^24; the engine sums int32 counts
    if any(abs(a - b) > 1e-5 for r in runs.values()
           for a, b in zip(r["clip_fraction"], leaf_clip)):
        raise AssertionError("per-leaf and engine clip fractions differ")
    return out


# ---------------------------------------------------------------------------
# phase 4c: the rope models (GPT-NeoX 1.5B / 6.6B, stablelm-1.6b)


MODEL_S, MODEL_STEPS, MODEL_K = 2048, 7, 3
# Sophia-G's first steps, with a Hessian EMA one refresh old, clip nearly
# every coordinate to a sign step of lr; on 1.5-2 B parameters that step
# overshoots at GPT-2's 6e-4 and, for NeoX, at 1e-4 (the loss rose by 1-7
# nats within 6 steps on the H100), while 1e-5 lowers it steadily
MODEL_LR = 1e-5
# NeoX-6.6B at full depth holds ~110 GB of fp32 weight, gradient, m and h
# (16 bytes a parameter): one 80 GB card trains it at 8 of its 32 layers
# (~2.0 B parameters, ~32 GB of state, B = 2 x S = 2048) and serves it at
# full depth (27.4 GB of fp32 weights)
NEOX66_TRAIN_LAYERS = 8
CPU_CHECK_LAYERS, CPU_CHECK_S = 2, 64


def _model_runs():
    """(name, config, layers trained, batch rows) of each rope model."""
    from repro_torch.configs import get_config
    from repro_torch.configs.gpt2 import NEOX_1_5B, NEOX_6_6B

    return (("neox-1.5b", NEOX_1_5B, NEOX_1_5B.n_layers, 4),
            ("stablelm-1.6b", get_config("stablelm-1.6b"), 24, 4),
            ("neox-6.6b", NEOX_6_6B, NEOX66_TRAIN_LAYERS, 2))


def host_memory() -> str:
    """The host's available and total memory (/proc/meminfo) and this
    process's peak resident set."""
    import resource

    info = {}
    with open("/proc/meminfo") as f:
        for ln in f:
            key, val = ln.split(":", 1)
            info[key] = int(val.split()[0]) / 2 ** 20        # kB -> GiB
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20
    return (f"host {info['MemAvailable']:.1f} of {info['MemTotal']:.1f} GiB "
            f"available, peak resident {peak:.1f} GiB")


def model_step0_against_cpu(torch, name, cfg, layers=CPU_CHECK_LAYERS):
    """The step-0 loss and gradients at full width and ``layers`` layers,
    fp32, B=1 x S=64: the card (the flash kernels, the fused CE's fp32
    kernels, whose backward runs in D-slabs at these widths) against the
    CPU's plain path on the same weights.  The loss within 1e-5 relative
    and every leaf's gradient within 1e-4 of its largest element (fp32
    sums in other orders on each side).  The card's gradients stay on the
    card and cross to the host one leaf at a time, so the host holds one
    copy of the weights and of the gradients.  Returns (the card params,
    max relative gradient error)."""
    import numpy as np

    from repro_torch.core.types import flat_tensors
    from repro_torch.models import get_model

    cfg2 = dataclasses.replace(cfg, n_layers=layers, dtype="float32")
    model = get_model(cfg2)
    params = model.init_params(
        cfg2, torch.Generator(device="cuda").manual_seed(1))
    cpu_params = copy.deepcopy(params).cpu()
    rng = np.random.default_rng(4)
    batch = {k: rng.integers(0, cfg.vocab_size, (1, CPU_CHECK_S))
             .astype(np.int32) for k in ("tokens", "labels")}
    out = {}
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        loss, _ = model.loss_fn(cfg2, p, b, attn_impl="flash")
        grads = torch.autograd.grad(loss, flat_tensors(p.param_tree()))
        out[dev] = (loss.item(), grads)
    del cpu_params
    (l_card, g_card), (l_cpu, g_cpu) = out.pop("cuda"), out.pop("cpu")
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    rel = max((a.cpu() - b).abs().max().item()
              / max(b.abs().max().item(), 1e-30)
              for a, b in zip(g_card, g_cpu))
    mem = host_memory()
    del g_card, g_cpu
    if not (np.isfinite(l_card) and loss_rel <= 1e-5 and rel <= 1e-4):
        raise AssertionError(f"{name} step 0 card vs CPU: loss {l_card} vs "
                             f"{l_cpu} ({loss_rel:.3g} relative), gradients "
                             f"{rel:.3g} of their largest element")
    log(f"[models] {name} step 0 at full width, {layers} layers "
        f"({param_count(cfg2):,} parameters), fp32, B=1 x S={CPU_CHECK_S}: "
        f"card loss {l_card:.6f}, CPU {l_cpu:.6f} ({loss_rel:.3g} relative, "
        f"within 1e-5); gradients within {rel:.3g} of each leaf's largest "
        f"element (limit 1e-4); {mem}")
    return params, rel


def train_model(torch, name, cfg, B, peak_lr=MODEL_LR, S=MODEL_S):
    """Sophia-G (bf16 compute, engine kernels, peak lr MODEL_LR after 2
    warmup steps, GNB refresh every MODEL_K steps from step 0 on half the
    batch, at least one row) at B x S for MODEL_STEPS steps through the
    trainer.  Launch counts zeroed just before, read just after, held
    exactly; the loss finite and falling; the parameters and the engine's
    shard the sizes ``param_count`` and ``shard_size`` give (phase 2
    checked the engine kernels at that shard).  Returns the report."""
    import numpy as np

    from repro_torch.data import DataConfig, make_source
    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
    from repro_torch.train import TrainerConfig
    from repro_torch.train.trainer import to_device_batch

    sub = max(1, B // 2)
    tc = TrainerConfig(peak_lr=peak_lr, total_steps=MODEL_STEPS,
                       warmup_steps=2, hess_interval=MODEL_K,
                       hess_subbatch=sub, seed=0, fused_kernel=True)
    state, train_step = _train_fns(torch, cfg, tc, "cuda")
    n_params = sum(p.numel() for p in state.params.parameters())
    shard = tuple(t.numel() for t in state.opt_state.m)
    if n_params != param_count(cfg) or shard != (shard_size(cfg),):
        raise AssertionError(f"{name}: {n_params} parameters in shards "
                             f"{shard}; param_count gives "
                             f"{param_count(cfg)}, shard_size "
                             f"{shard_size(cfg)}")
    src = make_source(DataConfig(seq_len=S, global_batch=B,
                                 vocab_size=cfg.vocab_size, seed=0))
    batches = [to_device_batch(src.batch_at(t), "cuda")
               for t in range(MODEL_STEPS)]
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, losses = [], []
    for t in range(MODEL_STEPS):
        t0 = time.perf_counter()
        state, metrics = train_step(state, batches[t], t % MODEL_K == 0)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(KERNEL_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_ref = len(range(0, MODEL_STEPS, MODEL_K))
    attn = cfg.n_layers * (MODEL_STEPS + n_ref)
    want = {"ce_forward": MODEL_STEPS, "ce_forward_sampled": n_ref,
            "ce_backward_dh": MODEL_STEPS + n_ref,
            "ce_backward_dw": MODEL_STEPS + n_ref,
            "attn_fwd": attn, "attn_bwd_dq": attn, "attn_bwd_dkv": attn,
            "sophia_step": MODEL_STEPS - n_ref, "sophia_refresh": n_ref}
    if launches != want:
        raise AssertionError(f"{name} training launches {launches} != "
                             f"{want}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"{name}: the loss is not finite and falling: "
                             f"{losses}")
    if int(state.opt_state.hess_count) != n_ref:
        raise AssertionError(f"{name}: hess_count "
                             f"{int(state.opt_state.hess_count)} != {n_ref}")
    plain = [dt for t, dt in enumerate(times) if t % MODEL_K]
    refresh = [dt for t, dt in enumerate(times) if t and t % MODEL_K == 0]
    tokens = B * S
    p50 = statistics.median(plain)
    report = dict(layers=cfg.n_layers, params=n_params, B=B, S=S,
                  launches=launches, losses=losses, plain_p50_ms=p50 * 1e3,
                  refresh_p50_ms=statistics.median(refresh) * 1e3,
                  step0_ms=times[0] * 1e3,
                  tokens_per_s=tokens * MODEL_STEPS / sum(times),
                  tokens_per_s_plain_p50=tokens / p50,
                  peak_mem_gib=peak / 2 ** 30,
                  resident_gib=resident / 2 ** 30)
    log(f"[models] {name} trained: {cfg.n_layers} layers, {n_params:,} "
        f"parameters, bf16 B={B} x S={S} Sophia-G lr {peak_lr:g} "
        f"fused_kernel=True "
        f"k={MODEL_K} sub={sub}: {MODEL_STEPS} steps, loss "
        + " -> ".join(f"{x:.4f}" for x in losses)
        + f"; step p50 plain {report['plain_p50_ms']:.1f} ms, refresh "
        f"(steps {list(range(MODEL_K, MODEL_STEPS, MODEL_K))}) "
        f"{report['refresh_p50_ms']:.1f} ms, step 0 "
        f"{report['step0_ms']:.1f} ms; {report['tokens_per_s']:.0f} tok/s "
        f"over the run ({report['tokens_per_s_plain_p50']:.0f} at the plain "
        f"p50); peak memory {report['peak_mem_gib']:.2f} GiB "
        f"({report['resident_gib']:.2f} GiB resident at the start); "
        f"launches {launches}")
    del state, batches
    torch.cuda.empty_cache()
    return report


MODEL_REQUESTS = 8


def serve_model(torch, name, cfg, small):
    """``cfg`` served at its depth with random weights from a seed: 8
    mixed requests over 8 slots with a bf16 and an int8 KV cache (every
    decode step launching the decode kernel once a layer), then the
    params of the step-0 check (``small``, 1-2 layers, held on the CPU
    while the model trains) decoded on the card against the CPU's plain
    path.
    Returns the report."""
    from repro_torch.models import get_model

    params = get_model(cfg).init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    report = {}
    cfg2 = dataclasses.replace(cfg, n_layers=len(small.layers))
    small.cuda()
    for kv_dtype in ("bf16", "int8"):
        eng, secs, launches = serve_once(torch, cfg, params, kv_dtype,
                                         n_requests=MODEL_REQUESTS)
        st = eng.stats()
        ref_err = check_against_cpu(torch, cfg2, small, kv_dtype)
        key = "decode_attention_q8" if kv_dtype == "int8" else \
            "decode_attention"
        report[kv_dtype] = dict(
            launches=launches[key],
            tok_per_s=st["tokens_emitted"] / secs,
            token_p50_ms=st["token_lat_p50_s"] * 1e3,
            tpot_p50_ms=st["tpot_p50_s"] * 1e3, cpu_logit_err=ref_err)
        log(f"[models] {name} served: {cfg.n_layers} layers, kv={kv_dtype}: "
            f"{len(eng.results)} requests, {st['tokens_emitted']} tokens in "
            f"{secs:.3f}s = {st['tokens_emitted'] / secs:.1f} tok/s; token "
            f"p50 {st['token_lat_p50_s'] * 1e3:.3f} ms; tpot p50 "
            f"{st['tpot_p50_s'] * 1e3:.3f} ms; launches {launches}; card "
            f"vs CPU logits ({cfg2.n_layers} layers, fp32) err "
            f"{ref_err:.3g}")
        del eng
    del params, small
    torch.cuda.empty_cache()
    return report


# every kernel on a rope model's path: rows 1 (both caches), 2, 4, 11, 12,
# 14, 15 and 16-18
PATH_KERNELS = ("decode_attention", "decode_attention_q8", "sophia_step",
                "sophia_refresh", "ce_forward", "ce_forward_sampled",
                "ce_backward_dh", "ce_backward_dw", "attn_fwd",
                "attn_bwd_dq", "attn_bwd_dkv")


def phase_models(torch):
    """Each rope model: the step-0 card-vs-CPU check, Sophia-G training
    (NeoX-6.6B at NEOX66_TRAIN_LAYERS layers), serving at full depth.
    Every row of the path (decode attention, the Sophia step and the
    refresh-fused step, the four CE kernels, the three flash kernels)
    must launch.  Returns {model: report}."""
    reports = {}
    for name, cfg, layers, B in _model_runs():
        small, rel = model_step0_against_cpu(torch, name, cfg)
        small.cpu()
        torch.cuda.empty_cache()
        trained = train_model(torch, name,
                              dataclasses.replace(cfg, n_layers=layers), B)
        served = serve_model(torch, name, cfg, small)
        del small
        launches = dict(trained["launches"])
        launches["decode_attention"] = served["bf16"]["launches"]
        launches["decode_attention_q8"] = served["int8"]["launches"]
        missing = [k for k in PATH_KERNELS if not launches.get(k)]
        if missing:
            raise AssertionError(f"{name}: kernels of the path not launched: "
                                 f"{missing}")
        reports[name] = dict(step0_grad_rel=rel, train=trained,
                             serve=served, launches=launches,
                             full_layers=cfg.n_layers)
        log(f"[models] {name}: launches on its path {launches}")
    return reports


# ---------------------------------------------------------------------------
# phase 4d: the dense configs (yi-6b, qwen1.5-110b, gemma2-9b)


# the kernels a step-0 check (fp32, the fused loss, flash) must launch
STEP0_KERNELS = ("ce_forward", "ce_backward_dh", "ce_backward_dw",
                 "attn_fwd", "attn_bwd_dq", "attn_bwd_dkv")
# Each config's cuts and the reason: 16 bytes a parameter of fp32 weight,
# gradient, m and h, and ~32-34 a parameter at a step's peak (NeoX-6.6B's
# 67.93 GiB for 2.02 B parameters, PR 21's phase 4c)
DENSE_CUTS = {
    "yi-6b": "trained at 8 of 32 layers (full depth ~97 GB of fp32 weight, "
             "gradient, m and h), B=2 as NeoX-6.6B; served at full depth",
    "gemma2-9b": "trained at 4 of 42 layers (full depth ~148 GB of state) "
                 "at B=1 x S=8192, its context; served at full depth",
    "qwen1.5-110b": "not trained on the card (its embedding and unembedding "
                    "alone, 2.49 B parameters, take ~80 GB at ~32 bytes a "
                    "parameter); served at 6 of 80 layers (10.6 B "
                    "parameters, 42.6 GB fp32); step 0 at 1 layer (3.85 B)",
}


def _dense_runs():
    """(name, config, step-0 layers, layers trained or None, (B, S),
    layers served) of each dense config."""
    from repro_torch.configs import get_config

    return (("yi-6b", get_config("yi-6b"), 2, 8, (2, 2048), 32),
            ("gemma2-9b", get_config("gemma2-9b"), 2, 4, (1, 8192), 42),
            ("qwen1.5-110b", get_config("qwen1.5-110b"), 1, None, None, 6))


def phase_dense_models(torch):
    """Each dense config: the step-0 card-vs-CPU check, Sophia-G training
    (where it fits), serving (bf16 and int8 caches).  Counts are zeroed
    before each run and read after: the step-0 check must launch the
    fp32 CE and flash kernels, training every kernel of the path exactly
    as ``train_model`` holds it, serving the decode kernel once a layer a
    step.  Returns {model: report}."""
    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts

    reports = {}
    for name, cfg, l0, layers, shape, served_layers in _dense_runs():
        log(f"[models] {name}: {DENSE_CUTS[name]}")
        reset_launch_counts()
        small, rel = model_step0_against_cpu(torch, name, cfg, layers=l0)
        launches = dict(KERNEL_LAUNCHES)
        missing = [k for k in STEP0_KERNELS if not launches.get(k)]
        if missing:
            raise AssertionError(f"{name} step 0: kernels not launched: "
                                 f"{missing}")
        small.cpu()
        torch.cuda.empty_cache()
        trained = None
        if layers:
            B, S = shape
            trained = train_model(torch, name,
                                  dataclasses.replace(cfg, n_layers=layers),
                                  B, S=S)
            launches = dict(trained["launches"])
        served = serve_model(torch, name,
                             dataclasses.replace(cfg, n_layers=served_layers),
                             small)
        del small
        launches["decode_attention"] = served["bf16"]["launches"]
        launches["decode_attention_q8"] = served["int8"]["launches"]
        path = PATH_KERNELS if layers else (
            ("decode_attention", "decode_attention_q8") + STEP0_KERNELS)
        missing = [k for k in path if not launches.get(k)]
        if missing:
            raise AssertionError(f"{name}: kernels of the path not launched: "
                                 f"{missing}")
        reports[name] = dict(step0_grad_rel=rel, step0_layers=l0,
                             train=trained, serve=served, launches=launches,
                             served_layers=served_layers,
                             full_layers=cfg.n_layers, cuts=DENSE_CUTS[name])
        log(f"[models] {name}: launches on its path {launches}; "
            f"{host_memory()}")
    return reports


# ---------------------------------------------------------------------------
# phase 5: kernel timings


def time_ms(torch, fn, flush, reps=200, warmup=10):
    """Median per-call device time: CUDA events around each call, the L2
    flushed before it by reading a buffer larger than the cache, and the
    stream held by a device-side sleep (~0.5 ms) so that the host has
    enqueued the whole call before the start event fires — the events then
    time the device's work, not the wrapper's host code."""
    for _ in range(warmup):
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


def time_decode(torch, quant, shape, positions, flush, opts=None):
    """One decode-attention kernel (bf16 q; bf16 or int8 cache; ``opts``
    the model's window and softcap) at one shape: its device and
    host-issue time, its plain version's and SDPA's (bf16 cache without a
    softcap only) device time, its bound, the split count S and
    ``cudaOccupancyMaxActiveClusters`` at that launch."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_plain, max_active_clusters,
        ring_mask, split_count)

    N, H, Hkv, C, hd = shape
    a = _decode_inputs(torch, N, H, Hkv, C, hd, torch.bfloat16, positions,
                       quant, seed=0)
    opts = opts or {}
    kw = dict(k_scale=a["k_scale"], v_scale=a["v_scale"], scale=1.0, **opts)

    def call():
        return decode_attention(a["q"], a["k_cache"], a["v_cache"],
                                a["positions"], **kw)

    ms = time_ms(torch, call, flush)
    issue_ms = host_ms(torch, call)
    plain_ms = time_ms(torch, lambda: decode_attention_plain(
        a["q"], a["k_cache"], a["v_cache"], a["positions"], **kw), flush)
    library_ms = None
    if not quant and opts.get("softcap") is None:
        q4 = a["q"][:, :, None, :]
        k4 = a["k_cache"].permute(0, 2, 1, 3)
        v4 = a["v_cache"].permute(0, 2, 1, 3)
        mask = ring_mask(a["positions"], C,
                         opts.get("window"))[:, None, None, :]
        sdpa = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                              scale=1.0, enable_gqa=H != Hkv)
        sdpa_err = (sdpa[:, :, 0].float() - call().float()).abs().max().item()
        log(f"[timing] SDPA yardstick vs kernel at N={N} C={C}: max abs err "
            f"{sdpa_err:.3g}")
        library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, scale=1.0, enable_gqa=H != Hkv),
            flush)
    # the bound counts what this call's data needs: q read and the output
    # written once, the positions, and only the ring rows the positions make
    # valid (K and V, int8: plus their two fp32 scales), with 4 flops per
    # element per query head (q.k and p.v); a masked row cannot change the
    # output
    valid_rows = int(ring_mask(a["positions"], C, opts.get("window")).sum())
    row_bytes = 2 * Hkv * hd * a["k_cache"].element_size() + 8 * quant
    nbytes = (2 * a["q"].numel() * a["q"].element_size()
              + a["positions"].numel() * 4 + valid_rows * row_bytes)
    flops = 4 * H * hd * valid_rows
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = split_count(N, Hkv, C, sms)
    clusters = max_active_clusters(N, H, Hkv, C, hd, torch.bfloat16, quant,
                                   splits)
    name = "decode_attention_q8" if quant else "decode_attention"
    log(f"[timing] {name} N={N} C={C}: kernel {ms * 1e3:.2f} us, plain "
        f"{plain_ms * 1e3:.2f} us, library "
        f"{'n/a' if library_ms is None else f'{library_ms * 1e3:.2f} us'}, "
        f"bound {bound_ms * 1e3:.2f} us ({nbytes} bytes, {flops} flops; "
        f"{valid_rows} valid rows of {N * C}), host issue "
        f"{issue_ms * 1e3:.2f} us; S={splits}, {N * Hkv * splits} blocks, "
        f"max active clusters {clusters}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_us": bound_ms * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "host_issue_ms": issue_ms,
            "splits": splits, "max_active_clusters": clusters,
            "shape": f"N={N} H={H} Hkv={Hkv} C={C} hd={hd} q=bf16 "
                     f"kv={'int8' if quant else 'bf16'} positions="
                     f"{positions if N <= 8 else 'every one >= 1023'}"
                     + "".join(f" {k}={v}" for k, v in opts.items())}


def phase_timings(torch, main_err, served):
    """Both decode kernels at the ``DECODE_SHAPES``: the serving shape is
    the row, the others go under its ``shapes``."""
    flush = torch.empty(128 * 2 ** 20 // 4, device="cuda")
    rows = []
    for name, replaces in DECODE_ATTN[1].items():
        quant = name.endswith("q8")
        timed = [time_decode(torch, quant, *DECODE_SHAPES[key], flush,
                             DECODE_KW.get(key))
                 for key in DECODE_SHAPES]
        rows.append({
            "name": name, "route": "cuda", "source": DECODE_ATTN[0],
            "replaces": replaces, "launches": served[name]["launches"],
            "max_abs_err": main_err[name], **timed[0], "shapes": timed[1:]})
    return rows


CE_TIME = dict(N=8192, D=768, V=50304, Vp=50304, tied=True, norm="ln",
               softcap=None, h="bfloat16", w="float32", mask=False)
# which units the CE kernels' products run on at CE_TIME (bf16 h)
CE_UNITS = dict.fromkeys(FUSED_CE[1], "tensor cores")
CE_REFRESH_N = 4096        # the sampled forward's rows in a GNB refresh


def _ce_timed(torch, spec, label, reps=20):
    """The four CE kernels at ``spec`` (bf16 h, fp32 W): {kernel: entry}
    with the kernel's time, its plain version's, its bound and the library
    composition's (not one call) beside it; ``reps`` launches each (a
    quarter of that for the plain versions)."""
    import torch.nn.functional as F

    from repro_torch.kernels import fused_ce as ce

    flush = torch.empty(128 * 2 ** 20 // 4, device="cuda")
    h, w, normp, labels, rs, opts = _ce_inputs(torch, **spec)
    N, D = h.shape
    Vp = spec["Vp"]
    lse, _ = ce.ce_forward_plain(h, w, normp, labels, **opts)
    calls = {
        "ce_forward": (lambda: ce.ce_forward(h, w, normp, labels, **opts),
                       lambda: ce.ce_forward_plain(h, w, normp, labels,
                                                   **opts)),
        "ce_forward_sampled": (
            lambda: ce.ce_forward_sampled(h, w, normp, CE_SEED, **opts),
            lambda: ce.ce_forward_sampled_plain(h, w, normp, CE_SEED,
                                                **opts)),
        "ce_backward_dh": (
            lambda: ce.ce_backward_dh(h, w, normp, labels, rs, lse, **opts),
            lambda: ce.ce_backward_dh_plain(h, w, normp, labels, rs, lse,
                                            **opts)),
        "ce_backward_dw": (
            lambda: ce.ce_backward_dw(h, w, normp, labels, rs, lse, **opts),
            lambda: ce.ce_backward_dw_plain(h, w, normp, labels, rs, lse,
                                            **opts)),
    }

    # the library composition: F.linear on the normed bf16 rows and W cast
    # to bf16 (bf16 logits), the softcap, logsumexp and a gather in fp32;
    # its autograd backward gives dh and dW together
    hn = ce.apply_norm(h, normp, spec["norm"], opts["eps"]).detach()
    cap = spec["softcap"]

    def composition(requires_grad=False):
        x = hn.clone().requires_grad_(requires_grad)
        wp = w.detach().clone().requires_grad_(requires_grad)
        wl = wp.T if opts["transpose_w"] else wp
        logits = F.linear(x, wl.to(x.dtype)).float()
        if cap:
            logits = cap * torch.tanh(logits / cap)
        loss = torch.sum(rs * (torch.logsumexp(logits, -1)
                               - logits.gather(1, labels.long()[:, None])[:, 0]))
        return loss, x, wp

    def comp_backward():
        loss, x, wp = composition(True)
        return torch.autograd.grad(loss, (x, wp))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    comp_backward()
    torch.cuda.synchronize()
    comp_peak = torch.cuda.max_memory_allocated() - base
    lib_fwd = time_ms(torch, lambda: composition(False), flush, reps=reps,
                      warmup=2)
    lib_fb = time_ms(torch, comp_backward, flush, reps=reps, warmup=2)
    log(f"[timing] library composition (not one call) {label} at N={N} "
        f"D={D} Vp={Vp}: forward {lib_fwd:.3f} ms, forward + autograd "
        f"backward {lib_fb:.3f} ms, backward alone {lib_fb - lib_fwd:.3f} "
        f"ms; peak memory above the inputs {comp_peak / 2 ** 30:.2f} GiB")
    library = {"ce_forward": lib_fwd, "ce_forward_sampled": None,
               "ce_backward_dh": lib_fb - lib_fwd,
               "ce_backward_dw": lib_fb - lib_fwd}
    layout = "tied" if spec["tied"] else "untied"
    out = {}
    for name in FUSED_CE[1]:
        kernel, plain = calls[name]
        ms = time_ms(torch, kernel, flush, reps=reps, warmup=2)
        plain_ms = time_ms(torch, plain, flush, reps=max(3, reps // 4),
                           warmup=1)
        flops = ce.ce_flops(N, D, Vp, name)
        nbytes = ce.ce_bytes(N, D, Vp, name, bytes_h=h.element_size(),
                             bytes_w=w.element_size())
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        bound_ms = max(t_ops, t_bytes)
        out[name] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library[name], "units": CE_UNITS[name],
            "library_note": (None if library[name] is None else
                             "F.linear + logsumexp + gather, not one call"
                             + ("" if name == "ce_forward" else
                                "; its autograd backward, dh and dW "
                                "together")),
            "shape": f"{label}: N={N} D={D} Vp={Vp} h=bf16 W=fp32 "
                     f"{layout} {spec['norm']}"
                     + (f" softcap {cap:g}" if cap else "")}
        log(f"[timing] {name} ({CE_UNITS[name]}) {label}: kernel {ms:.3f} "
            f"ms, plain {plain_ms:.3f} ms, library {library[name]}, bound "
            f"{bound_ms:.4f} ms ({flops} flops at {BF16_FLOPS_PER_S:.3g}/s, "
            f"{nbytes} bytes at {HBM_BYTES_PER_S:.3g}/s); "
            f"{flops / ms / 1e9:.1f} TFLOP/s")
    return out


def _ce_sampled_timed(torch, spec, label):
    """The sampled forward at the rows a refresh gives it: (ms, bound)."""
    from repro_torch.kernels import fused_ce as ce

    flush = torch.empty(128 * 2 ** 20 // 4, device="cuda")
    name = "ce_forward_sampled"
    h, w, normp, _, _, opts = _ce_inputs(torch, **spec)
    N, D = h.shape
    ms = time_ms(torch, lambda: ce.ce_forward_sampled(h, w, normp, CE_SEED,
                                                      **opts),
                 flush, reps=20, warmup=2)
    flops = ce.ce_flops(N, D, spec["Vp"], name)
    nbytes = ce.ce_bytes(N, D, spec["Vp"], name, bytes_h=h.element_size(),
                         bytes_w=w.element_size())
    bound_ms = max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
    log(f"[timing] {name} ({CE_UNITS[name]}) {label} at the refresh's "
        f"N={N}: kernel {ms:.3f} ms, bound {bound_ms:.4f} ms; "
        f"{flops / ms / 1e9:.1f} TFLOP/s")
    return ms, bound_ms




def phase_ce_timings(torch, ce_err, trained):
    """The CE kernels at the training loss shape beside their bound, their
    plain versions and the library composition (not one call); the
    sampled forward also at the refresh's N=4096; under each row's
    ``shapes`` the same at the rope models' and the dense configs' loss
    shapes.  Each row names the units its products run on
    (``CE_UNITS``)."""
    main = _ce_timed(torch, CE_TIME, "gpt2-small")
    models = [(name, spec, _ce_timed(torch, spec, name))
              for name, spec in ((n, dict(CE_TIME, **sp))
                                 for n, sp in CE_MODEL_SHAPES)]
    dense = [(name, spec, _ce_timed(torch, spec, name, reps=10))
             for name, spec in ((n, dict(CE_TIME, **sp))
                                for n, sp in CE_DENSE_SHAPES)]
    rows = []
    for name, replaces in FUSED_CE[1].items():
        rows.append({
            "name": name, "route": "cuda", "source": FUSED_CE[0],
            "replaces": replaces,
            "launches": trained["launches"].get(name, 0),
            "max_abs_err": ce_err[name], **main[name],
            "shapes": [t[name] for _, _, t in models + dense]})
    row = next(r for r in rows if r["name"] == "ce_forward_sampled")
    row["ms_N4096"], row["bound_ms_N4096"] = _ce_sampled_timed(
        torch, dict(CE_TIME, N=CE_REFRESH_N), "gpt2-small")
    for (name, spec, _), entry in zip(models, row["shapes"]):
        entry["ms_refresh"], entry["bound_ms_refresh"] = _ce_sampled_timed(
            torch, dict(spec, N=spec["N"] // 2), name)
    # yi's refresh draws on one of its two rows; gemma2's batch is its one
    # row (the entry above); qwen1.5 is not trained on the card
    for (name, spec, _), entry in zip(dense, row["shapes"][len(models):]):
        if name == "yi-6b":
            entry["ms_refresh"], entry["bound_ms_refresh"] = \
                _ce_sampled_timed(torch, dict(spec, N=spec["N"] // 2), name)
    return rows


# which units each flash kernel's bf16 products run on
FLASH_UNITS = {"attn_fwd": "tensor cores", "attn_bwd_dq": "tensor cores",
               "attn_bwd_dkv": "tensor cores"}


def _flash_timed(torch, spec, label, reps=20):
    """The three flash kernels at ``spec`` in bf16 (causal, with its window
    and softcap): {kernel: entry} with the kernel's time, its plain
    version's, its bound and SDPA's beside it.  SDPA takes no softcap: with
    one it computes the same pairs (``is_causal``, or the window as a
    boolean mask) without it, the nearest function it has."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    flush = torch.empty(128 * 2 ** 20 // 4, device="cuda")
    q, k, v, g, kw = _attn_inputs(torch, spec, torch.bfloat16)
    B, H, Hkv, S, hd = (spec[n] for n in ("B", "H", "Hkv", "Sq", "hd"))
    o, lse = fa.flash_forward(q, k, v, **kw)
    delta = (g.float() * o.float()).sum(-1)
    calls = {
        "attn_fwd": (lambda: fa.flash_forward(q, k, v, **kw),
                     lambda: fa.flash_forward_plain(q, k, v, **kw)),
        "attn_bwd_dq": (
            lambda: fa.flash_backward_dq(q, k, v, g, lse, delta, **kw),
            lambda: fa.flash_backward_dq_plain(q, k, v, g, lse, delta,
                                               **kw)),
        "attn_bwd_dkv": (
            lambda: fa.flash_backward_dkv(q, k, v, g, lse, delta, **kw),
            lambda: fa.flash_backward_dkv_plain(q, k, v, g, lse, delta,
                                                **kw)),
    }
    window, cap = spec["window"], spec["softcap"]
    band = fa.band_mask(S, S, causal=True, window=window, q_offset=0,
                        device="cuda")
    sdpa_kw = (dict(attn_mask=band) if window is not None
               else dict(is_causal=True))
    sdpa_kw["enable_gqa"] = H != Hkv
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    sdpa_o = F.scaled_dot_product_attention(*leaves, **sdpa_kw)
    sdpa_err = (sdpa_o.float() - o.float()).abs().max().item()
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, **sdpa_kw), flush, reps=reps, warmup=2)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        sdpa_o, leaves, g, retain_graph=True), flush, reps=reps, warmup=2)
    sdpa_how = ("is_causal=True" if window is None else
                f"the window {window} as a boolean mask") + (
        f", no softcap (the kernel's is {cap:g})" if cap else "")
    log(f"[timing] SDPA yardstick ({sdpa_how}) {label} at B={B} H={H} "
        f"Hkv={Hkv} S={S} hd={hd} bf16: forward {lib_fwd:.3f} ms, backward "
        f"(dq, dk, dv together) {lib_bwd:.3f} ms; max abs err vs the "
        f"kernel's o {sdpa_err:.3g}")
    library = {"attn_fwd": lib_fwd, "attn_bwd_dq": lib_bwd,
               "attn_bwd_dkv": lib_bwd}
    pairs = int(band.sum())
    del band
    out = {}
    for name in FLASH_ATTN[1]:
        kernel, plain = calls[name]
        ms = time_ms(torch, kernel, flush, reps=reps, warmup=2)
        plain_ms = time_ms(torch, plain, flush, reps=max(3, reps // 4),
                           warmup=1)
        flops = fa.attn_flops(B, H, hd, pairs, name)
        nbytes = fa.attn_bytes(B, H, Hkv, S, S, hd, name,
                               itemsize=q.element_size())
        t_ops = flops / BF16_FLOPS_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        out[name] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library[name], "units": FLASH_UNITS[name],
            "library_note": ("F.scaled_dot_product_attention forward"
                             if name == "attn_fwd" else
                             "F.scaled_dot_product_attention's autograd "
                             "backward, dq, dk and dv together")
                            + f" ({sdpa_how})",
            "shape": f"{label}: B={B} H={H} Hkv={Hkv} S={S} hd={hd} bf16 "
                     f"causal"
                     + (f" window {window}" if window is not None else "")
                     + (f" softcap {cap:g}" if cap else "")}
        log(f"[timing] {name} ({FLASH_UNITS[name]}) {label}: kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, SDPA "
            f"{library[name]:.3f} ms, bound {max(t_ops, t_bytes):.4f} ms "
            f"({flops} flops at {BF16_FLOPS_PER_S:.3g}/s, {nbytes} bytes at "
            f"{HBM_BYTES_PER_S:.3g}/s); {flops / ms / 1e9:.1f} TFLOP/s")
    return out




def phase_flash_timings(torch, attn_err, trained):
    """The flash kernels at GPT-2 small's training shape in bf16 beside
    their bound, their plain versions, and SDPA (``is_causal=True``; its
    forward for row 16, its autograd backward, dq, dk and dv together, for
    rows 17 and 18), which the port never calls; under each row's
    ``shapes`` the same at the rope models' training shapes and at
    gemma2's (hd 256, S 8192: a local layer with its window of 4096 and a
    global one, both with the softcap 50).  Each row names the units its
    products run on (``FLASH_UNITS``)."""
    main = _flash_timed(torch, ATTN_MAIN, "gpt2-small")
    models = [_flash_timed(torch, dict(ATTN_MAIN, **sp), name)
              for name, sp in ATTN_MODEL_SHAPES]
    models += [_flash_timed(torch, dict(ATTN_MAIN, **sp), name, reps=10)
               for name, sp in ATTN_DENSE_SHAPES]
    return [{"name": name, "route": "cuda", "source": FLASH_ATTN[0],
             "replaces": replaces,
             "launches": trained["launches"].get(name, 0),
             "max_abs_err": attn_err[name], **main[name],
             "shapes": [t[name] for t in models]}
            for name, replaces in FLASH_ATTN[1].items()]


# fp32 operations per element (the bound's second term; the bytes bound
# these kernels): sophia 12 (3 mul + add for m', mul + max + div, clamp 2,
# the compare, 2 mul + sub for p'), the EMA 4, the refresh both, AdamW 15
ENGINE_OPS_PER_ELEM = {"sophia_step": 12, "hessian_ema": 4,
                       "sophia_refresh": 16, "adamw_step": 15,
                       # AdaHessian 11 (m' 3, the Adam update 8), its
                       # refresh 16 (+ scale, square, the EMA 3); Lion 11
                       # (sign argument 3, sign 2, m' 3, p' 3); SignGD 8;
                       # SGD 4 (m' 2, p' 2)
                       "adahessian_refresh": 16, "adahessian_step": 11,
                       "lion_step": 11, "signgd_step": 8, "sgd_step": 4}
# which run's launch count each engine kernel reports
_ENGINE_RUN = {"sophia_step": "sophia_g", "sophia_refresh": "sophia_g",
               "hessian_ema": "update_hessian", "adamw_step": "adamw",
               "adahessian_refresh": "adahessian",
               "adahessian_step": "adahessian", "lion_step": "lion",
               "signgd_step": "signgd", "sgd_step": "sgd"}


def phase_engine_timings(torch, engine_err, trained):
    """The engine kernels at GPT-2 small's shard with fp32 state (the
    training run's) beside their byte bound, their plain versions and, for
    AdamW and SGD, ``torch.optim.AdamW(fused=True).step()`` and
    ``torch.optim.SGD(momentum=0.9, dampening=0, fused=True).step()`` on
    one flat parameter of the shard's size (one PyTorch call each, in its
    own rounding order; the port never calls them).  SGD is timed at
    ``SGD_HP``'s momentum 0.9 on both sides, after one warm library step
    has made the momentum buffer, so that both read p, g and m and write p
    and m (20 bytes per element)."""
    from repro_torch.kernels import sophia_update as su

    flush = torch.empty(128 * 2 ** 20 // 4, device="cuda")
    n, block = SHARD_N, SHARD_BLOCK
    p, m, h, g, e = _engine_operands(torch, n, torch.float32, torch.float32)
    lr = torch.tensor(6e-4, device="cuda")
    scale = torch.tensor(4096.0, device="cuda")
    step = torch.tensor(5.0, device="cuda")
    one = torch.tensor(1.0, device="cuda")
    sk = dict(SOPHIA_HP, block=block)
    ak = dict(ADAMW_HP, block=block)
    hk = dict(ADAHESSIAN_HP, block=block)
    lk, gk = dict(LION_HP, block=block), dict(SIGNGD_HP, block=block)
    mk = dict(SGD_HP, block=block)              # m' = 0.9 m + g
    calls = {
        "sophia_step": (lambda: su.sophia_fused_block(p, m, h, g, lr, **sk),
                        lambda: su.sophia_fused_block_plain(p, m, h, g, lr,
                                                            **sk)),
        "hessian_ema": (
            lambda: su.hessian_ema_block(h, e, beta2=0.99, scale=scale,
                                         block=block),
            lambda: su.hessian_ema_block_plain(h, e, beta2=0.99, scale=scale,
                                               block=block)),
        "sophia_refresh": (
            lambda: su.sophia_refresh_fused_block(p, m, h, g, e, lr, 1, scale,
                                                  beta2=0.99, **sk),
            lambda: su.sophia_refresh_fused_block_plain(
                p, m, h, g, e, lr, 1, scale, beta2=0.99, **sk)),
        "adamw_step": (
            lambda: su.adamw_fused_block(p, m, h, g, lr, step, **ak),
            lambda: su.adamw_fused_block_plain(p, m, h, g, lr, step, **ak)),
        "adahessian_refresh": (
            lambda: su.adahessian_refresh_fused_block(p, m, h, g, e, lr, 1,
                                                      one, step, **hk),
            lambda: su.adahessian_refresh_fused_block_plain(
                p, m, h, g, e, lr, 1, one, step, **hk)),
        "adahessian_step": (
            lambda: su.adahessian_fused_block(p, m, h, g, lr, step, **hk),
            lambda: su.adahessian_fused_block_plain(p, m, h, g, lr, step,
                                                    **hk)),
        "lion_step": (lambda: su.lion_fused_block(p, m, g, lr, **lk),
                      lambda: su.lion_fused_block_plain(p, m, g, lr, **lk)),
        "signgd_step": (
            lambda: su.signgd_fused_block(p, m, g, lr, **gk),
            lambda: su.signgd_fused_block_plain(p, m, g, lr, **gk)),
        "sgd_step": (lambda: su.sgd_fused_block(p, m, g, lr, **mk),
                     lambda: su.sgd_fused_block_plain(p, m, g, lr, **mk)),
    }
    param = torch.nn.Parameter(p.clone())
    param.grad = g.clone()
    opt = torch.optim.AdamW([param], lr=6e-4, betas=(0.9, 0.95), eps=1e-8,
                            weight_decay=0.2, fused=True)
    library = dict.fromkeys(calls)
    library["adamw_step"] = time_ms(torch, opt.step, flush, reps=20,
                                    warmup=2)
    del opt
    param.grad = g.clone()
    opt = torch.optim.SGD([param], lr=6e-4, dampening=0, fused=True,
                          **SGD_HP)
    opt.step()                          # the momentum buffer exists from here
    library["sgd_step"] = time_ms(torch, opt.step, flush, reps=20, warmup=2)
    del opt, param
    h_lib = h.clone()                   # h' = h + (1 - beta2) (e - h)
    library["hessian_ema"] = time_ms(torch, lambda: h_lib.lerp_(e, 0.01),
                                     flush, reps=20, warmup=2)
    del h_lib
    runs = {"sophia_g": trained["launches"], "adamw":
            trained["adamw"]["launches"],
            "update_hessian": {"hessian_ema":
                               trained["hessian_ema_launches"]}}
    runs.update({name: r["launches"]
                 for name, r in trained["baselines"].items()})
    notes = {"adamw_step": "torch.optim.AdamW(fused=True).step() on one "
                           "flat parameter, its own rounding order",
             "sgd_step": "torch.optim.SGD(momentum=0.9, dampening=0, "
                         "fused=True).step() on one flat parameter after "
                         "a warm step: reads p, g, m and writes p, m (20 "
                         "bytes per element), as the kernel at momentum "
                         "0.9",
             "hessian_ema": "h.lerp_(e, 1 - beta2) in place: the EMA at "
                            "scale 1 without the square (reads h, e and "
                            "writes h, 12 bytes per element, as the "
                            "kernel)"}
    rows = []
    for name, replaces in SOPHIA_UPDATE[1].items():
        kernel, plain = calls[name]
        ms = time_ms(torch, kernel, flush, reps=20, warmup=2)
        plain_ms = time_ms(torch, plain, flush, reps=5, warmup=1)
        nbytes = su.engine_kernel_bytes(name, n, torch.float32,
                                        torch.float32, block)
        flops = ENGINE_OPS_PER_ELEM[name] * n
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS_PER_S * 1e3
        bound_ms = max(t_bytes, t_ops)
        rows.append({
            "name": name, "route": "cuda", "source": SOPHIA_UPDATE[0],
            "replaces": replaces,
            "launches": runs[_ENGINE_RUN[name]].get(name, 0),
            "launches_path": _ENGINE_RUN[name] + " run",
            "max_abs_err": engine_err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library[name],
            "library_note": notes.get(name),
            "shape": f"n={n} block={block} p=fp32 state=fp32"})
        log(f"[timing] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"library {library[name]}, bound {bound_ms:.4f} ms ({nbytes} "
            f"bytes at {HBM_BYTES_PER_S:.3g}/s, {flops} fp32 ops); "
            f"{nbytes / ms / 1e9:.2f} TB/s = {bound_ms / ms:.1%} of the "
            f"bound")
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
    t_start = time.perf_counter()
    phase_build()
    main_err = phase_kernels(torch)
    ce_err = phase_ce_kernels(torch)
    attn_err = phase_flash_kernels(torch)
    engine_err = phase_engine_kernels(torch)
    served = phase_serve(torch)
    trained = phase_train(torch)
    phase_routes(torch)
    models = phase_models(torch)
    models.update(phase_dense_models(torch))
    rows = (phase_timings(torch, main_err, served)
            + phase_engine_timings(torch, engine_err, trained)
            + phase_ce_timings(torch, ce_err, trained)
            + phase_flash_timings(torch, attn_err, trained))
    for row in rows:     # each model's own runs, counted apart
        row["launches_models"] = {m: r["launches"].get(row["name"], 0)
                                  for m, r in models.items()}
    summary = {}
    for m, r in models.items():
        t = r["train"] or {}
        summary[m] = dict(
            layers=r["full_layers"], layers_trained=t.get("layers"),
            params_trained=t.get("params"), B=t.get("B"), S=t.get("S"),
            plain_p50_ms=t.get("plain_p50_ms"),
            refresh_p50_ms=t.get("refresh_p50_ms"),
            tokens_per_s=t.get("tokens_per_s"),
            peak_mem_gib=t.get("peak_mem_gib"), losses=t.get("losses"),
            layers_served=r.get("served_layers", r["full_layers"]),
            served_tok_per_s={kv: x["tok_per_s"]
                              for kv, x in r["serve"].items()},
            step0_grad_rel=r["step0_grad_rel"], cuts=r.get("cuts"))
    name, power = [s.strip() for s in card.split(",", 1)]
    log(f"[total] wall {time.perf_counter() - t_start:.1f}s")
    log(card)
    log(json.dumps({"models": summary, "card": name, "power_limit": power}))
    log(json.dumps({"kernels": rows, "card": name, "power_limit": power}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
