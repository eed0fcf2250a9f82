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
     gemma2's hd 256 with its softcap, and its window in a ring of 8192;
     qwen2-vl's group of 7 in the engine's ring and in the lockstep
     decode's 32,776-row linear cache; deepseek-moe-16b's group 1 at hd
     128 with 16 heads);
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
     30, qwen2-vl N=4096 D=3584 Vp=152064 untied with each sequence's 256
     patch rows masked, deepseek-moe-16b N=4096 D=2048 Vp=102400 untied;
     and each width with fp32 h at 130 rows).  The
     forwards within 1e-5 (fp32) or 2e-2 (bf16);
     dh and dW within 1e-5 of their largest element in fp32 and, with bf16
     h or W, element by element against each element's sum of absolute
     terms (``check_bf16_grad``; bf16 h takes the tensor-core kernels,
     forward and backward, and each case logs its share beyond 2^-16);
     the sampled labels identical except on rows whose two best perturbed
     logits lie within 1e-5, never a padded column, and the sampled
     forward on every other row with ``row_ids`` (a data-parallel rank's
     rows) drawing the whole call's labels bit for bit; the flash-attention
     kernels (forward, dQ, dK/dV) at GPT-2 small's training shape (B=8,
     H=12, S=1024, hd=64, causal) and the refresh's B=4, and the edge
     cases (GQA 8/2, window 48 + softcap 20, q_offset with Sq < Sk,
     non-causal, S=1000 off the tile, hd=128, rows with no key) and the
     rope models' S=2048 (hd 64, 24 heads; hd 128, 32 heads), hd 256
     (gemma2's training shape, B=1 H=16 Hkv=8 S=8192 softcap 50, a local
     layer with its window of 4096 and a global one; and GQA 2 with window
     and softcap off the tile, q_offset, non-causal, a row with no key),
     qwen2-vl's group of 7 (B=2 H=28 Hkv=4 S=2048 hd=128, and its prefill
     heads at B=1 S=4096), deepseek-moe-16b's training shape (B=2 H=16
     Hkv=16 S=2048 hd=128),
     fp32 and bf16, o, lse, dq, dk and dv within 1e-5 (fp32) or 2e-2
     (bf16) of their largest element, and in bf16 (all three on the
     tensor cores) every element of o, dq, dk and dv within 2^-7 of its
     absolute sum (the share beyond 2^-9 logged); the forward alone at
     the 32k prefill's shape (B=1 H=28 Hkv=4 S=32768 hd=128, bf16,
     causal), held over its first, a middle and its last 256 query rows
     (the plain version over each slice, ``q_offset`` at its first row):
     o within 2e-2 of its largest element and every element within 2^-7
     of its absolute sum, and lse, fp32 arithmetic on both sides, within
     1e-5 of its largest element, a bound a dropped or doubled key tile
     breaks (the engine kernels (the
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
     and rows 2-4 launched on the shard of each dense config phases 4d
     and 4e-4f train (yi-6b at 8 layers, 1,908,539,392 elements;
     gemma2-9b at 4, 1,710,358,528; qwen2-vl-7b at 4; deepseek-moe-16b
     at 3, 2,183,135,232; rwkv6-7b at 6), the plain versions over
     slices;
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
     then fp32 steps at 2 of its 12 layers, B=2 x S=128, held against
     the port's plain path on
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
     one card; NeoX-1.5B at 12 of its 48, for the script's time) for 7
     steps, bf16, engine kernels, peak lr 1e-5, GNB
     refresh at steps 0, 3 and 6 on half the batch, exact launch counts,
     the loss finite and falling, plain and refresh p50, tokens/s, peak
     memory; served (NeoX-1.5B at 12 layers, stablelm-1.6b and NeoX-6.6B
     at 8, for the script's time since phase 4h joined it; 8 mixed
     requests over 8 slots, bf16 and int8 KV caches), the 2-layer
     model's decode on the card against the CPU.
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
     needs); served (bf16 and int8 caches), yi-6b at 4 of 32 layers,
     gemma2-9b at 6 of 42 (both fit at full depth; cut for the script's
     time since phases 4g and 4h joined it) and qwen1.5 at 6 of 80
     layers.  Each cut and its reason is logged.  Counts are zeroed
     before each run and read after: the step-0 check launches the CE and
     flash kernels, training the path's kernels exactly, serving decode
     attention once a layer a step;
  4e. qwen2-vl-7b (M-RoPE sections 16/24/24, 256 patch embeddings a
     sequence, QKV bias, GQA 28/4, untied vocab 152,064), random weights
     from a seed, on batches in Qwen2-VL's layout (``vlm_batch``: the
     patches first at t=0 with (h, w) on a 16 x 16 lattice, masked out of
     the loss, then text from position 16 in all three streams): step 0
     at 2 layers, fp32, B=1 x S=320 against the CPU (loss within 1e-5
     relative, every gradient, ``patch_proj``'s included, within 1e-4 of
     its leaf's largest element); Sophia-G trained as in 4c at 4 of 28
     layers, B=2 x S=2048; served at 8 of 28 layers (bf16 and int8
     caches; for the script's time since phase 4h joined it); the prefix
     cache at that depth, cold and warm engines over 8
     requests behind a 4-page prefix on 4 slots (the tokens identical, a
     hit rate above 0, at least 4 pages reused; TTFT p50 of each); and
     ``prefill`` of a 32,768-token prompt (the flash forward kernel once
     a layer; wall time and peak memory) with ``generate_lockstep`` for 8
     tokens (the decode kernel on the padded linear cache), held against
     the chunked prefill of the same prompt (chunks of 1024; the logits
     through ``init_slots`` and ``prefill_into_slot``, the tokens from the
     engine): the last-token logits within ``PREFILL_LOGIT_TOL`` and the
     tokens equal unless the lockstep's top-2 gap at the first difference
     is below it.
     Each cut and its reason is logged (``VLM_CUTS``);
  4f. deepseek-moe-16b (64 routed experts of d_ff 1408, top 6, and 2
     shared in all 28 layers; MHA 16 heads of hd 128; untied vocab
     102,400), random weights from a seed: one MoE FFN at full width,
     fp32, on 8,192 rows (two dispatch groups of 4,096, capacity binding)
     against the port's same function on the CPU (the expert choices
     equal but for near ties, the dropped entries as many, the output
     within 1e-5 of its largest element, aux within 1e-6); step 0 at 2
     layers against the CPU as in 4c, the expert sets of every token
     compared; Sophia-G trained as in 4c at 3 of 28 layers, B=2 x S=2048
     (aux, and the share of dropped token-expert entries at the first and
     the last step), and ``torch.profiler`` over one MoE FFN's forward and
     backward at that shape (its device time by kind, its share of the
     plain step); served at 4 of 28 layers (bf16 and int8 caches; cut
     for the script's time since phases 4g and 4h joined it; the decode
     kernel held on the engine's own cache; the card-vs-CPU decode check
     compares every call's routing and leaves out a slot whose token took
     other experts at a near tie), a profile window of one decode burst,
     and the prefix cache cold against warm at that depth.  Each cut and
     its reason is logged (``MOE_CUTS``);
  4g. rwkv6-7b (the RWKV-6 family: no attention; 32 layers of the
     chunked WKV with a data-dependent decay per channel, token shift and
     the channel mix; d 4096, 64 heads of 64, d_ff 14,336, untied vocab
     65,536), random weights from a seed: step 0 at full width, 2 layers,
     fp32, B=1 x S=64 against the CPU (the CE kernels and no attention
     kernel launched; the loss, every gradient, and the recurrent state
     after the forward within 1e-5 of each leaf's largest element), the
     serving route at that depth against the CPU (chunked prefill into 3
     slots, 6 decode steps with an inactive slot) and ``generate_lockstep``
     against the engine there in fp32 (the greedy tokens equal, the two
     routes' teacher-forced logits within ``RWKV_ROUTE_TOL_F32`` of the
     largest), the smoke config (d 128) likewise; Sophia-G trained as in 4c at 6 of 32 layers, B=2 x
     S=2048, with a profile of one plain step (CE kernels, projections,
     engine, the rest, idle) and of the chunked WKV's forward and
     backward alone at that shape; served at full depth, bf16, 8 mixed
     requests over 8 slots (tok/s, TTFT and TPOT p50, a profile of one
     decode burst), a reused slot against a fresh engine (the greedy
     tokens equal), and ``generate_lockstep`` on 2 prompts against the
     engine in fp64 (the greedy tokens equal, the routes within
     ``RWKV_ROUTE_TOL_F64``: in fp32 the random-init model amplifies the
     two routes' rounding to ~6% of the largest logit at 32 layers).
     Each cut and its
     reason is logged (``RWKV_CUTS``); phase 2 also holds the CE kernels
     at rwkv's loss shape (N 4096, D 4096, Vp 65,536, untied, rms) and
     rows 2-4 on its 1,849,032,704-element shard; and, served at full
     depth in bf16, the time to first token of 2 prompts of 32 tokens on
     the engine's batched prefill and on a per-token absorption
     (``rwkv_ttft_routes``);
  4h. recurrentgemma-2b (the Griffin family: 8 groups of two RG-LRU
     recurrent layers and one local-attention layer, window 2048, plus 2
     recurrent tail layers; d 2560, 10 query heads over one KV head of
     256, d_ff 7,680, tied vocab 256,000 with the embedding scale), random
     weights from a seed: step 0 at full width, one group and one tail
     layer, fp32, B=1 x S=64 against the CPU (the CE and flash kernels;
     the loss, every gradient and the recurrent state after the
     forward); Sophia-G trained as in 4c at the largest depth 3g + 2 that
     ``griffin_train_layers`` plans (11 of 26), B=2 x S=4096 (the window
     masks), with a profile of one plain step (CE, flash, engine,
     projections, the rest, idle) and of the RG-LRU's forward and
     backward alone; served (at 11 of 26 layers since phase 4i joined
     the script, for its time), bf16, 8 requests over 8 slots
     each decoding past position 2048 (the ring wraps; the decode kernel
     at group 10 in two head tiles, its launches counted exactly, and
     held against its plain version on the engine's wrapped ring), a
     profile of one decode burst, a reused slot against a fresh engine
     (the greedy tokens equal), and ``generate_lockstep`` on 2 prompts
     against the engine in fp32 (the greedy tokens equal, the routes
     within ``GRIFFIN_ROUTE_TOL_F32``).  Phase 2 also holds the decode
     kernel at its shape (N 8, C 2048, H 10, Hkv 1, hd 256, positions
     around the wrap) and at groups 9, 12 and 16, the CE kernels at its
     loss shape (N 8192, D 2560, Vp 256,000, tied, rms) and flash at its
     attention (B 2, H 10 over 1, S 4096, hd 256, window 2048); phase 5
     times them there.  The cuts and their reasons are logged;
  4i. seamless-m4t-medium (the encoder-decoder family: 12 bidirectional
     encoder layers over frame embeddings, 12 decoder layers with causal
     self-attention and cross-attention; d 1024, 16 heads of 64, GELU
     d_ff 4096, tied vocab 256,206 padded to 256,256), random weights from
     a seed: step 0 at 1 + 1 layers, fp32, B=1 x S_tgt=256 over 300
     frames against the CPU (the loss and every gradient, frame_proj's
     and the encoder's, which arrive only through the cross-attention's
     dK/dV, non-zero); Sophia-G trained at full depth (615,962,624
     parameters), B=4 x S_tgt=2048 over 3000 frames (the cross kernels at
     Sq != Sk, off the 64-row tile), exact launch counts, a profile of one
     plain step (CE, flash, engine, projections, the rest, idle) and the
     flash time split by CUDA events into the encoder's, the decoder's
     self- and the cross-attention; the serving routes against the CPU at
     2 + 2 layers in fp32; served at full depth, bf16, 9 requests of 1024
     frames over 8 slots (one with a 9-token prefix over two chunks, one
     in a freed slot), the encoder's flash forward and the decode kernel
     counted exactly, a profile of one decode burst, and in fp32 the
     engine's greedy tokens equal to ``prefill_encoder`` +
     ``decode_step``'s with the routes' logits within
     ``SM_ROUTE_TOL_F32``; ``prefill_encoder`` over 32,768 frames (wall,
     peak) and 8 decode steps against its 1.6 GB cross cache.  Phase 2
     also holds the CE kernels at its loss shape (N 8192, D 1024, V
     256,206, Vp 256,256, tied, rms: no padded column sampled, none with
     gradient), flash at the encoder's (B 4, S 3000, non-causal) and the
     cross-attention's shapes (Sq 2048, Sk 3000), the bidirectional
     forward at 32k over slices of its rows, and decode at its serving
     shape (N 8, H 16/16, hd 64, C 80); phase 5 times them there, and the
     decoder's self-attention (causal, S 2048);
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
     global layers (SDPA beside them without the softcap), at
     qwen2-vl's training shape and prefill heads, and the forward alone
     at the 32k prefill (B=1 H=28 Hkv=4 S=32768, SDPA beside it; its
     plain version cannot run over every row there), decode attention also at
     qwen2-vl's two shapes, the CE kernels at its loss shape, and all
     three at deepseek-moe-16b's shapes; each row's
     ``launches_models`` the launches of each model's runs.  A JSON line
     of the models' step times, memory, served tok/s and cuts comes
     before it.

  6. data parallel (``distributed/``, ``train/elastic.py``): the NCCL
     all-gather of 64 bytes at world size 1 timed (the launch time behind
     ``launch/roofline.py``); ``_quantize`` on the card against the CPU
     bit for bit over 2^24 elements at a seed past 2^31 and an offset near
     2^32; the compressed reduction over GPT-2 small's whole shard in 8
     buckets against one bucket bit for bit, timed and profiled; then
     ``python -m repro_torch.launch.train`` as a subprocess through NCCL
     at world size 1: GPT-2 small 12 steps at B=8 x S=1024, Sophia-G +
     GNB on the engine kernels, ``--compress-grads --compress-hess
     --comm-telemetry`` in 8 buckets, ``--elastic`` with an asynchronous
     checkpoint at step 8; the same command after step 12's checkpoint is
     removed, which must resume at step 8 and log the first run's losses
     bit for bit; the 12 steps uncompressed.  Each run's launch counts
     (its own process's) are exact.  A JSON line ``{"dp": ...}`` holds
     the step p50s, peaks and the compression's cost.

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
# recurrentgemma-2b's ring (C 2048): before, at and after its wrap
GRIFFIN_POS = [100, 2047, 2048, 5000, 0, 1500, 4095, 2100]
# seamless-m4t-medium's served slots (phase 4i): positions of a ring that
# never wraps
SEAMLESS_POS = [0, 9, 20, 33, 50, 64, 72, 71]
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
    # qwen2-vl-7b: group 7 (28 over 4) in the engine's ring, and the
    # lockstep decode's one row over the 32k prompt's linear cache
    "qwen2vl_hd128_c512": ((8, 28, 4, 512, 128), MAIN_POS),
    "qwen2vl_lockstep_c32776": ((1, 28, 4, 32776, 128), [32770]),
    # deepseek-moe-16b (phase 4f): 16 heads over 16 (group 1) at hd 128
    "deepseek_hd128_c512": ((8, 16, 16, 512, 128), MAIN_POS),
    # recurrentgemma-2b (phase 4h): 10 query heads over one KV head of 256
    # (two head tiles of 5) in the 2048-entry ring of its window, before
    # and after the ring wraps
    "recurrentgemma_hd256_c2048": ((8, 10, 1, 2048, 256), GRIFFIN_POS),
    # seamless-m4t-medium (phase 4i): the decoder's 16 heads over 16 at hd
    # 64 in the engine's ring of 80 (a 9-token prefix + 64 new, in pages
    # of 8), every position below it
    "seamless_hd64_c80": ((8, 16, 16, 80, 64), SEAMLESS_POS),
}
# the options a timed shape's model calls the kernel with (gemma2: its
# softcap and window, which a ring of 512 never reaches)
DECODE_KW = {"gemma2_hd256_c512": {"window": 4096, "softcap": 50.0}}


def phase_kernels(torch):
    """Returns {kernel name: max abs err at the main bf16 shape}."""
    from repro_torch.kernels.decode_attention import head_tiles, split_count

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
        # qwen2-vl-7b (phase 4e): group 7, the first that is not a power
        # of two at hd 128, in the engine's ring (C 512) and in the
        # lockstep decode's linear cache of the 32k prompt (one row, S 8
        # splits of a 32,776-row walk over 4 KV heads)
        ("qwen2vl_hd128_H28_Hkv4", DECODE_SHAPES["qwen2vl_hd128_c512"][0],
         DECODE_SHAPES["qwen2vl_hd128_c512"][1], {}),
        ("qwen2vl_lockstep_C32776", DECODE_SHAPES[
            "qwen2vl_lockstep_c32776"][0],
         DECODE_SHAPES["qwen2vl_lockstep_c32776"][1], {}),
        # deepseek-moe-16b (phase 4f): multi-head attention (group 1) at
        # hd 128 with 16 heads
        ("deepseek_hd128_H16_Hkv16", DECODE_SHAPES["deepseek_hd128_c512"][0],
         DECODE_SHAPES["deepseek_hd128_c512"][1], {}),
        # recurrentgemma-2b (phase 4h): group 10 at hd 256 in two head
        # tiles of 5 over its window's ring of 2048, positions around the
        # wrap; and groups of 9 (tiles of 5 and 4), 12 and 16 at hd 64,
        # 128 and 256
        ("recurrentgemma_hd256_H10_Hkv1_C2048", DECODE_SHAPES[
            "recurrentgemma_hd256_c2048"][0],
         DECODE_SHAPES["recurrentgemma_hd256_c2048"][1], {}),
        ("g9_hd64_C2048", (4, 18, 2, 2048, 64), [100, 2047, 2048, 5000], {}),
        ("g12_hd128_C2048", (4, 24, 2, 2048, 128), [100, 2047, 2048, 5000],
         {}),
        ("g16_hd256_C2048", (4, 32, 2, 2048, 256), [100, 2047, 2048, 5000],
         {}),
        # seamless-m4t-medium (phase 4i): 16 heads over 16 at hd 64
        ("seamless_hd64_H16_Hkv16_C80", DECODE_SHAPES["seamless_hd64_c80"][0],
         DECODE_SHAPES["seamless_hd64_c80"][1], {}),
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
                    f"S={split_count(N, Hkv, C, sms, head_tiles(H // Hkv))}"
                    f" tiles={head_tiles(H // Hkv)} {kw or ''}: "
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
    # qwen2-vl-7b's training batch (phase 4e: B 2 x S 2048, untied), the
    # first 256 rows of each sequence (its patches) masked out
    ("qwen2-vl-7b", dict(N=4096, D=3584, V=152064, Vp=152064, tied=False,
                         norm="rms", mask="patches")),
    # deepseek-moe-16b's training batch (phase 4f: B 2 x S 2048, untied)
    ("deepseek-moe-16b", dict(N=4096, D=2048, V=102400, Vp=102400,
                              tied=False, norm="rms")),
    # rwkv6-7b's training batch (phase 4g: B 2 x S 2048, untied)
    ("rwkv6-7b", dict(N=4096, D=4096, V=65536, Vp=65536, tied=False,
                      norm="rms")),
    # recurrentgemma-2b's training batch (phase 4h: B 2 x S 4096, tied)
    ("recurrentgemma-2b", dict(N=8192, D=2560, V=256000, Vp=256000,
                               tied=True, norm="rms")),
    # seamless-m4t-medium's target batch (phase 4i: B 4 x S 2048, tied):
    # 256,206 rows padded to 256,256, whose 50 padded columns no loss,
    # sampled label or dW may touch
    ("seamless-m4t-medium", dict(N=8192, D=1024, V=256206, Vp=256256,
                                 tied=True, norm="rms")),
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
    if mask == "patches":      # Qwen2-VL's rows: each sequence's patches
        m = (torch.arange(N, device="cuda") % VLM_SEQ >= VLM_PATCHES).float()
    else:
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
    rows_note = sampled_rows_check(torch, name, h, w, normp, opts,
                                   (lse_s, ll_s, y_k), tol)

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
        f"near a tie (< {NEAR_TIE}); {rows_note}")
    return errs


def sampled_rows_check(torch, name, h, w, normp, opts, whole, tol):
    """The sampled forward kernel on every other row with ``row_ids`` (a
    data-parallel rank's rows, the hash keyed on each row's index in the
    whole batch) against the same kernel's ``whole`` call at those rows:
    the drawn labels and their logits bit for bit, the log-sum-exp within
    ``tol`` (its vocab splits follow the row count).  Returns the log
    note."""
    from repro_torch.kernels import fused_ce as ce

    sel = torch.arange(1, h.shape[0], 2, device=h.device)
    lse, ll, y = ce.ce_forward_sampled(h[sel].contiguous(), w, normp,
                                       CE_SEED, row_ids=sel, **opts)
    torch.cuda.synchronize()
    lse_w, ll_w, y_w = (t[sel] for t in whole)
    if not (torch.equal(y, y_w) and torch.equal(ll, ll_w)):
        bad = int((y != y_w).sum())
        raise AssertionError(f"ce_forward_sampled {name}: with row_ids, "
                             f"{bad} of {sel.numel()} drawn labels (or "
                             f"their logits) differ from the whole call's")
    err = (lse - lse_w).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"ce_forward_sampled {name}: with row_ids, "
                             f"lse {err:.3g} from the whole call's > {tol}")
    return (f"with row_ids on {sel.numel()} rows: labels and logits bit "
            f"for bit, lse within {err:.3g}")


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
# qwen2-vl-7b (phase 4e): its training attention (B 2 x S 2048, GQA 28/4,
# group 7, hd 128), and its prefill's heads at S 4096 (all three kernels);
# the prefill runs the forward alone at S 32768, held over slices of its
# query rows (check_flash_forward_long)
QWEN2VL_ATTN = dict(B=2, H=28, Hkv=4, Sq=2048, Sk=2048, hd=128)
ATTN_VLM_SHAPES = (
    ("qwen2-vl-7b", QWEN2VL_ATTN),
    ("qwen2-vl-7b-prefill-heads", dict(QWEN2VL_ATTN, B=1, Sq=4096,
                                       Sk=4096)),
)
# deepseek-moe-16b (phase 4f): its training attention, B 2 x S 2048, 16
# heads over 16 at hd 128
ATTN_MOE_SHAPES = (
    ("deepseek-moe-16b", dict(B=2, H=16, Hkv=16, Sq=2048, Sk=2048, hd=128)),
)
# recurrentgemma-2b (phase 4h): its local attention, B 2 x S 4096, 10
# query heads over one KV head of 256, window 2048
ATTN_GRIFFIN_SHAPES = (
    ("recurrentgemma-2b", dict(B=2, H=10, Hkv=1, Sq=4096, Sk=4096, hd=256,
                               window=2048)),
)
# seamless-m4t-medium's decoder self-attention (phase 4i: causal, S 2048),
# timed in phase 5 beside the two below
SEAMLESS_SELF_SHAPES = (
    ("seamless-m4t-medium-self", dict(B=4, H=16, Hkv=16, hd=64, Sq=2048,
                                      Sk=2048)),
)
# seamless-m4t-medium (phase 4i): 16 heads over 16 at hd 64, B 4; the
# encoder's bidirectional attention over 3000 frames (off the 64-row tile)
# and the cross-attention of 2048 target rows over them (Sq != Sk); the
# decoder's self-attention (causal, S 2048) is timed in phase 5
SEAMLESS_ATTN = dict(B=4, H=16, Hkv=16, hd=64, causal=False)
ATTN_SEAMLESS_SHAPES = (
    ("seamless-m4t-medium-encoder", dict(SEAMLESS_ATTN, Sq=3000, Sk=3000)),
    ("seamless-m4t-medium-cross", dict(SEAMLESS_ATTN, Sq=2048, Sk=3000)),
)
PREFILL_S = 32768           # the prefill_32k serve path (configs/shapes.py)
ATTN_MAIN = dict(B=8, H=12, Hkv=12, Sq=1024, Sk=1024, hd=64, causal=True,
                 window=None, softcap=None, q_offset=0)
PREFILL_ATTN = dict(ATTN_MAIN, **dict(QWEN2VL_ATTN, B=1, Sq=PREFILL_S,
                                      Sk=PREFILL_S))
# seamless-m4t-medium's encoder over the 32k frames of prefill_32k:
# bidirectional, every row attends every key
SEAMLESS_LONG_ATTN = dict(ATTN_MAIN, **dict(SEAMLESS_ATTN, B=1, Sq=PREFILL_S,
                                            Sk=PREFILL_S))
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
    (f"{name}_B{sp['B']}_S{sp['Sq']}_H28_Hkv4", sp)
    for name, sp in ATTN_VLM_SHAPES] + [
    (f"{name}_B{sp['B']}_S{sp['Sq']}_H16_hd128", sp)
    for name, sp in ATTN_MOE_SHAPES] + [
    (f"{name}_B{sp['B']}_S{sp['Sq']}_H10_Hkv1_hd256_w2048", sp)
    for name, sp in ATTN_GRIFFIN_SHAPES] + [
    (f"{name}_B{sp['B']}_Sq{sp['Sq']}_Sk{sp['Sk']}_H16_noncausal", sp)
    for name, sp in ATTN_SEAMLESS_SHAPES] + [
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


LONG_ROWS = 256


def check_flash_forward_long(torch, name, spec):
    """The forward kernel at a prefill's length in bf16, where the plain
    version's scores over every row would take B*H*S^2*4 bytes: held over
    LONG_ROWS query rows at the start, the middle and the end, each
    against the plain version of that slice (``q_offset`` its first row,
    every key; causal, or bidirectional with ``causal=False`` as the
    encoder's): o within TOL of its largest element and each element
    within 2^-7 of its absolute sum (``contract_sums``); lse within the
    fp32 TOL of its largest element, since both sides compute it in fp32
    from the same bf16 q and k (the tensor cores' bf16 products are exact
    in their fp32 accumulator).  One 64-key tile dropped at S 32768 moves
    lse by 3.5e-4-8.2e-4 of its largest element and o by 10-23% of its
    largest (``tests/_flash_long_sensitivity.py``: the plain version
    without keys 8192-8255 on inputs of this kind): both bounds catch it.
    Returns the largest errors {"o", "lse"}."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v, _, kw = _attn_inputs(torch, spec, torch.bfloat16)
    o, lse = fa.flash_forward(q, k, v, **kw)
    S, tol = spec["Sq"], TOL["bfloat16"]
    errs, rel, shares = {"o": 0.0, "lse": 0.0}, {"o": 0.0, "lse": 0.0}, []
    starts = (0, S // 2 - LONG_ROWS // 2, S - LONG_ROWS)
    for r0 in starts:
        rows = slice(r0, r0 + LONG_ROWS)
        q_s, kw_s = q[:, :, rows], dict(kw, q_offset=kw["q_offset"] + r0)
        o_p, lse_p = fa.flash_forward_plain(q_s, k, v, **kw_s)
        pairs = {"o": (o[:, :, rows], o_p), "lse": (lse[:, :, rows], lse_p)}
        for key, (got, want) in pairs.items():
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"flash {name}: {key} not finite in "
                                     f"rows {r0}..{r0 + LONG_ROWS - 1}")
            e = (got.float() - want.float()).abs().max().item()
            errs[key] = max(errs[key], e)
            rel[key] = max(rel[key],
                           e / max(want.float().abs().max().item(), 1e-30))
        zeros = torch.zeros_like(q_s)
        sums = fa.contract_sums(q_s, k, v, zeros, pairs["lse"][0],
                                zeros[..., 0].float(), **kw_s)["o"]
        n_hard, share = fa.contract_misses(*pairs["o"], sums)
        del sums, o_p, lse_p
        if n_hard:
            raise AssertionError(f"flash {name} bf16: {n_hard} elements of o "
                                 f"in rows {r0}..{r0 + LONG_ROWS - 1} beyond "
                                 f"2^-7 of their absolute sum")
        shares.append(share)
    if not (rel["o"] <= tol and rel["lse"] <= TOL["float32"]):
        raise AssertionError(f"flash forward differs from its plain version "
                             f"({name}, bf16): errors relative to the "
                             f"largest element o {rel['o']} (limit {tol}), "
                             f"lse {rel['lse']} (limit {TOL['float32']})")
    log(f"[kernels] flash_attention {name} bfloat16 forward "
        + " ".join(f"{n}={spec[n]}" for n in ATTN_MAIN)
        + f", query rows {', '.join(f'{r}..{r + LONG_ROWS - 1}' for r in starts)}"
        f" against the plain version of each slice: max abs errors o "
        f"{errs['o']:.3g}, lse {errs['lse']:.3g}; relative to the largest "
        f"element o {rel['o']:.3g} (within {tol}), lse {rel['lse']:.3g} "
        f"(within {TOL['float32']}); every element of o within 2^-7 of its "
        f"absolute sum, share beyond 2^-9: "
        + ", ".join(f"{x:.3g}" for x in shares))
    del q, k, v, o, lse
    torch.cuda.empty_cache()
    return errs


def phase_flash_kernels(torch):
    """Returns {kernel name: max abs error at the training shape, bf16},
    and under "attn_fwd_long" the forward's {"o", "lse"} errors at the
    32k prefill's shape (causal), under "attn_fwd_long_noncausal" at the
    32k encoder's (bidirectional)."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for name, over in ATTN_CASES:
            errs = check_flash_case(torch, name, dict(ATTN_MAIN, **over),
                                    dtype)
            if name == "train_step" and dtype == torch.bfloat16:
                out = errs
    out["attn_fwd_long"] = check_flash_forward_long(
        torch, f"qwen2-vl-7b-prefill_B1_S{PREFILL_S}_H28_Hkv4",
        PREFILL_ATTN)
    out["attn_fwd_long_noncausal"] = check_flash_forward_long(
        torch, f"seamless-m4t-medium-encoder_B1_S{PREFILL_S}_H16_noncausal",
        SEAMLESS_LONG_ATTN)
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
    """Parameters of a dense, MoE, RWKV, Griffin or encoder-decoder config
    (the port's
    ``init_params`` leaves, norms and the padded vocabulary included,
    unlike the config's own ``param_count``): the engine's one fp32 shard
    is this rounded up to its block.  A MoE layer holds the router (D, E),
    E experts and the shared experts (SwiGLU, 3 D F each) in place of the
    MLP; with ``moe_every == 2`` every other layer is dense, ``dense_d_ff``
    wide.  An RWKV layer holds six D x D products (wr, wk, wv, wg, wo and
    the channel mix's wr, which the config's own count leaves out), the
    channel mix's D x F and F x D, the decay LoRA (2 x 64 D) and 12 D of
    mixes, norms, decays and bonuses.  A Griffin recurrent layer holds
    w_in, w_gate (D x W) and w_out, w_a and w_x (W x W, which the config's
    own count leaves out), the conv (cw x W), 4 W of biases and decays,
    two norms and the MLP; an attention layer (every third) the
    attention, two norms and the MLP.  An encoder-decoder holds
    ``frame_proj`` (D x D, which the config's own count leaves out, as it
    does the norms and the GELU MLP's biases), encoder layers of one
    attention, two norms and the MLP, decoder layers of two attentions,
    three norms and the MLP, and two final norms."""
    D, F, hd = cfg.d_model, cfg.d_ff, cfg.hd
    if cfg.family == "rwkv":
        layer = 6 * D * D + 2 * D * F + 2 * 64 * D + 12 * D
        embed = cfg.padded_vocab * D * (1 if cfg.tie_embeddings else 2)
        return embed + D + cfg.n_layers * layer
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    norm = D * (2 if cfg.norm_type == "ln" else 1)
    attn = 2 * D * H * hd + 2 * D * Hkv * hd
    attn += (H + 2 * Hkv) * hd if cfg.qkv_bias else 0

    def mlp(width):
        return (3 * D * width if cfg.activation in ("swiglu", "geglu")
                else 2 * D * width + width + D)

    if cfg.family == "griffin":
        W = cfg.rnn_width or D
        rec = (3 * D * W + 2 * W * W + cfg.conv_width * W + 4 * W + 2 * D
               + mlp(F))
        n_attn = cfg.n_layers // 3
        embed = cfg.padded_vocab * D * (1 if cfg.tie_embeddings else 2)
        return (embed + D + (cfg.n_layers - n_attn) * rec
                + n_attn * (attn + 2 * D + mlp(F)))

    if cfg.family == "encdec":
        embed = cfg.padded_vocab * D * (1 if cfg.tie_embeddings else 2)
        return (embed + D * D + 2 * D
                + cfg.n_encoder_layers * (attn + 2 * D + mlp(F))
                + cfg.n_layers * (2 * attn + 3 * D + mlp(F)))

    base = attn + norm * (4 if cfg.post_norms else 2)
    if cfg.family == "moe":
        moe = D * cfg.n_experts + 3 * D * F * (cfg.n_experts
                                               + cfg.n_shared_experts)
        n_moe = cfg.n_layers // cfg.moe_every
        dense = mlp(cfg.dense_d_ff or F if cfg.moe_every > 1 else F)
        layers = (cfg.n_layers * base + n_moe * moe
                  + (cfg.n_layers - n_moe) * dense)
    else:
        layers = cfg.n_layers * (base + mlp(F))
    embed = cfg.padded_vocab * D * (1 if cfg.tie_embeddings else 2)
    embed += cfg.max_position_embeddings * D if cfg.learned_pos else 0
    embed += D * D if cfg.patch_embed_input else 0         # patch_proj
    return embed + norm + layers


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
    from repro_torch.configs import get_config
    runs = [(name, cfg, layers) for name, cfg, _, layers, _
            in _dense_runs()] + [(VLM, get_config(VLM), VLM_TRAIN_LAYERS),
                                 (MOE, get_config(MOE), MOE_TRAIN_LAYERS),
                                 (RWKV, get_config(RWKV), RWKV_TRAIN_LAYERS)]
    for name, cfg, layers in runs:
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


# router probability gaps under which a MoE token may take another expert
# on the other device: with a float cache only the fp32 sums' order
# differs (~2e-8 of a probability of ~1/64, MOE_NEAR_TIE); an int8 cache
# element that rounds the other way moves by one quantization step, ~1e-3
# of the attention output, ~2e-5 of a router probability (10x: 2e-4)
CACHE_NEAR_TIE = {"bf16": 1e-6, "int8": 2e-4}


def check_against_cpu(torch, cfg, params, kv_dtype):
    """Decode on the card (kernel route) against the port's plain path on
    the CPU, same weights, fp32 compute: 3 slots prefilled with 24-token
    prompts, then 6 teacher-forced decode steps.  Returns the max abs logit
    difference.  Tolerance: 1e-3 for an fp32 cache (12 layers of fp32 sums
    in another order on each side), 2e-2 for int8 (a K/V element that
    lands on the other side of a rounding boundary on one device moves by
    one quantization step).  With MoE layers the routing of every call is
    compared: a slot whose token took another expert set on the card, at
    a near tie (gap below ``CACHE_NEAR_TIE``), leaves the logit check from
    then on (slots do not mix, so the others stay exact), and at least one
    slot must stay in it; a wider gap fails, and the flips are logged."""
    import numpy as np

    from repro_torch.models import get_model
    from repro_torch.models.moe import record_routing

    cfg32 = dataclasses.replace(cfg, dtype="float32", kv_dtype=kv_dtype)
    model = get_model(cfg32)
    cpu_params = copy.deepcopy(params).cpu()
    N, C, P = 3, 64, 16
    caches = {"cuda": model.init_slots(cfg32, N, C, "cuda"),
              "cpu": model.init_slots(cfg32, N, C, "cpu")}
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (N, 24)).astype(np.int32)
    err = np.zeros(N)
    flipped, flips = set(), []

    def both(fn):
        """fn(device, params) on each device, its routing recorded; the
        flips between the two."""
        out, calls = {}, {}
        for dev, p in (("cuda", params), ("cpu", cpu_params)):
            with record_routing() as calls[dev]:
                out[dev] = fn(dev, p).float().cpu()
        return out, expert_set_flips(torch, calls["cuda"], calls["cpu"])

    last = {}
    for s in range(N):
        for start in range(0, 24, P):
            chunk = prompts[s, start:start + P]
            n_valid = len(chunk)
            chunk = torch.from_numpy(np.pad(chunk, (0, P - n_valid)))[None]
            last, f = both(lambda dev, p: model.prefill_into_slot(
                cfg32, p, caches[dev], s, chunk.to(dev), start, n_valid))
            if f:
                flipped.add(s)
                flips += f
        err[s] = (last["cuda"] - last["cpu"]).abs().max().item()
        if s == 0:
            first = np.zeros((N, 1), np.int32)
        first[s, 0] = int(last["cpu"].argmax())
    tokens = first
    pos = np.full((N,), 24, np.int32)
    for _ in range(6):
        out, f = both(lambda dev, p: model.decode_slots(
            cfg32, p, caches[dev], torch.from_numpy(tokens).to(dev),
            torch.from_numpy(pos).to(dev))[:, 0])
        for _, t, _ in f:
            flipped.add(t)
        flips += f
        if not torch.isfinite(out["cuda"]).all():
            raise AssertionError("non-finite logits on the card")
        err = np.maximum(err, (out["cuda"] - out["cpu"]).abs().amax(-1)
                         .numpy())
        tokens = out["cpu"].argmax(-1).numpy().astype(np.int32)[:, None]
        pos = pos + 1
    wide = [f for f in flips if not f[2] < CACHE_NEAR_TIE[kv_dtype]]
    kept = [s for s in range(N) if s not in flipped]
    if wide or not kept:
        raise AssertionError(f"card vs CPU ({kv_dtype} cache): expert sets "
                             f"differ beyond near ties: {flips}")
    if flips:
        log(f"[models] card vs CPU ({kv_dtype} cache): {len(flips)} "
            f"token-layers took other experts on the card at near ties "
            f"(gaps {[round(g, 7) for _, _, g in flips]}, limit "
            f"{CACHE_NEAR_TIE[kv_dtype]}); slots {sorted(flipped)} left out "
            f"of the logit check (their err {err.max():.3g})")
    tol = 2e-2 if kv_dtype == "int8" else 1e-3
    worst = float(err[kept].max())
    if not worst <= tol:
        raise AssertionError(f"card vs CPU logits ({kv_dtype} cache): max "
                             f"abs err {worst} > {tol}")
    return worst


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


# the seven card-vs-CPU runs of phase 4 at GPT-2 small's width and
# CPU_TRAIN_LAYERS of its 12 layers (all 12 until phase 4i joined the
# script, cut for its time: on the H100's host they took 102 s at 12
# layers, most of it parameter-sized work on the CPU (the optimizer, the
# Hutchinson HVP), 7-25 s a run, whatever the tokens (S 64 saved none);
# every route, kernel and comparison is the same at any depth)
CPU_TRAIN_LAYERS = 2


def check_train_against_cpu(torch, cfg, name, over, steps=3):
    """``steps`` fp32 steps at B=2 x S=128 (refresh every 2 on 1 row) at
    CPU_TRAIN_LAYERS of the config's layers on the card (the kernels) and
    on the CPU (their plain versions), same
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

    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                n_layers=CPU_TRAIN_LAYERS)
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
    log(f"[train] card vs CPU plain path, {name}, fp32 {CPU_TRAIN_LAYERS} "
        f"layers, B=2 S=128, {steps} "
        f"step(s) (refresh at 0, 2 for the hessian-aware): losses {card} vs "
        f"{cpu}, max relative diff {rel:.3g}"
        + ("" if h_rel is None else
           f"; refreshed h within {h_rel:.3g} of its largest element")
        + f"; {time.perf_counter() - t0:.1f}s")
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
# (~2.0 B parameters, ~32 GB of state, B = 2 x S = 2048); its full depth
# (27.4 GB of fp32 weights) fits the card for serving, which
# ``SERVE_LAYERS`` cuts to 8 layers for the script's time
NEOX66_TRAIN_LAYERS = 8
# NeoX-1.5B trained and served at 12 of its 48 layers: at its full depth,
# with phase 4e, the script's [total] passed 900 s of its 1200 s limit on
# the H100; its kernels' shapes are the same at any depth
NEOX15_LAYERS = 12
# the depth each model is served at where it is cut; every model not
# named here is served at full depth.  qwen1.5-110b's 80 layers (421 GB of
# fp32 weights) do not fit the card; yi-6b, gemma2-9b and deepseek-moe-16b
# fit at full depth and were cut for the script's time limit when phase 4g
# joined it (deepseek's host-bound decode at ~110-140 ms a step took ~120
# s at full depth), and cut again when phase 4h joined it (~175 s on the
# H100, 111 s of it recurrentgemma-2b's 2,096 host-bound decode steps past
# its ring's wrap): yi-6b from 8 to 4, gemma2-9b from 10 to 6 (3 local and
# 3 global), deepseek-moe-16b from 7 to 4; those cuts saved ~10 s of the
# [total], 1100.4 s on the H100 with them, so stablelm-1.6b (24 layers),
# NeoX-6.6B (32) and qwen2-vl-7b (28; its prefix cache and 32k prefill
# too) are served at 8.  When phase 4i joined it the [total] read 1151.1 s
# on a slow host (1041.7 on another), 144 s of it recurrentgemma-2b's
# wrapped run at 26 layers: it is served at 11 (3 groups + 2 tail, its
# trained depth; the ring still wraps).  Decode is host-bound, so a
# served depth's cost is its layers; the kernels' shapes do not change
SERVE_LAYERS = {"neox-1.5b": NEOX15_LAYERS, "yi-6b": 4, "gemma2-9b": 6,
                "qwen1.5-110b": 6, "deepseek-moe-16b": 4,
                "stablelm-1.6b": 8, "neox-6.6b": 8, "qwen2-vl-7b": 8,
                "recurrentgemma-2b": 11}
CPU_CHECK_LAYERS, CPU_CHECK_S = 2, 64


def serve_config(name, cfg):
    """``cfg`` at the depth ``name`` is served at (``SERVE_LAYERS``); a cut
    is logged."""
    layers = SERVE_LAYERS.get(name, cfg.n_layers)
    if layers < cfg.n_layers:
        log(f"[models] {name}: served at {layers} of {cfg.n_layers} layers "
            f"(SERVE_LAYERS)")
    return dataclasses.replace(cfg, n_layers=layers)


def _model_runs():
    """(name, config, layers trained, batch rows) of each rope model."""
    from repro_torch.configs import get_config
    from repro_torch.configs.gpt2 import NEOX_1_5B, NEOX_6_6B

    return (("neox-1.5b", NEOX_1_5B, NEOX15_LAYERS, 4),
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


def expert_set_flips(torch, calls_a, calls_b):
    """The tokens whose expert set differs between two recordings of the
    same MoE calls (``models.moe.record_routing``), each with the gap
    between its k-th and (k+1)-th router probabilities in ``calls_b``:
    [(call, token, gap)]."""
    flips = []
    for i, (a, b) in enumerate(zip(calls_a, calls_b)):
        ea = a["expert_idx"].cpu().sort(dim=1).values
        eb = b["expert_idx"].cpu().sort(dim=1).values
        k = eb.shape[1]
        top = b["probs"].cpu().sort(dim=-1, descending=True).values
        gap = (top[:, k - 1] - top[:, k] if k < top.shape[1]
               else torch.full_like(top[:, 0], float("inf")))
        for t in torch.nonzero((ea != eb).any(dim=1))[:, 0].tolist():
            flips.append((i, t, gap[t].item()))
    return flips


def leaf_names(tree, prefix=""):
    """The names of ``flat_tensors(tree)``'s tensors, in its order (a
    stacked leaf's layers as ``name[i]``)."""
    out = []
    for key in sorted(tree):
        leaf = tree[key]
        if isinstance(leaf, dict):
            out += leaf_names(leaf, f"{prefix}{key}.")
        elif isinstance(leaf, (list, tuple)):
            out += [f"{prefix}{key}[{i}]" for i in range(len(leaf))]
        else:
            out.append(prefix + key)
    return out


def model_step0_against_cpu(torch, name, cfg, layers=CPU_CHECK_LAYERS,
                            batch=None, detail=None):
    """The step-0 loss and gradients at full width and ``layers`` layers,
    fp32, on ``batch`` (numpy; by default B=1 x S=64 random tokens and
    labels): the card (the flash kernels, the fused CE's fp32
    kernels, whose backward runs in D-slabs at these widths) against the
    CPU's plain path on the same weights.  The loss within 1e-5 relative
    and every leaf's gradient within 1e-4 of its largest element (fp32
    sums in other orders on each side).  The card's gradients stay on the
    card and cross to the host one leaf at a time, so the host holds one
    copy of the weights and of the gradients.  With MoE layers the expert
    sets of every token on the two devices are compared and the count of
    tokens that differ is logged.  ``detail``, a dict when given, receives
    each leaf's relative error (``leaf_rel``) and the largest magnitude of
    its CPU gradient (``leaf_scale``) by name.  Returns (the card params,
    max relative gradient error)."""
    import numpy as np

    from repro_torch.core.types import flat_tensors
    from repro_torch.models import get_model
    from repro_torch.models.moe import record_routing

    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, n_layers=layers, dtype="float32")
    model = get_model(cfg2)
    params = model.init_params(
        cfg2, torch.Generator(device="cuda").manual_seed(1))
    cpu_params = copy.deepcopy(params).cpu()
    if batch is None:
        rng = np.random.default_rng(4)
        batch = {k: rng.integers(0, cfg.vocab_size, (1, CPU_CHECK_S))
                 .astype(np.int32) for k in ("tokens", "labels")}
    out, routing = {}, {}
    for dev, p in (("cuda", params), ("cpu", cpu_params)):
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        with record_routing() as routing[dev]:
            loss, _ = model.loss_fn(cfg2, p, b, attn_impl="flash")
        grads = torch.autograd.grad(loss, flat_tensors(p.param_tree()))
        out[dev] = (loss.item(), grads)
    del cpu_params
    flips = expert_set_flips(torch, routing["cuda"], routing["cpu"])
    route_note = (f"; expert sets of {len(flips)} token-layers differ "
                  f"(gaps {[round(g, 9) for _, _, g in flips]})"
                  if routing["cpu"] else "")
    (l_card, g_card), (l_cpu, g_cpu) = out.pop("cuda"), out.pop("cpu")
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    rels = [(a.cpu() - b).abs().max().item()
            / max(b.abs().max().item(), 1e-30)
            for a, b in zip(g_card, g_cpu)]
    rel = max(rels)
    if detail is not None:
        names = leaf_names(params.param_tree())
        detail["leaf_rel"] = dict(zip(names, rels))
        detail["leaf_scale"] = {n: b.abs().max().item()
                                for n, b in zip(names, g_cpu)}
    mem = host_memory()
    del g_card, g_cpu
    if not (np.isfinite(l_card) and loss_rel <= 1e-5 and rel <= 1e-4):
        raise AssertionError(f"{name} step 0 card vs CPU: loss {l_card} vs "
                             f"{l_cpu} ({loss_rel:.3g} relative), gradients "
                             f"{rel:.3g} of their largest element"
                             f"{route_note}")
    shape = " x ".join(f"{k}={n}" for k, n in zip(
        "BS", batch["tokens"].shape))
    extra = "".join(f", {k} {tuple(batch[k].shape)}" for k in
                    ("patch_embeds", "positions", "mask", "frames")
                    if k in batch)
    log(f"[models] {name} step 0 at full width, {layers} layers "
        f"({param_count(cfg2):,} parameters), fp32, {shape}{extra}: "
        f"card loss {l_card:.6f}, CPU {l_cpu:.6f} ({loss_rel:.3g} relative, "
        f"within 1e-5); gradients within {rel:.3g} of each leaf's largest "
        f"element (limit 1e-4){route_note}; {mem}; "
        f"{time.perf_counter() - t0:.1f}s")
    return params, rel


def train_model(torch, name, cfg, B, peak_lr=MODEL_LR, S=MODEL_S,
                source=None, after=None):
    """Sophia-G (bf16 compute, engine kernels, peak lr MODEL_LR after 2
    warmup steps, GNB refresh every MODEL_K steps from step 0 on half the
    batch, at least one row) at B x S for MODEL_STEPS steps through the
    trainer.  Launch counts zeroed just before, read just after, held
    exactly; the loss finite and falling; the parameters and the engine's
    shard the sizes ``param_count`` and ``shard_size`` give (phase 2
    checked the engine kernels at that shard).  Batches from ``source``
    (numpy, ``batch_at``), by default the synthetic token stream.  With MoE
    layers the share of the loss's token-expert entries dropped at the
    first and the last step goes in the report.  ``after(state,
    train_step, batches)``, when given, runs on the trained state once the
    checks have passed and its dict joins the report.  Returns the
    report."""
    import numpy as np

    from repro_torch.data import DataConfig, make_source
    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
    from repro_torch.models.moe import record_routing
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
    src = source or make_source(DataConfig(seq_len=S, global_batch=B,
                                           vocab_size=cfg.vocab_size, seed=0))
    batches = [to_device_batch(src.batch_at(t), "cuda")
               for t in range(MODEL_STEPS)]
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times, losses, aux, dropped = [], [], [], []
    for t in range(MODEL_STEPS):
        t0 = time.perf_counter()
        with record_routing() as calls:
            state, metrics = train_step(state, batches[t], t % MODEL_K == 0)
        # the loss's forward (B x S rows; not the refresh's sub-batch)
        keep = [c["keep"] for c in calls
                if c["expert_idx"].shape[0] == B * S]
        if keep and t in (0, MODEL_STEPS - 1):
            dropped.append(sum(int((~k).sum()) for k in keep)
                           / sum(k.numel() for k in keep))
        del calls, keep
        losses.append(float(metrics["loss"]))
        aux.append(float(metrics["aux"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = dict(KERNEL_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_ref = len(range(0, MODEL_STEPS, MODEL_K))
    # RWKV has no attention: no flash kernel may launch; Griffin attends
    # in every third layer
    attn_layers = {"rwkv": 0, "griffin": cfg.n_layers // 3,
                   "encdec": cfg.n_encoder_layers + 2 * cfg.n_layers}.get(
        cfg.family, cfg.n_layers)
    attn = attn_layers * (MODEL_STEPS + n_ref)
    want = {"ce_forward": MODEL_STEPS, "ce_forward_sampled": n_ref,
            "ce_backward_dh": MODEL_STEPS + n_ref,
            "ce_backward_dw": MODEL_STEPS + n_ref,
            "attn_fwd": attn, "attn_bwd_dq": attn, "attn_bwd_dkv": attn,
            "sophia_step": MODEL_STEPS - n_ref, "sophia_refresh": n_ref}
    want = {k: n for k, n in want.items() if n}
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
                  launches=launches, losses=losses, aux=aux,
                  dropped_share=dropped,
                  plain_p50_ms=p50 * 1e3,
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
    if after is not None:
        report.update(after(state, train_step, batches))
    del state, batches
    torch.cuda.empty_cache()
    return report


MODEL_REQUESTS = 8


def serve_model(torch, name, cfg, small, params=None):
    """``cfg`` served at its depth with random weights from a seed (or
    ``params``, which the caller keeps): 8
    mixed requests over 8 slots with a bf16 and an int8 KV cache (every
    decode step launching the decode kernel once a layer), then the
    params of the step-0 check (``small``, 1-2 layers, held on the CPU
    while the model trains) decoded on the card against the CPU's plain
    path, and the decode kernel against its plain version on the engine's
    own cache (``check_engine_cache``).  Returns the report."""
    from repro_torch.models import get_model

    owned = params is None
    if owned:
        params = get_model(cfg).init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0))
    report = {}
    cfg2 = dataclasses.replace(cfg, n_layers=len(small.layers))
    small.cuda()
    for kv_dtype in ("bf16", "int8"):
        eng, secs, launches = serve_once(torch, cfg, params, kv_dtype,
                                         n_requests=MODEL_REQUESTS)
        st = eng.stats()
        cache_err = check_engine_cache(torch, eng)
        ref_err = check_against_cpu(torch, cfg2, small, kv_dtype)
        key = "decode_attention_q8" if kv_dtype == "int8" else \
            "decode_attention"
        report[kv_dtype] = dict(
            launches=launches[key],
            tok_per_s=st["tokens_emitted"] / secs,
            token_p50_ms=st["token_lat_p50_s"] * 1e3,
            ttft_p50_ms=st["ttft_p50_s"] * 1e3,
            tpot_p50_ms=st["tpot_p50_s"] * 1e3, cpu_logit_err=ref_err,
            engine_cache_err=cache_err)
        log(f"[models] {name} served: {cfg.n_layers} layers, kv={kv_dtype}: "
            f"{len(eng.results)} requests, {st['tokens_emitted']} tokens in "
            f"{secs:.3f}s = {st['tokens_emitted'] / secs:.1f} tok/s; token "
            f"p50 {st['token_lat_p50_s'] * 1e3:.3f} ms; ttft p50 "
            f"{st['ttft_p50_s'] * 1e3:.1f} ms; tpot p50 "
            f"{st['tpot_p50_s'] * 1e3:.3f} ms; launches {launches}; card "
            f"vs CPU logits ({cfg2.n_layers} layers, fp32) err "
            f"{ref_err:.3g}; engine-cache kernel err {cache_err:.3g}")
        del eng
    del small
    if owned:
        del params
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
    (NeoX-6.6B at NEOX66_TRAIN_LAYERS layers), serving at the depth
    ``SERVE_LAYERS`` gives (NeoX-1.5B trained and served at
    NEOX15_LAYERS).
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
        scfg = serve_config(name, cfg)
        served = serve_model(torch, name, scfg, small)
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
                             served_layers=scfg.n_layers,
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
             "gradient, m and h), B=2 as NeoX-6.6B; served at 4 of 32 "
             "layers (1.22 B; full depth fits the card; cut for the "
             "script's time limit, to 8 when phase 4g joined it and to 4 "
             "when 4h did)",
    "gemma2-9b": "trained at 4 of 42 layers (full depth ~148 GB of state) "
                 "at B=1 x S=8192, its context; served at 6 of 42 layers "
                 "(3 local and 3 global, 2.11 B; full depth fits the card; "
                 "cut for the script's time limit, to 10 when phase 4g "
                 "joined it and to 6 when 4h did)",
    "qwen1.5-110b": "not trained on the card (its embedding and unembedding "
                    "alone, 2.49 B parameters, take ~80 GB at ~32 bytes a "
                    "parameter); served at 6 of 80 layers (10.6 B "
                    "parameters, 42.6 GB fp32); step 0 at 1 layer (3.85 B)",
}


def _dense_runs():
    """(name, config, step-0 layers, layers trained or None, (B, S)) of
    each dense config; ``SERVE_LAYERS`` gives the layers served."""
    from repro_torch.configs import get_config

    return (("yi-6b", get_config("yi-6b"), 2, 8, (2, 2048)),
            ("gemma2-9b", get_config("gemma2-9b"), 2, 4, (1, 8192)),
            ("qwen1.5-110b", get_config("qwen1.5-110b"), 1, None, None))


def phase_dense_models(torch):
    """Each dense config: the step-0 card-vs-CPU check, Sophia-G training
    (where it fits), serving (bf16 and int8 caches).  Counts are zeroed
    before each run and read after: the step-0 check must launch the
    fp32 CE and flash kernels, training every kernel of the path exactly
    as ``train_model`` holds it, serving the decode kernel once a layer a
    step.  Returns {model: report}."""
    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts

    reports = {}
    for name, cfg, l0, layers, shape in _dense_runs():
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
        scfg = serve_config(name, cfg)
        served = serve_model(torch, name, scfg, small)
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
                             served_layers=scfg.n_layers,
                             full_layers=cfg.n_layers, cuts=DENSE_CUTS[name])
        log(f"[models] {name}: launches on its path {launches}; "
            f"{host_memory()}")
    return reports


# ---------------------------------------------------------------------------
# phase 4e: qwen2-vl-7b (M-RoPE, patch embeddings), the prefix cache, and
# the whole-prompt prefill with the lockstep decode at 32k


VLM_PATCHES, VLM_GRID = 256, 16     # one 16 x 16-patch image a sequence
VLM_B, VLM_SEQ = 2, 2048            # the training batch


def vlm_positions(S, n_patches=VLM_PATCHES, grid=VLM_GRID):
    """Qwen2-VL's M-RoPE position streams of one row, (3, S) int32
    (arXiv:2409.12191 §2.1): the image's patches first, at temporal
    position 0 with (height, width) on a ``grid``-wide lattice, then the
    text from the largest patch position + 1 in all three streams."""
    import numpy as np

    i = np.arange(n_patches)
    patch = np.stack([np.zeros_like(i), i // grid, i % grid])
    text = patch.max() + 1 + np.arange(S - n_patches)
    return np.concatenate([patch, np.broadcast_to(text, (3, text.size))],
                          axis=1).astype(np.int32)


def vlm_batch(cfg, B, S, seed, n_patches=VLM_PATCHES, grid=VLM_GRID,
              text=None):
    """A numpy training batch in Qwen2-VL's layout: the tokens and labels
    of ``text`` (a batch of the token stream; by default random ones),
    ``patch_embeds`` (B, P, D) fp32 standing in for the vision tower's
    output over the first P positions, the loss mask 0 there, and the
    (B, 3, S) positions of :func:`vlm_positions`, whose three streams
    differ over the patches (with three equal streams M-RoPE is plain
    rope)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if text is None:
        text = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
                for k in ("tokens", "labels")}
    mask = np.ones((B, S), np.float32)
    mask[:, :n_patches] = 0.0
    pos = vlm_positions(S, n_patches, grid)
    return {"tokens": text["tokens"], "labels": text["labels"], "mask": mask,
            "patch_embeds": rng.standard_normal(
                (B, n_patches, cfg.d_model)).astype(np.float32),
            "positions": np.broadcast_to(pos, (B, 3, S)).copy()}


class VLMSource:
    """``batch_at(t)``: :func:`vlm_batch` of step t over the synthetic
    token stream's batch t (the trainer's source protocol)."""

    def __init__(self, cfg, B, S, seed=0, n_patches=VLM_PATCHES,
                 grid=VLM_GRID):
        from repro_torch.data import DataConfig, make_source

        self.cfg, self.B, self.S, self.seed = cfg, B, S, seed
        self.n_patches, self.grid = n_patches, grid
        self.text = make_source(DataConfig(seq_len=S, global_batch=B,
                                           vocab_size=cfg.vocab_size,
                                           seed=seed))

    def batch_at(self, t):
        return vlm_batch(self.cfg, self.B, self.S, (self.seed, t),
                         self.n_patches, self.grid, self.text.batch_at(t))


VLM = "qwen2-vl-7b"
VLM_TRAIN_LAYERS = 4
VLM_STEP0_S = 320                   # 256 patches and 64 text tokens
# the cuts and their reasons: 16 bytes a parameter of fp32 weight,
# gradient, m and h (full depth, 7.63 B parameters: ~122 GB), ~32-34 at a
# step's peak (NeoX-6.6B's 67.93 GiB for 2.02 B parameters at 8 layers)
VLM_CUTS = ("trained at 4 of 28 layers (2.04 B parameters, 1.09 B of them "
            "the untied embeddings; full depth would hold ~122 GB of fp32 "
            "weight, gradient, m and h, ~244 GB at a step's peak) at B=2 x "
            "S=2048; step 0 vs the CPU at 2 layers (1.57 B, fp32) on one "
            "320-token row; served, the prefix cache and the 32k prefill "
            "at 8 of 28 layers (2.97 B parameters; full depth, 7.63 B, "
            "30.5 GB fp32, fits the card: cut for the script's time limit "
            "when phase 4h joined it)")
PREFIX_PAGE, PREFIX_SLOTS, PREFIX_REQUESTS = 16, 4, 8
PREFILL_NEW, PREFILL_PAGE = 8, 1024
# the whole-prompt prefill (flash forward, one pass) against the engine's
# chunked prefill (32 chunks of 1024, plain softmax attention over each
# slot's ring), both in bf16 through 28 layers: the routes round the
# attention differently (one bf16 rounding of o against the softmax
# weights rounded before w.v, ~2^-8 relative a layer) and their K/V
# products run at other shapes.  Each bf16 route lies ~0.07 from the fp32
# logits at 28 layers and widths 512-1024 (tests/_bf16_prefill_spread.py
# on the CPU), and so ~0.07 from the other; the random-weight model's
# logits reach ~4-5, where a bf16 ulp is 2^-6.  The last token's logits
# within 0.25 absolute, 3.5x that spread
PREFILL_LOGIT_TOL = 0.25


def _shared_prefix_requests(cfg, seed=11):
    """PREFIX_REQUESTS requests behind one prefix of 4 full pages and 3
    tokens (the reference's ``tests/test_prefix_cache.py`` stream), tails
    of 8..36 tokens, 8 new tokens each."""
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab_size, 4 * PREFIX_PAGE + 3)
    return [Request(uid=i, tokens=np.concatenate(
        [shared, rng.integers(0, cfg.vocab_size, 8 + 4 * i)]).astype(
            np.int32), max_new=8) for i in range(PREFIX_REQUESTS)]


def vlm_prefix_cache(torch, cfg, params, tag="vlm"):
    """Cold and warm (prefix cache on) engines at ``cfg``'s depth, bf16 and
    int8 caches, over the shared-prefix stream on PREFIX_SLOTS slots (the
    second wave of requests finds the first wave's pages): the greedy
    tokens identical, a hit rate above 0 and at least 4 pages reused,
    TTFT p50 of each; decode attention launched once a layer a step.
    Returns the report."""
    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
    from repro_torch.serve import ServeEngine

    report = {}
    for kv_dtype in ("bf16", "int8"):
        def engine(prefix):
            return ServeEngine(cfg, params, n_slots=PREFIX_SLOTS,
                               cache_len=512, page_len=PREFIX_PAGE,
                               steps_per_tick=8, seed=0, kv_dtype=kv_dtype,
                               prefix_cache=prefix, device="cuda")

        warm_up = engine(True)               # first calls off the clock
        for r in _shared_prefix_requests(cfg, seed=12)[:2]:
            warm_up.submit(r)
        warm_up.run()
        out, stats, launches, engines = {}, {}, {}, {}
        for mode in ("cold", "warm"):
            eng = engines[mode] = engine(mode == "warm")
            for r in _shared_prefix_requests(cfg):
                eng.submit(r)
            reset_launch_counts()
            out[mode] = {r.uid: r.tokens for r in eng.run()}
            torch.cuda.synchronize()
            launches[mode] = dict(KERNEL_LAUNCHES)
            stats[mode] = eng.stats()
            want = (cfg.n_layers * eng.decode_ticks * eng.steps_per_tick)
            key = ("decode_attention_q8" if kv_dtype == "int8"
                   else "decode_attention")
            if launches[mode] != {key: want}:
                raise AssertionError(f"prefix cache {mode} {kv_dtype}: "
                                     f"launches {launches[mode]} != "
                                     f"{ {key: want} }")
        st = stats["warm"]
        if out["cold"] != out["warm"]:
            bad = [u for u in out["cold"] if out["cold"][u] != out["warm"][u]]
            raise AssertionError(f"prefix cache {kv_dtype}: warm tokens "
                                 f"differ from cold for requests {bad}")
        if not (st["prefix_hit_rate"] > 0 and st["prefix_pages_reused"] >= 4):
            raise AssertionError(f"prefix cache {kv_dtype}: no reuse: {st}")
        hit_ttft = [r.ttft_s for r in engines["warm"].results
                    if r.uid >= PREFIX_SLOTS]
        report[kv_dtype] = dict(
            ttft_p50_cold_ms=stats["cold"]["ttft_p50_s"] * 1e3,
            ttft_p50_warm_ms=st["ttft_p50_s"] * 1e3,
            ttft_hits_p50_warm_ms=statistics.median(hit_ttft) * 1e3,
            hit_rate=st["prefix_hit_rate"],
            pages_reused=st["prefix_pages_reused"],
            inserts=st["prefix_inserts"], pool=st["prefix_pool_used"],
            launches=launches["warm"])
        log(f"[{tag}] prefix cache kv={kv_dtype}: {PREFIX_REQUESTS} requests "
            f"over {PREFIX_SLOTS} slots behind a {4 * PREFIX_PAGE + 3}-token "
            f"prefix, {cfg.n_layers} layers: warm tokens identical to cold; "
            f"hit rate {st['prefix_hit_rate']:.2f}, pages reused "
            f"{st['prefix_pages_reused']}, inserts {st['prefix_inserts']}, "
            f"pool {st['prefix_pool_used']}/{st['prefix_pool_pages']}; TTFT "
            f"p50 cold {report[kv_dtype]['ttft_p50_cold_ms']:.1f} ms, warm "
            f"{report[kv_dtype]['ttft_p50_warm_ms']:.1f} ms (the second "
            f"wave's, which hit: "
            f"{report[kv_dtype]['ttft_hits_p50_warm_ms']:.1f} ms); launches "
            f"{launches['warm']}")
    return report


def chunked_prefill_logits(torch, model, cfg, params, prompt, page):
    """The last token's logits (V,) fp32 after the engine's chunked
    prefill of ``prompt`` (S,) int32 into a fresh one-slot cache, ``page``
    tokens a chunk, driven through the model's slot protocol
    (``init_slots``, ``prefill_into_slot``) as the engine drives it."""
    S = prompt.shape[0]
    cache = model.init_slots(cfg, 1, -(-S // page) * page, "cuda")
    tokens = torch.from_numpy(prompt).cuda()
    for start in range(0, S, page):
        chunk = tokens[start:start + page]
        n_valid = chunk.shape[0]
        chunk = torch.nn.functional.pad(chunk, (0, page - n_valid))
        logits = model.prefill_into_slot(cfg, params, cache, 0, chunk[None],
                                         start, n_valid)
    return logits.float()


def _top2_gap(logits):
    top = logits.float().topk(2, dim=-1).values
    return (top[..., 0] - top[..., 1]).min().item()


def vlm_prefill_32k(torch, cfg, params):
    """The whole-prompt path at PREFILL_S tokens, B=1, ``cfg``'s depth, bf16:
    ``prefill`` (the flash forward kernel once a layer; its wall time and
    peak memory), then ``generate_lockstep`` for PREFILL_NEW tokens (the
    prefill again, then decode steps through the decode kernel on the
    padded linear cache), held against the chunked prefill of the same
    prompt (PREFILL_PAGE-token chunks; the logits from
    :func:`chunked_prefill_logits`, the tokens from the engine, which
    prefills so and decodes): the last token's logits within
    PREFILL_LOGIT_TOL and the tokens equal, unless
    the lockstep's own top-2 gap at the first differing step is below the
    tolerance.  Returns the report."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
    from repro_torch.models import get_model
    from repro_torch.serve import Request, ServeEngine, generate_lockstep

    model = get_model(cfg)
    S, L = PREFILL_S, cfg.n_layers
    prompt = np.random.default_rng(21).integers(
        0, cfg.vocab_size, (1, S)).astype(np.int32)
    tokens = torch.from_numpy(prompt).cuda()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill(cfg, params, tokens)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(KERNEL_LAUNCHES)
    if launches != {"attn_fwd": L}:
        raise AssertionError(f"prefill launches {launches} != "
                             f"{ {'attn_fwd': L} }")
    if not torch.isfinite(logits).all() or tuple(logits.shape) != (
            1, 1, cfg.padded_vocab):
        raise AssertionError(f"prefill logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")

    reset_launch_counts()
    t0 = time.perf_counter()
    lock = generate_lockstep(cfg, params, prompt, max_new=PREFILL_NEW)
    torch.cuda.synchronize()
    lock_s = time.perf_counter() - t0
    lock_launches = dict(KERNEL_LAUNCHES)
    want = {"attn_fwd": L, "decode_attention": L * (PREFILL_NEW - 1)}
    if lock_launches != want:
        raise AssertionError(f"lockstep launches {lock_launches} != {want}")

    eng = ServeEngine(cfg, params, n_slots=1, cache_len=S + PREFILL_NEW,
                      page_len=PREFILL_PAGE, steps_per_tick=PREFILL_NEW - 1,
                      seed=0, device="cuda")
    eng.submit(Request(uid=0, tokens=prompt[0], max_new=PREFILL_NEW))
    reset_launch_counts()
    t0 = time.perf_counter()
    eng_tokens = eng.run()[0].tokens
    torch.cuda.synchronize()
    eng_s = time.perf_counter() - t0
    eng_launches = dict(KERNEL_LAUNCHES)
    steps = eng.decode_ticks * eng.steps_per_tick
    if eng_launches != {"decode_attention": L * steps}:
        raise AssertionError(f"engine launches {eng_launches}")
    del eng
    chunked = chunked_prefill_logits(torch, model, cfg, params, prompt[0],
                                     PREFILL_PAGE)
    err = (logits[0, 0].float() - chunked).abs().max().item()
    scale = logits.float().abs().max().item()
    if not err <= PREFILL_LOGIT_TOL:
        raise AssertionError(f"32k prefill vs the engine's chunked prefill: "
                             f"last-token logits differ by {err} > "
                             f"{PREFILL_LOGIT_TOL} (largest |logit| {scale})")
    lock = lock[0].tolist()
    gap_note = "tokens equal"
    if lock != eng_tokens:
        i = next(j for j, (a, b) in enumerate(zip(lock, eng_tokens))
                 if a != b)
        # the lockstep's logits at step i: the prefill's, then i decode
        # steps over the lockstep's own tokens
        cache = {k: F.pad(v, (0, 0, 0, 0, 0, PREFILL_NEW))
                 for k, v in cache.items()}
        lg = logits[:, -1]
        for j in range(i):
            lg = model.decode_step(cfg, params, cache, torch.tensor(
                [[lock[j]]], dtype=torch.int32, device="cuda"), S + j)[:, -1]
        gap = _top2_gap(lg)
        if not gap < PREFILL_LOGIT_TOL:
            raise AssertionError(f"lockstep tokens {lock} != the engine's "
                                 f"{eng_tokens} from step {i}, where the "
                                 f"lockstep's top-2 gap {gap} >= "
                                 f"{PREFILL_LOGIT_TOL}")
        gap_note = (f"tokens differ from step {i}, where the lockstep's "
                    f"top-2 gap is {gap:.4g} < {PREFILL_LOGIT_TOL}")
    del cache
    torch.cuda.empty_cache()
    report = dict(S=S, prefill_s=prefill_s,
                  prefill_peak_gib=peak / 2 ** 30,
                  prefill_peak_above_weights_gib=(peak - base) / 2 ** 30,
                  lockstep_s=lock_s, engine_chunked_s=eng_s,
                  logit_err=err, logit_scale=scale,
                  top2_gap_first=_top2_gap(logits[:, -1]),
                  tokens_equal=lock == eng_tokens,
                  launches={"prefill": launches, "lockstep": lock_launches,
                            "engine": eng_launches})
    log(f"[vlm] prefill at S={S}, B=1, {L} layers, bf16: "
        f"{prefill_s * 1e3:.1f} ms ({S / prefill_s:.0f} tok/s), peak "
        f"{peak / 2 ** 30:.2f} GiB ({(peak - base) / 2 ** 30:.2f} above the "
        f"weights); generate_lockstep {PREFILL_NEW} tokens "
        f"{lock_s * 1e3:.1f} ms (its own prefill included); the engine's "
        f"chunked prefill ({S // PREFILL_PAGE} chunks of {PREFILL_PAGE}) and "
        f"decode {eng_s * 1e3:.1f} ms; last-token logits vs the engine's "
        f"within {err:.4g} (limit {PREFILL_LOGIT_TOL}; largest |logit| "
        f"{scale:.3f}, top-2 gap {report['top2_gap_first']:.4g}); "
        f"{gap_note}: lockstep {lock}, engine {eng_tokens}; launches "
        f"{report['launches']}")
    return report


def phase_vlm(torch):
    """qwen2-vl-7b (``get_config``: M-RoPE, patch embeddings, QKV bias,
    GQA 28/4, untied vocab 152,064), random weights from a seed: the
    step-0 check against the CPU on a patch batch, Sophia-G training on
    patch batches (``VLMSource``), serving (bf16 and int8 caches), the
    prefix cache, and the 32k prefill with the lockstep decode, with the
    cuts of ``VLM_CUTS``.  Counts are zeroed before each run and read
    after.  Returns {model: report}."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
    from repro_torch.models import get_model

    cfg = get_config(VLM)
    log(f"[vlm] {VLM}: {VLM_CUTS}")
    reset_launch_counts()
    small, rel = model_step0_against_cpu(
        torch, VLM, cfg, layers=CPU_CHECK_LAYERS,
        batch=vlm_batch(cfg, 1, VLM_STEP0_S, 4))
    missing = [k for k in STEP0_KERNELS if not KERNEL_LAUNCHES.get(k)]
    if missing:
        raise AssertionError(f"{VLM} step 0: kernels not launched: "
                             f"{missing}")
    small.cpu()
    torch.cuda.empty_cache()
    tcfg = dataclasses.replace(cfg, n_layers=VLM_TRAIN_LAYERS)
    trained = train_model(torch, VLM, tcfg, VLM_B, S=VLM_SEQ,
                          source=VLMSource(tcfg, VLM_B, VLM_SEQ))
    scfg = serve_config(VLM, cfg)
    params = get_model(scfg).init_params(
        scfg, torch.Generator(device="cuda").manual_seed(0))
    served = serve_model(torch, VLM, scfg, small, params=params)
    del small
    prefix = vlm_prefix_cache(torch, scfg, params)
    long = vlm_prefill_32k(torch, scfg, params)
    del params
    torch.cuda.empty_cache()
    launches = dict(trained["launches"])
    launches["decode_attention"] = served["bf16"]["launches"]
    launches["decode_attention_q8"] = served["int8"]["launches"]
    missing = [k for k in PATH_KERNELS if not launches.get(k)]
    if missing:
        raise AssertionError(f"{VLM}: kernels of the path not launched: "
                             f"{missing}")
    log(f"[vlm] {VLM}: launches on its path {launches}; {host_memory()}")
    return {VLM: dict(step0_grad_rel=rel, step0_layers=CPU_CHECK_LAYERS,
                      train=trained, serve=served, prefix_cache=prefix,
                      prefill_32k=long, launches=launches,
                      served_layers=scfg.n_layers,
                      full_layers=cfg.n_layers, cuts=VLM_CUTS)}


# ---------------------------------------------------------------------------
# phase 4f: deepseek-moe-16b (the MoE family: top 6 of 64 routed experts and
# 2 shared ones in every layer)


MOE = "deepseek-moe-16b"
MOE_TRAIN_LAYERS = 3
MOE_B, MOE_SEQ = 2, 2048
MOE_ROUTE_ROWS = 8192       # two dispatch groups of GROUP_SIZE = 4096
# a token whose k-th and (k+1)-th router probabilities lie this close may
# take the other expert on the other device: the fp32 router logits, sums
# over D = 2048 in other orders, differ by ~1e-6, which moves probabilities
# of ~1/64 by ~2e-8; 1e-6 is 50x that
MOE_NEAR_TIE = 1e-6
# the cuts and their reasons: 16 bytes a parameter of fp32 weight,
# gradient, m and h, ~36 at a step's peak (NeoX-6.6B's 67.93 GiB for 2.02 B
# parameters); each MoE layer holds 605 M parameters, 571 M of them experts
MOE_CUTS = ("trained at 3 of 28 layers (2.18 B parameters, 0.42 B of them "
            "the untied embeddings; full depth would hold ~270 GB of fp32 "
            "weight, gradient, m and h) at B=2 x S=2048; step 0 vs the CPU "
            "at 2 layers (1.60 B, fp32) on one 64-token row; served and the "
            "prefix cache at 4 of 28 layers (2.77 B parameters, 11.1 GB "
            "fp32; full depth, 16.88 B, fits the card, but its host-bound "
            "decode at ~110-140 ms a step took ~120 s of the script's time "
            "limit: cut to 7 when phase 4g joined it and to 4 when 4h "
            "did)")
# the ops of a MoE FFN's forward and backward by what they do (the
# profile of one layer at the training shape, where every op is the FFN's)
MOE_OP_KINDS = {
    "expert products": ("aten::bmm",),
    "router": ("aten::mm", "aten::_softmax", "aten::_softmax_backward_data"),
    "sort and slots": ("aten::sort", "aten::searchsorted", "aten::bincount",
                       "aten::scatter_", "aten::scatter", "aten::arange"),
    "dispatch and combine": ("aten::index_put_", "aten::_index_put_impl_",
                             "aten::index", "aten::gather",
                             "aten::scatter_add_", "aten::index_select",
                             "aten::where"),
}


def _moe_params(torch, p, device):
    return {k: (_moe_params(torch, v, device) if isinstance(v, dict)
                else v.to(device)) for k, v in p.items()}


def moe_routing_against_cpu(torch, cfg):
    """One MoE FFN at full width (64 experts at 2048 x 1408, top 6, 2
    shared), fp32, on MOE_ROUTE_ROWS rows (two dispatch groups, the card's
    only G > 1 case): the card against the port's same function on the
    CPU, same weights and inputs (N(0, 1) rows plus half of one shared
    N(0, 1) vector, which skews the load so that capacity binds).  The
    expert choices equal but for near ties (their gap below MOE_NEAR_TIE
    on the CPU, counted), the dropped entries as many, the output within
    1e-5 of its largest element on the tokens routed alike, aux within
    1e-6.  Returns the report."""
    import numpy as np

    from repro_torch.models import moe as tmoe

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p = tmoe.init_moe(torch.Generator().manual_seed(5), cfg32)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, MOE_ROUTE_ROWS // 2, cfg.d_model)).astype(
        np.float32)
    x += 0.5 * rng.standard_normal(cfg.d_model).astype(np.float32)
    out, secs = {}, {}
    for dev in ("cuda", "cpu"):
        pd = _moe_params(torch, p, dev)
        xd = torch.from_numpy(x).to(dev)
        if dev == "cuda":           # first calls off the clock
            tmoe.moe_ffn(pd, xd, cfg32)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad(), tmoe.record_routing() as calls:
            o, aux = tmoe.moe_ffn(pd, xd, cfg32)
            o, aux = o.cpu(), aux.item()
        secs[dev] = time.perf_counter() - t0
        out[dev] = (o, aux, calls)
        del pd, xd
    (o_card, aux_card, r_card), (o_cpu, aux_cpu, r_cpu) = \
        out["cuda"], out["cpu"]
    flips = expert_set_flips(torch, r_card, r_cpu)
    wide = [f for f in flips if not f[2] < MOE_NEAR_TIE]
    if wide:
        raise AssertionError(f"MoE routing: {len(wide)} tokens choose other "
                             f"experts on the card, gaps {wide[:8]} >= "
                             f"{MOE_NEAR_TIE}")
    drops = {d: int((~r[0]["keep"]).sum()) for d, r in (("cuda", r_card),
                                                       ("cpu", r_cpu))}
    if not flips and drops["cuda"] != drops["cpu"]:
        raise AssertionError(f"MoE routing: dropped entries {drops}")
    alike = torch.ones(o_cpu.shape[0] * o_cpu.shape[1], dtype=torch.bool)
    alike[[t for _, t, _ in flips]] = False
    a = o_card.reshape(-1, cfg.d_model)[alike]
    b = o_cpu.reshape(-1, cfg.d_model)[alike]
    scale = b.abs().max().item()
    err = (a - b).abs().max().item()
    aux_err = abs(aux_card - aux_cpu)
    if not (torch.isfinite(o_card).all() and err <= 1e-5 * scale
            and aux_err <= 1e-6):
        raise AssertionError(f"MoE FFN card vs CPU: output err {err} "
                             f"(largest {scale}), aux {aux_card} vs "
                             f"{aux_cpu}")
    n = MOE_ROUTE_ROWS * cfg.moe_top_k
    report = dict(rows=MOE_ROUTE_ROWS, groups=MOE_ROUTE_ROWS // 4096,
                  dropped=drops, dropped_share=drops["cpu"] / n,
                  flips=len(flips), out_err_rel=err / scale,
                  aux=aux_cpu, aux_err=aux_err,
                  card_ms=secs["cuda"] * 1e3, cpu_ms=secs["cpu"] * 1e3)
    log(f"[moe] routing at full width ({cfg.n_experts} experts of "
        f"{cfg.d_model} x {cfg.d_ff}, top {cfg.moe_top_k}, "
        f"{cfg.n_shared_experts} shared), fp32, {MOE_ROUTE_ROWS} rows in "
        f"{report['groups']} groups: expert sets of {len(flips)} tokens "
        f"differ from the CPU's (near ties, gaps "
        f"{[round(g, 10) for _, _, g in flips]}); dropped entries card "
        f"{drops['cuda']}, CPU {drops['cpu']} of {n} "
        f"({report['dropped_share']:.4f}); output within "
        f"{report['out_err_rel']:.3g} of its largest element (limit 1e-5); "
        f"aux {aux_card:.8f} vs {aux_cpu:.8f} (err {aux_err:.3g}, limit "
        f"1e-6); one call {secs['cuda'] * 1e3:.1f} ms on the card, "
        f"{secs['cpu'] * 1e3:.0f} ms on the CPU")
    return report


def moe_ffn_profile(torch, cfg, T=MOE_B * MOE_SEQ):
    """torch.profiler over one MoE FFN's forward and backward at the
    training shape (T rows, bf16, full width, gradients of x and of every
    weight): its device time by op, summed into MOE_OP_KINDS (the rest:
    casts and elementwise ops).  Returns {kind: device us}, the total and
    the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import moe as tmoe

    p = tmoe.init_moe(torch.Generator(device="cuda").manual_seed(7), cfg)
    for t in (p["router"], p["w_gate"], p["w_up"], p["w_down"],
              *p["shared"].values()):
        t.requires_grad_(True)
    x = torch.randn((1, T, cfg.d_model), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(8)
                    ).to(torch.bfloat16).requires_grad_(True)

    leaves = [p["router"], p["w_gate"], p["w_up"], p["w_down"],
              *p["shared"].values(), x]

    def fwd_bwd():          # torch.autograd.grad, as the trainer takes them
        out, aux = tmoe.moe_ffn(p, x, cfg)
        torch.autograd.grad(out.float().square().mean() + aux, leaves)

    fwd_bwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fwd_bwd()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if getattr(e, attr, None):
                return getattr(e, attr)
        return 0.0

    # the ops' own device time (the kernels they launched); the kernels'
    # entries of key_averages() carry the same time again, so leave them out
    by_op = {e.key: dev_us(e) for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CPU}
    total = sum(by_op.values())
    kinds = {k: sum(by_op.get(op, 0.0) for op in ops)
             for k, ops in MOE_OP_KINDS.items()}
    kinds["casts and elementwise"] = total - sum(kinds.values())
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    del p, x
    torch.cuda.empty_cache()
    return dict(T=T, total_us=total, wall_us=wall * 1e6, kinds_us=kinds,
                top_ops_us=[[k, v] for k, v in top])


def moe_train(torch, cfg):
    """Sophia-G at MOE_TRAIN_LAYERS layers through ``train_model`` (its
    exact launch counts, the loss finite and falling), the routing of the
    loss's forward recorded at the first and the last step (the share of
    token-expert entries dropped), and the MoE FFN's share of a plain step
    (``moe_ffn_profile`` x the layers against the plain step's p50).
    Returns the report."""
    tcfg = dataclasses.replace(cfg, n_layers=MOE_TRAIN_LAYERS)
    trained = train_model(torch, MOE, tcfg, MOE_B, S=MOE_SEQ)
    prof = moe_ffn_profile(torch, cfg)
    step_us = trained["plain_p50_ms"] * 1e3
    moe_us = prof["total_us"] * MOE_TRAIN_LAYERS
    trained.update(moe_ffn_profile=prof,
                   moe_share_of_plain_step=moe_us / step_us)
    first, last = trained["dropped_share"]
    log(f"[moe] {MOE} trained: aux {trained['aux'][0]:.6f} -> "
        f"{trained['aux'][-1]:.6f}; dropped token-expert entries "
        f"{first:.4f} at step 0, {last:.4f} at step {MODEL_STEPS - 1}")
    log(f"[moe] MoE FFN forward + backward at T={prof['T']} bf16 (one "
        f"layer, torch.profiler): device {prof['total_us']:.0f} us, wall "
        f"{prof['wall_us']:.0f} us; by kind "
        + ", ".join(f"{k} {v:.0f} us ({v / prof['total_us']:.1%})"
                    for k, v in prof["kinds_us"].items())
        + f"; x {MOE_TRAIN_LAYERS} layers = {moe_us / 1e3:.1f} ms, "
        f"{trained['moe_share_of_plain_step']:.1%} of the plain step's p50 "
        f"{trained['plain_p50_ms']:.1f} ms; top ops {prof['top_ops_us']}")
    return trained


def moe_decode_profile(torch, cfg, params, n_slots=8, prompt=64):
    """torch.profiler over one decode burst (``steps_per_tick`` 8 steps of
    ``n_slots`` slots, bf16 cache) of the served model at its depth, every
    slot decoding (``launch/profile_serve.py``'s window): wall, device busy
    and idle share, the decode kernel's and the expert products' device
    time, the top kernels.  Returns the window."""
    import numpy as np

    from repro_torch.launch.profile_serve import profile_window
    from repro_torch.serve import Request, ServeEngine

    rng = np.random.default_rng(9)
    eng = ServeEngine(cfg, params, n_slots=n_slots, cache_len=512,
                      page_len=16, steps_per_tick=8, seed=0, device="cuda")
    for i in range(n_slots):
        eng.submit(Request(uid=i, tokens=rng.integers(0, cfg.vocab_size,
                                                      prompt), max_new=64))
    while eng.tokens_emitted < n_slots:
        eng.tick()
    eng.tick()
    win = profile_window(f"decode burst ({MOE}, {cfg.n_layers} layers, 8 "
                         f"steps x {n_slots} slots, kv=bf16)", eng.tick,
                         match="decode_attention", also=("gemm", "elementwise",
                                                         "copy"))
    del eng
    torch.cuda.empty_cache()
    log("[profile] " + json.dumps(win))
    return win


def phase_moe(torch):
    """deepseek-moe-16b (``get_config``: 64 routed experts top 6 and 2
    shared in all 28 layers, MHA 16 heads of hd 128, untied vocab 102,400),
    random weights from a seed: the MoE FFN's routing against the CPU at
    full width over two dispatch groups, the step-0 check against the CPU
    at 2 layers (the expert sets of every token compared), Sophia-G
    training at MOE_TRAIN_LAYERS layers (``moe_train``), serving at
    ``SERVE_LAYERS`` (bf16 and int8 caches, the decode kernel on the
    engine's own cache) and the prefix cache cold against warm there, with
    the cuts of ``MOE_CUTS``.  Counts are zeroed before each run and read
    after.  Returns {model: report}."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
    from repro_torch.models import get_model

    cfg = get_config(MOE)
    log(f"[moe] {MOE}: {MOE_CUTS}")
    routing = moe_routing_against_cpu(torch, cfg)
    reset_launch_counts()
    small, rel = model_step0_against_cpu(torch, MOE, cfg,
                                         layers=CPU_CHECK_LAYERS)
    missing = [k for k in STEP0_KERNELS if not KERNEL_LAUNCHES.get(k)]
    if missing:
        raise AssertionError(f"{MOE} step 0: kernels not launched: "
                             f"{missing}")
    small.cpu()
    torch.cuda.empty_cache()
    trained = moe_train(torch, cfg)
    scfg = serve_config(MOE, cfg)
    params = get_model(scfg).init_params(
        scfg, torch.Generator(device="cuda").manual_seed(0))
    served = serve_model(torch, MOE, scfg, small, params=params)
    del small
    decode_profile = moe_decode_profile(torch, scfg, params)
    prefix = vlm_prefix_cache(torch, scfg, params, tag="moe")
    del params
    torch.cuda.empty_cache()
    launches = dict(trained["launches"])
    launches["decode_attention"] = served["bf16"]["launches"]
    launches["decode_attention_q8"] = served["int8"]["launches"]
    missing = [k for k in PATH_KERNELS if not launches.get(k)]
    if missing:
        raise AssertionError(f"{MOE}: kernels of the path not launched: "
                             f"{missing}")
    log(f"[moe] {MOE}: launches on its path {launches}; {host_memory()}")
    return {MOE: dict(step0_grad_rel=rel, step0_layers=CPU_CHECK_LAYERS,
                      routing=routing, train=trained, serve=served,
                      decode_profile=decode_profile,
                      prefix_cache=prefix, launches=launches,
                      served_layers=scfg.n_layers,
                      full_layers=cfg.n_layers, cuts=MOE_CUTS)}


# ---------------------------------------------------------------------------
# phase 4g: rwkv6-7b (the RWKV-6 family: the chunked WKV with a
# data-dependent decay, the bounded-state slot protocol)


RWKV = "rwkv6-7b"
RWKV_TRAIN_LAYERS = 6
RWKV_B, RWKV_SEQ = 2, 2048
# the cuts and their reasons: 16 bytes a parameter of fp32 weight,
# gradient, m and h, ~32-34 at a step's peak (deepseek-moe-16b's 73.27 GiB
# for 2.18 B parameters); each layer holds 218.7 M parameters
RWKV_CUTS = ("trained at 6 of 32 layers (1.85 B parameters, 0.54 B of them "
             "the untied embeddings; full depth, 7.53 B, would hold ~120 GB "
             "of fp32 weight, gradient, m and h, ~250 GB at a step's peak) "
             "at B=2 x S=2048; step 0 vs the CPU at 2 layers (0.97 B, fp32) "
             "on one 64-token row; served at full depth (32 layers, 7.53 B "
             "parameters, 30.1 GB fp32)")
# the kernels of RWKV's path: rows 2, 4, 11, 12, 14 and 15 (no attention)
RWKV_PATH_KERNELS = ("sophia_step", "sophia_refresh", "ce_forward",
                     "ce_forward_sampled", "ce_backward_dh", "ce_backward_dw")
RWKV_STEP0_KERNELS = ("ce_forward", "ce_backward_dh", "ce_backward_dw")
# The engine's serving route (``prefill_into_slot``, each chunk's
# projections batched over its tokens, then ``decode_slots``) and the
# lockstep's (``decode_step``, one token at a time) compute one function
# and round it differently: their products run at other shapes.  At 32
# random-init layers the model multiplies that rounding by ~1e5-1e6: in
# fp32 the two routes' logits differed by 2.5-6% of the largest on the
# H100, and an fp32 bound gave way each time it was set from a measured
# spread.  So the routes are held to each other twice, each time with
# their greedy tokens equal: at CPU_CHECK_LAYERS in fp32, within
# RWKV_ROUTE_TOL_F32 of the largest logit (the card's serving route lies
# ~2e-6 from the CPU's there), and at full depth in fp64 (``dtype=
# "float64"``, every fp32 of the routes in fp64), within
# RWKV_ROUTE_TOL_F64: the fp32 gap at 32 layers, <= 0.06, times the ratio
# of the two formats' epsilons, 2^-29, is 1.1e-10; the bound is ~100x
# that.  A wrong state or a token absorbed twice moves the logits by O(1).
RWKV_ROUTE_TOL_F32 = 1e-4
RWKV_ROUTE_TOL_F64 = 1e-8


def rwkv_step0_against_cpu(torch, name, cfg):
    """The step-0 check of ``model_step0_against_cpu`` (the CE kernels, no
    attention kernel) and, on the same weights and row, the recurrent state
    after the forward (the chunked WKV at S 64): each leaf on the card
    within 1e-5 of its largest element on the CPU.  Returns (the card
    params, max relative gradient error, max relative state error)."""
    import numpy as np

    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
    from repro_torch.models import get_model

    rng = np.random.default_rng(4)
    batch = {k: rng.integers(0, cfg.vocab_size, (1, CPU_CHECK_S))
             .astype(np.int32) for k in ("tokens", "labels")}
    reset_launch_counts()
    params, rel = model_step0_against_cpu(torch, name, cfg, batch=batch)
    launched = dict(KERNEL_LAUNCHES)
    missing = [k for k in RWKV_STEP0_KERNELS if not launched.get(k)]
    if missing or any(k.startswith("attn") for k in launched):
        raise AssertionError(f"{name} step 0 launches {launched}")
    cfg2 = dataclasses.replace(cfg, n_layers=len(params.layers),
                               dtype="float32")
    model = get_model(cfg2)
    states = {}
    for dev, p in (("cuda", params), ("cpu", copy.deepcopy(params).cpu())):
        with torch.no_grad():
            _, _, st = model.forward_hidden(
                cfg2, p, torch.from_numpy(batch["tokens"]).to(dev))
        states[dev] = {k: v.cpu() for k, v in st.items()}
        del p
    state_rel = max((states["cuda"][k] - v).abs().max().item()
                    / v.abs().max().item() for k, v in states["cpu"].items())
    if not state_rel <= 1e-5:
        raise AssertionError(f"{name} state after step 0's forward: "
                             f"{state_rel:.3g} of its largest element")
    log(f"[rwkv] {name} step 0: launches {launched} (no attention); the "
        f"state after the forward (tm_shift, cm_shift, wkv) within "
        f"{state_rel:.3g} of each leaf's largest element on the CPU (limit "
        f"1e-5)")
    return params, rel, state_rel


def wkv_profile(torch, cfg, B=RWKV_B, S=RWKV_SEQ):
    """torch.profiler over one layer's chunked WKV forward and backward at
    the training shape (fp32 r, k, v, log-decays (B, S, H, 64), the bonus
    u and a zero state, gradients of all of them, as the trainer takes
    them): its device time, kernel count and wall.  Returns the report."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile_serve import _busy_us, _device_events
    from repro_torch.models import rwkv as trwkv

    H, K = cfg.d_model // trwkv.HEAD_DIM, trwkv.HEAD_DIM
    gen = torch.Generator(device="cuda").manual_seed(9)

    def rand(*shape, scale=0.5):
        return (scale * torch.randn(shape, generator=gen, device="cuda")
                ).requires_grad_(True)

    r, k, v = (rand(B, S, H, K) for _ in range(3))
    logw = (-4.0 * torch.rand((B, S, H, K), generator=gen, device="cuda")
            ).clamp(-4.0, -1e-6).requires_grad_(True)
    u = rand(H, K, scale=0.1)
    state = torch.zeros((B, H, K, K), device="cuda")
    leaves = [r, k, v, logw, u]

    def fwd_bwd():
        o, s = trwkv.wkv_chunked(r, k, v, logw, u, state)
        torch.autograd.grad(o.square().mean() + s.square().mean(), leaves)

    fwd_bwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fwd_bwd()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _device_events(prof)
    total = sum(e - s for _, s, e in kernels)
    busy = _busy_us([(s, e) for _, s, e in kernels])
    del r, k, v, logw, u, state, leaves
    torch.cuda.empty_cache()
    return dict(B=B, S=S, H=H, chunks=S // trwkv.CHUNK,
                device_us=total, busy_us=busy, wall_us=wall * 1e6,
                kernels=len(kernels))


def step_profile(torch, state, train_step, batches):
    """torch.profiler over one plain step of the trained model: wall,
    device busy and idle, and the device time of the CE kernels
    (``::ce_``), the flash kernels (``flash_attn::``, none in RWKV), the
    engine (``sophia_update::``), the projections (the kernels of
    ``aten::mm`` and ``aten::addmm``, forward and backward: every x @ W of a
    (B, S, D) x lowers to mm) and the rest (the WKV or the RG-LRU, token
    shifts or convs, norms, gates, casts).  Returns {"profile":
    window}."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile_serve import _busy_us, _device_events

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, batches[1], False)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    kernels = _device_events(prof)
    busy = _busy_us([(s, e) for _, s, e in kernels])

    def named(part):
        return sum(e - s for n, s, e in kernels if part in n)

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            if getattr(e, attr, None):
                return getattr(e, attr)
        return 0.0

    mm = sum(dev_us(e) for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CPU
             and e.key in ("aten::mm", "aten::addmm"))
    total = sum(e - s for _, s, e in kernels)
    ce, engine = named("::ce_"), named("sophia_update::")
    flash = named("flash_attn::")
    win = dict(wall_us=wall, device_busy_us=busy,
               device_idle_share=1.0 - busy / wall, kernels=len(kernels),
               device_total_us=total, ce_us=ce, flash_us=flash,
               engine_us=engine, projections_us=mm,
               rest_us=total - ce - flash - engine - mm)
    if not (ce and engine):
        raise AssertionError(f"profile of a plain step: CE {ce} us, "
                             f"engine {engine} us")
    return {"profile": win}


def rwkv_serve_against_cpu(torch, cfg, params):
    """The serving route at full width and the step-0 check's depth, fp32,
    on the card (``params``) against the CPU (a copy): 3 slots prefilled
    with 24-token prompts in chunks of 16 (a full and a ragged chunk), then
    6 teacher-forced decode steps with slot 1 inactive in every other one.
    Every logit within 1e-4 of the largest and every state leaf within
    1e-4 of its largest element.  Returns the two errors."""
    import numpy as np

    from repro_torch.models import get_model

    cfg = dataclasses.replace(cfg, n_layers=len(params.layers),
                              dtype="float32")
    model = get_model(cfg)
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (3, 24)).astype(np.int32)
    toks = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 1))
                             .astype(np.int32)) for _ in range(6)]
    out = []
    for dev, p in (("cuda", params), ("cpu", copy.deepcopy(params).cpu())):
        st = model.init_slots(cfg, 3, 0, dev)
        logits = []
        for s in range(3):
            for start in (0, 16):
                chunk = prompts[s, start:start + 16]
                n = len(chunk)
                chunk = torch.from_numpy(np.pad(chunk, (0, 16 - n)))[None]
                logits.append(model.prefill_into_slot(
                    cfg, p, st, s, chunk.to(dev), start, n).cpu())
        pos = torch.zeros(3, dtype=torch.int32, device=dev)
        for step, tok in enumerate(toks):
            active = torch.tensor([True, step % 2 == 0, True], device=dev)
            logits.append(model.decode_slots(cfg, p, st, tok.to(dev), pos,
                                             active=active)[:, 0].cpu())
        out.append((torch.cat([x.reshape(-1) for x in logits]),
                    {k: v.cpu() for k, v in st.items()}))
        del p
    (got, st_got), (want, st_want) = out
    logit_rel = ((got - want).abs().max() / want.abs().max()).item()
    state_rel = max((st_got[k].float() - v.float()).abs().max().item()
                    / v.float().abs().max().item()
                    for k, v in st_want.items())
    if not (logit_rel <= 1e-4 and state_rel <= 1e-4):
        raise AssertionError(f"RWKV serving card vs CPU: logits "
                             f"{logit_rel:.3g}, state {state_rel:.3g} of "
                             f"their largest (limit 1e-4)")
    log(f"[rwkv] serving route card vs CPU ({cfg.n_layers} layers, full "
        f"width, fp32; 3 slots, chunked prefill and 6 decode steps, slot 1 "
        f"inactive in 3): logits within {logit_rel:.3g} of the largest, "
        f"the slot state within {state_rel:.3g} of each leaf's largest "
        f"(limit 1e-4)")
    return logit_rel, state_rel


def serving_routes(torch, cfg, params, prompts, tokens, page=16,
                device="cuda"):
    """The two serving routes teacher-forced over ``prompts`` (N, S) then
    ``tokens`` (N, T): the engine's (``prefill_into_slot`` in chunks of
    ``page`` into slot i, then ``decode_slots`` of all N at positions S,
    S + 1, ...) and the lockstep's (``decode_step`` of all N rows one
    token at a time from ``init_cache``).  Returns, (N, T) each, over each row's largest
    logit: the largest difference of the two routes' logits and the
    lockstep route's top-2 gap."""
    import numpy as np

    from repro_torch.models import get_model

    model = get_model(cfg)
    N, S = prompts.shape
    tokens = np.asarray(tokens, np.int32)
    seq = torch.from_numpy(np.concatenate([prompts, tokens], axis=1)).to(
        device)
    cache = model.init_cache(cfg, N, 0, device)
    lock = []
    for t in range(seq.shape[1] - 1):
        lg = model.decode_step(cfg, params, cache, seq[:, t:t + 1], t)
        if t >= S - 1:
            lock.append(lg[:, 0])
    lock = torch.stack(lock, dim=1)                     # (N, T, V)
    st = model.init_slots(cfg, N, 0, device)
    first = []
    for i in range(N):
        for start in range(0, S, page):
            chunk = prompts[i, start:start + page].astype(np.int32)
            n = len(chunk)
            chunk = torch.from_numpy(np.pad(chunk, (0, page - n)))[None]
            lg = model.prefill_into_slot(cfg, params, st, i,
                                         chunk.to(device), start, n)
        first.append(lg)
    eng = [torch.stack(first)]
    for t in range(tokens.shape[1] - 1):
        pos = torch.full((N,), S + t, dtype=torch.int32, device=device)
        eng.append(model.decode_slots(cfg, params, st,
                                      seq[:, S + t:S + t + 1], pos)[:, 0])
    eng = torch.stack(eng, dim=1)
    scale = lock.abs().amax(-1)
    top = lock.topk(2, dim=-1).values
    return (((eng - lock).abs().amax(-1) / scale).cpu().numpy(),
            ((top[..., 0] - top[..., 1]) / scale).cpu().numpy())


def lockstep_against_engine(torch, cfg, params, tol, seed, n=2, S=24,
                                 new=8, tag="rwkv"):
    """``generate_lockstep`` and a ServeEngine of ``n`` slots on ``n``
    prompts of ``S`` tokens, ``new`` greedy tokens each, in ``cfg``'s
    dtype on the card: the tokens equal, and the two routes
    (``serving_routes``, teacher-forced on the lockstep's tokens) within
    ``tol`` of the largest logit at every position.  Returns the
    report."""
    import numpy as np

    from repro_torch.serve import Request, ServeEngine, generate_lockstep

    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (n, S)).astype(np.int32)
    t0 = time.perf_counter()
    lock = generate_lockstep(cfg, params, prompts, max_new=new).tolist()
    lock_s = time.perf_counter() - t0
    eng = ServeEngine(cfg, params, n_slots=n, cache_len=512, page_len=16,
                      steps_per_tick=8, seed=0, device="cuda")
    for i in range(n):
        eng.submit(Request(uid=i, tokens=prompts[i], max_new=new))
    served = {r.uid: r.tokens for r in eng.run()}
    del eng
    diff, gap = serving_routes(torch, cfg, params, prompts, lock)
    worst = float(diff.max())
    where = np.unravel_index(int(diff.argmax()), diff.shape)
    equal = all(served[i] == lock[i] for i in range(n))
    what = (f"{cfg.n_layers} layers, {cfg.dtype}: generate_lockstep ({n} "
            f"prompts of {S}, {new} new, {lock_s:.2f}s) against the engine")
    if not (equal and worst <= tol):
        raise AssertionError(
            f"{what}: tokens {lock} vs {[served[i] for i in range(n)]}; the "
            f"routes' logits differ by up to {worst:.3g} of the largest at "
            f"(prompt, position) {tuple(map(int, where))} (limit {tol})")
    log(f"[{tag}] {what}: the greedy tokens equal; teacher-forced, the "
        f"routes' logits within {worst:.3g} of the largest (limit {tol}; "
        f"the smallest top-2 gap {float(gap.min()):.3g} of it)")
    return dict(layers=cfg.n_layers, dtype=cfg.dtype, tokens_equal=equal,
                route_rel=worst, route_rel_by_position=diff.tolist(),
                min_top2_gap=float(gap.min()), lockstep_s=lock_s)


def rwkv_serve(torch, cfg, params):
    """``cfg`` served at its depth, bf16: MODEL_REQUESTS mixed requests
    over 8 slots after a warm engine (every request its full budget of
    in-vocabulary tokens; no kernel of the port on this path), a profile
    window of one decode burst with every slot decoding; a slot reused
    (one slot, two requests) against a fresh engine for the second (the
    greedy tokens equal: the slot was zeroed); and
    ``lockstep_against_engine`` in fp64 within RWKV_ROUTE_TOL_F64.
    Returns the report."""
    import numpy as np

    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
    from repro_torch.launch.profile_serve import profile_window
    from repro_torch.serve import Request, ServeEngine

    def engine(n_slots=8):
        return ServeEngine(cfg, params, n_slots=n_slots, cache_len=512,
                           page_len=16, steps_per_tick=8, seed=0,
                           device="cuda")

    def run(eng, reqs):
        for r in reqs:
            eng.submit(r)
        return {r.uid: r.tokens for r in eng.run()}

    run(engine(), _requests(cfg, n=2, seed=7))     # first calls off the clock
    torch.cuda.synchronize()
    eng = engine()
    reqs = _requests(cfg, n=MODEL_REQUESTS)
    for r in reqs:
        eng.submit(r)
    reset_launch_counts()
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(KERNEL_LAUNCHES)
    budget = {r.uid: r.max_new for r in reqs}
    for r in results:
        if len(r.tokens) != budget[r.uid] or not all(
                0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request {r.uid}: {len(r.tokens)} tokens "
                                 f"for a budget of {budget[r.uid]}")
    if len(results) != len(reqs) or launches:
        raise AssertionError(f"{len(results)} of {len(reqs)} requests; "
                             f"launches {launches}")
    st = eng.stats()
    report = dict(layers=cfg.n_layers, tok_per_s=st["tokens_emitted"] / secs,
                  token_p50_ms=st["token_lat_p50_s"] * 1e3,
                  ttft_p50_ms=st["ttft_p50_s"] * 1e3,
                  tpot_p50_ms=st["tpot_p50_s"] * 1e3,
                  decode_steps=eng.decode_ticks * eng.steps_per_tick)
    log(f"[rwkv] {RWKV} served: {cfg.n_layers} layers, bf16, "
        f"{len(results)} requests over 8 slots, {st['tokens_emitted']} "
        f"tokens in {secs:.3f}s = {report['tok_per_s']:.1f} tok/s; token "
        f"p50 {report['token_p50_ms']:.3f} ms; ttft p50 "
        f"{report['ttft_p50_ms']:.1f} ms; tpot p50 "
        f"{report['tpot_p50_ms']:.3f} ms; {report['decode_steps']} decode "
        f"steps; launches {launches} (no kernel of the port on this path)")
    del eng

    # one decode burst, every slot decoding
    rng = np.random.default_rng(9)
    eng = engine()
    for i in range(8):
        eng.submit(Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, 16),
                           max_new=64))
    while eng.tokens_emitted < 8:
        eng.tick()
    eng.tick()
    win = profile_window(f"decode burst ({RWKV}, {cfg.n_layers} layers, 8 "
                         f"steps x 8 slots, bf16)", eng.tick, match="gemm",
                         also=("elementwise", "copy", "reduce"))
    log("[profile] " + json.dumps(win))
    report["decode_profile"] = win
    del eng

    # slot reuse: one slot, a request, then a second
    first, second = (Request(uid=i, tokens=rng.integers(0, cfg.vocab_size,
                                                        n), max_new=8)
                     for i, n in enumerate((40, 24)))
    reused = run(engine(n_slots=1), [first, second])
    fresh = run(engine(n_slots=1), [second])
    if reused[1] != fresh[1]:
        raise AssertionError(f"slot reuse: the second request's tokens "
                             f"{reused[1]} != a fresh engine's {fresh[1]}")
    report["reuse_tokens_equal"] = True
    log(f"[rwkv] slot reuse (a 40-token then a 24-token prompt, 8 new "
        f"each, one slot): the second request's {len(fresh[1])} greedy "
        f"tokens equal a fresh engine's")
    report["lockstep"] = lockstep_against_engine(
        torch, dataclasses.replace(cfg, dtype="float64"), params,
        RWKV_ROUTE_TOL_F64, seed=10)
    report["ttft_routes"] = rwkv_ttft_routes(torch, cfg, params)
    return report


def rwkv_ttft_routes(torch, cfg, params, n=2, S=32, page=16):
    """Time to first token of ``n`` prompts of ``S`` tokens, each alone,
    on two routes over the same prompts: the engine's (one slot,
    ``prefill_into_slot`` batched over each ``page``-token chunk, its
    ``ttft_s``) and a per-token absorption (``prefill_into_slot`` fed one
    token per call from a zeroed slot, then the first token's argmax,
    timed on the host to its read-back).  Each route once off the clock
    first.  Returns {"engine_ms": [...], "per_token_ms": [...], ...}."""
    import numpy as np

    from repro_torch.models import get_model
    from repro_torch.serve import Request, ServeEngine

    model = get_model(cfg)
    prompts = np.random.default_rng(13).integers(
        0, cfg.vocab_size, (n, S)).astype(np.int32)

    def engine_ttft(prompt):
        eng = ServeEngine(cfg, params, n_slots=1, cache_len=512,
                          page_len=page, steps_per_tick=8, seed=0,
                          device="cuda")
        eng.submit(Request(uid=0, tokens=prompt, max_new=1))
        res = eng.run()[0]
        return res.ttft_s * 1e3, res.tokens[0]

    def per_token_ttft(prompt):
        st = model.init_slots(cfg, 1, 0, "cuda")
        toks = torch.from_numpy(prompt).cuda()[None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(S):
            logits = model.prefill_into_slot(cfg, params, st, 0,
                                             toks[:, t:t + 1], t, 1)
        first = int(torch.argmax(logits))
        return (time.perf_counter() - t0) * 1e3, first

    engine_ttft(prompts[0])
    per_token_ttft(prompts[0])
    eng = [engine_ttft(p) for p in prompts]
    tok = [per_token_ttft(p) for p in prompts]
    out = dict(prompts=n, prompt_len=S, page=page,
               engine_ms=[t for t, _ in eng],
               per_token_ms=[t for t, _ in tok],
               first_tokens_equal=[a == b for (_, a), (_, b) in
                                   zip(eng, tok)])
    log(f"[rwkv] C7: TTFT of {n} prompts of {S} tokens, each alone, "
        f"{cfg.n_layers} layers, bf16: the engine's batched prefill "
        f"(chunks of {page}) {[round(t, 1) for t in out['engine_ms']]} ms; "
        f"per-token absorption {[round(t, 1) for t in out['per_token_ms']]}"
        f" ms; first tokens equal {out['first_tokens_equal']}")
    return out


def phase_rwkv(torch):
    """rwkv6-7b (``get_config``: 32 layers, d 4096, 64 heads of 64, d_ff
    14,336, untied vocab 65,536), random weights from a seed: step 0 at
    full width, 2 layers, fp32 against the CPU (the loss, every gradient
    and the state after the forward; then the serving route,
    ``rwkv_serve_against_cpu``, and the two serving routes against each
    other, ``lockstep_against_engine``), the smoke config (d 128)
    likewise;
    Sophia-G at RWKV_TRAIN_LAYERS layers, B=2 x S=2048, with the engine
    and CE kernels (exact launch counts; one profiled plain step split
    into CE kernels, projections, engine and the rest, beside the chunked
    WKV's own forward and backward x the layers); served at full depth
    (``rwkv_serve``).  Each cut and its reason is logged (``RWKV_CUTS``).
    Counts are zeroed before each run and read after.  Returns {model:
    report}."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    cfg = get_config(RWKV)
    log(f"[rwkv] {RWKV}: {RWKV_CUTS}")
    t0 = time.perf_counter()

    def lap(what):
        log(f"[rwkv] {what}: {time.perf_counter() - t0:.1f}s into 4g")

    small, rel, state_rel = rwkv_step0_against_cpu(torch, RWKV, cfg)
    serve_cpu = rwkv_serve_against_cpu(torch, cfg, small)
    routes = lockstep_against_engine(
        torch, dataclasses.replace(cfg, n_layers=len(small.layers),
                                   dtype="float32"), small,
        RWKV_ROUTE_TOL_F32, seed=6)
    del small
    torch.cuda.empty_cache()
    smoke = get_config(RWKV, smoke=True)
    _, smoke_rel, smoke_state_rel = rwkv_step0_against_cpu(
        torch, smoke.name, smoke)
    lap("checks against the CPU done")
    tcfg = dataclasses.replace(cfg, n_layers=RWKV_TRAIN_LAYERS)
    trained = train_model(torch, RWKV, tcfg, RWKV_B, S=RWKV_SEQ,
                          after=lambda *a: step_profile(torch, *a))
    wkv = wkv_profile(torch, cfg)
    lap("training and its profiles done")
    prof = trained["profile"]
    wkv_us = wkv["device_us"] * RWKV_TRAIN_LAYERS
    step_us = trained["plain_p50_ms"] * 1e3
    trained.update(wkv_profile=wkv, wkv_share_of_plain_step=wkv_us / step_us)
    log(f"[rwkv] plain step profile (6 layers, B={RWKV_B} x S={RWKV_SEQ}, "
        f"bf16): wall {prof['wall_us'] / 1e3:.1f} ms, device busy "
        f"{prof['device_busy_us'] / 1e3:.1f} ms, idle "
        f"{prof['device_idle_share']:.1%}, {prof['kernels']} kernels; CE "
        f"kernels {prof['ce_us'] / 1e3:.2f} ms, projections (mm) "
        f"{prof['projections_us'] / 1e3:.2f} ms, engine "
        f"{prof['engine_us'] / 1e3:.2f} ms, the rest "
        f"{prof['rest_us'] / 1e3:.2f} ms; the chunked WKV's forward + "
        f"backward alone (one layer, {wkv['chunks']} chunks): device "
        f"{wkv['device_us'] / 1e3:.2f} ms in {wkv['kernels']} kernels, wall "
        f"{wkv['wall_us'] / 1e3:.2f} ms; x {RWKV_TRAIN_LAYERS} layers = "
        f"{wkv_us / 1e3:.1f} ms, {trained['wkv_share_of_plain_step']:.1%} of "
        f"the plain step's p50 {trained['plain_p50_ms']:.1f} ms")
    params = get_model(cfg).init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    served = rwkv_serve(torch, cfg, params)
    del params
    torch.cuda.empty_cache()
    lap("serving done")
    launches = dict(trained["launches"])
    missing = [k for k in RWKV_PATH_KERNELS if not launches.get(k)]
    if missing:
        raise AssertionError(f"{RWKV}: kernels of the path not launched: "
                             f"{missing}")
    log(f"[rwkv] {RWKV}: launches on its path {launches}; {host_memory()}")
    return {RWKV: dict(step0_grad_rel=rel, step0_state_rel=state_rel,
                       serve_cpu_rel=serve_cpu, routes_step0=routes,
                       smoke_step0_grad_rel=smoke_rel,
                       smoke_step0_state_rel=smoke_state_rel,
                       step0_layers=CPU_CHECK_LAYERS, train=trained,
                       serve={"bf16": served}, launches=launches,
                       served_layers=cfg.n_layers, full_layers=cfg.n_layers,
                       cuts=RWKV_CUTS)}


# ---------------------------------------------------------------------------
# phase 4h: the Griffin family (recurrentgemma-2b)


GRIFFIN = "recurrentgemma-2b"
GRIFFIN_STEP0_LAYERS = 4           # one (rec, rec, attn) group + one tail
GRIFFIN_B, GRIFFIN_SEQ = 2, 4096   # the window of 2048 masks
# the training depth: the largest 3g + 2 (g groups and the config's two
# tail layers) whose parameters, at a step's peak of ~34 bytes each
# (rwkv6-7b's 62.06 GiB for 1.85 B parameters in phase 4g), hold at most
# GRIFFIN_PLAN_BYTES, leaving the rest of the card's 80 GB to the
# activations of B 2 x S 4096 (~2.5 GB a recurrent layer: its fp32 gates
# and RG-LRU terms; ~1.1 GB an attention layer).  ``param_count`` counts
# the module's leaves; ``train_model`` holds it to their numel.
GRIFFIN_BYTES_PER_PARAM = 34
GRIFFIN_PLAN_BYTES = 60e9
# the served requests all decode past position GRIFFIN_WRAP - 1 = 2111:
# the ring of 2048 wraps for each of them
GRIFFIN_WRAP = 2112
# The engine's serving route (``prefill_into_slot`` token by token through
# ``decode_slots``, the decode kernel; one row while a prompt is absorbed,
# N rows in a burst) and the lockstep's (``decode_step``, plain rolling
# attention, every row at once) compute one function in fp32 and round it
# differently.  On the CPU, at 26 layers and d 256 / 512, the two routes
# lie 4.3e-6 / 3.4e-6 of the largest logit apart and a one-ulp move of
# every weight moves the logits by 5.0e-6 / 3.5e-6
# (``tests/_griffin_spread.py --routes``): the random-init
# Griffin does not amplify rounding as RWKV's ``ln_x`` does, nor more with
# width.  The bound, set before the first run on the card, is ~10x the
# prediction (3e-6 to 3e-5); a token absorbed twice or a stale ring entry
# moves the logits by O(1).
GRIFFIN_ROUTE_TOL_F32 = 1e-4
# every kernel on recurrentgemma-2b's path: rows 1 (a bf16 ring; no int8
# cache), 2, 4, 11, 12, 14, 15 and 16-18
GRIFFIN_PATH_KERNELS = ("decode_attention", "sophia_step", "sophia_refresh",
                        "ce_forward", "ce_forward_sampled", "ce_backward_dh",
                        "ce_backward_dw", "attn_fwd", "attn_bwd_dq",
                        "attn_bwd_dkv")


def griffin_train_layers(cfg) -> int:
    """The largest depth 3g + 2 (g >= 1) that the plan fits."""
    g = 1
    while (param_count(dataclasses.replace(cfg, n_layers=3 * (g + 1) + 2))
           * GRIFFIN_BYTES_PER_PARAM <= GRIFFIN_PLAN_BYTES):
        g += 1
    return 3 * g + 2


def griffin_cuts(cfg, layers) -> str:
    return (f"trained at {layers} of {cfg.n_layers} layers "
            f"({(layers - 2) // 3} groups + 2 tail; "
            f"{param_count(dataclasses.replace(cfg, n_layers=layers)) / 1e9:.2f}"
            f" B parameters, 0.66 B of them the tied embedding; full depth, "
            f"{param_count(cfg) / 1e9:.2f} B, would hold ~"
            f"{param_count(cfg) * GRIFFIN_BYTES_PER_PARAM / 1e9:.0f} GB at a "
            f"step's peak) at B={GRIFFIN_B} x S={GRIFFIN_SEQ}; step 0 vs the "
            f"CPU at {GRIFFIN_STEP0_LAYERS} layers (one group + one tail, "
            f"fp32) on one {CPU_CHECK_S}-token row; served at "
            f"{SERVE_LAYERS[GRIFFIN]} of {cfg.n_layers} layers for the "
            f"script's time (full depth, {param_count(cfg) / 1e9:.2f} B "
            f"parameters, {param_count(cfg) * 4 / 1e9:.1f} GB fp32, fits "
            f"the card and was served until phase 4i joined the script)")


def griffin_step0_against_cpu(torch, cfg):
    """The step-0 check of ``model_step0_against_cpu`` at one group and one
    tail layer (the CE and flash kernels) and, on the same weights and
    row, the recurrent state after the forward (every recurrent layer's
    conv tail and h): each leaf on the card within 1e-5 of its largest
    element on the CPU.  Returns (the card params, max relative gradient
    error, max relative state error)."""
    import numpy as np

    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
    from repro_torch.models import get_model
    from repro_torch.models.griffin import flat_state

    rng = np.random.default_rng(4)
    batch = {k: rng.integers(0, cfg.vocab_size, (1, CPU_CHECK_S))
             .astype(np.int32) for k in ("tokens", "labels")}
    reset_launch_counts()
    params, rel = model_step0_against_cpu(
        torch, GRIFFIN, cfg, layers=GRIFFIN_STEP0_LAYERS, batch=batch)
    launched = dict(KERNEL_LAUNCHES)
    missing = [k for k in STEP0_KERNELS if not launched.get(k)]
    if missing:
        raise AssertionError(f"{GRIFFIN} step 0: kernels not launched: "
                             f"{missing} ({launched})")
    cfg2 = dataclasses.replace(cfg, n_layers=GRIFFIN_STEP0_LAYERS,
                               dtype="float32")
    model = get_model(cfg2)
    states = {}
    for dev, p in (("cuda", params), ("cpu", copy.deepcopy(params).cpu())):
        with torch.no_grad():
            _, _, st = model.forward_hidden(
                cfg2, p, torch.from_numpy(batch["tokens"]).to(dev),
                attn_impl="flash")
        states[dev] = {k: v.cpu() for k, v in flat_state(st).items()}
        del p
    state_rel = max((states["cuda"][k] - v).abs().max().item()
                    / v.abs().max().item() for k, v in states["cpu"].items())
    if not state_rel <= 1e-5:
        raise AssertionError(f"{GRIFFIN} state after step 0's forward: "
                             f"{state_rel:.3g} of its largest element")
    log(f"[griffin] {GRIFFIN} step 0: launches {launched}; the recurrent "
        f"state after the forward ({sorted(states['cpu'])}) within "
        f"{state_rel:.3g} of each leaf's largest element on the CPU (limit "
        f"1e-5)")
    return params, rel, state_rel


def rglru_profile(torch, cfg, B=GRIFFIN_B, S=GRIFFIN_SEQ):
    """torch.profiler over one recurrent layer's RG-LRU forward and
    backward at the training shape: fp32 u and the two gates (B, S, W) and
    lam, the scan's 12 doubling passes forward and back, gradients of all
    of them, as the trainer takes them: its device time, kernel count and
    wall.  Returns the report."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile_serve import _busy_us, _device_events
    from repro_torch.models import griffin as tg

    W = cfg.rnn_width or cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(9)
    u = torch.randn((B, S, W), generator=gen, device="cuda")
    r, i = (torch.rand((B, S, W), generator=gen, device="cuda")
            for _ in range(2))
    lam = torch.linspace(2.0, 5.0, W, device="cuda")
    leaves = [t.requires_grad_(True) for t in (u, r, i, lam)]

    def fwd_bwd():
        h, last = tg.rg_lru(u, r, i, lam)
        torch.autograd.grad(h.square().mean() + last.square().mean(),
                            leaves)

    fwd_bwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fwd_bwd()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _device_events(prof)
    total = sum(e - s for _, s, e in kernels)
    busy = _busy_us([(s, e) for _, s, e in kernels])
    del u, r, i, lam, leaves
    torch.cuda.empty_cache()
    return dict(B=B, S=S, W=W, device_us=total, busy_us=busy,
                wall_us=wall * 1e6, kernels=len(kernels))


def griffin_serve(torch, cfg, params):
    """``cfg`` served at its depth, bf16: MODEL_REQUESTS requests over 8
    slots after a warm engine, every request decoding past position
    GRIFFIN_WRAP - 1 (the ring of 2048 wraps), the decode kernel launched
    exactly once a group for every token a slot absorbs or decodes; the
    kernel against its plain version on the engine's own ring after the
    wrap; a profile window of one decode burst with every slot decoding;
    a slot reused (one slot, two requests) against a fresh engine for the
    second (the greedy tokens equal: the recurrent state was zeroed and
    the mask hides the old ring); ``generate_lockstep`` against the engine
    in fp32 within GRIFFIN_ROUTE_TOL_F32.  Returns the report."""
    import numpy as np

    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
    from repro_torch.launch.profile_serve import profile_window
    from repro_torch.models.griffin import n_groups
    from repro_torch.serve import Request, ServeEngine

    def engine(n_slots=8):
        return ServeEngine(cfg, params, n_slots=n_slots,
                           cache_len=GRIFFIN_WRAP, page_len=16,
                           steps_per_tick=8, seed=0, device="cuda")

    def run(eng, reqs):
        for r in reqs:
            eng.submit(r)
        return {r.uid: r.tokens for r in eng.run()}

    rng = np.random.default_rng(1)
    run(engine(), [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, 16),
                           max_new=8) for i in range(2)])  # off the clock
    torch.cuda.synchronize()
    reqs = []
    for i in range(MODEL_REQUESTS):
        prompt = rng.integers(0, cfg.vocab_size, int(rng.integers(16, 49)))
        reqs.append(Request(uid=i, tokens=prompt.astype(np.int32),
                            max_new=GRIFFIN_WRAP - len(prompt)))
    eng = engine()
    for r in reqs:
        eng.submit(r)
    reset_launch_counts()
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(KERNEL_LAUNCHES)
    for r in results:
        if len(r.tokens) != GRIFFIN_WRAP - len(reqs[r.uid].tokens) or not all(
                0 <= t < cfg.vocab_size for t in r.tokens):
            raise AssertionError(f"request {r.uid}: {len(r.tokens)} tokens")
    absorbed = sum(len(r.tokens) for r in reqs)
    steps = eng.decode_ticks * eng.steps_per_tick
    want = {"decode_attention": n_groups(cfg) * (steps + absorbed)}
    if len(results) != len(reqs) or launches != want:
        raise AssertionError(f"{len(results)} of {len(reqs)} requests; "
                             f"launches {launches} != {want} ({n_groups(cfg)}"
                             f" groups x ({steps} decode steps + {absorbed} "
                             f"prompt tokens))")
    # the last position each request wrote into its ring
    written = [len(reqs[r.uid].tokens) + len(r.tokens) - 2 for r in results]
    last = min(written)
    if not last >= cfg.local_window:
        raise AssertionError(f"the requests' last positions {written} do "
                             f"not pass the ring of {cfg.local_window}")
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((eng.n_slots, cfg.n_heads, cfg.hd), generator=gen,
                    device="cuda").to(cfg.compute_dtype)
    ring_err = check_decode_attention(torch, dict(
        q=q, k_cache=eng.state["kv"]["k"][0], v_cache=eng.state["kv"]["v"][0],
        positions=torch.from_numpy(eng._pos).cuda(), k_scale=None,
        v_scale=None), scale=1.0)[0]
    st = eng.stats()
    report = dict(layers=cfg.n_layers, tok_per_s=st["tokens_emitted"] / secs,
                  token_p50_ms=st["token_lat_p50_s"] * 1e3,
                  ttft_p50_ms=st["ttft_p50_s"] * 1e3,
                  tpot_p50_ms=st["tpot_p50_s"] * 1e3,
                  decode_steps=steps, launches=launches["decode_attention"],
                  last_position=last, engine_ring_err=ring_err)
    log(f"[griffin] {GRIFFIN} served: {cfg.n_layers} layers, bf16, "
        f"{len(results)} requests over 8 slots, each to position {last} "
        f"(the ring of {cfg.local_window} wrapped), {st['tokens_emitted']} "
        f"tokens in {secs:.3f}s = {report['tok_per_s']:.1f} tok/s; token "
        f"p50 {report['token_p50_ms']:.3f} ms; ttft p50 "
        f"{report['ttft_p50_ms']:.1f} ms; tpot p50 "
        f"{report['tpot_p50_ms']:.3f} ms; {steps} decode steps; launches "
        f"{launches} (= {n_groups(cfg)} groups x (decode steps + {absorbed} "
        f"prompt tokens)); the kernel on the engine's wrapped layer-0 ring "
        f"vs its plain version: max abs err {ring_err:.3g}")
    del eng

    # one decode burst, every slot decoding (4-token prompts: each prompt
    # token is a decode step of one row)
    eng = engine()
    for i in range(8):
        eng.submit(Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, 4),
                           max_new=64))
    while eng.tokens_emitted < 8:
        eng.tick()
    eng.tick()
    win = profile_window(f"decode burst ({GRIFFIN}, {cfg.n_layers} layers, "
                         f"8 steps x 8 slots, bf16)", eng.tick,
                         also=("gemm", "elementwise", "copy", "reduce",
                               "cat"))
    log("[profile] " + json.dumps(win))
    report["decode_profile"] = win
    del eng

    # slot reuse: one slot, a request, then a second
    first, second = (Request(uid=i, tokens=rng.integers(0, cfg.vocab_size,
                                                        n), max_new=8)
                     for i, n in enumerate((40, 24)))
    reused = run(engine(n_slots=1), [first, second])
    fresh = run(engine(n_slots=1), [second])
    if reused[1] != fresh[1]:
        raise AssertionError(f"slot reuse: the second request's tokens "
                             f"{reused[1]} != a fresh engine's {fresh[1]}")
    report["reuse_tokens_equal"] = True
    log(f"[griffin] slot reuse (a 40-token then a 24-token prompt, 8 new "
        f"each, one slot): the second request's {len(fresh[1])} greedy "
        f"tokens equal a fresh engine's")
    report["lockstep"] = lockstep_against_engine(
        torch, dataclasses.replace(cfg, dtype="float32"), params,
        GRIFFIN_ROUTE_TOL_F32, seed=10, tag="griffin")
    return report


def phase_griffin(torch):
    """recurrentgemma-2b (``get_config``: 26 layers, 8 (rec, rec, attn)
    groups + 2 tail, d 2560, RG-LRU width 2560, 10 query heads over one KV
    head of 256, window 2048, d_ff 7,680, tied vocab 256,000), random
    weights from a seed: step 0 at full width, one group and one tail
    layer, fp32, against the CPU (the loss, every gradient and the
    recurrent state after the forward); Sophia-G at the depth
    ``griffin_train_layers`` plans, B=2 x S=4096, on the flash, CE and
    engine kernels (exact launch counts; one profiled plain step split
    into CE, flash, engine, projections and the rest, beside the RG-LRU's
    own forward and backward x the recurrent layers); served at the depth
    ``SERVE_LAYERS`` gives (``griffin_serve``).  Each cut and its reason
    is logged.
    Counts are zeroed before each run and read after.  Returns {model:
    report}."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    cfg = get_config(GRIFFIN)
    layers = griffin_train_layers(cfg)
    cuts = griffin_cuts(cfg, layers)
    log(f"[griffin] {GRIFFIN}: {cuts}")
    t0 = time.perf_counter()

    def lap(what):
        log(f"[griffin] {what}: {time.perf_counter() - t0:.1f}s into 4h")

    small, rel, state_rel = griffin_step0_against_cpu(torch, cfg)
    del small
    torch.cuda.empty_cache()
    lap("step 0 against the CPU done")
    tcfg = dataclasses.replace(cfg, n_layers=layers)
    trained = train_model(torch, GRIFFIN, tcfg, GRIFFIN_B, S=GRIFFIN_SEQ,
                          after=lambda *a: step_profile(torch, *a))
    scan = rglru_profile(torch, cfg)
    lap("training and its profiles done")
    prof = trained["profile"]
    n_rec = layers - layers // 3
    scan_us = scan["device_us"] * n_rec
    trained.update(rglru_profile=scan,
                   rglru_share_of_plain_step=scan_us
                   / (trained["plain_p50_ms"] * 1e3))
    log(f"[griffin] plain step profile ({layers} layers, B={GRIFFIN_B} x "
        f"S={GRIFFIN_SEQ}, bf16): wall {prof['wall_us'] / 1e3:.1f} ms, "
        f"device busy {prof['device_busy_us'] / 1e3:.1f} ms, idle "
        f"{prof['device_idle_share']:.1%}, {prof['kernels']} kernels; CE "
        f"kernels {prof['ce_us'] / 1e3:.2f} ms, flash "
        f"{prof['flash_us'] / 1e3:.2f} ms, projections (mm) "
        f"{prof['projections_us'] / 1e3:.2f} ms, engine "
        f"{prof['engine_us'] / 1e3:.2f} ms, the rest "
        f"{prof['rest_us'] / 1e3:.2f} ms; the RG-LRU's forward + backward "
        f"alone (one layer): device {scan['device_us'] / 1e3:.2f} ms in "
        f"{scan['kernels']} kernels, wall {scan['wall_us'] / 1e3:.2f} ms; x "
        f"{n_rec} recurrent layers = {scan_us / 1e3:.1f} ms, "
        f"{trained['rglru_share_of_plain_step']:.1%} of the plain step's "
        f"p50 {trained['plain_p50_ms']:.1f} ms")
    scfg = serve_config(GRIFFIN, cfg)
    params = get_model(scfg).init_params(
        scfg, torch.Generator(device="cuda").manual_seed(0))
    served = griffin_serve(torch, scfg, params)
    del params
    torch.cuda.empty_cache()
    lap("serving done")
    launches = dict(trained["launches"])
    launches["decode_attention"] = served["launches"]
    missing = [k for k in GRIFFIN_PATH_KERNELS if not launches.get(k)]
    if missing:
        raise AssertionError(f"{GRIFFIN}: kernels of the path not launched: "
                             f"{missing}")
    log(f"[griffin] {GRIFFIN}: launches on its path {launches}; "
        f"{host_memory()}")
    return {GRIFFIN: dict(step0_grad_rel=rel, step0_state_rel=state_rel,
                          step0_layers=GRIFFIN_STEP0_LAYERS, train=trained,
                          serve={"bf16": served}, launches=launches,
                          served_layers=scfg.n_layers,
                          full_layers=cfg.n_layers, cuts=cuts)}


# ---------------------------------------------------------------------------
# phase 4i: the encoder-decoder family (seamless-m4t-medium)


SEAMLESS = "seamless-m4t-medium"
# training at full depth: B 4 target rows of 2048 tokens over frame
# streams of 3000, off the flash kernels' 64-row tile and unlike the
# target's length, so that the cross-attention kernels run Sq != Sk
SM_B, SM_TGT, SM_SRC = 4, 2048, 3000
# step 0 against the CPU: one encoder and one decoder layer at full width
SM_STEP0_TGT, SM_STEP0_SRC = 256, 300
# serving at full depth: 8 requests over 8 slots of SM_SERVE_SRC frames
# each, greedy, SM_NEW new tokens; the first has a decoder prefix of
# SM_PREFIX tokens, two chunks of a page of SM_PAGE; a 9th request takes a
# slot another left (its cross rows overwritten)
SM_SERVE_SRC, SM_NEW, SM_PAGE, SM_PREFIX = 1024, 64, 8, 9
SM_CACHE = SM_PREFIX + SM_NEW            # the engine's prompt + max_new
SM_LONG_SRC, SM_LONG_DECODE = 32768, 8    # the reference's prefill_32k cell
# The engine's route (prefill_encoder_slot, prefill_into_slot in chunks,
# decode_slots over every slot) and the whole-prompt route
# (prefill_encoder, decode_step one row at a time) compute one function
# and round it differently: in bf16 a one-ulp difference of the residual
# stream moves the logits by ~1e-2, while the top-2 gap of 256,206 random
# logits is ~0.1, so bf16 greedy tokens part at near ties (logged, not
# held).  In fp32 at full depth the two routes lie ~1e-6 of the largest
# logit apart (sums in other orders: the decode kernel's split walk
# against the chunk prefill's materialized softmax, cuBLAS at other row
# counts); the bound is 100x that.  The card against the CPU at 2 + 2
# layers in fp32 holds the same bound.
SM_ROUTE_TOL_F32 = 1e-4
SM_BF16_NEW = 16          # the bf16 routes' tokens compared (64 in call 7)
# what the script's time limit cut when phase 4i joined it (logged first)
TIME_CUTS = (f"phase 4's seven card-vs-CPU runs at {CPU_TRAIN_LAYERS} of "
             f"GPT-2 small's 12 layers (12 before phase 4i); phase 5 times "
             f"each CE kernel's plain version once at the models' loss "
             f"shapes (4-6 calls before; GPT-2's row keeps its 5 after a "
             f"warm-up), the kernels and the library composition there "
             f"after one warm-up launch (two before), over 6 launches at "
             f"the dense configs' shapes (10 before); phase 4i compares "
             f"the bf16 routes' greedy tokens over {SM_BF16_NEW} of "
             f"{SM_NEW}; recurrentgemma-2b is served at "
             f"{SERVE_LAYERS[GRIFFIN]} of 26 layers (SERVE_LAYERS)")
SEAMLESS_PATH_KERNELS = GRIFFIN_PATH_KERNELS


def seamless_cuts(cfg) -> str:
    return (f"trained at full depth ({cfg.n_encoder_layers} + "
            f"{cfg.n_layers} layers, {param_count(cfg):,} parameters) at "
            f"B={SM_B} x S_tgt={SM_TGT}, S_src={SM_SRC}; step 0 vs the CPU "
            f"at 1 + 1 layers (fp32, B=1 x S_tgt={SM_STEP0_TGT}, "
            f"S_src={SM_STEP0_SRC}); served at full depth "
            f"({param_count(cfg) * 4 / 1e9:.1f} GB fp32), {SM_SERVE_SRC} "
            f"frames a request; the routes held in fp32 at full depth and "
            f"against the CPU at 2 + 2 layers")


class FrameSource:
    """The synthetic token stream's batches with frames beside them: (B,
    S_src, D) fp32 normals seeded from (``seed``, step), the stub
    frontend's embeddings."""

    def __init__(self, cfg, B, S, S_src, seed=0):
        from repro_torch.data import DataConfig, make_source

        self.tokens = make_source(DataConfig(seq_len=S, global_batch=B,
                                             vocab_size=cfg.vocab_size,
                                             seed=seed))
        self.shape, self.seed = (B, S_src, cfg.d_model), seed

    def batch_at(self, t):
        import numpy as np

        batch = dict(self.tokens.batch_at(t))
        batch["frames"] = np.random.default_rng(
            (self.seed, t)).standard_normal(self.shape, dtype=np.float32)
        return batch


def seamless_step0_against_cpu(torch, cfg):
    """The step-0 check of ``model_step0_against_cpu`` at one encoder and
    one decoder layer, B=1 x S_tgt=SM_STEP0_TGT over SM_STEP0_SRC frames:
    the loss and every gradient, ``frame_proj``'s and the encoder's (which
    reach them only through the cross-attention's K and V: the dK/dV
    kernel) each non-zero and within 1e-4 of its largest element; the
    three attentions' kernels launched once each way.  Returns (max
    relative gradient error, {leaf: error} of the encoder side)."""
    import numpy as np

    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts

    rng = np.random.default_rng(4)
    batch = {k: rng.integers(0, cfg.vocab_size, (1, SM_STEP0_TGT))
             .astype(np.int32) for k in ("tokens", "labels")}
    batch["frames"] = rng.standard_normal(
        (1, SM_STEP0_SRC, cfg.d_model), dtype=np.float32)
    detail = {}
    reset_launch_counts()
    params, rel = model_step0_against_cpu(
        torch, SEAMLESS, dataclasses.replace(cfg, n_encoder_layers=1),
        layers=1, batch=batch, detail=detail)
    launched = dict(KERNEL_LAUNCHES)
    del params
    want = dict.fromkeys(("attn_fwd", "attn_bwd_dq", "attn_bwd_dkv"), 3)
    if ({k: launched.get(k) for k in want} != want
            or any(not launched.get(k) for k in STEP0_KERNELS)):
        raise AssertionError(f"{SEAMLESS} step 0: launches {launched}; want "
                             f"{want} and each of {STEP0_KERNELS}")
    enc = {n: r for n, r in detail["leaf_rel"].items()
           if n.startswith(("frame_proj", "encoder", "enc_norm"))}
    dead = [n for n in enc if not detail["leaf_scale"][n] > 0]
    if dead:
        raise AssertionError(f"{SEAMLESS} step 0: no gradient reaches {dead}")
    worst = max(enc, key=enc.get)
    log(f"[seamless] step 0: launches {launched}; the encoder side's "
        f"gradients ({len(enc)} leaves: frame_proj, the encoder layer, "
        f"enc_norm; they arrive only through the cross-attention's dK/dV) "
        f"non-zero, within {enc[worst]:.3g} of their largest element on "
        f"the CPU at worst ({worst}); frame_proj {enc['frame_proj']:.3g}")
    return rel, enc


def flash_split(torch, state, train_step, batches):
    """One more plain step with a pair of CUDA events around each flash
    kernel launch, summed by the attention it serves (the encoder's:
    non-causal over Sq = Sk; the decoder's self-attention: causal; the
    cross-attention: non-causal, Sq != Sk) and by kernel.  Returns
    {"flash_split_ms": {attention: {kernel: ms}}, "flash_split_launches":
    {attention: {kernel: n}}}."""
    from repro_torch.kernels import flash_attention as fa

    names = {"_forward_kernel": "attn_fwd", "_dq_kernel": "attn_bwd_dq",
             "_dkv_kernel": "attn_bwd_dkv"}
    orig = {n: getattr(fa, n) for n in names}
    events = []

    def timed(name, fn):
        def run(q, k, v, *args, **opts):
            kind = ("decoder self" if opts["causal"] else
                    "encoder" if q.shape[2] == k.shape[2] else "cross")
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(q, k, v, *args, **opts)
            ev[1].record()
            events.append((kind, names[name], ev))
            return out
        return run

    try:
        for n, fn in orig.items():
            setattr(fa, n, timed(n, fn))
        train_step(state, batches[2], False)
        torch.cuda.synchronize()
    finally:
        for n, fn in orig.items():
            setattr(fa, n, fn)
    ms, count = {}, {}
    for kind, name, (a, b) in events:
        ms.setdefault(kind, {}).setdefault(name, 0.0)
        ms[kind][name] += a.elapsed_time(b)
        count.setdefault(kind, {}).setdefault(name, 0)
        count[kind][name] += 1
    return {"flash_split_ms": ms, "flash_split_launches": count}


def seamless_routes(torch, cfg, params, frames, prefixes, new, device):
    """The engine's route and the whole-prompt route over requests of
    ``frames`` (n, S_src, D) numpy and decoder ``prefixes`` (lists), in
    ``cfg``'s dtype on ``device``.  The whole-prompt route, one request at
    a time: ``prefill_encoder`` into ``init_cache``, ``decode_step``
    through the prefix and ``new`` greedy tokens.  The engine's,
    teacher-forced on those tokens: every slot's ``prefill_encoder_slot``,
    its prefix through ``prefill_into_slot`` in chunks of SM_PAGE, then
    ``decode_slots`` of all n slots at their own positions, the last
    slot inactive in every other step until its turn.  Returns (the
    greedy tokens [n][new], the two routes' logits (n, new, V) each, the
    slot cache)."""
    import numpy as np

    from repro_torch.models import get_model

    model = get_model(cfg)
    n, S_src = len(prefixes), frames.shape[1]
    C = max(len(p) for p in prefixes) + new
    toks, whole = [], []
    for i, prefix in enumerate(prefixes):
        cache = model.init_cache(cfg, 1, C, 0, device)
        cache = model.prefill_encoder(
            cfg, params, torch.from_numpy(frames[i:i + 1]).to(device), cache)
        seq = list(prefix)
        out = []
        for t in range(len(prefix) + new - 1):
            lg = model.decode_step(cfg, params, cache, torch.tensor(
                [[seq[t]]], dtype=torch.int32, device=device), t)[0, 0]
            if t >= len(prefix) - 1:
                out.append(lg)
                if len(seq) == t + 1:
                    seq.append(int(lg.argmax()))
        toks.append(seq[len(prefix):])
        whole.append(torch.stack(out))
        del cache
    st = model.init_slots(cfg, n, C, S_src, device)
    first = []
    for i, prefix in enumerate(prefixes):
        model.prefill_encoder_slot(
            cfg, params, st, i, torch.from_numpy(frames[i:i + 1]).to(device))
        for start in range(0, len(prefix), SM_PAGE):
            chunk = np.asarray(prefix[start:start + SM_PAGE], np.int32)
            m = len(chunk)
            chunk = torch.from_numpy(np.pad(chunk, (0, SM_PAGE - m)))[None]
            lg = model.prefill_into_slot(cfg, params, st, i,
                                         chunk.to(device), start, m)
        first.append(lg)
    eng = [[x] for x in first]
    pos = torch.tensor([len(p) for p in prefixes], dtype=torch.int32,
                       device=device)
    last = torch.tensor([[t[0]] for t in toks], dtype=torch.int32,
                        device=device)
    for j in range(new - 1):
        active = torch.ones(n, dtype=torch.bool, device=device)
        active[-1] = j % 2 == 0
        lg = model.decode_slots(cfg, params, st, last, pos, active=active)
        for i in range(n):
            if active[i]:
                eng[i].append(lg[i, 0])
        nxt = [toks[i][len(eng[i]) - 1] if active[i] else int(last[i, 0])
               for i in range(n)]
        pos = pos + active.to(torch.int32)
        last = torch.tensor([[t] for t in nxt], dtype=torch.int32,
                            device=device)
    while len(eng[-1]) < new:               # the last slot catches up
        i = n - 1
        p = torch.tensor([len(prefixes[i]) + len(eng[i]) - 1],
                         dtype=torch.int32, device=device)
        sub = {k: v[:, i:i + 1] for k, v in st.items()}
        lg = model.decode_slots(cfg, params, sub, torch.tensor(
            [[toks[i][len(eng[i]) - 1]]], dtype=torch.int32,
            device=device), p)
        eng[i].append(lg[0, 0])
    eng = torch.stack([torch.stack(x) for x in eng])
    return toks, eng, torch.stack(whole), st


def _route_report(vocab, got, want):
    """The largest difference of two routes' logits over each row's
    largest, and the smallest top-2 gap of ``want`` on that scale, both
    over the ``vocab`` real columns (the padded ones sit at -1e30)."""
    got, want = got[..., :vocab], want[..., :vocab]
    scale = want.abs().amax(-1)
    top = want.topk(2, dim=-1).values
    return (float(((got - want).abs().amax(-1) / scale).max()),
            float(((top[..., 0] - top[..., 1]) / scale).min()))


def seamless_serve_against_cpu(torch, cfg):
    """The serving routes at 2 + 2 layers, full width, fp32, on the card
    against the CPU (a copy of the same weights): 3 requests of 64 frames,
    the first with a prefix of SM_PREFIX tokens (two chunks), 8 tokens
    each (``seamless_routes``): every logit of both routes within
    SM_ROUTE_TOL_F32 of the largest, the slot caches (k, v, xk, xv)
    within it of each leaf's largest.  Returns the errors."""
    import numpy as np

    from repro_torch.models import get_model

    cfg2 = dataclasses.replace(cfg, n_layers=2, n_encoder_layers=2,
                               dtype="float32")
    params = get_model(cfg2).init_params(
        cfg2, torch.Generator(device="cuda").manual_seed(2))
    rng = np.random.default_rng(6)
    frames = rng.standard_normal((3, 64, cfg.d_model), dtype=np.float32)
    prefixes = [[0] + rng.integers(0, cfg.vocab_size, SM_PREFIX - 1)
                .tolist(), [0], [0]]
    out = {}
    for dev, p in (("cuda", params), ("cpu", copy.deepcopy(params).cpu())):
        toks, eng, whole, st = seamless_routes(torch, cfg2, p, frames,
                                               prefixes, 8, dev)
        out[dev] = (toks, eng.cpu(), whole.cpu(),
                    {k: v.cpu() for k, v in st.items()})
        del p
    del params
    torch.cuda.empty_cache()
    (t_card, e_card, w_card, st_card), (t_cpu, e_cpu, w_cpu, st_cpu) = (
        out["cuda"], out["cpu"])
    errs = {"engine": _route_report(cfg.vocab_size, e_card, e_cpu)[0],
            "whole_prompt": _route_report(cfg.vocab_size, w_card, w_cpu)[0],
            "cache": max((st_card[k] - v).abs().max().item()
                         / v.abs().max().item() for k, v in st_cpu.items())}
    if not (t_card == t_cpu and max(errs.values()) <= SM_ROUTE_TOL_F32):
        raise AssertionError(f"{SEAMLESS} serving card vs CPU at 2 + 2 "
                             f"layers: tokens {t_card} vs {t_cpu}; errors "
                             f"{errs} (limit {SM_ROUTE_TOL_F32})")
    log(f"[seamless] serving routes card vs CPU (2 + 2 layers, full width, "
        f"fp32; 3 requests of 64 frames, a {SM_PREFIX}-token prefix in "
        f"chunks of {SM_PAGE}, 8 tokens each, one slot inactive in every "
        f"other decode step): greedy tokens equal; logits within "
        f"{errs['engine']:.3g} (engine route) and "
        f"{errs['whole_prompt']:.3g} (prefill_encoder + decode_step) of "
        f"the largest, the slot cache within {errs['cache']:.3g} (limit "
        f"{SM_ROUTE_TOL_F32})")
    return errs


def seamless_requests(cfg, n, seed, S_src=SM_SERVE_SRC, new=SM_NEW):
    """n requests of S_src frames (seeded normals), BOS prefixes but the
    first's SM_PREFIX tokens, ``new`` tokens each."""
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        prefix = (np.concatenate([[0], rng.integers(0, cfg.vocab_size,
                                                    SM_PREFIX - 1)])
                  if i == 0 else np.zeros((1,)))
        reqs.append(Request(
            uid=i, tokens=prefix.astype(np.int32), max_new=new,
            frames=rng.standard_normal((S_src, cfg.d_model),
                                       dtype=np.float32)))
    return reqs


def seamless_serve(torch, cfg, params):
    """``cfg`` served at full depth, bf16: a warm engine off the clock,
    then MODEL_REQUESTS + 1 requests (``seamless_requests``) over
    MODEL_REQUESTS slots, the last taking a freed slot: each request's
    encoder on the flash forward (n_encoder_layers launches a request),
    every decode step the decode kernel once a decoder layer (exact
    counts); the decode kernel against its plain version on the engine's
    own ring; a profile window of one decode burst; the greedy tokens
    against the whole-prompt route's in bf16 (logged: they part at near
    ties) and, in fp32 at full depth, 3 requests over 2 slots through the
    engine and both routes (``seamless_routes``): the engine's tokens
    equal the whole-prompt route's and the routes' logits lie within
    SM_ROUTE_TOL_F32 of the largest.  Returns the report."""
    import numpy as np

    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
    from repro_torch.launch.profile_serve import profile_window
    from repro_torch.serve import ServeEngine

    def engine(c, n_slots, src=SM_SERVE_SRC):
        return ServeEngine(c, params, n_slots=n_slots, cache_len=SM_CACHE,
                           page_len=SM_PAGE, steps_per_tick=8, seed=0,
                           src_len=src, device="cuda")

    def run(eng, reqs):
        for r in reqs:
            eng.submit(r)
        return {r.uid: r.tokens for r in eng.run()}

    run(engine(cfg, 2), seamless_requests(cfg, 2, seed=99, new=8))
    torch.cuda.synchronize()
    reqs = seamless_requests(cfg, MODEL_REQUESTS + 1, seed=7)
    eng = engine(cfg, MODEL_REQUESTS)
    for r in reqs:
        eng.submit(r)
    reset_launch_counts()
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(KERNEL_LAUNCHES)
    served = {r.uid: r.tokens for r in results}
    steps = eng.decode_ticks * eng.steps_per_tick
    want = {"attn_fwd": cfg.n_encoder_layers * len(reqs),
            "decode_attention": cfg.n_layers * steps}
    if (len(results) != len(reqs) or launches != want
            or any(len(t) != SM_NEW or not all(0 <= x < cfg.vocab_size
                                               for x in t)
                   for t in served.values())):
        raise AssertionError(f"{len(results)} of {len(reqs)} requests, "
                             f"lengths {[len(t) for t in served.values()]}; "
                             f"launches {launches} != {want}")
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((eng.n_slots, cfg.n_heads, cfg.hd), generator=gen,
                    device="cuda").to(cfg.compute_dtype)
    ring_err = check_decode_attention(torch, dict(
        q=q, k_cache=eng.state["k"][0], v_cache=eng.state["v"][0],
        positions=torch.from_numpy(eng._pos).cuda(), k_scale=None,
        v_scale=None), scale=1.0)[0]
    st = eng.stats()
    report = dict(layers=cfg.n_layers, src_len=SM_SERVE_SRC,
                  requests=len(reqs), tok_per_s=st["tokens_emitted"] / secs,
                  token_p50_ms=st["token_lat_p50_s"] * 1e3,
                  ttft_p50_ms=st["ttft_p50_s"] * 1e3,
                  tpot_p50_ms=st["tpot_p50_s"] * 1e3, decode_steps=steps,
                  launches=launches["decode_attention"],
                  encoder_launches=launches["attn_fwd"],
                  engine_ring_err=ring_err)
    log(f"[seamless] {SEAMLESS} served: {cfg.n_encoder_layers} + "
        f"{cfg.n_layers} layers, bf16, {len(results)} requests over "
        f"{eng.n_slots} slots ({SM_SERVE_SRC} frames each, the first with a "
        f"{SM_PREFIX}-token prefix; the last in a freed slot), "
        f"{st['tokens_emitted']} tokens in {secs:.3f}s = "
        f"{report['tok_per_s']:.1f} tok/s; token p50 "
        f"{report['token_p50_ms']:.3f} ms; ttft p50 "
        f"{report['ttft_p50_ms']:.1f} ms; tpot p50 "
        f"{report['tpot_p50_ms']:.3f} ms; {steps} decode steps; launches "
        f"{launches}; the kernel on the engine's layer-0 ring vs its plain "
        f"version: max abs err {ring_err:.3g}")
    del eng

    # one decode burst, every slot decoding
    eng = engine(cfg, MODEL_REQUESTS)
    for r in seamless_requests(cfg, MODEL_REQUESTS, seed=8):
        eng.submit(r)
    while eng.tokens_emitted < MODEL_REQUESTS:
        eng.tick()
    eng.tick()
    win = profile_window(f"decode burst ({SEAMLESS}, {cfg.n_layers} "
                         f"decoder layers, 8 steps x {MODEL_REQUESTS} slots, "
                         f"{SM_SERVE_SRC} frames, bf16)", eng.tick,
                         also=("gemm", "elementwise", "copy", "reduce"))
    log("[profile] " + json.dumps(win))
    report["decode_profile"] = win
    del eng

    # bf16: the whole-prompt route's greedy tokens beside the engine's
    frames = np.stack([r.frames for r in reqs])
    prefixes = [r.tokens.tolist() for r in reqs]
    toks, _, _, st16 = seamless_routes(torch, cfg, params, frames[:3],
                                       prefixes[:3], SM_BF16_NEW, "cuda")
    del st16
    agree = [next((j for j, (a, b) in enumerate(zip(toks[i], served[i]))
                   if a != b), SM_BF16_NEW) for i in range(3)]
    report["bf16_tokens_agree"] = agree
    log(f"[seamless] bf16, {cfg.n_layers} layers: the whole-prompt route's "
        f"greedy tokens equal the engine's for the first {agree} of "
        f"{SM_BF16_NEW} (requests 0-2; not held: bf16 rounds the two routes "
        f"apart and 256,206 random logits lie close)")

    # fp32 at full depth: the engine's tokens = the whole-prompt route's
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    new32 = 16
    reqs32 = seamless_requests(cfg, 3, seed=9, new=new32)
    t0 = time.perf_counter()
    eng = engine(cfg32, 2)
    served32 = run(eng, reqs32)
    del eng
    toks32, eng32, whole32, st32 = seamless_routes(
        torch, cfg32, params, np.stack([r.frames for r in reqs32]),
        [r.tokens.tolist() for r in reqs32], new32, "cuda")
    del st32
    worst, gap = _route_report(cfg.vocab_size, eng32, whole32)
    equal = all(served32[i] == toks32[i] for i in range(3))
    if not (equal and worst <= SM_ROUTE_TOL_F32):
        raise AssertionError(f"{SEAMLESS} fp32 routes: the engine's tokens "
                             f"{served32} vs the whole-prompt route's "
                             f"{toks32}; logits {worst:.3g} of the largest "
                             f"(limit {SM_ROUTE_TOL_F32})")
    report["fp32_routes"] = dict(tokens_equal=equal, route_rel=worst,
                                 min_top2_gap=gap,
                                 secs=time.perf_counter() - t0)
    log(f"[seamless] fp32, {cfg.n_encoder_layers} + {cfg.n_layers} layers, "
        f"3 requests over 2 slots (one reused), {new32} tokens each: the "
        f"engine's greedy tokens equal prefill_encoder + decode_step's; "
        f"teacher-forced, the engine route's logits within {worst:.3g} of "
        f"the largest (limit {SM_ROUTE_TOL_F32}; the smallest top-2 gap "
        f"{gap:.3g} of it); {report['fp32_routes']['secs']:.1f}s")
    return report


def seamless_encoder_32k(torch, cfg, params):
    """``prefill_encoder`` at B 1 over SM_LONG_SRC frames (the reference's
    prefill_32k cell for this family: the flash forward, non-causal, once
    an encoder layer), its wall time and peak memory, then SM_LONG_DECODE
    greedy ``decode_step``s against that cross cache.  Returns the
    report."""
    import numpy as np

    from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
    from repro_torch.models import get_model

    model = get_model(cfg)
    frames = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (1, SM_LONG_SRC, cfg.d_model), dtype=np.float32)).cuda()
    cache = model.init_cache(cfg, 1, SM_LONG_DECODE, 0, "cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    cache = model.prefill_encoder(cfg, params, frames, cache)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    launched = dict(KERNEL_LAUNCHES)
    xkv_gb = 2 * cache["xk"].numel() * cache["xk"].element_size() / 1e9
    tok = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    toks = []
    t0 = time.perf_counter()
    for pos in range(SM_LONG_DECODE):
        lg = model.decode_step(cfg, params, cache, tok, pos)
        tok = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        toks.append(int(tok))
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    ok = (launched == {"attn_fwd": cfg.n_encoder_layers}
          and bool(torch.isfinite(cache["xk"]).all())
          and all(0 <= t < cfg.vocab_size for t in toks))
    if not ok:
        raise AssertionError(f"{SEAMLESS} 32k encoder: launches {launched}, "
                             f"tokens {toks}")
    log(f"[seamless] prefill_encoder B=1 S_src={SM_LONG_SRC}: "
        f"{enc_s * 1e3:.1f} ms, peak {peak / 2 ** 30:.2f} GiB above what was "
        f"held, launches {launched}; cross cache {xkv_gb:.2f} GB; "
        f"{SM_LONG_DECODE} greedy decode steps against it {dec_s * 1e3:.1f} "
        f"ms: {toks}")
    del cache, frames
    torch.cuda.empty_cache()
    return dict(S_src=SM_LONG_SRC, encoder_ms=enc_s * 1e3,
                encoder_peak_gib=peak / 2 ** 30, cross_cache_gb=xkv_gb,
                decode_steps=SM_LONG_DECODE, decode_ms=dec_s * 1e3,
                tokens=toks, launches=launched)


def phase_seamless(torch):
    """seamless-m4t-medium (``get_config``: 12 encoder + 12 decoder layers,
    d 1024, 16 heads of 64, GELU d_ff 4096, tied vocab 256,206 padded to
    256,256, rope), random weights from a seed: step 0 at 1 + 1 layers,
    fp32, against the CPU (``seamless_step0_against_cpu``); Sophia-G at
    full depth, B=4 x S_tgt=2048 over 3000 frames, on the flash, CE and
    engine kernels (exact launch counts; one profiled plain step split
    into CE, flash, engine, projections and the rest, and the flash time
    split into the encoder's, the decoder's self- and the
    cross-attention by CUDA events); the serving routes against the CPU
    at 2 + 2 layers; served at full depth (``seamless_serve``); the
    encoder at 32k frames (``seamless_encoder_32k``).  Counts are zeroed
    before each run and read after.  Returns {model: report}."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model

    cfg = get_config(SEAMLESS)
    cuts = seamless_cuts(cfg)
    log(f"[seamless] {SEAMLESS}: {cuts}")
    t0 = time.perf_counter()

    def lap(what):
        log(f"[seamless] {what}: {time.perf_counter() - t0:.1f}s into 4i")

    rel, enc_rel = seamless_step0_against_cpu(torch, cfg)
    torch.cuda.empty_cache()
    lap("step 0 against the CPU done")
    trained = train_model(
        torch, SEAMLESS, cfg, SM_B, S=SM_TGT,
        source=FrameSource(cfg, SM_B, SM_TGT, SM_SRC),
        after=lambda *a: {**step_profile(torch, *a),
                          **flash_split(torch, *a)})
    trained["S_src"] = SM_SRC
    prof, split = trained["profile"], trained["flash_split_ms"]
    log(f"[seamless] plain step profile ({cfg.n_encoder_layers} + "
        f"{cfg.n_layers} layers, B={SM_B} x S_tgt={SM_TGT}, "
        f"S_src={SM_SRC}, bf16): wall {prof['wall_us'] / 1e3:.1f} ms, "
        f"device busy {prof['device_busy_us'] / 1e3:.1f} ms, idle "
        f"{prof['device_idle_share']:.1%}, {prof['kernels']} kernels; CE "
        f"{prof['ce_us'] / 1e3:.2f} ms, flash {prof['flash_us'] / 1e3:.2f} "
        f"ms, projections (mm) {prof['projections_us'] / 1e3:.2f} ms, "
        f"engine {prof['engine_us'] / 1e3:.2f} ms, the rest "
        f"{prof['rest_us'] / 1e3:.2f} ms; flash by attention (CUDA events, "
        f"one more plain step): "
        + "; ".join(f"{kind} " + ", ".join(f"{k} {v:.2f}"
                                           for k, v in ms.items())
                    + f" ms ({trained['flash_split_launches'][kind]})"
                    for kind, ms in split.items()))
    lap("training and its profiles done")
    serve_cpu = seamless_serve_against_cpu(torch, cfg)
    lap("serving against the CPU done")
    params = get_model(cfg).init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0))
    served = seamless_serve(torch, cfg, params)
    lap("serving done")
    long = seamless_encoder_32k(torch, cfg, params)
    del params
    torch.cuda.empty_cache()
    lap("the 32k encoder done")
    launches = dict(trained["launches"])
    launches["decode_attention"] = served["launches"]
    missing = [k for k in SEAMLESS_PATH_KERNELS if not launches.get(k)]
    if missing:
        raise AssertionError(f"{SEAMLESS}: kernels of the path not "
                             f"launched: {missing}")
    log(f"[seamless] {SEAMLESS}: launches on its path {launches}; "
        f"{host_memory()}")
    return {SEAMLESS: dict(step0_grad_rel=rel, step0_encoder_rel=enc_rel,
                           train=trained, serve={"bf16": served},
                           serve_cpu_rel=serve_cpu, encoder_32k=long,
                           launches=launches, served_layers=cfg.n_layers,
                           full_layers=cfg.n_layers, cuts=cuts)}


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
        decode_attention, decode_attention_plain, head_tiles,
        max_active_clusters, ring_mask, split_count)

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
    tiles = head_tiles(H // Hkv)
    splits = split_count(N, Hkv, C, sms, tiles)
    clusters = max_active_clusters(N, H, Hkv, C, hd, torch.bfloat16, quant,
                                   splits)
    name = "decode_attention_q8" if quant else "decode_attention"
    log(f"[timing] {name} N={N} C={C}: kernel {ms * 1e3:.2f} us, plain "
        f"{plain_ms * 1e3:.2f} us, library "
        f"{'n/a' if library_ms is None else f'{library_ms * 1e3:.2f} us'}, "
        f"bound {bound_ms * 1e3:.2f} us ({nbytes} bytes, {flops} flops; "
        f"{valid_rows} valid rows of {N * C}), host issue "
        f"{issue_ms * 1e3:.2f} us; S={splits}, {tiles} head tiles, "
        f"{N * Hkv * tiles * splits} blocks, max active clusters {clusters}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_us": bound_ms * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "host_issue_ms": issue_ms,
            "splits": splits, "head_tiles": tiles,
            "max_active_clusters": clusters,
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


def _ce_timed(torch, spec, label, reps=20, plain_once=False):
    """The four CE kernels at ``spec`` (bf16 h, fp32 W): {kernel: entry}
    with the kernel's time, its plain version's, its bound and the library
    composition's (not one call) beside it; ``reps`` launches each (a
    quarter of that for the plain versions after a warm-up, or with
    ``plain_once``, at the models' shapes, one call and one warm-up
    launch of the others: ``TIME_CUTS``)."""
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
    warm = 1 if plain_once else 2
    lib_fwd = time_ms(torch, lambda: composition(False), flush, reps=reps,
                      warmup=warm)
    lib_fb = time_ms(torch, comp_backward, flush, reps=reps, warmup=warm)
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
        ms = time_ms(torch, kernel, flush, reps=reps, warmup=warm)
        plain_ms = time_ms(torch, plain, flush,
                           reps=1 if plain_once else max(3, reps // 4),
                           warmup=0 if plain_once else 1)
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
    models = [(name, spec, _ce_timed(torch, spec, name, plain_once=True))
              for name, spec in ((n, dict(CE_TIME, **sp))
                                 for n, sp in CE_MODEL_SHAPES)]
    dense = [(name, spec, _ce_timed(torch, spec, name, reps=6,
                                    plain_once=True))
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
    # yi's, qwen2-vl's, deepseek's, rwkv's and recurrentgemma's refreshes
    # draw on one of their two rows; gemma2's batch is its one row (the
    # entry above); qwen1.5 is not trained on the card
    for (name, spec, _), entry in zip(dense, row["shapes"][len(models):]):
        if name in ("yi-6b", VLM, MOE, RWKV, GRIFFIN, SEAMLESS):
            entry["ms_refresh"], entry["bound_ms_refresh"] = \
                _ce_sampled_timed(torch, dict(spec, N=spec["N"] // 2), name)
    return rows


# which units each flash kernel's bf16 products run on
FLASH_UNITS = {"attn_fwd": "tensor cores", "attn_bwd_dq": "tensor cores",
               "attn_bwd_dkv": "tensor cores"}


def _flash_timed(torch, spec, label, reps=20):
    """The three flash kernels at ``spec`` in bf16 (causal with its window
    and softcap, or bidirectional over Sq queries and Sk keys):
    {kernel: entry} with the kernel's time, its plain version's, its bound
    and SDPA's beside it.  SDPA takes no softcap: with one it computes the
    same pairs (``is_causal``, or the window as a boolean mask) without
    it, the nearest function it has."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    flush = torch.empty(128 * 2 ** 20 // 4, device="cuda")
    q, k, v, g, kw = _attn_inputs(torch, spec, torch.bfloat16)
    B, H, Hkv, S, Sk, hd = (spec[n] for n in ("B", "H", "Hkv", "Sq", "Sk",
                                              "hd"))
    causal = spec["causal"]
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
    band = fa.band_mask(S, Sk, causal=causal, window=window, q_offset=0,
                        device="cuda")
    sdpa_kw = (dict(attn_mask=band) if window is not None
               else dict(is_causal=causal))
    sdpa_kw["enable_gqa"] = H != Hkv
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    sdpa_o = F.scaled_dot_product_attention(*leaves, **sdpa_kw)
    sdpa_err = (sdpa_o.float() - o.float()).abs().max().item()
    lib_fwd = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, **sdpa_kw), flush, reps=reps, warmup=2)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        sdpa_o, leaves, g, retain_graph=True), flush, reps=reps, warmup=2)
    sdpa_how = (f"is_causal={causal}" if window is None else
                f"the window {window} as a boolean mask") + (
        f", no softcap (the kernel's is {cap:g})" if cap else "")
    log(f"[timing] SDPA yardstick ({sdpa_how}) {label} at B={B} H={H} "
        f"Hkv={Hkv} Sq={S} Sk={Sk} hd={hd} bf16: forward {lib_fwd:.3f} ms, "
        f"backward "
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
        nbytes = fa.attn_bytes(B, H, Hkv, S, Sk, hd, name,
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
            "shape": f"{label}: B={B} H={H} Hkv={Hkv} "
                     + (f"S={S}" if S == Sk else f"Sq={S} Sk={Sk}")
                     + f" hd={hd} bf16 "
                     + ("causal" if causal else "bidirectional")
                     + (f" window {window}" if window is not None else "")
                     + (f" softcap {cap:g}" if cap else "")}
        log(f"[timing] {name} ({FLASH_UNITS[name]}) {label}: kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, SDPA "
            f"{library[name]:.3f} ms, bound {max(t_ops, t_bytes):.4f} ms "
            f"({flops} flops at {BF16_FLOPS_PER_S:.3g}/s, {nbytes} bytes at "
            f"{HBM_BYTES_PER_S:.3g}/s); {flops / ms / 1e9:.1f} TFLOP/s")
    return out




def _flash_forward_long_timed(torch, spec, label, check_err, reps=5):
    """The forward kernel alone at a prefill's length, where its plain
    version cannot run over every row (its fp32 scores would take
    B*H*S^2*4 bytes): the kernel's time beside its bound and SDPA's
    forward (``is_causal``, ``enable_gqa``, restricted to its fused
    backends so that it cannot fall back to materializing the scores).
    ``check_err``: phase 2's errors over slices of the rows
    (:func:`check_flash_forward_long`)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels import flash_attention as fa

    flush = torch.empty(128 * 2 ** 20 // 4, device="cuda")
    q, k, v, _, kw = _attn_inputs(torch, spec, torch.bfloat16)
    B, H, Hkv, S, hd = (spec[n] for n in ("B", "H", "Hkv", "Sq", "hd"))
    causal = spec["causal"]
    ms = time_ms(torch, lambda: fa.flash_forward(q, k, v, **kw), flush,
                 reps=reps, warmup=1)
    o, _ = fa.flash_forward(q, k, v, **kw)
    library_ms, note = None, None
    try:
        with sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                          SDPBackend.CUDNN_ATTENTION,
                          SDPBackend.EFFICIENT_ATTENTION]):
            def sdpa():
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=H != Hkv)
            err = (sdpa().float() - o.float()).abs().max().item()
            library_ms = time_ms(torch, sdpa, flush, reps=reps, warmup=1)
        note = (f"F.scaled_dot_product_attention forward (is_causal="
                f"{causal}, enable_gqa={H != Hkv}), max abs err vs the "
                f"kernel's o {err:.3g}")
    except RuntimeError as e:        # no fused backend takes these inputs
        note = f"SDPA's fused backends refused: {str(e).splitlines()[0]}"
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = fa.attn_flops(B, H, hd, pairs, "attn_fwd")
    nbytes = fa.attn_bytes(B, H, Hkv, S, S, hd, "attn_fwd",
                           itemsize=q.element_size())
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[timing] attn_fwd (tensor cores) {label}: kernel {ms:.3f} ms, "
        f"plain not run (its scores would take "
        f"{B * H * S * S * 4 / 1e9:.0f} GB), library "
        f"{'n/a' if library_ms is None else f'{library_ms:.3f} ms'} "
        f"({note}), bound {max(t_ops, t_bytes):.4f} ms ({flops} flops, "
        f"{nbytes} bytes); {flops / ms / 1e9:.1f} TFLOP/s")
    return {"ms": ms, "plain_ms": None,
            "plain_note": "not run: the plain version's fp32 scores would "
                          f"take {B * H * S * S * 4 / 1e9:.0f} GB; held in "
                          f"phase 2 over three slices of {LONG_ROWS} query "
                          "rows, and end to end by the 32k prefill of "
                          "phase 4e (causal) or the 32k encoder of phase "
                          "4i (bidirectional)",
            "max_abs_err": max(check_err.values()),
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "library_note": note,
            "units": FLASH_UNITS["attn_fwd"],
            "shape": f"{label}: B={B} H={H} Hkv={Hkv} S={S} hd={hd} bf16 "
                     + ("causal" if causal else "bidirectional")}


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
               for name, sp in ATTN_DENSE_SHAPES + ATTN_VLM_SHAPES
               + ATTN_MOE_SHAPES + ATTN_GRIFFIN_SHAPES
               + ATTN_SEAMLESS_SHAPES + SEAMLESS_SELF_SHAPES]
    rows = [{"name": name, "route": "cuda", "source": FLASH_ATTN[0],
             "replaces": replaces,
             "launches": trained["launches"].get(name, 0),
             "max_abs_err": attn_err[name], **main[name],
             "shapes": [t[name] for t in models]}
            for name, replaces in FLASH_ATTN[1].items()]
    rows[0]["shapes"].append(_flash_forward_long_timed(
        torch, PREFILL_ATTN, "qwen2-vl-7b-prefill-32k",
        attn_err["attn_fwd_long"]))
    rows[0]["shapes"].append(_flash_forward_long_timed(
        torch, SEAMLESS_LONG_ATTN, "seamless-m4t-medium-encoder-32k",
        attn_err["attn_fwd_long_noncausal"]))
    return rows


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


# ---------------------------------------------------------------------------
# phase 6: data-parallel training through the launcher (NCCL at world size
# 1): GPT-2 small with the int8 error-feedback reduction in 8 buckets,
# telemetry, an asynchronous checkpoint and a resume

DP_SHARD = 124_518_400                   # GPT-2 small's flat shard
DP_BUCKETS = 8
DP_BUCKET_ELEMS = DP_SHARD // DP_BUCKETS  # 15,564,800, 256-aligned
DP_STEPS, DP_K, DP_CKPT = 12, 4, 8
DP_QUANT_N = 1 << 24                     # the card-vs-CPU _quantize slice
DP_QUANT_SEED, DP_QUANT_OFFSET = 2 ** 31 + 12345, 2 ** 32 - (1 << 20)
DP_ARGS = ["--arch", "gpt2-small", "--opt", "sophia_g", "--estimator",
           "gnb", "--fused-kernel", "--steps", str(DP_STEPS), "--seq-len",
           str(TRAIN_S), "--global-batch", str(TRAIN_B), "--hess-interval",
           str(DP_K), "--hess-subbatch", str(TRAIN_SUB), "--peak-lr", "6e-4",
           "--log-every", "1", "--device", "cuda", "--comm-telemetry"]
DP_COMPRESS = ["--compress-grads", "--compress-hess", "--comm-bucket-elems",
               str(DP_BUCKET_ELEMS)]
# the kernels of phase 6's path: rows 2 and 4, 11-15 (by 14 and 15) and
# 16-18
DP_PATH_KERNELS = ("sophia_step", "sophia_refresh", "ce_forward",
                   "ce_forward_sampled", "ce_backward_dh", "ce_backward_dw",
                   "attn_fwd", "attn_bwd_dq", "attn_bwd_dkv")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def nccl_launch_us(torch, reps=500):
    """{collective: (device µs, host µs)} per call of an NCCL all-gather
    and an all-reduce of 64 bytes at world size 1, CUDA events over
    ``reps`` back-to-back calls after 50 warm-up calls: the collectives
    one card can time, behind ``launch.roofline.COLLECTIVE_LAUNCH_S``."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        x = torch.ones(16, device="cuda")
        out = torch.empty(16, device="cuda")
        calls = {"all_gather": lambda: dist.all_gather_into_tensor(out, x),
                 "all_reduce": lambda: dist.all_reduce(x)}
        res = {}
        for name, fn in calls.items():
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            t0 = time.perf_counter()
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            host = (time.perf_counter() - t0) / reps * 1e6
            torch.cuda.synchronize()
            res[name] = (start.elapsed_time(end) / reps * 1e3, host)
        return res
    finally:
        dist.destroy_process_group()


def quantize_against_cpu(torch):
    """``_quantize`` of a 2^24-element slice on the card and on the CPU at
    a seed past 2^31 and an offset near 2^32 (the hash wraps): q, scales
    and deq bit for bit."""
    from repro_torch.quant import _quantize

    gen = torch.Generator().manual_seed(5)
    x = torch.randn(DP_QUANT_N, generator=gen) * torch.rand(
        DP_QUANT_N, generator=gen) * 3
    want = _quantize(x, 256, DP_QUANT_SEED, offset=DP_QUANT_OFFSET)
    got = _quantize(x.cuda(), 256, DP_QUANT_SEED, offset=DP_QUANT_OFFSET)
    for name, a, b in zip(("q", "scales", "deq"), got, want):
        if not torch.equal(a.cpu(), b):
            bad = int((a.cpu() != b).sum())
            raise AssertionError(f"_quantize on the card differs from the "
                                 f"CPU in {name}: {bad} elements")
    log(f"[dp] _quantize of {DP_QUANT_N:,} elements at seed "
        f"{DP_QUANT_SEED}, offset {DP_QUANT_OFFSET}: card == CPU bit for "
        f"bit (q, scales, deq)")


def compression_on_the_shard(torch):
    """The compressed reduction over GPT-2 small's whole shard at world
    size 1 (no process group: every bucket quantized in place): bucketed
    in DP_BUCKETS against monolithic bit for bit (deq and error), then
    one bucketed call timed (CUDA events, median of 5) and profiled (its
    kernels and device time).  Returns the report."""
    from repro_torch.distributed import FlatCompressionState, GradCompressor
    from repro_torch.launch.profile_serve import profile_window

    gen = torch.Generator(device="cuda").manual_seed(3)
    g = torch.randn(DP_SHARD, device="cuda", generator=gen) * 1e-2
    e0 = torch.randn(DP_SHARD, device="cuda", generator=gen) * 1e-4
    comp = GradCompressor()
    outs = []
    for be in (0, DP_BUCKET_ELEMS):
        st = FlatCompressionState(error=(e0.clone(),))
        deq, st = comp.allreduce_shards((g,), st, 7, bucket_elems=be)
        outs.append((deq[0], st.error[0]))
    for name, a, b in zip(("deq", "error"), *outs):
        if not torch.equal(a, b):
            raise AssertionError(f"bucketed compression differs from "
                                 f"monolithic in {name}")
    del outs
    st = FlatCompressionState(error=(e0,))

    def call():
        comp.allreduce_shards((g,), st, 7, bucket_elems=DP_BUCKET_ELEMS)

    times = []
    for _ in range(6):
        a, b = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        a.record()
        call()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    prof = profile_window("compression", call, match="")
    # at least: g and e read, e and deq written (fp32), q and the scales
    # written once
    nbytes = DP_SHARD * (4 * 4 + 1) + DP_SHARD // 256 * 4
    report = dict(ms=statistics.median(times[1:]),
                  device_busy_ms=prof["device_busy_us"] / 1e3,
                  kernels=prof["kernels_launched"],
                  bound_ms=nbytes / 3.35e12 * 1e3, bytes=nbytes,
                  top_kernels_us=prof["top_kernels_us"][:6])
    log(f"[dp] compression over the {DP_SHARD:,}-element shard in "
        f"{DP_BUCKETS} buckets: bucketed == monolithic bit for bit (deq, "
        f"error); one call {report['ms']:.2f} ms (events, median of 5), "
        f"device busy {report['device_busy_ms']:.2f} ms in "
        f"{report['kernels']} kernels (profiler); bytes bound "
        f"{report['bound_ms']:.3f} ms ({nbytes / 1e9:.2f} GB at 3.35 TB/s)")
    del g, e0, st
    torch.cuda.empty_cache()
    return report


def dp_launch(tag, extra, workdir, timeout=300):
    """``python -m repro_torch.launch.train`` on the card through NCCL at
    world size 1 (its own rendezvous port): (stdout, per-step metrics,
    the last record: peak memory, launch counts)."""
    out = os.path.join(workdir, f"{tag}.jsonl")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *DP_ARGS,
           "--coordinator", f"127.0.0.1:{_free_port()}", "--num-processes",
           "1", "--process-id", "0", "--metrics-out", out, *extra]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    r = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"[dp] {tag}: the launcher exited "
                             f"{r.returncode}:\n{r.stdout[-3000:]}\n"
                             f"{r.stderr[-3000:]}")
    with open(out) as f:
        records = [json.loads(ln) for ln in f]
    steps = [rec for rec in records if "step" in rec]
    last = records[-1]
    log(f"[dp] {tag}: {len(steps)} steps from step {last['start']} in "
        f"{secs:.1f}s (process included); peak "
        f"{last['peak_bytes'] / 2 ** 30:.2f} GiB; launches "
        f"{last['launches']}")
    return r.stdout, steps, last


def _dp_want(steps, first):
    refs = sum(1 for t in range(first, first + steps) if t % DP_K == 0)
    attn = 12 * (steps + refs)
    return {"ce_forward": steps, "ce_forward_sampled": refs,
            "ce_backward_dh": steps + refs, "ce_backward_dw": steps + refs,
            "attn_fwd": attn, "attn_bwd_dq": attn, "attn_bwd_dkv": attn,
            "sophia_step": steps - refs, "sophia_refresh": refs}


def _dp_times(steps):
    """(plain p50 s, refresh p50 s) of a run's steps, step 0 left out."""
    plain = [r["wall_s"] for r in steps if r["step"] % DP_K and r["step"]]
    refresh = [r["wall_s"] for r in steps
               if r["step"] % DP_K == 0 and r["step"]]
    return (statistics.median(plain),
            statistics.median(refresh) if refresh else None)


def phase_dp(torch):
    """Data-parallel training (``distributed/``, ``train/elastic.py``,
    ``launch/train.py``): the NCCL launch time at world size 1; in this
    process ``_quantize`` card against CPU and the compressed reduction
    bucketed against monolithic over the whole shard (timed, profiled);
    then the launcher as a subprocess: GPT-2 small 12 steps compressed
    (8 buckets, telemetry, the asynchronous checkpoint at step 8), the
    same command again after step 12's checkpoint is removed (it must
    resume at step 8 and log the first run's losses bit for bit, or,
    if the card is not deterministic, within two uninterrupted runs'
    spread) and the 12 steps uncompressed.  Each launcher run's launch
    counts are its own process's: exact, as phase 4's.  Returns the
    report."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.launch.roofline import (COLLECTIVE_LAUNCH_S,
                                             choose_bucket_elems)

    report = {}
    launch = nccl_launch_us(torch)
    report["nccl_64B_us"] = {k: dict(device=d, host=h)
                             for k, (d, h) in launch.items()}
    log(f"[dp] nccl launch at world size 1, 64 bytes: "
        + "; ".join(f"{k} {d:.2f} µs a call on the card, {h:.2f} µs to "
                    f"issue" for k, (d, h) in launch.items())
        + f" (roofline.COLLECTIVE_LAUNCH_S = {COLLECTIVE_LAUNCH_S * 1e6:g} "
          f"µs; choose_bucket_elems at 8 ranks over the shard: "
          f"{choose_bucket_elems(DP_SHARD, 8):,})")
    quantize_against_cpu(torch)
    report["compression"] = compression_on_the_shard(torch)
    torch.cuda.empty_cache()

    work = tempfile.mkdtemp(prefix="dp-", dir=os.path.join(ROOT, "build"))
    try:
        ck = os.path.join(work, "ckpt")
        run = DP_COMPRESS + ["--elastic", "--ckpt-dir", ck, "--ckpt-every",
                             str(DP_CKPT)]
        _, first, last1 = dp_launch("compressed", run, work)
        if last1["launches"] != _dp_want(DP_STEPS, 0):
            raise AssertionError(f"[dp] compressed run launches "
                                 f"{last1['launches']} != "
                                 f"{_dp_want(DP_STEPS, 0)}")
        # as if the run had died after step 8's checkpoint
        shutil.rmtree(os.path.join(ck, f"step_{DP_STEPS:08d}"))
        out, resumed, last2 = dp_launch("resumed", run, work)
        if f"[resume] restored step {DP_CKPT}" not in out:
            raise AssertionError(f"[dp] the second run did not resume at "
                                 f"step {DP_CKPT}:\n{out[-2000:]}")
        if last2["launches"] != _dp_want(DP_STEPS - DP_CKPT, DP_CKPT):
            raise AssertionError(f"[dp] resumed run launches "
                                 f"{last2['launches']}")
        a = [r["loss"] for r in first[DP_CKPT:]]
        b = [r["loss"] for r in resumed]
        resume = dict(first=a, resumed=b, bitwise=a == b)
        if a != b:
            _, again, _ = dp_launch("compressed-again", DP_COMPRESS, work)
            spread = max(abs(x["loss"] - y["loss"])
                         for x, y in zip(first, again))
            gap = max(abs(x - y) for x, y in zip(a, b))
            resume.update(spread=spread, gap=gap)
            if gap > spread:
                raise AssertionError(f"[dp] resumed losses {b} vs {a}: gap "
                                     f"{gap:.3g} > two runs' spread "
                                     f"{spread:.3g}")
        log(f"[dp] resume at step {DP_CKPT}: losses of steps "
            f"{DP_CKPT}-{DP_STEPS - 1} {b} against the first run's {a}: "
            + ("bit for bit" if a == b else
               f"within {resume['gap']:.3g} (two uninterrupted runs "
               f"{resume['spread']:.3g} apart)"))
        _, plain, last3 = dp_launch("uncompressed", [], work)
        if last3["launches"] != _dp_want(DP_STEPS, 0):
            raise AssertionError(f"[dp] uncompressed run launches "
                                 f"{last3['launches']}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for steps in (first, resumed, plain):
        if not all(np.isfinite([r["loss"] for r in steps])):
            raise AssertionError(f"[dp] non-finite loss: {steps}")
    missing = [k for k in DP_PATH_KERNELS if not last1["launches"].get(k)]
    if missing:
        raise AssertionError(f"[dp] kernels of the path not launched: "
                             f"{missing}")
    c_plain, c_ref = _dp_times(first)
    u_plain, u_ref = _dp_times(plain)
    comm = [r["comm_seconds"] for r in first[1:]]
    frac = [r["exposed_comm_fraction"] for r in first[1:]]
    report.update(
        launches=last1["launches"], resume=resume,
        compressed=dict(plain_p50_ms=c_plain * 1e3,
                        refresh_p50_ms=c_ref * 1e3,
                        peak_gib=last1["peak_bytes"] / 2 ** 30,
                        comm_p50_ms=statistics.median(comm) * 1e3,
                        exposed_comm_fraction_p50=statistics.median(frac),
                        losses=[r["loss"] for r in first]),
        uncompressed=dict(plain_p50_ms=u_plain * 1e3,
                          refresh_p50_ms=u_ref * 1e3,
                          peak_gib=last3["peak_bytes"] / 2 ** 30,
                          losses=[r["loss"] for r in plain]))
    log(f"[dp] GPT-2 small B={TRAIN_B} x S={TRAIN_S}, Sophia-G + GNB, "
        f"engine kernels, NCCL at world size 1: compressed plain p50 "
        f"{c_plain * 1e3:.1f} ms, refresh p50 {c_ref * 1e3:.1f} ms, peak "
        f"{report['compressed']['peak_gib']:.2f} GiB, comm window p50 "
        f"{report['compressed']['comm_p50_ms']:.2f} ms (exposed fraction "
        f"p50 {report['compressed']['exposed_comm_fraction_p50']:.3f}: at "
        f"world size 1 every bucket is quantized in place, no collective); "
        f"uncompressed plain p50 {u_plain * 1e3:.1f} ms, refresh p50 "
        f"{u_ref * 1e3:.1f} ms, peak "
        f"{report['uncompressed']['peak_gib']:.2f} GiB")
    return report


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

    def timed(name, fn, *args):
        """fn(*args), its wall time logged as the phase's."""
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"[phase] {name}: {time.perf_counter() - t0:.1f}s")
        return out

    log(f"[cuts] for the script's time: {TIME_CUTS}")
    timed("1 build", phase_build)
    main_err = timed("2 decode", phase_kernels, torch)
    ce_err = timed("2 ce", phase_ce_kernels, torch)
    attn_err = timed("2 flash", phase_flash_kernels, torch)
    engine_err = timed("2 engine", phase_engine_kernels, torch)
    served = timed("3 serve", phase_serve, torch)
    trained = timed("4 train", phase_train, torch)
    timed("4b routes", phase_routes, torch)
    models = timed("4c rope models", phase_models, torch)
    models.update(timed("4d dense models", phase_dense_models, torch))
    models.update(timed("4e qwen2-vl", phase_vlm, torch))
    models.update(timed("4f moe", phase_moe, torch))
    models.update(timed("4g rwkv", phase_rwkv, torch))
    models.update(timed("4h griffin", phase_griffin, torch))
    models.update(timed("4i seamless", phase_seamless, torch))
    rows = (timed("5 decode", phase_timings, torch, main_err, served)
            + timed("5 engine", phase_engine_timings, torch, engine_err,
                    trained)
            + timed("5 ce", phase_ce_timings, torch, ce_err, trained)
            + timed("5 flash", phase_flash_timings, torch, attn_err,
                    trained))
    dp = timed("6 dp", phase_dp, torch)
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
            layers_served=r["served_layers"],
            served_tok_per_s={kv: x["tok_per_s"]
                              for kv, x in r["serve"].items()},
            step0_grad_rel=r["step0_grad_rel"], cuts=r.get("cuts"))
        if "prefix_cache" in r:
            summary[m].update(prefix_cache=r["prefix_cache"],
                              prefill_32k=r.get("prefill_32k"))
        if "routing" in r:
            summary[m].update(
                routing=r["routing"], aux=t.get("aux"),
                dropped_share=t.get("dropped_share"),
                moe_share_of_plain_step=t.get("moe_share_of_plain_step"),
                moe_ffn_profile=t.get("moe_ffn_profile"),
                serve={kv: {k: x[k] for k in ("tok_per_s", "ttft_p50_ms",
                                              "tpot_p50_ms")}
                       for kv, x in r["serve"].items()})
        if m == RWKV:
            summary[m].update(
                step0_state_rel=r["step0_state_rel"],
                serve_cpu_rel=r["serve_cpu_rel"],
                routes_step0=r["routes_step0"],
                smoke_step0_grad_rel=r["smoke_step0_grad_rel"],
                smoke_step0_state_rel=r["smoke_step0_state_rel"],
                step_profile=t.get("profile"),
                wkv_profile=t.get("wkv_profile"),
                wkv_share_of_plain_step=t.get("wkv_share_of_plain_step"),
                serve=r["serve"])
        if m == SEAMLESS:
            summary[m].update(
                S_src=t.get("S_src"),
                step0_encoder_rel=max(r["step0_encoder_rel"].values()),
                step_profile=t.get("profile"),
                flash_split_ms=t.get("flash_split_ms"),
                serve_cpu_rel=r["serve_cpu_rel"], encoder_32k=r["encoder_32k"],
                serve=r["serve"])
        if m == GRIFFIN:
            summary[m].update(
                step0_state_rel=r["step0_state_rel"],
                step0_layers=r["step0_layers"],
                step_profile=t.get("profile"),
                rglru_profile=t.get("rglru_profile"),
                rglru_share_of_plain_step=t.get("rglru_share_of_plain_step"),
                serve=r["serve"])
    name, power = [s.strip() for s in card.split(",", 1)]
    log(json.dumps({"dp": dp, "card": name, "power_limit": power}))
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
