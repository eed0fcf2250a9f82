"""The roofline formulas: the counterpart of ``repro/launch/roofline.py``.

Three parts, each at the H100's peaks rather than the reference's TPU v5e:

  * the roofline terms of a cost dict (``roofline_terms``,
    ``dominant_term``): compute at ``PEAK_FLOPS``, memory at ``HBM_BW``,
    collectives at ``LINK_BW``;
  * the stage overlays and the serving and model-FLOP formulas
    (``loss_stage_seconds``, ``attention_stage_seconds``,
    ``kv_cache_slot_bytes``, ``kv_slots_at_budget``, ``model_flops_train``,
    ``model_flops_infer``): the byte and FLOP counts are the reference's,
    integer for integer; only the peaks they are divided by differ;
  * the communication model of the bucketed gradient collective
    (``ring_collective_seconds`` ... ``choose_bucket_elems``).

The reference's HLO parsers (``_iter_collectives``, ``collective_bytes``,
``collective_buffer_bytes``) read XLA's compiled text, which PyTorch does
not produce: they belong with the XLA-only launch tools and are not
ported here.

The kernel tuner (``kernels/autotune.py``) ranks its candidates with the
same peaks; ``chip_smoke.py`` divides each kernel's counted work
(``fused_ce.ce_flops`` / ``ce_bytes``, ``flash_attention.attn_flops`` /
``attn_bytes``) by them for its bounds.

The constants (NVIDIA's data sheet, H100 SXM, dense rates, at the full
700 W power limit):

  * ``PEAK_FLOPS``: 989 TFLOP/s, bf16 on the tensor cores;
  * ``FP32_FLOPS``: 67 TFLOP/s, fp32 outside the tensor cores;
  * ``HBM_BW``: 3.35 TB/s of device memory;
  * ``LINK_BW``: NVLink between the cards of one host, 900 GB/s all to
    all, 450 GB/s each way;
  * ``COLLECTIVE_LAUNCH_S``: the fixed cost of one collective, an NCCL
    all-gather of 64 bytes at world size 1 on an NVIDIA H100 80GB HBM3
    at a 700 W power limit: 65.1 µs a call over 500 back-to-back calls,
    as long as the host takes to issue one (``chip_smoke.py`` phase 6
    logs it as ``[dp] nccl launch``; an all-reduce took 51.5 µs; other
    calls read 128.5 and 145 µs for the all-gather: the host's cost moves
    between machines).  One card can time no other collective: a ring
    across cards adds its hops to this host cost.
    The value only has to be of the right order to keep the bucket
    chooser out of the latency-bound regime.
"""
from __future__ import annotations

#: dense bf16 tensor-core rate of one H100 SXM, FLOP/s
PEAK_FLOPS = 989e12

#: fp32 rate outside the tensor cores, FLOP/s
FP32_FLOPS = 67e12

#: device-memory bandwidth, bytes/s
HBM_BW = 3.35e12

#: NVLink bandwidth each way between two cards of one H100 host, bytes/s
LINK_BW = 450e9

#: one collective's fixed cost in seconds (an NCCL all-gather of 64 bytes
#: at world size 1 on the H100, chip_smoke.py phase 6; see the docstring)
COLLECTIVE_LAUNCH_S = 65e-6

#: buckets the overlap wants in flight per shard: more buckets give finer
#: interleaving, fewer less launch overhead
TARGET_OVERLAP_BUCKETS = 8


def roofline_terms(cost: dict, coll_bytes: int) -> dict:
    """The three roofline terms of one device's work: ``cost`` holds
    ``"flops"`` and ``"bytes accessed"`` (the keys of XLA's cost
    analysis, kept so that one dict serves both packages), ``coll_bytes``
    the bytes its collectives send."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    return {
        "flops_per_device": flops,
        "bytes_per_device": byts,
        "collective_bytes_per_device": float(coll_bytes),
        "t_compute_s": flops / PEAK_FLOPS,
        "t_memory_s": byts / HBM_BW,
        "t_collective_s": coll_bytes / LINK_BW,
    }


def dominant_term(terms: dict) -> str:
    """"compute", "memory" or "collective": the largest of the terms."""
    t = {"compute": terms["t_compute_s"], "memory": terms["t_memory_s"],
         "collective": terms["t_collective_s"]}
    return max(t, key=t.get)


def loss_stage_seconds(batch_tokens: int, d_model: int, padded_vocab: int,
                       *, fused: bool, bytes_act: int = 2) -> float:
    """Device-memory-bound time of the LM loss and its gradient:
    ``fused=True`` the logits-free kernels' streams
    (``fused_ce.lm_loss_hbm_bytes_fused``), ``fused=False`` the
    materialized fp32 logits' ~5 crossings (``_unfused``)."""
    from ..kernels.fused_ce import (lm_loss_hbm_bytes_fused,
                                    lm_loss_hbm_bytes_unfused)
    fn = lm_loss_hbm_bytes_fused if fused else lm_loss_hbm_bytes_unfused
    return fn(batch_tokens, d_model, padded_vocab, bytes_h=bytes_act) / HBM_BW


def attention_stage_seconds(B: int, H: int, Hkv: int, S: int, hd: int,
                            *, fused: bool, train: bool = True,
                            bytes_act: int = 2) -> float:
    """Device-memory-bound time of ONE layer's attention middle: fused,
    the flash kernels' streaming floor (each pass reads Q, K, V once and
    writes its output once; ``train=False`` the forward alone); unfused,
    the materialized fp32 score tiles' crossings (5 with the backward, 2
    without)."""
    from ..kernels.flash_attention import (attention_hbm_bytes_flash,
                                           attention_hbm_bytes_train_flash,
                                           attention_hbm_bytes_unfused)
    if fused:
        fn = (attention_hbm_bytes_train_flash if train
              else attention_hbm_bytes_flash)
        return fn(B, H, Hkv, S, hd, bytes_per_el=bytes_act) / HBM_BW
    passes = 5 if train else 2
    return attention_hbm_bytes_unfused(B, H, S, hd, passes=passes) / HBM_BW


def kv_cache_slot_bytes(cfg, cache_len: int, *, kv_dtype=None) -> int:
    """Device-memory bytes one serving slot's KV cache holds over all
    layers of ``cfg`` (a ``models.common.ModelConfig``):
    ``quant.kv_bytes_per_token`` (bf16 2 bytes an element; int8 1 byte
    and an fp32 scale a token a plane) times layers times ``cache_len``.
    At a fixed budget the slots are ``budget // slot_bytes``
    (:func:`kv_slots_at_budget`)."""
    from ..quant import kv_bytes_per_token
    kv_dtype = kv_dtype or cfg.kv_dtype
    return cfg.n_layers * cache_len * kv_bytes_per_token(
        cfg.n_kv_heads, cfg.hd, kv_dtype)


def kv_slots_at_budget(cfg, cache_len: int, hbm_budget_bytes: int,
                       *, kv_dtype=None) -> int:
    """Concurrent slots a fixed device-memory budget holds for the KV
    cache."""
    return int(hbm_budget_bytes
               // kv_cache_slot_bytes(cfg, cache_len, kv_dtype=kv_dtype))


def model_flops_train(n_params_active: int, tokens: int) -> float:
    """6 N T per step (forward and backward)."""
    return 6.0 * n_params_active * tokens


def model_flops_infer(n_params_active: int, tokens: int) -> float:
    """2 N T (forward only)."""
    return 2.0 * n_params_active * tokens


# ---------------------------------------------------------------------------
# the gradient collective's bucket model (distributed/overlap.py)


def ring_collective_seconds(nbytes: int, ndev: int, *, bw: float = LINK_BW,
                            launch: float = COLLECTIVE_LAUNCH_S) -> float:
    """Ring reduce-scatter + all-gather time for ``nbytes`` of payload:
    each phase moves ``(ndev-1)/ndev * nbytes`` per link."""
    if ndev <= 1:
        return 0.0
    return launch + 2.0 * (ndev - 1) / ndev * nbytes / bw


def ring_phase_seconds(nbytes: int, ndev: int, *, bw: float = LINK_BW,
                       launch: float = COLLECTIVE_LAUNCH_S) -> float:
    """ONE ring phase (a reduce-scatter OR an all-gather) of ``nbytes``."""
    if ndev <= 1:
        return 0.0
    return launch + (ndev - 1) / ndev * nbytes / bw


def exposed_comm_seconds(bucket_elems_list, ndev: int,
                         compute_budget_s: float, *, block: int = 256,
                         bw: float = LINK_BW,
                         launch: float = COLLECTIVE_LAUNCH_S) -> float:
    """Event-driven exposed-communication model of a bucket schedule.

    Bucket ``j``'s compressed reduction (an fp32 ring reduce-scatter, then
    an int8 + scales ring all-gather) joins one channel the moment its
    share of the backward has been produced, modelled as ready at
    ``compute_budget_s * (j + 1) / B``.  What the channel still owes once
    compute is done is exposed:

        exposed = max(0, channel_finish - compute_budget_s)

    The monolithic schedule is the one-bucket case: ready only when the
    backward completes, so all of its wire time is exposed."""
    buckets = [int(n) for n in bucket_elems_list]
    B = len(buckets)
    channel = 0.0
    for j, n in enumerate(buckets):
        ready = compute_budget_s * (j + 1) / B
        wire = (ring_phase_seconds(4 * n, ndev, bw=bw, launch=launch)
                + ring_phase_seconds(n + 4 * (-(-n // block)), ndev,
                                     bw=bw, launch=launch))
        channel = max(channel, ready) + wire
    return max(0.0, channel - compute_budget_s)


def choose_bucket_elems(total_elems: int, ndev: int, *, block: int = 256,
                        bytes_per_elem: float = 1.0 + 4.0 / 256,
                        target_buckets: int = TARGET_OVERLAP_BUCKETS,
                        bw: float = LINK_BW,
                        launch: float = COLLECTIVE_LAUNCH_S) -> int:
    """Bucket size (elements) of the bucketed compressed all-reduce.

    Overlap wants many buckets (``TARGET_OVERLAP_BUCKETS`` a shard); the
    launch cost wants few: the floor is the size at which the launch is at
    most 10% of a bucket's ring wire time.  ``bytes_per_elem`` defaults to
    the int8-plus-scales wire format.  The result is a multiple of
    ``block * ndev``, so every rank's segment stays aligned with the
    quantization blocks."""
    align = block * max(1, ndev)
    if total_elems <= align:
        return total_elems
    wire_bw = bw / max(1, 2 * (ndev - 1)) * max(1, ndev) if ndev > 1 else bw
    floor_elems = int(10.0 * launch * wire_bw / bytes_per_elem)
    want = max(floor_elems, total_elems // max(1, target_buckets))
    want = min(want, total_elems)
    b = -(-want // align) * align
    return min(b, total_elems)
