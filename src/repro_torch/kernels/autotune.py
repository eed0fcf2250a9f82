"""Shape-keyed tuner of the CE and flash kernels' tiles: the counterpart of
``repro/kernels/autotune.py``, for the port's own kernels on the H100.

What it tunes is what the hand-written kernels leave open:

  * the CE forward with bf16 h (rows 11-12, ``ce_fwd_wgmma_kernel``): the
    persistent walk's ``pieces`` (k, the runs each row tile's vocabulary
    is cut into) and ``group`` (G, the row tiles a group);
  * the CE backward with bf16 h (rows 13-15, ``ce_wgmma_kernel``): the
    chunk width ``cw``, the vocabulary columns of a chunk;
  * the flash kernels in bf16 (rows 16-18): the forward's and dQ's key
    tile and dK/dV's (q tile, head dims a block) among the instantiations
    built (``flash_attention.KEY_TILES``, ``DKV_TILES``).

The fp32 routes (FMA kernels, the card-vs-CPU checks) have fixed tiles,
and the plain versions on the CPU keep their ``CHUNK``: neither is tuned,
and a CPU tensor never consults this module.

Three stages, as in the reference:

1. **candidates**: for the forward, the few k whose busiest block is
   within ``PIECE_SLACK`` tiles of the best (``fused_ce.piece_loads``)
   with G in {every row tile, 12, 6}; for the backward, the widths that
   ``WS_BUDGETS`` of d planes give (``fused_ce.backward_plan``), skipping
   any whose workspace exceeds what the caller allows; for flash, each
   kernel's built tiles at the head dim.
2. **predict** (the forward only): each (k, G)'s roofline at
   ``launch/roofline.py``'s peaks over the walk's busy share
   (``fused_ce.plan_at``) orders which of its up to nine candidates are
   measured (``MEASURE_TOP_K``, the seed always among them).  The
   backward's widths (at most four beside the seed) and the flash tiles
   (two a kernel) are all measured.
3. **measure**: CUDA events on the caller's stream around each launch,
   the L2 flushed before it, the median of ``MEASURE_REPS``; the fastest
   candidate of each kernel is the pick.  Only measured picks are
   persisted.

**Seed versus roofline pick.**  Without a measured entry ``get_tuned`` and
``get_tuned_attn`` return the seed, which is exactly the pick the
wrappers made before the tuner existed (``source="seed"``:
``fused_ce.forward_plan``'s k and G, ``fused_ce.backward_plan``'s 256-MiB
chunk width, each flash kernel's first tile), so no launch changes until
someone tunes.  The reference runs its roofline-only pick instead; here
the tensor-core kernels land 1.1-2x off their reckoning (PERF.md §6, "What
the predictions taught"), so a prediction is trusted to order candidates
and never to replace today's measured choice.

The cache is keyed on the shape (N, D, Vp, h and W dtypes, tied or
untied, softcap, norm; or B, H, Hkv, Sq, Sk, hd, dtype, causal, window,
softcap), the device's name and SM count and ``CACHE_VERSION``, and
lives at ``$REPRO_TORCH_AUTOTUNE_CACHE`` (default
``~/.cache/repro_torch/autotune.json``).  A lookup reads the file once a
process; after that it is a dict access.  A measured pick is written into
the file as it is on disk at that moment (the other entries stay), through
a temporary file and a rename.  Measurement only runs eagerly, from
``tune_shape`` / ``tune_attn_shape`` (``launch/train.py --retune``,
``chip_smoke.py``); its launches are not the caller's, so the launch
counts (``KERNEL_LAUNCHES``) are restored after it.  Processes whose
launches must agree (model peers compute the same loss, and a chunk width
changes dh's summation order) take one process's measurement:
``launch/train.py --retune`` tunes on rank 0, which alone writes the file,
and the other ranks :func:`adopt` its picks.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import statistics
import threading
from collections import Counter
from typing import Optional

import torch

from ..launch.roofline import HBM_BW, PEAK_FLOPS
from . import KERNEL_LAUNCHES
from . import flash_attention as fa
from . import fused_ce as ce

CACHE_VERSION = 2
MEASURE_TOP_K = 4
MEASURE_REPS = 10
MEASURE_WARMUP = 2

L2_BYTES = 50 << 20            # the H100's L2
WS_BUDGETS = (128 << 20, 256 << 20, 512 << 20, 1024 << 20)   # d planes
ROW_GROUPS = (12, 6)           # besides every row tile a group
PIECE_SLACK = 2                # tiles above the best busiest block
MAX_PIECE_COUNTS = 3           # values of k considered

_LOCK = threading.Lock()
_CE: dict = {}                 # key -> TunedCE (measured and seed picks)
_ATTN: dict = {}               # key -> TunedAttn
_LOADED = False


@dataclasses.dataclass(frozen=True)
class TunedCE:
    """The CE kernels' choices at one shape: the forward's ``pieces`` and
    ``group``, the backward's chunk width ``cw``; ``source`` "seed" or
    "measured"; the pick's measured ms (forward plus backward), the
    seed's and every measured candidate's (``timings``, label -> ms)."""
    pieces: int
    group: int
    cw: int
    source: str
    measured_ms: Optional[float] = None
    seed_ms: Optional[float] = None
    timings: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class TunedAttn:
    """The flash kernels' tiles at one shape (``flash_attention.FlashTiles``
    as ``tiles``) and their provenance, as :class:`TunedCE`."""
    fwd: int
    dq: int
    dkv_bq: int
    dkv_ho: int
    source: str
    measured_ms: Optional[float] = None
    seed_ms: Optional[float] = None
    timings: dict = dataclasses.field(default_factory=dict)

    @property
    def tiles(self) -> fa.FlashTiles:
        return fa.FlashTiles(self.fwd, self.dq, (self.dkv_bq, self.dkv_ho))


def cache_path() -> str:
    return os.environ.get(
        "REPRO_TORCH_AUTOTUNE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                     "autotune.json"))


def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "")


@functools.cache
def device_info(index: int):
    """(name, SM count) of CUDA device ``index``."""
    p = torch.cuda.get_device_properties(index)
    return p.name, p.multi_processor_count


def _device(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise ValueError(f"autotune: the kernels are tuned on a CUDA device, "
                         f"not {device}: the plain versions on the CPU are "
                         f"never tuned")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _tag(name: str, sms: int) -> str:
    return f"{name}|sm{sms}|v{CACHE_VERSION}"


def cache_key(N, D, Vp, *, h_dtype, w_dtype, transpose_w, softcap, norm,
              device_name, sms) -> str:
    return (f"ce-N{N}-D{D}-V{Vp}-h{_dt(h_dtype)}-w{_dt(w_dtype)}-"
            f"{'untied' if transpose_w else 'tied'}-"
            f"cap{float(softcap) if softcap else 0}-norm{norm or 'none'}|"
            + _tag(device_name, sms))


def attn_cache_key(B, H, Hkv, Sq, Sk, hd, *, dtype, causal, window, softcap,
                   device_name, sms) -> str:
    return (f"attn-B{B}-H{H}-Hkv{Hkv}-Sq{Sq}-Sk{Sk}-hd{hd}-{_dt(dtype)}-"
            f"{'causal' if causal else 'bidi'}-win{window or 0}-"
            f"cap{float(softcap) if softcap else 0}|" + _tag(device_name, sms))


# ---------------------------------------------------------------------------
# the persistent cache


def _read() -> dict:
    """The file's entries, ``{"ce": {key: fields}, "attn": {...}}``: none
    when there is no file, or it holds another version's cache or no JSON
    (it is rewritten at the next save)."""
    try:
        with open(cache_path()) as f:
            blob = json.load(f)
    except (FileNotFoundError, ValueError):
        blob = {}
    if not isinstance(blob, dict) or blob.get("version") != CACHE_VERSION:
        blob = {}
    return {"ce": dict(blob.get("ce", {})), "attn": dict(blob.get("attn", {}))}


def _load() -> None:
    """Read the cache file into memory once a process (under _LOCK)."""
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    blob = _read()
    for k, e in blob["ce"].items():
        _CE.setdefault(k, TunedCE(**e))
    for k, e in blob["attn"].items():
        _ATTN.setdefault(k, TunedAttn(**e))


def _save(key: str, tuned=None) -> None:
    """Write ``tuned`` at ``key`` into the file, or remove ``key`` (None),
    under _LOCK: the file is read again first, so that the entries other
    runs wrote stay, then replaced atomically (a file of this process
    beside it, then a rename).  Seed picks are never written."""
    blob = _read()
    blob["ce"].pop(key, None)
    blob["attn"].pop(key, None)
    if tuned is not None:
        blob["ce" if isinstance(tuned, TunedCE) else "attn"][key] = \
            dataclasses.asdict(tuned)
    path = cache_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(dict(blob, version=CACHE_VERSION), f, indent=1,
                  sort_keys=True)
    os.replace(tmp, path)


def clear_memory_cache() -> None:
    """Forget this process's picks (the file stays; the next lookup reads
    it again)."""
    global _LOADED
    with _LOCK:
        _CE.clear()
        _ATTN.clear()
        _LOADED = False


def drop_entry(key: str) -> None:
    """Remove one entry, CE or attention, from memory and from the file."""
    with _LOCK:
        _load()
        _CE.pop(key, None)
        _ATTN.pop(key, None)
        _save(key)


def _remember(store: dict, key: str, tuned):
    with _LOCK:
        _load()
        store[key] = tuned
        if tuned.source == "measured":
            _save(key, tuned)
    return tuned


def adopt(tuned, device, **shape) -> None:
    """Hold ``tuned``, a :class:`TunedCE` or :class:`TunedAttn` that another
    process measured, as this process's pick at ``shape`` (the keyword
    arguments of :func:`cache_key` or :func:`attn_cache_key` but the
    device's) on ``device``.  In memory only: the process that measured it
    wrote the file."""
    device = _device(device)
    name, sms = device_info(device.index)
    if isinstance(tuned, TunedCE):
        store, key = _CE, cache_key(**shape, device_name=name, sms=sms)
    else:
        store, key = _ATTN, attn_cache_key(**shape, device_name=name,
                                           sms=sms)
    with _LOCK:
        _load()
        store[key] = tuned


# ---------------------------------------------------------------------------
# the CE kernels: candidates and the forward's prediction


def ce_seed(N: int, D: int, Vp: int, sms: int) -> TunedCE:
    """Today's pick: ``forward_plan``'s k and G, ``backward_plan``'s cw."""
    plan = ce.forward_plan(N, Vp, D, sms)
    return TunedCE(plan.pieces, plan.group, ce.backward_plan(N, Vp), "seed")


def candidate_blocks(N: int, D: int, Vp: int, *, sms: int, w_bf16: bool,
                     norm, ws_limit: Optional[int] = None):
    """(forward candidates [(pieces, group)], backward candidates [cw]),
    the seed's first in each; a backward width whose workspace exceeds
    ``ws_limit`` bytes is skipped (never the seed's)."""
    seed = ce_seed(N, D, Vp, sms)
    n_rt = -(-N // 128)
    loads = ce.piece_loads(N, Vp, sms)
    best = min(loads)[0]
    ks = [k for load, k in sorted(loads) if load <= best + PIECE_SLACK]
    ks = [seed.pieces] + [k for k in ks[:MAX_PIECE_COUNTS]
                          if k != seed.pieces]
    groups = [seed.group] + sorted({min(n_rt, g) for g in (n_rt,)
                                    + ROW_GROUPS} - {seed.group},
                                   reverse=True)
    fwd = [(k, g) for k in ks for g in groups]
    dh_f32 = norm is not None          # the combined call's dh with a norm
    bwd = [seed.cw]
    for budget in WS_BUDGETS:
        cw = ce.backward_plan(N, Vp, budget)
        ws = ce.backward_ws_bytes(N, D, Vp, w_bf16=w_bf16, dh_f32=dh_f32,
                                  cw=cw)
        if cw not in bwd and (ws_limit is None or ws <= ws_limit):
            bwd.append(cw)
    return fwd, bwd


def predict_seconds(N: int, D: int, Vp: int, *, pieces: int, group: int,
                    sms: int, bytes_w: int) -> float:
    """The bf16-h forward at (pieces, group): the product at PEAK_FLOPS or
    its bytes at HBM_BW, whichever is longer, over the walk's busy share
    (1 - idle share).  Bytes: h and W read and h_n and W's bf16 plane
    written by the prep; h_n read once if a group's rows stay in the L2,
    else once a piece; W's plane once if it stays in the L2, else once a
    group of row tiles; the partials written and read by the combine."""
    plan = ce.plan_at(N, Vp, pieces, group, sms)
    Np = plan.row_tiles * 128
    hn, wp = Np * D * 2, Vp * D * 2
    n_groups = -(-plan.row_tiles // group)
    hn_reads = 1 if group * 128 * D * 2 <= L2_BYTES else pieces
    w_reads = 1 if wp <= L2_BYTES else n_groups
    nbytes = (N * D * 2 + Vp * D * bytes_w + hn + wp
              + hn * hn_reads + wp * w_reads + 2 * 20 * pieces * N)
    t = max(2.0 * Np * D * Vp / PEAK_FLOPS, nbytes / HBM_BW)
    return t / (1.0 - plan.idle_share)


# ---------------------------------------------------------------------------
# the flash kernels: candidates


def attn_candidate_blocks(hd: int):
    """{kernel: [its tiles at ``hd``, the seed's first]}: the forward's
    and dQ's key tiles, dK/dV's (BQ, HO)."""
    return {"attn_fwd": list(fa.KEY_TILES[hd]),
            "attn_bwd_dq": list(fa.KEY_TILES[hd]),
            "attn_bwd_dkv": list(fa.DKV_TILES[hd])}


def tile_label(which: str, tile) -> str:
    """``attn_fwd BN=64``, ``attn_bwd_dkv BQ=32 HO=64``."""
    if which == "attn_bwd_dkv":
        return f"{which} BQ={tile[0]} HO={tile[1]}"
    return f"{which} BN={tile}"


def attn_seed(hd: int) -> TunedAttn:
    t = fa.seed_tiles(hd)
    return TunedAttn(t.fwd, t.dq, *t.dkv, "seed")


# ---------------------------------------------------------------------------
# lookups: the wrappers' path


def get_tuned(N: int, D: int, Vp: int, *, h_dtype, w_dtype, transpose_w,
              softcap, norm, device) -> TunedCE:
    """The CE kernels' choices for this shape on ``device`` (a CUDA
    device): the measured entry, else the seed.  After the first call a
    process makes, a dict access."""
    device = _device(device)
    name, sms = device_info(device.index)
    key = cache_key(N, D, Vp, h_dtype=h_dtype, w_dtype=w_dtype,
                    transpose_w=transpose_w, softcap=softcap, norm=norm,
                    device_name=name, sms=sms)
    hit = _CE.get(key)
    if hit is None:
        with _LOCK:
            _load()
            hit = _CE.get(key)
            if hit is None:
                hit = _CE[key] = ce_seed(N, D, Vp, sms)
    return hit


def get_tuned_attn(B, H, Hkv, Sq, Sk, hd, *, dtype, causal, window, softcap,
                   device) -> TunedAttn:
    """The flash kernels' tiles for this shape on ``device``: the measured
    entry, else the seed (each kernel's first built tile)."""
    device = _device(device)
    name, sms = device_info(device.index)
    key = attn_cache_key(B, H, Hkv, Sq, Sk, hd, dtype=dtype, causal=causal,
                         window=window, softcap=softcap, device_name=name,
                         sms=sms)
    hit = _ATTN.get(key)
    if hit is None:
        with _LOCK:
            _load()
            hit = _ATTN.get(key)
            if hit is None:
                hit = _ATTN[key] = attn_seed(hd)
    return hit


# ---------------------------------------------------------------------------
# measurement


def _time_ms(fn, flush) -> float:
    """Median device time of one call of ``fn``: CUDA events on the current
    stream around each call, the L2 flushed before it by reading a buffer
    larger than the cache, and the stream held by a short device-side
    sleep so that the events time the device's work, not the host's
    issue."""
    for _ in range(MEASURE_WARMUP):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True))
          for _ in range(MEASURE_REPS)]
    for start, end in ev:
        flush.sum()
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def _flush_buffer(device):
    return torch.zeros(2 * L2_BYTES // 4, dtype=torch.float32, device=device)


def _ranked(cands, predict, seed):
    """The seed and the MEASURE_TOP_K best-predicted others."""
    rest = sorted((c for c in cands if c != seed), key=lambda c:
                  (predict(c), str(c)))
    return [seed] + rest[:MEASURE_TOP_K]


def _pick(times: dict):
    """The fastest candidate; the first listed (the seed) on a tie."""
    return min(times, key=lambda c: times[c])


class _KeepCounts:
    """Restores ``KERNEL_LAUNCHES`` on exit: the tuner's launches are not
    the caller's run."""

    def __enter__(self):
        self.saved = Counter(KERNEL_LAUNCHES)

    def __exit__(self, *exc):
        KERNEL_LAUNCHES.clear()
        KERNEL_LAUNCHES.update(self.saved)


def tune_shape(N: int, D: int, Vp: int, *, h_dtype=torch.bfloat16,
               w_dtype=torch.float32, transpose_w=False, softcap=None,
               norm=None, device=None, ws_limit: Optional[int] = None,
               refresh: bool = False) -> TunedCE:
    """Measure the CE kernels' candidates at one shape on the card and
    keep the fastest forward (rows 11) and combined backward (row 13);
    the pick is persisted.  ``ws_limit`` bounds a candidate backward's
    workspace in bytes (default: the device's free memory).  Without
    ``refresh`` a measured entry is returned as it is.  Only bf16 h has a
    choice; any other dtype, or a CPU device, raises ``ValueError``."""
    device = _device(device)
    if h_dtype != torch.bfloat16:
        raise ValueError(f"autotune: h {h_dtype} runs the fp32 kernels, "
                         f"whose tiles are fixed; only bf16 h is tuned")
    name, sms = device_info(device.index)
    key = cache_key(N, D, Vp, h_dtype=h_dtype, w_dtype=w_dtype,
                    transpose_w=transpose_w, softcap=softcap, norm=norm,
                    device_name=name, sms=sms)
    if not refresh:
        with _LOCK:
            _load()
            hit = _CE.get(key)
        if hit is not None and hit.source == "measured":
            return hit
    if ws_limit is None:
        ws_limit = torch.cuda.mem_get_info(device)[0]
    seed = ce_seed(N, D, Vp, sms)
    w_bf16 = w_dtype == torch.bfloat16
    fwd_c, bwd_c = candidate_blocks(N, D, Vp, sms=sms, w_bf16=w_bf16,
                                    norm=norm, ws_limit=ws_limit)
    bytes_w = 2 if w_bf16 else 4

    def pf(c):
        return predict_seconds(N, D, Vp, pieces=c[0], group=c[1], sms=sms,
                               bytes_w=bytes_w)

    gen = torch.Generator(device=device).manual_seed(0)
    h = torch.randn((N, D), generator=gen, device=device).to(h_dtype)
    w = (torch.randn((D, Vp) if transpose_w else (Vp, D), generator=gen,
                     device=device) * 0.02).to(w_dtype)
    labels = torch.randint(0, Vp, (N,), generator=gen, device=device,
                           dtype=torch.int32)
    normp = torch.stack([torch.ones(D, device=device),
                         torch.zeros(D, device=device)])
    opts = dict(vocab=Vp, transpose_w=bool(transpose_w),
                softcap=float(softcap) if softcap else None, norm=norm,
                eps=1e-6)
    rs = torch.full((N,), 1.0 / N, device=device)
    flush = _flush_buffer(device)
    with _KeepCounts():
        lse, _, _ = ce._forward_kernel(h, w, normp, labels, None, **opts,
                                       plan=(seed.pieces, seed.group))
        fwd_t = {c: _time_ms(lambda c=c: ce._forward_kernel(
            h, w, normp, labels, None, **opts, plan=c), flush)
            for c in _ranked(fwd_c, pf, (seed.pieces, seed.group))}
        bwd_t = {cw: _time_ms(lambda cw=cw: ce._backward_kernel(
            "both", h, w, normp, labels, rs, lse, **opts, cw=cw), flush)
            for cw in bwd_c}
        torch.cuda.synchronize()
    del h, w, labels, normp, rs, lse, flush
    (k, g), cw = _pick(fwd_t), _pick(bwd_t)
    timings = {f"ce_forward pieces={c[0]} group={c[1]}": ms
               for c, ms in fwd_t.items()}
    timings.update({f"ce_backward cw={c}": ms for c, ms in bwd_t.items()})
    tuned = TunedCE(k, g, cw, "measured",
                    measured_ms=fwd_t[(k, g)] + bwd_t[cw],
                    seed_ms=(fwd_t[(seed.pieces, seed.group)]
                             + bwd_t[seed.cw]),
                    timings=timings)
    return _remember(_CE, key, tuned)


def tune_attn_shape(B, H, Hkv, Sq, Sk, hd, *, dtype=torch.bfloat16,
                    causal=True, window=None, softcap=None, device=None,
                    refresh: bool = False) -> TunedAttn:
    """Measure each flash kernel's built tiles at one shape on the card
    and keep each kernel's fastest; the pick is persisted.  As
    :func:`tune_shape`: bf16 only, CUDA only, ``refresh`` re-measures."""
    device = _device(device)
    if dtype != torch.bfloat16:
        raise ValueError(f"autotune: {dtype} runs the fp32 flash kernels, "
                         f"whose tiles are fixed; only bf16 is tuned")
    if hd not in fa.KEY_TILES:
        raise ValueError(f"autotune: head dim {hd} not in {fa.HEAD_DIMS}")
    name, sms = device_info(device.index)
    key = attn_cache_key(B, H, Hkv, Sq, Sk, hd, dtype=dtype, causal=causal,
                         window=window, softcap=softcap, device_name=name,
                         sms=sms)
    if not refresh:
        with _LOCK:
            _load()
            hit = _ATTN.get(key)
        if hit is not None and hit.source == "measured":
            return hit
    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    q, do = randn(B, H, Sq, hd), randn(B, H, Sq, hd)
    k, v = randn(B, Hkv, Sk, hd), randn(B, Hkv, Sk, hd)
    opts = dict(causal=bool(causal), window=window,
                softcap=float(softcap) if softcap else None, q_offset=0,
                scale=1.0 / math.sqrt(hd))
    seed = fa.seed_tiles(hd)
    seed_of = {"attn_fwd": seed.fwd, "attn_bwd_dq": seed.dq,
               "attn_bwd_dkv": seed.dkv}
    cands = attn_candidate_blocks(hd)
    flush = _flush_buffer(device)
    times = {}
    with _KeepCounts():
        o, lse = fa._forward_kernel(q, k, v, tiles=seed, **opts)
        delta = (do.float() * o.float()).sum(-1)
        calls = {
            "attn_fwd": lambda t: fa._forward_kernel(
                q, k, v, tiles=seed._replace(fwd=t), **opts),
            "attn_bwd_dq": lambda t: fa._dq_kernel(
                q, k, v, do, lse, delta, tiles=seed._replace(dq=t), **opts),
            "attn_bwd_dkv": lambda t: fa._dkv_kernel(
                q, k, v, do, lse, delta, tiles=seed._replace(dkv=t), **opts)}
        for which, call in calls.items():
            times[which] = {
                t: _time_ms(lambda t=t, call=call: call(t), flush)
                for t in cands[which]}
        torch.cuda.synchronize()
    del q, k, v, do, o, lse, delta, flush
    pick = {w: _pick(t) for w, t in times.items()}
    tuned = TunedAttn(
        pick["attn_fwd"], pick["attn_bwd_dq"], *pick["attn_bwd_dkv"],
        "measured", measured_ms=sum(times[w][t] for w, t in pick.items()),
        seed_ms=sum(times[w][seed_of[w]] for w in times),
        timings={tile_label(w, t): ms for w, ts in times.items()
                 for t, ms in ts.items()})
    return _remember(_ATTN, key, tuned)
