"""Continuous-batching serve engine: slot scheduler over the decode burst.

The counterpart of ``repro/serve/engine.py``.  Requests stream in through
:meth:`ServeEngine.submit`; the engine admits them into free slots,
chunk-prefills (one ``page_len`` chunk per admitted request per tick, so
in-flight decodes never stall behind a long prompt), decodes every active
slot in bursts of ``steps_per_tick`` tokens, and evicts finished sequences,
freeing their slots for the queue.  Slots are independent rows of the ring
KV cache, so a *greedy* request's tokens do not depend on what else shares
the batch.  Temperature sampling draws from the engine's one device
generator, so sampled tokens depend on scheduling.

Telemetry: per-request queue/prefill/first-token/total latency and
per-tick slot utilization, aggregated by :meth:`stats`.  Each decode
tick's time covers its device work: reading the burst's tokens back to the
host waits for the device.

Not ported yet: the shared-prefix page cache (``prefix_cache=True``
raises) and encoder-decoder requests.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models import ModelConfig, get_model
from .decode import NO_EOS, make_decode_burst, sample_tokens

FREE, PREFILL, ACTIVE = 0, 1, 2


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    GPU.  Without a GPU and without a device asked for, raise: the port
    does not carry on on the CPU unasked.  A CUDA device without an index
    resolves to the current one."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port serves on the GPU; "
                           "pass device='cpu' to run its plain CPU path")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _pct(xs, q: float) -> float:
    if not xs:
        return 0.0
    xs = sorted(xs)
    return float(xs[min(len(xs) - 1, int(len(xs) * q))])


@dataclasses.dataclass
class Request:
    """One generation request: ``tokens`` is the prompt (1-D int);
    ``temperature <= 0`` decodes greedily."""
    uid: Any
    tokens: Any
    max_new: int
    temperature: float = 0.0
    eos_id: Optional[int] = None


@dataclasses.dataclass
class RequestResult:
    uid: Any
    tokens: List[int]
    submitted_t: float
    admitted_t: float
    first_token_t: float
    done_t: float

    @property
    def latency_s(self) -> float:
        return self.done_t - self.submitted_t

    @property
    def ttft_s(self) -> float:
        """Time to first token (queue wait + prefill)."""
        return self.first_token_t - self.submitted_t


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, *, n_slots: int = 4,
                 cache_len: int = 256, page_len: int = 32,
                 steps_per_tick: int = 8, seed: int = 0,
                 prefix_cache: bool = False,
                 kv_dtype: Optional[str] = None, device=None):
        if prefix_cache:
            raise NotImplementedError("the prefix cache is not ported yet")
        if kv_dtype is not None and kv_dtype != cfg.kv_dtype:
            cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
        self.device = resolve_device(device)
        if params.embed["tok"].device != self.device:
            raise ValueError(f"params on {params.embed['tok'].device}, "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.model = get_model(cfg)
        self.n_slots = n_slots
        self.page_len = page_len
        # round the ring up to whole pages so a final prefill chunk always
        # fits (start + page_len <= cache_len)
        self.cache_len = -(-cache_len // page_len) * page_len
        self.steps_per_tick = steps_per_tick
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = self.model.init_slots(cfg, n_slots, self.cache_len,
                                           self.device)
        self._burst = make_decode_burst(cfg, steps_per_tick)

        # host-side slot table
        self.slot_mode = [FREE] * n_slots
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.slot_cursor = [0] * n_slots          # prefill progress (tokens)
        self.slot_out: List[List[int]] = [[] for _ in range(n_slots)]
        self.slot_meta: List[Optional[dict]] = [None] * n_slots
        self._last_tok = np.zeros((n_slots,), np.int32)
        self._pos = np.zeros((n_slots,), np.int32)
        self._rem = np.zeros((n_slots,), np.int32)
        self._temps = np.zeros((n_slots,), np.float32)
        self._eos = np.full((n_slots,), NO_EOS, np.int32)

        self.queue: deque = deque()
        self.results: List[RequestResult] = []
        # telemetry
        self.tick_utilization: List[float] = []
        self.token_latencies: List[float] = []
        self.tokens_emitted = 0
        self.decode_ticks = 0

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        prompt_len = int(np.asarray(req.tokens).shape[0])
        if prompt_len + req.max_new > self.cache_len:
            raise ValueError(
                f"request {req.uid}: prompt {prompt_len} + max_new "
                f"{req.max_new} exceeds cache_len {self.cache_len}")
        if (self.cfg.learned_pos and prompt_len + req.max_new
                > self.cfg.max_position_embeddings):
            raise ValueError(
                f"request {req.uid}: prompt {prompt_len} + max_new "
                f"{req.max_new} exceeds the model's "
                f"{self.cfg.max_position_embeddings} learned positions")
        self.queue.append((req, time.perf_counter()))

    def idle(self) -> bool:
        return not self.queue and all(m == FREE for m in self.slot_mode)

    # ------------------------------------------------------------------
    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _admit(self) -> None:
        for slot in range(self.n_slots):
            if self.slot_mode[slot] != FREE or not self.queue:
                continue
            req, submitted_t = self.queue.popleft()
            self.state = self.model.reset_slot(self.cfg, self.state, slot)
            self.slot_mode[slot] = PREFILL
            self.slot_req[slot] = req
            self.slot_cursor[slot] = 0
            self.slot_out[slot] = []
            self.slot_meta[slot] = {"submitted_t": submitted_t,
                                    "admitted_t": time.perf_counter()}
            self._temps[slot] = req.temperature
            self._eos[slot] = NO_EOS if req.eos_id is None else req.eos_id

    def _prefill_tick(self) -> None:
        P = self.page_len
        for slot in range(self.n_slots):
            if self.slot_mode[slot] != PREFILL:
                continue
            prompt = np.asarray(self.slot_req[slot].tokens,
                                np.int32).reshape(-1)
            start = self.slot_cursor[slot]
            chunk = prompt[start:start + P]
            n_valid = chunk.shape[0]
            if n_valid < P:
                chunk = np.pad(chunk, (0, P - n_valid))
            logits = self.model.prefill_into_slot(
                self.cfg, self.params, self.state, slot,
                self._to_device(chunk)[None], start, n_valid)
            self.slot_cursor[slot] = start + n_valid
            if self.slot_cursor[slot] >= prompt.shape[0]:
                self._activate(slot, logits)

    def _activate(self, slot: int, logits) -> None:
        """Prefill done: sample the first token and open the slot."""
        req = self.slot_req[slot]
        first = int(sample_tokens(self._gen, logits[None],
                                  self._to_device(self._temps[slot:slot + 1]))[0])
        self.slot_meta[slot]["first_token_t"] = time.perf_counter()
        self.slot_out[slot].append(first)
        self.tokens_emitted += 1
        self._last_tok[slot] = first
        self._pos[slot] = self.slot_cursor[slot]
        hit_eos = self._eos[slot] != NO_EOS and first == self._eos[slot]
        self._rem[slot] = 0 if hit_eos else req.max_new - 1
        self.slot_mode[slot] = ACTIVE
        if self._rem[slot] == 0:
            self._finish(slot)

    def _decode_tick(self) -> None:
        if not any(self.slot_mode[s] == ACTIVE and self._rem[s] > 0
                   for s in range(self.n_slots)):
            return
        t0 = time.perf_counter()
        self.state, toks, pos, rem, ys, act = self._burst(
            self.params, self.state, self._to_device(self._last_tok[:, None]),
            self._to_device(self._pos), self._to_device(self._rem),
            self._to_device(self._temps), self._to_device(self._eos),
            self._gen)
        ys = ys.cpu().numpy()        # waits for the burst's device work
        act = act.cpu().numpy()
        dt = time.perf_counter() - t0
        n_emitted = int(act.sum())
        if n_emitted:
            self.token_latencies.extend([dt / self.steps_per_tick] * n_emitted)
        self.tokens_emitted += n_emitted
        self.decode_ticks += 1
        self.tick_utilization.append(
            sum(m == ACTIVE for m in self.slot_mode) / self.n_slots)
        self._last_tok = toks[:, 0].cpu().numpy().copy()
        self._pos = pos.cpu().numpy().copy()
        self._rem = rem.cpu().numpy().copy()
        for t in range(ys.shape[0]):
            for slot in range(self.n_slots):
                if act[t, slot]:
                    self.slot_out[slot].append(int(ys[t, slot]))
        for slot in range(self.n_slots):
            if self.slot_mode[slot] == ACTIVE and self._rem[slot] == 0:
                self._finish(slot)

    def _finish(self, slot: int) -> None:
        req = self.slot_req[slot]
        meta = self.slot_meta[slot]
        self.results.append(RequestResult(
            uid=req.uid, tokens=list(self.slot_out[slot]),
            submitted_t=meta["submitted_t"], admitted_t=meta["admitted_t"],
            first_token_t=meta.get("first_token_t", time.perf_counter()),
            done_t=time.perf_counter()))
        self.slot_mode[slot] = FREE
        self.slot_req[slot] = None
        self._rem[slot] = 0
        self._temps[slot] = 0.0
        self._eos[slot] = NO_EOS

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def tick(self) -> None:
        """One scheduler round: admit -> chunk-prefill -> decode burst,
        under ``torch.inference_mode()`` (serving records no autograd)."""
        self._admit()
        self._prefill_tick()
        self._decode_tick()

    def run(self, max_ticks: int = 100_000) -> List[RequestResult]:
        """Drive ticks until every submitted request has finished."""
        ticks = 0
        while not self.idle():
            self.tick()
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError("engine did not drain "
                                   f"within {max_ticks} ticks")
        return self.results

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, float]:
        lat = sorted(self.token_latencies) or [0.0]
        util = self.tick_utilization or [0.0]
        ttft = [r.ttft_s for r in self.results]
        # time-per-output-token after the first (steady decode cadence)
        tpot = [(r.done_t - r.first_token_t) / max(1, len(r.tokens) - 1)
                for r in self.results]
        qwait = [r.admitted_t - r.submitted_t for r in self.results]
        return {
            "tokens_emitted": self.tokens_emitted,
            "decode_ticks": self.decode_ticks,
            "slot_utilization": float(np.mean(util)),
            "token_lat_p50_s": float(lat[len(lat) // 2]),
            "token_lat_p95_s": float(lat[min(len(lat) - 1,
                                             int(len(lat) * 0.95))]),
            "mean_request_latency_s": float(np.mean(
                [r.latency_s for r in self.results])) if self.results else 0.0,
            "mean_ttft_s": float(np.mean(ttft)) if ttft else 0.0,
            "ttft_p50_s": _pct(ttft, 0.50),
            "ttft_p95_s": _pct(ttft, 0.95),
            "ttft_p99_s": _pct(ttft, 0.99),
            "tpot_p50_s": _pct(tpot, 0.50),
            "tpot_p95_s": _pct(tpot, 0.95),
            "tpot_p99_s": _pct(tpot, 0.99),
            "queue_wait_p50_s": _pct(qwait, 0.50),
            "queue_wait_p95_s": _pct(qwait, 0.95),
            "queue_wait_p99_s": _pct(qwait, 0.99),
        }
