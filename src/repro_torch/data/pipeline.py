"""Data pipeline: deterministic, stateless, resumable; numpy only.  The
counterpart of ``repro/data/pipeline.py``.

Every batch is a pure function of ``(seed, step)``, so an exact resume
needs only the step counter, and the batches are bit-identical to the
reference's for every ``(seed, step)``.

  * SyntheticLM   — Zipf-distributed tokens with a Markov structure, so
    the loss decreases under training (the paper's OpenWebText is not
    available offline).
  * MemmapTokens  — a binary uint16 token file (the nanoGPT format the
    paper uses), memory-mapped, random offsets per step.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    source: str = "synthetic"          # synthetic | memmap
    path: Optional[str] = None         # for memmap
    zipf_a: float = 1.2                # synthetic skew


class SyntheticLM:
    """Markov-Zipf synthetic LM stream: token t+1 follows a fixed random
    bigram table 70% of the time and a Zipf draw otherwise."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.next_tok = rng.integers(0, cfg.vocab_size,
                                     size=(cfg.vocab_size,), dtype=np.int64)

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.global_batch, cfg.seq_len
        start = rng.integers(0, cfg.vocab_size, size=(B,))
        noise = (rng.zipf(cfg.zipf_a, size=(B, S + 1)) - 1) % cfg.vocab_size
        use_noise = rng.random((B, S + 1)) < 0.3
        toks = np.empty((B, S + 1), dtype=np.int64)
        toks[:, 0] = start
        for t in range(1, S + 1):
            det = self.next_tok[toks[:, t - 1]]
            toks[:, t] = np.where(use_noise[:, t], noise[:, t], det)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


class MemmapTokens:
    """nanoGPT-style binary token file (the paper's data format)."""

    def __init__(self, cfg: DataConfig, dtype=np.uint16):
        self.cfg = cfg
        self.data = np.memmap(cfg.path, dtype=dtype, mode="r")

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.global_batch, cfg.seq_len
        ix = rng.integers(0, len(self.data) - S - 1, size=(B,))
        toks = np.stack([self.data[i:i + S + 1].astype(np.int32) for i in ix])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_source(cfg: DataConfig):
    if cfg.source == "memmap":
        return MemmapTokens(cfg)
    return SyntheticLM(cfg)


def iterate(source, start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield source.batch_at(step)
        step += 1
