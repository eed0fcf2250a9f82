"""Assigned input shapes and the per-(arch, shape) input specs: the
counterpart of ``repro/configs/shapes.py``.

Shapes (LM family, seq_len x global_batch):
    train_4k     4,096 x 256   train_step
    prefill_32k  32,768 x 32   prefill step (forward + KV-cache fill)
    decode_32k   32,768 x 128  serve_step: 1 new token, cache of seq_len
    long_500k    524,288 x 1   serve_step; only the bounded-state families
                               (rwkv, griffin): a full-attention family's
                               KV state is unbounded there and is skipped

``input_specs`` returns stand-ins for every model input: tensors on the
``meta`` device, with the reference's shapes and dtypes and no storage,
so that a cell of any size costs nothing to describe.  The reference's
``jax.ShapeDtypeStruct`` leaves are its counterparts; a cache is the
tree its family's ``init_cache`` (``init_state`` for the bounded-state
families) builds, on ``meta``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models import ModelConfig
from ..models import encdec as encdec_mod
from ..models import griffin as griffin_mod
from ..models import rwkv as rwkv_mod
from ..models import transformer as tf_mod

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

BOUNDED_STATE_FAMILIES = ("rwkv", "griffin")
N_PATCHES = 256          # qwen2-vl stub: one 256-patch image per sequence
META = torch.device("meta")


def applicable(cfg: ModelConfig, shape_name: str) -> tuple:
    """(runs?, reason if skipped)."""
    if shape_name == "long_500k" and cfg.family not in BOUNDED_STATE_FAMILIES:
        return False, ("full-attention KV state is unbounded at 524k; "
                       "long_500k runs only for SSM/hybrid archs")
    return True, ""


@dataclasses.dataclass
class Cell:
    kind: str                     # train | prefill | decode
    specs: dict                   # kwargs of the step function (meta trees)
    note: str = ""


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _token_batch(B: int, S: int) -> dict:
    return {"tokens": _spec((B, S), torch.int32),
            "labels": _spec((B, S), torch.int32)}


def input_specs(cfg: ModelConfig, shape_name: str) -> Optional[Cell]:
    """The cell of (arch, shape): its kind and the step function's inputs
    as meta tensors; None where :func:`applicable` skips it."""
    ok, _ = applicable(cfg, shape_name)
    if not ok:
        return None
    sh = SHAPES[shape_name]
    B, S, kind = sh["batch"], sh["seq"], sh["kind"]
    f32, i32 = torch.float32, torch.int32

    if kind == "train":
        batch = _token_batch(B, S)
        if cfg.patch_embed_input:
            batch["patch_embeds"] = _spec((B, N_PATCHES, cfg.d_model), f32)
            batch["mask"] = _spec((B, S), f32)
        if cfg.family == "encdec":
            batch["frames"] = _spec((B, S, cfg.d_model), f32)
        return Cell(kind="train", specs={"batch": batch})

    if kind == "prefill":
        specs = {"tokens": _spec((B, S), i32)}
        if cfg.patch_embed_input:
            specs["patch_embeds"] = _spec((B, N_PATCHES, cfg.d_model), f32)
        if cfg.family == "encdec":
            specs = {"frames": _spec((B, S, cfg.d_model), f32),
                     "cache": encdec_mod.init_cache(cfg, B, S, S, META)}
        if cfg.family == "rwkv":
            specs["state"] = rwkv_mod.init_state(cfg, B, META)
        return Cell(kind="prefill", specs=specs)

    tokens = _spec((B, 1), i32)
    if cfg.family in ("dense", "moe"):
        return Cell(kind="decode",
                    specs={"cache": tf_mod.init_cache(cfg, B, S, META),
                           "tokens": tokens, "position": S - 1})
    if cfg.family == "rwkv":
        return Cell(kind="decode",
                    specs={"cache": rwkv_mod.init_state(cfg, B, META),
                           "tokens": tokens, "position": S - 1},
                    note="O(1) recurrent state; cache size independent of "
                         f"context {S}")
    if cfg.family == "griffin":
        return Cell(kind="decode",
                    specs={"cache": griffin_mod.init_state(cfg, B, META),
                           "tokens": tokens, "position": S - 1},
                    note=f"bounded state: RG-LRU h + {cfg.local_window}-token "
                         "rolling window")
    if cfg.family == "encdec":
        return Cell(kind="decode",
                    specs={"cache": encdec_mod.init_cache(cfg, B, S, S, META),
                           "tokens": tokens, "position": S - 1})
    raise ValueError(cfg.family)
