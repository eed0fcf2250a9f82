"""Checkpointing, single process: the counterpart of
``repro/train/checkpoint.py`` with its directory format, so that a
checkpoint of either package restores in the other.

    ckpt_dir/step_00001000/
        manifest.json     {step, n_leaves, treedef, shapes, dtypes, extra}
        leaf_00000.npy ... leaf_NNNNN.npy

A save goes to ``.tmp-step_X`` and is renamed into place, so a crashed
save never shadows a complete one; ``keep`` bounds the steps kept.  The
leaves follow the reference's TrainState order: the step (int32), the
parameter leaves in sorted-key order (a stacked leaf saved with its
leading layer axis), the engine state (count, m shards, h shards,
hess_count, clip_fraction), the clip state and the rng.  The launcher
records the engine layout under ``extra``.

Two leaves need care, because numpy and JAX hold them differently:

  * bf16.  numpy has no bf16, and the reference's ``np.save`` of an
    ml_dtypes bf16 array writes 2-byte void (``V2``) with "bfloat16" in
    the manifest.  A save here writes the same: the 16 bits as ``V2``.  A
    restore reads a "bfloat16" leaf's void bits back as bf16.
  * the rng.  The reference keeps its JAX key, two uint32 words,
    ``split(PRNGKey(seed))[1]``; so does the port's TrainState
    (``train_state.train_key`` computes it with a numpy Threefry), and a
    save writes it as the reference's (2,) uint32 leaf.  The port cannot
    reproduce JAX's key stream: it seeds its own refresh noise from the
    key's two words (``trainer.hess_seed``), so a restored key, the
    port's or the reference's, continues the port's stream exactly where
    it left off, and a reference checkpoint continues the reference's
    trajectory wherever the refresh noise is passed in.

Multi-process and asynchronous saves are not ported.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np
import torch

from ..core.clipping import ClipState
from ..core.engine import EngineState, dtype_name
from ..core.types import leaf_parts, tree_leaves
from .train_state import TrainState

_MANIFEST = "manifest.json"
TREEDEF = ("TrainState(step, params[sorted leaves], opt_state(count, m[*], "
           "h[*], hess_count, clip_fraction), clip_state(count, triggers, "
           "last_norm), rng)")


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(name.split("_")[1]) for name in os.listdir(ckpt_dir)
             if name.startswith("step_")
             and os.path.exists(os.path.join(ckpt_dir, name, _MANIFEST))]
    return max(steps) if steps else None


def read_manifest(ckpt_dir: str, step: Optional[int] = None) -> dict:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    with open(os.path.join(_step_dir(ckpt_dir, step), _MANIFEST)) as f:
        return json.load(f)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """The leaf as the reference's ``np.save`` writes it: bf16 as ``V2``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _state_leaves(state: TrainState):
    """[(array, dtype name)] in the checkpoint's leaf order."""
    out = [(np.asarray(state.step, np.int32), "int32")]
    for leaf in tree_leaves(state.params.param_tree()):
        parts = leaf_parts(leaf)
        value = (torch.stack([p.detach() for p in parts])
                 if isinstance(leaf, (list, tuple)) else parts[0])
        out.append((_to_numpy(value), dtype_name(value.dtype)))
    opt = state.opt_state
    for t in (opt.count, *opt.m, *opt.h, opt.hess_count, opt.clip_fraction,
              *state.clip_state):
        out.append((_to_numpy(t), dtype_name(t.dtype)))
    out.append((np.asarray(state.rng, np.uint32), "uint32"))
    return out


def save(ckpt_dir: str, step: int, state: TrainState, *, keep: int = 3,
         extra: Optional[dict] = None) -> None:
    """Write ``state`` as step ``step``, atomically; keep the newest
    ``keep`` steps.  ``extra`` (JSON) goes into the manifest."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp-step_{step:08d}")
    final = _step_dir(ckpt_dir, step)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    leaves = _state_leaves(state)
    for i, (arr, _) in enumerate(leaves):
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
    manifest = {"step": step, "n_leaves": len(leaves), "treedef": TREEDEF,
                "shapes": [list(arr.shape) for arr, _ in leaves],
                "dtypes": [dt for _, dt in leaves]}
    if extra:
        manifest["extra"] = extra
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
                   if n.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)


def _load(path: str, dtype: str, device) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        if arr.dtype.kind != "V" or arr.dtype.itemsize != 2:
            raise ValueError(f"{path}: a bfloat16 leaf stored as {arr.dtype}")
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    if dtype == "uint32":     # the rng key: int64 holds every word
        return torch.from_numpy(arr.astype(np.int64))
    return torch.from_numpy(arr).to(device)


@torch.no_grad()
def restore(ckpt_dir: str, like: TrainState, *,
            step: Optional[int] = None) -> tuple:
    """Restore into the structure of ``like`` (a TrainState from the same
    config, e.g. a fresh ``init_fn()``): its parameters are overwritten in
    place, the other leaves replaced on their device.  Returns ``(state,
    step)``."""
    manifest = read_manifest(ckpt_dir, step)
    step = manifest["step"]
    d = _step_dir(ckpt_dir, step)
    param_leaves = tree_leaves(like.params.param_tree())
    opt = like.opt_state
    n_m, n_h = len(opt.m), len(opt.h)
    want = 1 + len(param_leaves) + 3 + n_m + n_h + 3 + 1
    if manifest["n_leaves"] != want:
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"expected {want}")
    device = opt.count.device
    vals = iter(_load(os.path.join(d, f"leaf_{i:05d}.npy"), dt, device)
                for i, dt in enumerate(manifest["dtypes"]))
    saved_step = int(next(vals))
    for leaf in param_leaves:
        value = next(vals)
        parts = leaf_parts(leaf)
        if isinstance(leaf, (list, tuple)):
            for p, v in zip(parts, value):
                p.copy_(v)
        else:
            parts[0].copy_(value)
    count = next(vals)
    m = tuple(next(vals) for _ in range(n_m))
    h = tuple(next(vals) for _ in range(n_h))
    opt_state = EngineState(count=count, m=m, h=h, hess_count=next(vals),
                            clip_fraction=next(vals))
    clip_state = ClipState(next(vals), next(vals), next(vals))
    key = next(vals)
    if tuple(key.shape) != (2,):
        raise ValueError(f"the rng leaf has shape {tuple(key.shape)}, not "
                         "the key's (2,)")
    rng = (int(key[0]), int(key[1]))
    return TrainState(step=saved_step, params=like.params,
                      opt_state=opt_state, clip_state=clip_state,
                      rng=rng), step
