"""Checkpointing: the counterpart of ``repro/train/checkpoint.py`` with
its directory format, so that a checkpoint of either package restores in
the other.

    ckpt_dir/step_00001000/
        manifest.json     {step, n_leaves, treedef, shapes, dtypes, extra}
        leaf_00000.npy ... leaf_NNNNN.npy

A save goes to ``.tmp-step_X`` and is renamed into place, so a crashed
save never shadows a complete one; ``keep`` bounds the steps kept.  The
leaves follow the reference's TrainState order: the step (int32), the
parameter leaves in sorted-key order (a stacked leaf saved with its
leading layer axis), the engine state (count, m shards, h shards,
hess_count, clip_fraction), the clip state, the rng and, with gradient
compression, the error-feedback shards (``comp_state.error``, each the
whole shard).  The launcher records the engine layout under ``extra``.

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

Data parallel (a ``torch.distributed`` group of W > 1 ranks):

  * ``save`` is collective: every rank calls it; the error-feedback
    segments are gathered into whole shards, rank 0 writes, and every
    rank meets at a barrier after the write (rank 0 writes synchronously
    then: an asynchronous write racing the barrier could publish a half-
    written step);
  * ``async_=True`` in a single process snapshots the state to the host
    and writes on a thread (``wait_for_pending`` joins it);
  * ``restore_resharded`` barriers, checks that every rank resolved the
    same manifest (an all-gather of its sha1 digest) and the recorded
    flat-shard layout, then restores: each rank takes its segment of the
    error feedback for the current W, so a checkpoint written on N ranks
    resumes on M.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.clipping import ClipState
from ..core.engine import EngineState, dtype_name
from ..core.types import leaf_parts, tree_leaves
from ..distributed import world
from ..distributed.compression import FlatCompressionState
from ..distributed.overlap import comm_device
from .train_state import TrainState

_MANIFEST = "manifest.json"
TREEDEF = ("TrainState(step, params[sorted leaves], opt_state(count, m[*], "
           "h[*], hess_count, clip_fraction), clip_state(count, triggers, "
           "last_norm), rng, comp_state(error[*]))")


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
    t = t.detach().to("cpu", copy=True)    # a snapshot, also on the CPU
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _state_leaves(state: TrainState, group=None):
    """[(array, dtype name)] in the checkpoint's leaf order (collective
    when the error feedback is segmented over ranks)."""
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
    for e, m in zip(_errors(state), opt.m):
        out.append((_to_numpy(_whole_shard(e, m.numel(), group)),
                    "float32"))
    return out


def _errors(state: TrainState):
    comp = state.comp_state
    return comp.error if isinstance(comp, FlatCompressionState) else ()


def _whole_shard(e: torch.Tensor, n: int, group=None) -> torch.Tensor:
    """A rank's error-feedback buffer as the whole shard of ``n``: its
    segment gathered from every rank (collective), or itself."""
    if e.numel() == n:
        return e
    full = torch.empty((n,), dtype=e.dtype, device=e.device)
    dist.all_gather_into_tensor(full, e.contiguous(), group=group)
    return full


def _sync(group=None) -> None:
    """Barrier across the ranks (none on one process)."""
    if world(group)[0] > 1:
        dist.barrier(group=group)


def _write(leaves, step: int, ckpt_dir: str, extra: Optional[dict]) -> None:
    tmp = os.path.join(ckpt_dir, f".tmp-step_{step:08d}")
    final = _step_dir(ckpt_dir, step)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
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


_pending: list = []


def save(ckpt_dir: str, step: int, state: TrainState, *,
         async_: bool = False, keep: int = 3, extra: Optional[dict] = None,
         group=None) -> None:
    """Write ``state`` as step ``step``, atomically; keep the newest
    ``keep`` steps.  ``extra`` (JSON) goes into the manifest.  The state
    is snapshot to the host before this returns; ``async_`` writes the
    files on a thread (one process only).  Data parallel: collective, rank
    0 writes."""
    ndev, rank = world(group)
    if ndev > 1 and rank != 0:
        # take part in rank 0's gathers of the error feedback, then in its
        # barrier after the write
        for e, m in zip(_errors(state), state.opt_state.m):
            _whole_shard(e, m.numel(), group)
        _sync(group)
        return
    leaves = _state_leaves(state, group)
    os.makedirs(ckpt_dir, exist_ok=True)
    if async_ and ndev <= 1:
        t = threading.Thread(target=_write,
                             args=(leaves, step, ckpt_dir, extra),
                             daemon=True)
        t.start()
        _pending.append(t)
    else:
        _write(leaves, step, ckpt_dir, extra)
    _gc(ckpt_dir, keep)
    _sync(group)


def wait_for_pending() -> None:
    """Join the asynchronous writes still running."""
    for t in _pending:
        t.join()
    _pending.clear()


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
                   if n.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)


def _check_layout(recorded: dict, expected: dict) -> None:
    """Refuse a restore when the flat-shard layout differs: the layout
    (block size, shard dtypes and sizes) depends on the model and engine
    config only, never on the ranks, so a mismatch means the flat m/h
    buffers would be reinterpreted."""
    for key in ("block", "shards"):
        if key in recorded and key in expected \
                and recorded[key] != expected[key]:
            raise ValueError(
                f"checkpoint flat-shard layout mismatch on {key!r}: "
                f"checkpoint has {recorded[key]!r}, engine expects "
                f"{expected[key]!r} (incompatible engine config; "
                f"use a fresh ckpt dir)")


def manifest_digest(ckpt_dir: str, step: Optional[int] = None) -> str:
    """sha1 of the manifest as JSON with sorted keys, the reference's
    digest: two ranks restoring the same step from the same bytes agree,
    and one manifest gives both packages the same digest."""
    blob = json.dumps(read_manifest(ckpt_dir, step), sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()


def _validate_digest_cross_process(digest_hex: str, group=None) -> None:
    """Raise unless every rank resolved the same manifest (an all-gather
    of the 20 digest bytes; nothing on one process)."""
    ndev, _ = world(group)
    if ndev <= 1:
        return
    local = torch.tensor(list(bytes.fromhex(digest_hex)), dtype=torch.uint8,
                         device=comm_device(group))
    gathered = torch.empty((ndev * local.numel(),), dtype=torch.uint8,
                           device=local.device)
    dist.all_gather_into_tensor(gathered, local, group=group)
    rows = gathered.view(ndev, -1)
    if not bool((rows == rows[0]).all()):
        raise ValueError(
            "checkpoint manifest differs across ranks: they would restore "
            f"different checkpoints (skewed filesystem?); local digest "
            f"{digest_hex}")


def restore_resharded(ckpt_dir: str, like: TrainState, *,
                      expect_layout: Optional[dict] = None,
                      step: Optional[int] = None, group=None) -> tuple:
    """The elastic restore: barrier (rank 0's rename must be visible),
    check that every rank resolved the same manifest and, with
    ``expect_layout`` (the engine's ``ShardLayout.manifest()`` as the
    launcher records it), the recorded layout; then :func:`restore`, which
    takes this rank's error-feedback segment for the current ranks."""
    _sync(group)
    manifest = read_manifest(ckpt_dir, step)
    _validate_digest_cross_process(
        manifest_digest(ckpt_dir, manifest["step"]), group)
    if expect_layout is not None:
        _check_layout(manifest.get("extra") or {}, expect_layout)
    return restore(ckpt_dir, like, step=manifest["step"], group=group)


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
            step: Optional[int] = None, group=None) -> tuple:
    """Restore into the structure of ``like`` (a TrainState from the same
    config, e.g. a fresh ``init_fn()``): its parameters are overwritten in
    place, the other leaves replaced on their device; each error-feedback
    buffer takes this rank's segment of the saved shard when ``like``'s is
    a segment.  Returns ``(state, step)``."""
    manifest = read_manifest(ckpt_dir, step)
    step = manifest["step"]
    d = _step_dir(ckpt_dir, step)
    param_leaves = tree_leaves(like.params.param_tree())
    opt = like.opt_state
    n_m, n_h = len(opt.m), len(opt.h)
    errors = _errors(like)
    want = 1 + len(param_leaves) + 3 + n_m + n_h + 3 + 1 + len(errors)
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
    comp = like.comp_state
    if errors:
        _, rank = world(group)
        segs = []
        for e in errors:
            full = next(vals)
            k = e.numel()
            segs.append(full if full.numel() == k
                        else full[rank * k:(rank + 1) * k].clone())
        comp = FlatCompressionState(error=tuple(segs))
    return TrainState(step=saved_step, params=like.params,
                      opt_state=opt_state, clip_state=clip_state,
                      rng=rng, comp_state=comp), step
