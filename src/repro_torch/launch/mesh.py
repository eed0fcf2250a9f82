"""Process-group setup and the ``(data, model)`` grid: the counterpart of
``initialize_distributed`` and ``make_mesh`` in ``repro/launch/mesh.py``
and of ``build_mesh`` in ``repro/launch/train.py``.  The reference's
``make_host_spanning_mesh`` is ``make_mesh`` here: the default process
group spans every process of every host already.

The reference's ``latency_hiding_flags`` and ``enable_latency_hiding`` are
XLA scheduler flags, and ``make_production_mesh`` a TPU pod's layout; they
have no counterpart here.
"""
from __future__ import annotations

import datetime
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..distributed.sharding import AXES, Grid


def initialize_distributed(coordinator: str, num_processes: int,
                           process_id: int, device=None,
                           timeout_s: float = 600.0) -> torch.device:
    """Join the default process group: ``coordinator`` is ``host:port`` of
    the rendezvous (rank 0 listens there), or a ``file://`` URL.  NCCL
    when ``device`` is a CUDA device (None: the GPU), on the card of this
    rank's local index; gloo only when the caller asked for the CPU.  An
    NCCL failure on a CUDA device raises: it never falls back to gloo.
    Returns the device this rank trains on."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: a CUDA device was "
                               "asked for and none is available")
        local = process_id % torch.cuda.device_count()
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    init = (coordinator if "://" in coordinator
            else f"tcp://{coordinator}")
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    return device


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(shape: Sequence[int], axes: Sequence[str] = AXES) -> Grid:
    """The :class:`Grid` of ``shape`` (data, model) over the default
    process group, whose size must be their product; on no process group,
    ``(1, 1)``.  Every rank calls ``new_group`` for every data group, then
    every model group, in one order (NCCL needs it).  A group that is the
    whole world is the default group."""
    if tuple(axes) != AXES:
        raise ValueError(f"axes {tuple(axes)}: the port's grid is {AXES}")
    D, M = (int(s) for s in shape)
    n, rank = _world()
    if D * M != n:
        raise ValueError(f"a ({D}, {M}) grid needs {D * M} processes, the "
                         f"process group has {n}")

    def group(ranks):
        if len(ranks) == n and n > 1:
            return dist.group.WORLD
        return dist.new_group(ranks) if n > 1 else None

    d, m = divmod(rank, M)
    data_group = model_group = None
    for mm in range(M):
        g = group([dd * M + mm for dd in range(D)])
        if mm == m:
            data_group = g
    for dd in range(D):
        g = group([dd * M + mm for mm in range(M)])
        if dd == d:
            model_group = g
    return Grid(shape=(D, M), rank=rank, data_group=data_group,
                model_group=model_group)


def mesh_shape(n: int) -> Optional[Tuple[int, int]]:
    """The reference's auto shape for ``n`` ranks: None for one; else the
    model axis 4, else 2, where it divides ``n`` and ``n // model >=
    model``, else 1 (2 -> (2, 1), 4 -> (2, 2), 8 -> (4, 2), 16 -> (4, 4))."""
    if n <= 1:
        return None
    model = next((m for m in (4, 2) if n % m == 0 and n // m >= m), 1)
    return (n // model, model)


def build_mesh() -> Optional[Grid]:
    """The auto grid over the default process group (:func:`mesh_shape`),
    None on one process.  A layout heavy in tensor parallelism passes its
    shape to :func:`make_mesh`."""
    shape = mesh_shape(_world()[0])
    return None if shape is None else make_mesh(shape)
