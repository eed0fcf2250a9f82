"""Process-group setup for data-parallel training: the counterpart of
``initialize_distributed`` in ``repro/launch/mesh.py``.

The reference's ``latency_hiding_flags`` and ``enable_latency_hiding`` are
XLA scheduler flags with no counterpart here; its mesh builders belong to
tensor parallelism, which is not ported yet.
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist


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
