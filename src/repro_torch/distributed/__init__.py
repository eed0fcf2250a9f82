"""Training across processes on ``torch.distributed``: the data axis's
compressed, bucketed gradient reduction (the counterpart of
``repro/distributed``'s ``compression.py`` and ``overlap.py``), the
sharding rules and the ``(data, model)`` grid (``sharding.py``), and the
model axis's tensor and expert parallelism (``tensor_parallel.py``,
``models/moe.py``)."""
from .compression import (CompressionState, FlatCompressionState,
                          GradCompressor, compressed_bytes)
from .overlap import world
from .sharding import Grid, active_grid, partition_params, set_grid
