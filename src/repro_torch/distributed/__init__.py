"""Data-parallel training on ``torch.distributed``: the compressed,
bucketed gradient reduction (the counterpart of ``repro/distributed``'s
``compression.py`` and ``overlap.py``).  The reference's tensor-parallel
sharding rules (``sharding.py``) are not ported yet."""
from .compression import (CompressionState, FlatCompressionState,
                          GradCompressor, compressed_bytes)
from .overlap import world
