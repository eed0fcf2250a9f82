"""PyTorch/CUDA port of the Sophia reproduction, for an NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``models/layers.py`` here is the counterpart of ``models/layers.py``
there) and imports nothing of it.  Every TPU kernel on a ported path becomes
a kernel written by hand for Hopper under ``kernels/csrc/``, built at first
use into ``build/repro_torch_kernels/``; its plain PyTorch version beside it
serves tensors that lie on the CPU.

Ported so far: serving GPT-2 (dense family) through the continuous-batching
engine, with the decode-attention kernel; training GPT-2 with Sophia-G and
the GNB estimator (``train/``), with the fused cross-entropy kernels.
"""
__version__ = "0.1.0"
