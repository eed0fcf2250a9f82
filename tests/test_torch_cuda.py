"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and the serve engine's launch count.  Every test here needs an
NVIDIA GPU; each carries the ``cuda`` marker and skips without one.  The
file imports no JAX, so it runs on a GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.gpt2 import GPT2_TINY
from repro_torch.kernels import KERNEL_LAUNCHES, reset_launch_counts
from repro_torch.kernels.decode_attention import (decode_attention,
                                                   decode_attention_plain)
from repro_torch.models import get_model
from repro_torch.quant import quantize_kv
from repro_torch.serve import Request, ServeEngine

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dt,quant", [(torch.float32, False),
                                      (torch.bfloat16, False),
                                      (torch.float32, True),
                                      (torch.bfloat16, True)])
@pytest.mark.parametrize("N,H,Hkv,C,hd,window,softcap", [
    (8, 12, 12, 512, 64, None, None),     # GPT-2 small serving shape
    (4, 8, 2, 48, 128, None, None),       # GQA, ring off the kernel's tile
    (3, 4, 2, 64, 256, 12, 50.0),         # window + softcap
])
def test_decode_attention_kernel_matches_plain(cuda_device, dt, quant, N, H,
                                               Hkv, C, hd, window, softcap):
    """fp32 within 1e-5 (sums in another order), bf16 within 2e-2 (the
    reference tests' bf16 bound)."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    q = torch.randn((N, H, hd), generator=gen, device=cuda_device).to(dt)
    k = torch.randn((N, C, Hkv, hd), generator=gen, device=cuda_device)
    v = torch.randn((N, C, Hkv, hd), generator=gen, device=cuda_device)
    pos = torch.tensor([(i * 97 + 5) % (3 * C) for i in range(N)],
                       dtype=torch.int32, device=cuda_device)
    kw = dict(window=window, softcap=softcap)
    if quant:
        k, kw["k_scale"] = quantize_kv(k)
        v, kw["v_scale"] = quantize_kv(v)
    else:
        k, v = k.to(dt), v.to(dt)
    reset_launch_counts()
    got = decode_attention(q, k, v, pos, **kw)
    torch.cuda.synchronize()
    assert sum(KERNEL_LAUNCHES.values()) == 1
    want = decode_attention_plain(q, k, v, pos, **kw)
    atol = 1e-5 if dt == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_engine_on_card_matches_cpu_and_launches_per_layer(cuda_device,
                                                           kv_dtype):
    """The engine on the card emits the CPU engine's greedy tokens (fp32,
    same weights) and launches the kernel once per layer per decode step.
    Two heads give GPT2_TINY's width a head dim of 64, one the kernel
    takes (its own 32 is refused)."""
    cfg = dataclasses.replace(GPT2_TINY, n_heads=2, n_kv_heads=2,
                              dtype="float32", kv_dtype=kv_dtype)
    params = get_model(cfg).init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(0))
    rng = np.random.default_rng(1)
    spec = [(5, 7), (13, 3), (8, 9), (21, 5)]

    def run(device, p):
        eng = ServeEngine(cfg, p, n_slots=2, cache_len=64, page_len=8,
                          steps_per_tick=4, device=device)
        for i, (sp, mn) in enumerate(spec):
            eng.submit(Request(uid=i, tokens=prompts[i], max_new=mn))
        reset_launch_counts()
        out = {r.uid: r.tokens for r in eng.run()}
        return out, dict(KERNEL_LAUNCHES), eng

    prompts = [rng.integers(0, cfg.vocab_size, sp) for sp, _ in spec]
    got, launches, eng = run(cuda_device, params)
    want, _, _ = run("cpu", params.cpu())
    assert got == want
    name = "decode_attention_q8" if kv_dtype == "int8" else "decode_attention"
    assert launches == {name: cfg.n_layers * eng.decode_ticks
                        * eng.steps_per_tick}
