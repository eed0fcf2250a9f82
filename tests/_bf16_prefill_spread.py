"""How far bf16 moves the last-token logits of the two prefill routes:
``prefill`` (the whole prompt on the flash route) and the engine's chunked
prefill, each in bf16 against the fp32 prefill, on qwen2-vl-7b's layout
cut in width (GQA 7/1 at hd 128, M-RoPE, QKV bias, untied, random weights
from a seed).  The spread sets ``chip_smoke.PREFILL_LOGIT_TOL``, the bound
the 32k prefill is held to against the engine on the card.  Runs on the
CPU's plain path (~2 min):

    PYTHONPATH=src python tests/_bf16_prefill_spread.py
"""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import get_model

# (layers, d_model, prompt tokens, engine chunk)
CASES = ((4, 512, 1024, 256), (28, 512, 1024, 256), (28, 1024, 2048, 512))


def engine_logits(model, cfg, params, prompt, page):
    """The last token's logits (V,) fp32 after the engine's chunked
    prefill, driven through the model's slot protocol (``init_slots``,
    ``prefill_into_slot``) chunk by chunk, as the engine drives it."""
    cache = model.init_slots(cfg, 1, len(prompt), "cpu")
    for start in range(0, len(prompt), page):
        chunk = torch.from_numpy(prompt[start:start + page])[None]
        logits = model.prefill_into_slot(cfg, params, cache, 0, chunk, start,
                                         chunk.shape[1])
    return logits.float()


def main():
    for L, D, S, page in CASES:
        cfg = dataclasses.replace(
            get_config("qwen2-vl-7b"), name=f"spread-{L}-{D}", n_layers=L,
            d_model=D, n_heads=7, n_kv_heads=1, d_ff=4 * D,
            vocab_size=8192)
        model = get_model(cfg)
        params = model.init_params(cfg, torch.Generator().manual_seed(0))
        prompt = np.random.default_rng(0).integers(
            0, cfg.vocab_size, S).astype(np.int32)
        out = {}
        for dt in ("bfloat16", "float32"):
            c = dataclasses.replace(cfg, dtype=dt)
            lg, _ = model.prefill(c, params, torch.from_numpy(prompt)[None])
            out[dt] = (lg[0, 0].float(), engine_logits(model, c, params,
                                                       prompt, page))
        ref = out["float32"][0]
        pre, eng = out["bfloat16"]
        print(f"layers {L} d {D} S {S} chunk {page}: bf16 prefill vs engine "
              f"{(pre - eng).abs().max().item():.4f}, prefill vs fp32 "
              f"{(pre - ref).abs().max().item():.4f}, engine vs fp32 "
              f"{(eng - ref).abs().max().item():.4f}; fp32 routes "
              f"{(out['float32'][1] - ref).abs().max().item():.3g}; "
              f"largest |logit| {ref.abs().max().item():.3f}")


if __name__ == "__main__":
    torch.set_num_threads(8)
    main()
