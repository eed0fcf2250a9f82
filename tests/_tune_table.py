"""The tuning table of PERF.md: ``kernels/autotune.py`` at GPT-2 small's
training shapes twice in one process (the spread of two tunings), at
gemma2-9b's CE shape and at NeoX-6.6B's hd-128 attention, each candidate
measured as the tuner measures it (CUDA events, the L2 flushed, the
median of ``MEASURE_REPS``), into a temporary cache.  A diagnostic behind
PERF.md, not a test (pytest does not collect it); it needs an NVIDIA GPU
and nvcc:

    python3 tests/_tune_table.py        # ~1 min with the builds

Prints a ``[table]`` line a tuning and writes them all to
``build/tune_table.json``.
"""
import dataclasses
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main():
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import autotune as at

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    card = cs.card_line()
    print(card, flush=True)
    cs.phase_build()
    out = {"card": card, "runs": []}

    def show(tag, t):
        d = dataclasses.asdict(t)
        out["runs"].append(dict(tag=tag, **d))
        print(f"[table] {tag}: {json.dumps(d)}", flush=True)

    bf, f32 = torch.bfloat16, torch.float32
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = os.path.join(tmp, "a.json")
        at.clear_memory_cache()
        for rep in range(2):
            t0 = time.perf_counter()
            show(f"gpt2 ce #{rep}", at.tune_shape(
                8192, 768, 50304, h_dtype=bf, w_dtype=f32, norm="ln",
                refresh=True))
            show(f"gpt2 attn #{rep}", at.tune_attn_shape(
                8, 12, 12, 1024, 1024, 64, refresh=True))
            print(f"[table] gpt2 tuning #{rep}: "
                  f"{time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        show("gemma2-9b ce", at.tune_shape(
            8192, 3584, 256000, h_dtype=bf, w_dtype=f32, softcap=30.0,
            norm="rms", refresh=True))
        print(f"[table] gemma2 tuning: {time.perf_counter() - t0:.1f}s",
              flush=True)
        show("neox-6.6b attn hd128", at.tune_attn_shape(
            2, 32, 32, 2048, 2048, 128, refresh=True))
        at.clear_memory_cache()
    with open(os.path.join(ROOT, "build", "tune_table.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
