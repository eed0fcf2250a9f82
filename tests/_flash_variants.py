"""Variants of the tensor-core flash kernels, timed on the card beside the
kernels as committed: each is ``csrc/flash_attention.cu`` with a few
lines replaced (every occurrence), built with nvcc into
``build/flash_variants/``, held to the bf16 contract (every element of o,
dq, dk and dv within 2^-7 of its absolute sum) at GPT-2 small's training
shape (B=8, H=12, S=1024, hd=64, causal) and timed as ``chip_smoke.py``
times the kernels (CUDA events, L2 flushed, median of 20).  A diagnostic behind PERF.md, not a test
(pytest does not collect it); it needs an NVIDIA GPU and nvcc:

    python3 tests/_flash_variants.py

Variants: "committed"; "mask test in every tile" (the per-tile choice
of the unmasked path taken away from the forward, dQ and dK/dV, so every
element of every tile runs the mask test); "dK/dV q tiles of 32".
"""
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

SOURCE = _build.CSRC / "flash_attention.cu"
VARIANTS = {
    "committed": {},
    "mask test in every tile": {
        "const bool full = cover(a, w0, 16, c0, kKeys) == kAll;":
            "const bool full = false;",
        "const bool full = cover(a, q0, BQ, kw, 16) == kAll;":
            "const bool full = false;"},
    "dK/dV q tiles of 32": {
        "constexpr int BQ = HD == 128 ? 32 : 64;": "constexpr int BQ = 32;"},
}


def build(name):
    src = SOURCE.read_text()
    for old, new in VARIANTS[name].items():
        if old not in src:
            raise RuntimeError(f"{name}: {old!r} is not in the source")
        src = src.replace(old, new)
    out = _build.build_dir().parent / "flash_variants"
    out.mkdir(parents=True, exist_ok=True)
    stem = out / name.replace(" ", "_").replace("/", "")
    stem.with_suffix(".cu").write_text(src)
    lib = stem.with_suffix(".so")
    proc = subprocess.run(["/usr/local/cuda/bin/nvcc", *_build.NVCC_FLAGS,
                           "-o", str(lib), str(stem.with_suffix(".cu"))],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(str(lib))


def entry(lib, name):
    fn = getattr(lib, name)
    fn.argtypes = fa._SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def measure(lib, flush):
    fwd_fn = entry(lib, "flash_forward_launch")
    dq_fn = entry(lib, "flash_backward_dq_launch")
    dkv_fn = entry(lib, "flash_backward_dkv_launch")
    q, k, v, g, kw = cs._attn_inputs(torch, cs.ATTN_MAIN, torch.bfloat16)
    dims = fa._dims(q, k, **kw)
    o, lse = torch.empty_like(q), torch.empty(q.shape[:3], device="cuda")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    def fwd():
        if fwd_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), *dims):
            raise RuntimeError("forward launch failed")

    fwd()
    delta = (g.float() * o.float()).sum(-1)

    def dq_():
        if dq_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *dims):
            raise RuntimeError("dQ launch failed")

    def dkv():
        if dkv_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), *dims):
            raise RuntimeError("dK/dV launch failed")

    dq_()
    dkv()
    torch.cuda.synchronize()
    o_p, _ = fa.flash_forward_plain(q, k, v, **kw)
    dq_p = fa.flash_backward_dq_plain(q, k, v, g, lse, delta, **kw)
    dk_p, dv_p = fa.flash_backward_dkv_plain(q, k, v, g, lse, delta, **kw)
    sums = fa.contract_sums(q, k, v, g, lse, delta, **kw)
    got = dict(o=(o, o_p), dq=(dq, dq_p), dk=(dk, dk_p), dv=(dv, dv_p))
    misses = {n: fa.contract_misses(*got[n], s)[0] for n, s in sums.items()}
    return {"forward_ms": cs.time_ms(torch, fwd, flush, reps=20, warmup=3),
            "dq_ms": cs.time_ms(torch, dq_, flush, reps=20, warmup=3),
            "dkv_ms": cs.time_ms(torch, dkv, flush, reps=20, warmup=3),
            "beyond_2^-7": misses}


def main():
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    print(cs.card_line())
    flush = torch.empty(128 * 2 ** 20 // 4, device="cuda")
    rows = {}
    for name, lib in libs.items():
        rows[name] = measure(lib, flush)
        print(f"{name}: {json.dumps(rows[name])}", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
