"""The port's rope models served, held against the JAX reference (the
configs of ``tests/_rope_models.py``, fp32, the reference's weights):
prefill and decode through the slot cache with bf16 and int8 caches, the
engine's position limit under rope, and the launchers with ``--arch
stablelm-1.6b``."""
import dataclasses
import io
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _rope_models import model, tcfg as _t  # noqa: F401
from repro.models import get_model as jax_get_model
from repro.models.layers import set_decode_attn_impl
from repro_torch.models import get_model
from repro_torch.serve import Request, ServeEngine

torch.set_num_threads(1)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefill_and_decode_match_reference(model, kv_dtype):
    """Two slots prefilled in chunks of 16 (one ragged), then three decode
    steps of three slots (slot 0 fresh at position 0), the reference
    decoding through its Pallas kernel in interpret mode: logits within
    1e-4 (fp32, two layers summed in other orders, as GPT2_TINY's serving
    test), the rotated keys in the cache within 1e-5.  An int8 cache holds
    each entry to one quantization step: rope's cos and sin differ by an
    fp32 ulp between the frameworks, so a key on a rounding boundary can
    land one step over (~1/127 of the token's largest entry), which moves
    the logits by up to ~6e-4 here; int8 logits are held within 2e-3."""
    name, cfg, params, tparams = model
    cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
    tcfg = _t(cfg)
    atol = 2e-3 if kv_dtype == "int8" else 1e-4
    jm, tm = jax_get_model(cfg), get_model(tcfg)
    N, C, P = 3, 40, 16
    st, tst = jm.init_slots(cfg, N, C), tm.init_slots(tcfg, N, C)
    rng = np.random.default_rng(0)
    prompts = {1: rng.integers(0, cfg.vocab_size, 11),
               2: rng.integers(0, cfg.vocab_size, 29)}
    for slot, prompt in prompts.items():
        for start in range(0, len(prompt), P):
            chunk = prompt[start:start + P].astype(np.int32)
            n = len(chunk)
            chunk = np.pad(chunk, (0, P - n))[None]
            st, lg = jm.prefill_into_slot(cfg, params, st, slot,
                                          jnp.asarray(chunk), start, n)
            tlg = tm.prefill_into_slot(tcfg, tparams, tst, slot,
                                       torch.from_numpy(chunk), start, n)
            np.testing.assert_allclose(tlg.numpy(), np.asarray(lg),
                                       atol=atol)
    pos = np.array([0, 11, 29], np.int32)
    set_decode_attn_impl("pallas")
    try:
        for step in range(3):
            toks = rng.integers(0, cfg.vocab_size, (N, 1)).astype(np.int32)
            lg, st = jm.decode_slots(cfg, params, st, jnp.asarray(toks),
                                     jnp.asarray(pos + step))
            tlg = tm.decode_slots(tcfg, tparams, tst, torch.from_numpy(toks),
                                  torch.from_numpy(pos + step))
            np.testing.assert_allclose(tlg.numpy(), np.asarray(lg),
                                       atol=atol)
    finally:
        set_decode_attn_impl("xla")
    for key, leaf in st.items():
        ref, got = np.asarray(leaf), tst[key].numpy()
        if ref.dtype == np.int8:
            assert np.abs(ref.astype(np.int32)
                          - got.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_engine_has_no_position_limit_under_rope(model):
    """Under rope only the cache length bounds a request (the reference's
    rule): a request past ``max_position_embeddings`` is taken and
    served; with learned positions it is refused."""
    _, cfg, _, tparams = model
    tcfg = dataclasses.replace(_t(cfg), max_position_embeddings=8)
    eng = ServeEngine(tcfg, tparams, n_slots=1, cache_len=32, device="cpu")
    eng.submit(Request(uid=0, tokens=np.arange(6, dtype=np.int32),
                       max_new=6))
    assert len(eng.run()[0].tokens) == 6
    learned = dataclasses.replace(tcfg, rope=False, learned_pos=True)
    with pytest.raises(ValueError, match="learned positions"):
        ServeEngine(learned, get_model(learned).init_params(
            learned, torch.Generator().manual_seed(0)), n_slots=1,
            cache_len=32, device="cpu").submit(
            Request(uid=0, tokens=np.arange(6, dtype=np.int32), max_new=6))


def test_launchers_run_stablelm_smoke(tmp_path):
    """``--arch stablelm-1.6b --smoke`` trains (GNB refreshes, a
    checkpoint, a resume) and serves on the CPU through the launchers."""
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as train_launch
    args = ["--arch", "stablelm-1.6b", "--smoke", "--device", "cpu",
            "--seq-len", "16", "--global-batch", "2", "--hess-subbatch", "1",
            "--hess-interval", "2", "--log-every", "2", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2"]
    out = io.StringIO()
    with redirect_stdout(out):
        train_launch.main(args + ["--steps", "3"])
        train_launch.main(args + ["--steps", "4"])
        serve_launch.main(["--arch", "stablelm-1.6b", "--smoke", "--device",
                           "cpu", "--requests", "2", "--slots", "2",
                           "--prompt-len", "8", "--max-new", "4"])
    text = out.getvalue()
    assert "done: 3 steps" in text and "[resume] restored step 3" in text
    assert "arch=stablelm-1.6b-smoke" in text and "tok/s" in text
