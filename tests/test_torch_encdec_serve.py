"""The encoder-decoder family's serving held against the JAX reference on
seamless-m4t-medium's smoke config (fp32, the reference's weights carried
across by ``params_from_jax``, numpy frames and tokens): the slot protocol
(``init_slots``, ``prefill_encoder_slot``, ``prefill_into_slot`` over a
prefix of two chunks, ``decode_slots`` with the reference on its own route
and on its Pallas kernel in interpret mode), the whole-prompt path
(``prefill_encoder`` and ``decode_step``), the engine's greedy tokens
against the reference engine's, and what the family refuses: frames of
another length, an int8 cache, the prefix cache, ``generate_lockstep``
and the training launcher; and ``launch.serve`` on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _encdec_models import assert_close, encdec_cfg, port_params, ref_params
from _rope_models import tcfg
from repro.models import get_model as jax_get_model
from repro.models.layers import set_decode_attn_impl
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.launch import serve as torch_serve
from repro_torch.launch import train as torch_train
from repro_torch.models import get_model
from repro_torch.serve import Request, ServeEngine, generate_lockstep

torch.set_num_threads(1)

S_SRC = 6


@pytest.fixture(scope="module")
def model():
    """(reference config fp32, reference params, the port's params); a
    uniquely named config, since the reference compiles one program per
    config."""
    cfg = encdec_cfg(name="seamless-serve")
    params = ref_params(cfg)
    return cfg, params, port_params(cfg, params)


def _frames(cfg, n, S=S_SRC, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_slot_protocol_matches_reference(model, impl):
    """Three slots' cross rows from ``prefill_encoder_slot`` (frames of 6),
    two slots' decoder prefixes through ``prefill_into_slot`` in chunks of
    8 (9 tokens: a full and a ragged chunk; 1 token), then 6 decode steps
    of all three slots at their own positions, the reference decoding on
    its own route ("xla") or through its Pallas kernel in interpret mode:
    the last valid token's logits, every step's logits and the cache's
    four leaves (k, v, xk, xv) within 1e-5 of their largest element."""
    cfg, params, tparams = model
    jm, tm, c = jax_get_model(cfg), get_model(tcfg(cfg)), tcfg(cfg)
    N, P, C = 3, 8, 32
    st, tst = jm.init_slots(cfg, N, C, S_SRC), tm.init_slots(c, N, C, S_SRC)
    assert sorted(tst) == ["k", "v", "xk", "xv"]
    assert tuple(tst["xk"].shape) == (2, N, S_SRC, 4, 16)
    frames = _frames(cfg, N)
    enc = jax.jit(lambda st, slot, f: jm.prefill_encoder_slot(
        cfg, params, st, slot, f))
    for slot in range(N):
        st = enc(st, slot, jnp.asarray(frames[slot:slot + 1]))
        tm.prefill_encoder_slot(c, tparams, tst, slot,
                                torch.from_numpy(frames[slot:slot + 1]))
    rng = np.random.default_rng(1)
    prompts = {0: np.concatenate([[0], rng.integers(0, cfg.vocab_size, 8)]),
               1: np.zeros((1,), np.int64)}
    prefill = jax.jit(lambda st, slot, chunk, start, n: jm.prefill_into_slot(
        cfg, params, st, slot, chunk, start, n))
    for slot, prompt in prompts.items():
        for start in range(0, len(prompt), P):
            chunk = prompt[start:start + P].astype(np.int32)
            n = len(chunk)
            chunk = np.pad(chunk, (0, P - n))[None]
            st, lg = prefill(st, slot, jnp.asarray(chunk), start, n)
            tlg = tm.prefill_into_slot(c, tparams, tst, slot,
                                       torch.from_numpy(chunk), start, n)
            assert_close(tlg, lg, what=f"prefill slot {slot} at {start}")
    pos = np.array([9, 1, 0], np.int32)
    set_decode_attn_impl(impl)
    try:
        decode = jax.jit(lambda st, toks, pos: jm.decode_slots(
            cfg, params, st, toks, pos))
        for step in range(6):
            toks = rng.integers(0, cfg.vocab_size, (N, 1)).astype(np.int32)
            lg, st = decode(st, jnp.asarray(toks), jnp.asarray(pos + step))
            tlg = tm.decode_slots(c, tparams, tst, torch.from_numpy(toks),
                                  torch.from_numpy(pos + step))
            assert_close(tlg, lg, what=f"decode step {step}")
    finally:
        set_decode_attn_impl("xla")
    for name in ("k", "v", "xk", "xv"):
        assert_close(tst[name], st[name], what=f"cache {name}")


def test_prefill_encoder_and_decode_step_match_reference(model):
    """The whole-prompt path over 2 rows: ``prefill_encoder`` (frames of
    6, the flash forward's plain version non-causal) into ``init_cache``'s
    cross rows, then 6 ``decode_step``s at positions 0..5: every step's
    logits and the cache within 1e-5 of the largest element."""
    cfg, params, tparams = model
    jm, tm, c = jax_get_model(cfg), get_model(tcfg(cfg)), tcfg(cfg)
    frames = _frames(cfg, 2, seed=3)
    cache = jm.prefill_encoder(cfg, params, jnp.asarray(frames),
                               jm.init_cache(cfg, 2, 8, S_SRC))
    tcache = tm.prefill_encoder(c, tparams, torch.from_numpy(frames),
                                tm.init_cache(c, 2, 8, 0))
    assert tuple(tcache["xk"].shape) == (2, 2, S_SRC, 4, 16)
    for name in ("xk", "xv"):
        assert_close(tcache[name], cache[name], what=name)
    step = jax.jit(lambda cache, tok, pos: jm.decode_step(
        cfg, params, cache, tok, pos))
    rng = np.random.default_rng(4)
    for pos in range(6):
        toks = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        lg, cache = step(cache, jnp.asarray(toks), pos)
        tlg = tm.decode_step(c, tparams, tcache, torch.from_numpy(toks), pos)
        assert_close(tlg, lg, what=f"decode_step {pos}")
    for name in ("k", "v"):
        assert_close(tcache[name], cache[name], what=name)
    with pytest.raises(ValueError, match="outside the cache"):
        tm.decode_step(c, tparams, tcache, torch.zeros((2, 1),
                                                       dtype=torch.int32), 8)


ENGINE = dict(n_slots=2, cache_len=16, page_len=4, steps_per_tick=4, seed=0,
              src_len=S_SRC)


def _requests(cfg, cls):
    """The reference test's three BOS requests of 5 new tokens on frames
    ``normal(PRNGKey(20 + i), (6, d))`` (``tests/test_serve_engine.py``),
    and a fourth with a 6-token prefix (two chunks of 4)."""
    reqs = []
    for i in range(3):
        frames = np.asarray(jax.random.normal(jax.random.PRNGKey(20 + i),
                                              (S_SRC, cfg.d_model)))
        reqs.append(cls(uid=i, tokens=np.zeros((1,), np.int32), max_new=5,
                        frames=frames))
    prefix = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                               6).astype(np.int32)
    reqs.append(cls(uid=3, tokens=prefix, max_new=5,
                    frames=_frames(cfg, 1, seed=6)[0]))
    return reqs


def _run(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return {r.uid: r.tokens for r in eng.run()}


def test_engine_greedy_tokens_match_reference(model):
    """Four requests over 2 slots (each slot reused, its cross rows
    overwritten at admission; one prefix over two chunks): the port
    engine's greedy tokens equal the reference engine's, distinct frame
    streams decode differently, and the last request equals a fresh
    one-slot engine's."""
    cfg, params, tparams = model
    got = _run(ServeEngine(tcfg(cfg), tparams, device="cpu", **ENGINE),
               _requests(cfg, Request))
    want = _run(JServeEngine(cfg, params, **ENGINE), _requests(cfg, JRequest))
    assert got == want
    assert sorted(got) == [0, 1, 2, 3] and all(len(t) == 5
                                               for t in got.values())
    assert len({tuple(t) for t in got.values()}) > 1
    last = _requests(cfg, Request)[3]
    alone = _run(ServeEngine(tcfg(cfg), tparams, device="cpu",
                             **dict(ENGINE, n_slots=1)), [last])
    assert alone[3] == got[3]


def test_refused_options_raise(model):
    """Frames of another length than ``src_len`` (or none) raise the
    reference's ``ValueError`` at ``submit``; an int8 cache and the prefix
    cache raise it when the engine is built, in the engine and in the
    launcher; ``generate_lockstep`` (whose reference asserts a dense, MoE,
    RWKV or Griffin family) and the training launcher (no frame source)
    raise ``ValueError``."""
    cfg, _, tparams = model
    c = tcfg(cfg)
    eng = ServeEngine(c, tparams, device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="frames length 5 != engine src_len"):
        eng.submit(Request(uid=0, tokens=np.zeros((1,), np.int32), max_new=2,
                           frames=_frames(cfg, 1, S=5)[0]))
    with pytest.raises(ValueError, match="needs frames"):
        eng.submit(Request(uid=1, tokens=np.zeros((1,), np.int32),
                           max_new=2))
    with pytest.raises(ValueError, match="encdec keeps bf16 slots"):
        ServeEngine(c, tparams, device="cpu", kv_dtype="int8", **ENGINE)
    with pytest.raises(ValueError, match="prefix cache needs a paged KV"):
        ServeEngine(c, tparams, device="cpu", prefix_cache=True, **ENGINE)
    for flag in (["--kv-dtype", "int8"], ["--prefix-cache"]):
        with pytest.raises(ValueError):
            torch_serve.main(["--arch", "seamless-m4t-medium", "--smoke",
                              "--device", "cpu", "--requests", "1",
                              "--slots", "1"] + flag)
    with pytest.raises(ValueError, match="generate_lockstep has no route"):
        generate_lockstep(c, tparams, np.zeros((1, 2), np.int32), max_new=2)
    with pytest.raises(ValueError, match="frames"):
        torch_train.main(["--arch", "seamless-m4t-medium", "--smoke",
                          "--device", "cpu", "--steps", "1"])


def test_serve_launcher_runs_seamless_on_cpu(capsys):
    """``launch.serve --arch seamless-m4t-medium --smoke --device cpu``:
    requests of ENC_SRC_LEN (16) frames and a BOS prefix, every request
    served, the report's lines printed."""
    results = torch_serve.main(["--arch", "seamless-m4t-medium", "--smoke",
                                "--device", "cpu", "--requests", "3",
                                "--slots", "2", "--max-new", "6",
                                "--mixed"])
    assert torch_serve.ENC_SRC_LEN == 16
    assert len(results) == 3 and all(r.tokens for r in results)
    out = capsys.readouterr().out
    assert "arch=seamless-m4t-smoke" in out and "steady state:" in out
