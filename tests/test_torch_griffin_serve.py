"""The Griffin family's serving held against the JAX reference on
recurrentgemma-2b's smoke config (fp32, window 16, the reference's weights
carried across by ``params_from_jax``, numpy inputs): the slot protocol
(``init_slots``, ``prefill_into_slot`` token by token, ``decode_slots``
past the ring's wrap with the reference on its own route and on its Pallas
kernel in interpret mode, ``reset_slot``, inactive slots), the lockstep
path (``decode_step`` past the window, ``generate_lockstep``), the
engine's greedy tokens, and the options the family refuses (an int8
cache, the prefix cache), in the engine and in the launchers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _griffin_models import (assert_close, griffin_cfg, port_params,
                             ref_params)
from _rope_models import tcfg
from repro.models import get_model as jax_get_model
from repro.models.layers import set_decode_attn_impl
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import generate_lockstep as jax_generate_lockstep
from repro_torch.launch import serve as torch_serve
from repro_torch.launch import train as torch_train
from repro_torch.models import get_model
from repro_torch.models.griffin import flat_state
from repro_torch.serve import Request, ServeEngine, generate_lockstep

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model():
    """(reference config fp32, reference params, the port's params); a
    uniquely named config, since the reference compiles one program per
    config."""
    cfg = griffin_cfg(name="recurrentgemma-serve")
    params = ref_params(cfg)
    return cfg, params, port_params(cfg, params)


def _ref_flat(state):
    return {f"{kind}/{k}": np.asarray(v) for kind, leaves in state.items()
            for k, v in leaves.items()}


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_slot_protocol_matches_reference(model, impl):
    """``init_slots`` ignores the cache length (the ring is the window's
    16 entries); two of three slots prefilled in chunks of 8 (11 tokens:
    a ragged chunk; 21: two full and a ragged one), then 8 decode steps of
    all three slots (slot 2 to position 28, past the ring's wrap at 16),
    the reference decoding on its own route ("xla") or through its Pallas
    kernel in interpret mode: the last valid token's logits, every step's
    logits and every state leaf within 1e-5 of their largest element."""
    cfg, params, tparams = model
    jm, tm, c = jax_get_model(cfg), get_model(tcfg(cfg)), tcfg(cfg)
    N, P = 3, 8
    st, tst = jm.init_slots(cfg, N, 64), tm.init_slots(c, N, 4096)
    assert tuple(tst["kv"]["k"].shape) == (1, N, 16, 1, 16)
    assert tst["rec1"]["h"].dtype == torch.float32
    rng = np.random.default_rng(0)
    prompts = {1: rng.integers(0, cfg.vocab_size, 11),
               2: rng.integers(0, cfg.vocab_size, 21)}
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
    pos = np.array([0, 11, 21], np.int32)
    set_decode_attn_impl(impl)
    try:
        decode = jax.jit(lambda st, toks, pos: jm.decode_slots(
            cfg, params, st, toks, pos))
        for step in range(8):
            toks = rng.integers(0, cfg.vocab_size, (N, 1)).astype(np.int32)
            lg, st = decode(st, jnp.asarray(toks), jnp.asarray(pos + step))
            tlg = tm.decode_slots(c, tparams, tst, torch.from_numpy(toks),
                                  torch.from_numpy(pos + step))
            assert_close(tlg, lg, what=f"decode step {step}")
    finally:
        set_decode_attn_impl("xla")
    want = _ref_flat(st)
    got = flat_state(tst)
    assert sorted(got) == sorted(want)
    for name, leaf in got.items():
        assert_close(leaf, want[name], what=f"state {name}")


def test_decode_leaves_inactive_slots_and_reset_keeps_the_ring(model):
    """``decode_slots`` with ``active`` writes the active slots' state
    only: an inactive slot's rows (recurrent state and ring) come out bit
    for bit, and the active ones equal a decode without the mask.
    ``reset_slot`` zeroes one slot's recurrent state, leaves its ring (the
    mask hides it) and the other slots as they were."""
    cfg, _, tparams = model
    tm, c = get_model(tcfg(cfg)), tcfg(cfg)
    st = tm.init_slots(c, 3, 0)
    rng = np.random.default_rng(1)
    for slot in range(3):
        tm.prefill_into_slot(c, tparams, st, slot, torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (1, 8)).astype(np.int32)), 0, 8)
    before = {k: v.clone() for k, v in flat_state(st).items()}
    free = tm.init_slots(c, 3, 0)
    for k, v in flat_state(free).items():
        v.copy_(before[k])
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 1)).astype(
        np.int32))
    pos = torch.full((3,), 8, dtype=torch.int32)
    active = torch.tensor([True, False, True])
    lg = tm.decode_slots(c, tparams, st, toks, pos, active=active)
    lg_free = tm.decode_slots(c, tparams, free, toks, pos)
    # an inactive slot's logits are not read (its ring did not take the
    # token), the active ones' are those of the unmasked step
    assert torch.equal(lg[[0, 2]], lg_free[[0, 2]])
    after, after_free = flat_state(st), flat_state(free)
    for k in after:
        assert torch.equal(after[k][:, 1], before[k][:, 1]), k
        assert torch.equal(after[k][:, [0, 2]], after_free[k][:, [0, 2]]), k
        assert not torch.equal(after[k][:, 0], before[k][:, 0]), k
    kept = {k: v.clone() for k, v in after.items()}
    tm.reset_slot(c, st, 2)
    for k, v in flat_state(st).items():
        if k.startswith("kv/"):
            assert torch.equal(v, kept[k]), k
        else:
            assert not v[:, 2].any(), k
            assert torch.equal(v[:, :2], kept[k][:, :2]), k


def test_decode_step_matches_reference_past_the_window(model):
    """The lockstep path's ``decode_step`` (the reference's
    ``_rolling_attention``) over 30 positions of 2 rows from
    ``init_cache``, past the window of 16: every step's logits and the
    final state within 1e-5 of their largest element."""
    cfg, params, tparams = model
    jm, tm = jax_get_model(cfg), get_model(tcfg(cfg))
    seq = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 30)).astype(np.int32)
    cache, tcache = jm.init_cache(cfg, 2, 0), tm.init_cache(tcfg(cfg), 2, 0)
    step = jax.jit(lambda cache, tok, t: jm.decode_step(cfg, params, cache,
                                                        tok, t))
    for t in range(30):
        lg, cache = step(cache, jnp.asarray(seq[:, t:t + 1]), t)
        tlg = tm.decode_step(tcfg(cfg), tparams, tcache,
                             torch.from_numpy(seq[:, t:t + 1]), t)
        assert_close(tlg, lg, what=f"decode_step {t}")
    want = _ref_flat(cache)
    for name, leaf in flat_state(tcache).items():
        assert_close(leaf, want[name], what=f"cache {name}")


def _mixed_requests(cfg, cls):
    """6 requests, prompts of 3..25 tokens (some ragged in pages of 8),
    budgets of 3..13 tokens: the longest pass the window of 16."""
    rng = np.random.default_rng(42)
    return [cls(uid=i, tokens=rng.integers(
        0, cfg.vocab_size, 3 + 4 * i + i % 3).astype(np.int32),
        max_new=3 + 2 * i) for i in range(6)]


def _run(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return {r.uid: r.tokens for r in eng.run()}


ENGINE = dict(n_slots=2, cache_len=64, page_len=8, steps_per_tick=4)


def test_engine_greedy_tokens_match_reference(model):
    """6 mixed requests over 2 slots (each slot serves three, its
    recurrent state zeroed at each admission): the port engine's greedy
    tokens equal the reference engine's, and a reused slot's request
    equals a fresh one-slot engine's."""
    cfg, params, tparams = model
    got = _run(ServeEngine(tcfg(cfg), tparams, device="cpu", **ENGINE),
               _mixed_requests(cfg, Request))
    want = _run(JServeEngine(cfg, params, **ENGINE),
                _mixed_requests(cfg, JRequest))
    assert got == want
    assert sorted(got) == list(range(6))
    last = _mixed_requests(cfg, Request)[5]
    alone = _run(ServeEngine(tcfg(cfg), tparams, device="cpu",
                             **dict(ENGINE, n_slots=1)), [last])
    assert alone[last.uid] == got[last.uid]


def test_lockstep_matches_reference_and_engine(model):
    """``generate_lockstep`` (the prompt fed one token at a time from
    ``init_cache``, its last step's token the first generated one) past
    the window: the greedy tokens equal the reference's and the engine's
    for the same prompts."""
    cfg, params, tparams = model
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)
    want = np.asarray(jax_generate_lockstep(cfg, params, jnp.asarray(prompt),
                                            max_new=12))
    got = generate_lockstep(tcfg(cfg), tparams, prompt, max_new=12)
    np.testing.assert_array_equal(got.numpy(), want)
    eng = _run(ServeEngine(tcfg(cfg), tparams, device="cpu", **ENGINE),
               [Request(uid=i, tokens=prompt[i], max_new=12)
                for i in range(2)])
    assert [eng[i] for i in range(2)] == got.tolist()


def test_int8_cache_and_prefix_cache_raise(model):
    """An int8 cache and the prefix cache raise the reference's
    ``ValueError`` before any state or pool is built: the rolling window is
    bounded already, and has no pages to share."""
    cfg, _, tparams = model
    with pytest.raises(ValueError, match="rolling window is already"):
        ServeEngine(tcfg(cfg), tparams, device="cpu", kv_dtype="int8",
                    **ENGINE)
    with pytest.raises(ValueError, match="prefix cache needs a paged KV"):
        ServeEngine(tcfg(cfg), tparams, device="cpu", prefix_cache=True,
                    **ENGINE)
    for flag in (["--kv-dtype", "int8"], ["--prefix-cache"]):
        with pytest.raises(ValueError):
            torch_serve.main(["--arch", "recurrentgemma-2b", "--smoke",
                              "--device", "cpu", "--requests", "1",
                              "--slots", "1"] + flag)


def test_launchers_run_griffin_on_cpu(capsys, tmp_path):
    """``--arch recurrentgemma-2b --smoke --device cpu`` serves mixed
    requests and trains Sophia-G with a GNB refresh and a checkpoint."""
    results = torch_serve.main(["--arch", "recurrentgemma-2b", "--smoke",
                                "--device", "cpu", "--requests", "3",
                                "--slots", "2", "--prompt-len", "12",
                                "--max-new", "6", "--mixed"])
    assert len(results) == 3 and all(r.tokens for r in results)
    state = torch_train.main(["--arch", "recurrentgemma-2b", "--smoke",
                              "--device", "cpu", "--steps", "3",
                              "--seq-len", "32", "--global-batch", "2",
                              "--hess-subbatch", "1", "--hess-interval", "2",
                              "--log-every", "1", "--ckpt-dir",
                              str(tmp_path)])
    out = capsys.readouterr().out
    assert "arch=recurrentgemma-smoke" in out and "hess refreshes: 2" in out
    assert int(state.opt_state.hess_count) == 2
