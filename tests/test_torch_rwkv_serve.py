"""The RWKV-6 family's serving held against the JAX reference on rwkv6-7b's
smoke config (fp32 compute, the reference's weights carried across by
``params_from_jax``, numpy inputs): the bounded-state slot protocol
(``init_slots``, ``prefill_into_slot``, ``decode_slots``, ``reset_slot``),
the engine's greedy tokens with slots reused, ``generate_lockstep``, the
two serving routes against each other in fp64, and the options the
family refuses (an int8 cache, the prefix cache), in the engine and in
the launchers."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _rope_models import tcfg
from _rwkv_models import port_params, ref_params, rwkv_cfg
from repro.models import get_model as jax_get_model
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import generate_lockstep as jax_generate_lockstep
from repro_torch.launch import serve as torch_serve
from repro_torch.launch import train as torch_train
from repro_torch.models import get_model
from repro_torch.serve import Request, ServeEngine, generate_lockstep

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model():
    """(reference config fp32, reference params, the port's params); a
    uniquely named config, since the reference compiles one program per
    config."""
    cfg = rwkv_cfg(name="rwkv6-7b-serve")
    params = ref_params(cfg)
    return cfg, params, port_params(cfg, params)


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max(), err_msg=what)


def test_prefill_and_decode_match_reference(model):
    """Two of three slots prefilled in chunks of 16 (11 tokens: one ragged
    chunk; 29: a full and a ragged one), then three decode steps of all
    three slots: the last valid token's logits, every step's logits and
    the whole slot state within 1e-5 of their largest element."""
    cfg, params, tparams = model
    jm, tm = jax_get_model(cfg), get_model(tcfg(cfg))
    N, P = 3, 16
    st, tst = jm.init_slots(cfg, N, 64), tm.init_slots(tcfg(cfg), N, 64)
    assert all(leaf.shape[:2] == (cfg.n_layers, N) for leaf in tst.values())
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
            tlg = tm.prefill_into_slot(tcfg(cfg), tparams, tst, slot,
                                       torch.from_numpy(chunk), start, n)
            _close(tlg, lg, f"prefill slot {slot} at {start}")
    for name, leaf in st.items():
        _close(tst[name], leaf, f"state {name} after prefill")
    pos = np.array([0, 11, 29], np.int32)
    for step in range(3):
        toks = rng.integers(0, cfg.vocab_size, (N, 1)).astype(np.int32)
        lg, st = jm.decode_slots(cfg, params, st, jnp.asarray(toks),
                                 jnp.asarray(pos + step))
        tlg = tm.decode_slots(tcfg(cfg), tparams, tst,
                              torch.from_numpy(toks),
                              torch.from_numpy(pos + step))
        _close(tlg, lg, f"decode step {step}")
    for name, leaf in st.items():
        _close(tst[name], leaf, f"state {name} after decode")


def test_decode_leaves_inactive_slots_and_reset_clears_one(model):
    """``decode_slots`` with ``active`` writes the active slots' state only:
    an inactive slot's rows come out bit-identical (a slot between prefill
    chunks must not move during a decode burst), and the active ones equal
    a decode without the mask.  ``reset_slot`` zeroes one slot's rows of
    every leaf and leaves the others as they were."""
    cfg, _, tparams = model
    tm, c = get_model(tcfg(cfg)), tcfg(cfg)
    st = tm.init_slots(c, 3, 0)
    rng = np.random.default_rng(1)
    for slot in range(3):
        tm.prefill_into_slot(c, tparams, st, slot, torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (1, 8)).astype(np.int32)), 0, 8)
    before = {k: v.clone() for k, v in st.items()}
    free = {k: v.clone() for k, v in st.items()}
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 1)).astype(
        np.int32))
    pos = torch.zeros(3, dtype=torch.int32)
    active = torch.tensor([True, False, True])
    lg = tm.decode_slots(c, tparams, st, toks, pos, active=active)
    lg_free = tm.decode_slots(c, tparams, free, toks, pos)
    assert torch.equal(lg, lg_free)
    for k in st:
        assert torch.equal(st[k][:, 1], before[k][:, 1])
        assert torch.equal(st[k][:, [0, 2]], free[k][:, [0, 2]])
        assert not torch.equal(st[k][:, 0], before[k][:, 0])
    kept = {k: v[:, :2].clone() for k, v in st.items()}
    tm.reset_slot(c, st, 2)
    for k in st:
        assert not st[k][:, 2].any()
        assert torch.equal(st[k][:, :2], kept[k])


def _mixed_requests(cfg, cls):
    """6 requests, prompts of 3..25 tokens (some ragged in pages of 8),
    budgets of 3..8 tokens."""
    rng = np.random.default_rng(42)
    return [cls(uid=i, tokens=rng.integers(
        0, cfg.vocab_size, 3 + 4 * i + i % 3).astype(np.int32),
        max_new=3 + i) for i in range(6)]


def _run(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return {r.uid: r.tokens for r in eng.run()}


ENGINE = dict(n_slots=2, cache_len=64, page_len=8, steps_per_tick=4)


def test_engine_greedy_tokens_match_reference(model):
    """6 mixed requests over 2 slots (each slot serves three, zeroed at
    each admission): the port engine's greedy tokens equal the reference
    engine's, and each request's tokens equal those of a fresh engine
    that serves it alone (no state leaks from the slot's last request)."""
    cfg, params, tparams = model
    got = _run(ServeEngine(tcfg(cfg), tparams, device="cpu", **ENGINE),
               _mixed_requests(cfg, Request))
    want = _run(JServeEngine(cfg, params, **ENGINE),
                _mixed_requests(cfg, JRequest))
    assert got == want
    assert sorted(got) == list(range(6))
    for r in _mixed_requests(cfg, Request)[3:]:
        alone = _run(ServeEngine(tcfg(cfg), tparams, device="cpu",
                                 **dict(ENGINE, n_slots=1)), [r])
        assert alone[r.uid] == got[r.uid]


def test_lockstep_matches_reference_and_engine(model):
    """``generate_lockstep`` (the prompt fed one token at a time from
    ``init_cache``, its last step's token the first generated one): the
    greedy tokens equal the reference's and the engine's for the same
    prompts; and ``decode_step`` updates the cache in place, its logits
    within 1e-5 of the reference's."""
    cfg, params, tparams = model
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)
    want = np.asarray(jax_generate_lockstep(cfg, params, jnp.asarray(prompt),
                                            max_new=6))
    got = generate_lockstep(tcfg(cfg), tparams, prompt, max_new=6)
    np.testing.assert_array_equal(got.numpy(), want)
    eng = _run(ServeEngine(tcfg(cfg), tparams, device="cpu", **ENGINE),
               [Request(uid=i, tokens=prompt[i], max_new=6)
                for i in range(2)])
    assert [eng[i] for i in range(2)] == got.tolist()
    jm, tm = jax_get_model(cfg), get_model(tcfg(cfg))
    cache = jm.init_cache(cfg, 2, 16)
    tcache = tm.init_cache(tcfg(cfg), 2, 16)
    for t in range(3):
        lg, cache = jm.decode_step(cfg, params, cache,
                                   jnp.asarray(prompt[:, t:t + 1]), t)
        tlg = tm.decode_step(tcfg(cfg), tparams, tcache,
                             torch.from_numpy(prompt[:, t:t + 1]), t)
        _close(tlg, lg, f"decode_step {t}")
    for name, leaf in cache.items():
        _close(tcache[name], leaf, f"cache {name}")


def test_fp64_serving_routes_agree(model):
    """An fp64 config (every fp32 of the model in fp64, the WKV state
    included; ``chip_smoke.py`` holds the two serving routes to each other
    in it at full depth on the card): its logits within 1e-4 of the fp32
    model's largest; teacher-forced over 2 prompts of 20 tokens and 5
    more, the engine's route (``prefill_into_slot`` in chunks of 16, then
    ``decode_slots``) and the lockstep's (``decode_step``) within 1e-12 of
    the largest logit; and ``generate_lockstep``'s greedy tokens equal the
    engine's."""
    cfg, _, tparams = model
    c64 = dataclasses.replace(tcfg(cfg), dtype="float64")
    tm = get_model(c64)
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    seq = torch.from_numpy(np.concatenate(
        [prompts, rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)],
        axis=1))
    cache = tm.init_cache(c64, 2, 0)
    assert cache["wkv"].dtype == cache["tm_shift"].dtype == torch.float64
    lock = torch.stack([tm.decode_step(c64, tparams, cache,
                                       seq[:, t:t + 1], t)[:, 0]
                        for t in range(seq.shape[1] - 1)], dim=1)[:, 19:]
    assert lock.dtype == torch.float64
    f32 = tm.forward(tcfg(cfg), tparams, seq[:, :-1])[0][:, 19:]
    assert (lock - f32).abs().max() <= 1e-4 * f32.abs().max()
    st = tm.init_slots(c64, 2, 0)
    first = []
    for i in range(2):
        for start in (0, 16):
            chunk = prompts[i, start:start + 16]
            padded = torch.from_numpy(np.pad(chunk, (0, 16 - len(chunk))))
            lg = tm.prefill_into_slot(c64, tparams, st, i, padded[None],
                                      start, len(chunk))
        first.append(lg)
    eng = [torch.stack(first)]
    for t in range(20, seq.shape[1] - 1):
        eng.append(tm.decode_slots(c64, tparams, st, seq[:, t:t + 1],
                                   torch.zeros(2, dtype=torch.int32))[:, 0])
    eng = torch.stack(eng, dim=1)
    assert (eng - lock).abs().max() <= 1e-12 * lock.abs().max()
    got = generate_lockstep(c64, tparams, prompts, max_new=6).tolist()
    served = _run(ServeEngine(c64, tparams, device="cpu", **ENGINE),
                  [Request(uid=i, tokens=prompts[i], max_new=6)
                   for i in range(2)])
    assert [served[i] for i in range(2)] == got


def test_int8_cache_and_prefix_cache_raise(model):
    """An int8 cache and the prefix cache raise the reference's
    ``ValueError`` before any state or pool is built: the recurrent state
    has no KV cache to quantize and no pages to share."""
    cfg, _, tparams = model
    with pytest.raises(ValueError, match="rwkv has no KV cache"):
        ServeEngine(tcfg(cfg), tparams, device="cpu", kv_dtype="int8",
                    **ENGINE)
    with pytest.raises(ValueError, match="prefix cache needs a paged KV"):
        ServeEngine(tcfg(cfg), tparams, device="cpu", prefix_cache=True,
                    **ENGINE)
    for flag in (["--kv-dtype", "int8"], ["--prefix-cache"]):
        with pytest.raises(ValueError):
            torch_serve.main(["--arch", "rwkv6-7b", "--smoke", "--device",
                              "cpu", "--requests", "1", "--slots", "1"]
                             + flag)


def test_launchers_run_rwkv_on_cpu(capsys, tmp_path):
    """``--arch rwkv6-7b --smoke --device cpu`` serves mixed requests and
    trains Sophia-G with a GNB refresh and a checkpoint."""
    results = torch_serve.main(["--arch", "rwkv6-7b", "--smoke", "--device",
                                "cpu", "--requests", "3", "--slots", "2",
                                "--prompt-len", "12", "--max-new", "4",
                                "--mixed"])
    assert len(results) == 3 and all(r.tokens for r in results)
    state = torch_train.main(["--arch", "rwkv6-7b", "--smoke", "--device",
                              "cpu", "--steps", "3", "--seq-len", "32",
                              "--global-batch", "2", "--hess-subbatch", "1",
                              "--hess-interval", "2", "--log-every", "1",
                              "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "arch=rwkv6-7b-smoke" in out and "hess refreshes: 2" in out
    assert int(state.opt_state.hess_count) == 2
