"""The port's serving path (repro_torch) held against the JAX reference on
GPT2_TINY: the same weights (the reference's ``init_params`` carried over
by ``params_from_jax``), the same numpy inputs.  The reference decodes
through its Pallas kernel in interpret mode (``set_decode_attn_impl
("pallas")``), whose pre-scaled-q convention the port follows on every
device."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.gpt2 import GPT2_TINY
from repro.models import get_model as jax_get_model
from repro.models.layers import set_decode_attn_impl
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import generate as jax_generate
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as torch_launch
from repro_torch.models import ModelConfig, check_supported, get_model
from repro_torch.serve import Request, ServeEngine, generate

pytestmark = pytest.mark.serve

LOGIT_TOL = 1e-4   # fp32: four layers of fp32 products summed in other orders


def _cfgs(name, **over):
    cfg = dataclasses.replace(GPT2_TINY, name=name, **over)
    return cfg, ModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def weights():
    cfg = dataclasses.replace(GPT2_TINY, dtype="float32")
    params = jax_get_model(cfg).init_params(cfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)
    return params, np_params


def _pallas(fn):
    set_decode_attn_impl("pallas")
    try:
        return fn()
    finally:
        set_decode_attn_impl("xla")


def _run_slots(cfg, tcfg, params, tparams):
    """Prefill two slots in chunks (one ragged), then two decode steps of
    three slots (slot 0 fresh at position 0).  Returns the logits and
    caches of both sides."""
    jm, tm = jax_get_model(cfg), get_model(tcfg)
    N, C, P = 3, 32, 16
    st = jm.init_slots(cfg, N, C)
    tst = tm.init_slots(tcfg, N, C)
    rng = np.random.default_rng(0)
    prompts = {1: rng.integers(0, cfg.vocab_size, 11),
               2: rng.integers(0, cfg.vocab_size, 21)}
    out = []
    for slot, prompt in prompts.items():
        for start in range(0, len(prompt), P):
            chunk = prompt[start:start + P].astype(np.int32)
            n = len(chunk)
            chunk = np.pad(chunk, (0, P - n))[None]
            st, lg = jm.prefill_into_slot(cfg, params, st, slot,
                                          jnp.asarray(chunk), start, n)
            tlg = tm.prefill_into_slot(tcfg, tparams, tst, slot,
                                       torch.from_numpy(chunk), start, n)
            out.append((np.asarray(lg), tlg.numpy()))
    pos = np.array([0, 11, 21], np.int32)
    for step in range(2):
        toks = rng.integers(0, cfg.vocab_size, (N, 1)).astype(np.int32)
        lg, st = _pallas(lambda: jm.decode_slots(
            cfg, params, st, jnp.asarray(toks), jnp.asarray(pos + step)))
        tlg = tm.decode_slots(tcfg, tparams, tst, torch.from_numpy(toks),
                              torch.from_numpy(pos + step))
        out.append((np.asarray(lg, np.float32), tlg.float().numpy()))
    return out, st, tst


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefill_and_decode_logits_match_jax(weights, kv_dtype):
    params, np_params = weights
    cfg, tcfg = _cfgs("gpt2-tiny", dtype="float32", kv_dtype=kv_dtype)
    tparams = params_from_jax(np_params, tcfg)
    logits, st, tst = _run_slots(cfg, tcfg, params, tparams)
    for ref, got in logits:
        np.testing.assert_allclose(got, ref, atol=LOGIT_TOL)
    for name, leaf in st.items():
        ref, got = np.asarray(leaf), tst[name].numpy()
        if ref.dtype == np.int8:      # one quantization step of slack
            assert np.abs(ref.astype(np.int32) - got.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_bf16_decode_logits_close_to_jax(weights):
    """bf16 activations: the two frameworks round the residual stream, the
    GELU and the matmul outputs to bf16 at slightly different points
    (XLA fuses elementwise chains in fp32, PyTorch rounds after each op),
    so logits of magnitude ~0.8 agree to a few bf16 ulps (about 8e-3
    apart on this input): the reference's bf16 bound, 2e-2."""
    params, np_params = weights
    cfg, tcfg = _cfgs("gpt2-tiny", dtype="bfloat16")
    tparams = params_from_jax(np_params, tcfg)
    logits, _, _ = _run_slots(cfg, tcfg, params, tparams)
    for ref, got in logits:
        np.testing.assert_allclose(got, ref, atol=2e-2)


MIXED = [(5, 7), (13, 3), (8, 9), (21, 5), (3, 8), (17, 6)]


def _requests(cls, vocab, eos=None):
    rng = np.random.default_rng(10)
    return [cls(uid=i, tokens=rng.integers(0, vocab, sp).astype(np.int32),
                max_new=mn, eos_id=eos) for i, (sp, mn) in enumerate(MIXED)]


def test_engine_greedy_tokens_match_jax(weights):
    """6 mixed-length requests over 3 slots (slot reuse, chunked prefill
    interleaved with decode bursts) with an EOS id: the port's engine on
    the CPU emits exactly the reference engine's greedy tokens."""
    params, np_params = weights
    # a uniquely named config: the reference compiles one program per
    # config, and this one must trace on the Pallas route
    cfg, tcfg = _cfgs("gpt2-tiny-port-engine-parity", dtype="float32")
    tparams = params_from_jax(np_params, tcfg)
    kw = dict(n_slots=3, cache_len=64, page_len=8, steps_per_tick=4, seed=0)

    def port(eos):
        eng = ServeEngine(tcfg, tparams, device="cpu", **kw)
        for r in _requests(Request, cfg.vocab_size, eos):
            eng.submit(r)
        return {r.uid: r.tokens for r in eng.run()}

    eos = port(None)[0][3]            # request 0's 4th greedy token
    got = port(eos)

    def ref():
        eng = JServeEngine(cfg, params, **kw)
        for r in _requests(JRequest, cfg.vocab_size, eos):
            eng.submit(r)
        return {r.uid: r.tokens for r in eng.run()}

    want = _pallas(ref)
    assert got == want
    assert got[0][-1] == eos and len(got[0]) <= 4
    for i, (_, mn) in enumerate(MIXED):
        assert len(got[i]) == mn or got[i][-1] == eos


def test_generate_matches_jax(weights):
    params, np_params = weights
    cfg, tcfg = _cfgs("gpt2-tiny-port-generate", dtype="float32")
    tparams = params_from_jax(np_params, tcfg)
    prompts = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)
    want = np.asarray(_pallas(lambda: jax_generate(
        cfg, params, jnp.asarray(prompts), max_new=6)))
    got = generate(tcfg, tparams, torch.from_numpy(prompts), max_new=6,
                   device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_without_device_raises_on_cpu_only_machine(weights):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    _, np_params = weights
    _, tcfg = _cfgs("gpt2-tiny", dtype="float32")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(tcfg, params_from_jax(np_params, tcfg))


@pytest.mark.parametrize("arch", ["seamless-m4t-medium"])
def test_unported_options_raise(arch):
    """Since the port serves every family of the reference (the
    encoder-decoder family last), what it refuses in serving are the
    options the reference refuses there: for seamless-m4t-medium's smoke
    config an int8 cache and the prefix cache, each with the reference's
    ``ValueError``; and a family the reference does not have, by its
    family."""
    cfg = ModelConfig(**dataclasses.asdict(jax_get_config(arch, smoke=True)))
    check_supported(cfg)
    params = get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0))
    for kw in (dict(kv_dtype="int8"), dict(prefix_cache=True)):
        with pytest.raises(ValueError):
            ServeEngine(cfg, params, device="cpu", src_len=4, **kw)
    other = dataclasses.replace(cfg, family="other")
    with pytest.raises(NotImplementedError, match="family") as err:
        check_supported(other)
    assert repr(other.family) in str(err.value)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b"])
def test_ported_families_build_an_engine(arch):
    """recurrentgemma-2b's smoke config (griffin), refused until its family
    was ported, passes ``check_supported`` and builds a serve engine on
    the CPU whose slot state is the family's (a ring of the window's
    size, whatever the cache length)."""
    cfg = ModelConfig(**dataclasses.asdict(jax_get_config(arch, smoke=True)))
    check_supported(cfg)
    params = get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0))
    eng = ServeEngine(cfg, params, n_slots=2, cache_len=256, device="cpu")
    assert tuple(eng.state["kv"]["k"].shape[2:]) == (
        cfg.local_window, cfg.n_kv_heads, cfg.hd)


def test_launcher_runs_on_cpu(capsys):
    results = torch_launch.main([
        "--smoke", "--device", "cpu", "--requests", "3", "--slots", "2",
        "--prompt-len", "8", "--max-new", "4", "--mixed"])
    assert len(results) == 3 and all(r.tokens for r in results)
    out = capsys.readouterr().out
    assert "steady state:" in out and "kernel=plain" in out


def test_sample_tokens_greedy_ties_and_temperature():
    """Greedy takes the first maximal index, as ``jnp.argmax`` does; a
    positive temperature draws from softmax(logits / T) (draws differ from
    ``jax.random``'s, so the distribution is checked, not the tokens)."""
    from repro.serve.decode import sample_tokens as jax_sample_tokens
    from repro_torch.serve import sample_tokens

    gen = torch.Generator().manual_seed(0)
    logits = np.array([[0.5, 2.0, 2.0, -1.0]] * 3, np.float32)
    temps = np.zeros(3, np.float32)
    got = sample_tokens(gen, torch.from_numpy(logits), torch.from_numpy(temps))
    want = jax_sample_tokens(jax.random.PRNGKey(0), jnp.asarray(logits),
                             jnp.asarray(temps))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and got.tolist() == [1, 1, 1]

    n = 4000
    probs = np.exp(logits[0] / 2.0) / np.exp(logits[0] / 2.0).sum()
    draws = sample_tokens(gen, torch.from_numpy(np.repeat(logits[:1], n, 0)),
                          torch.full((n,), 2.0))
    freq = np.bincount(draws.numpy(), minlength=4) / n
    np.testing.assert_allclose(freq, probs, atol=0.03)


def test_profile_idle_gaps_between_kernels():
    """profile_window's gap report: the idle spans between the union of
    kernel intervals, longest first, named by the kernel that ended last
    before each and the one after it; overlapping kernels leave none."""
    from repro_torch.launch.profile_serve import _idle_gaps
    kernels = [("a", 0, 10), ("b", 5, 20), ("c", 30, 40), ("d", 100, 101),
               ("e", 35, 38)]
    assert _idle_gaps(kernels) == [[60, "c", "d"], [10, "b", "c"]]
    assert _idle_gaps(kernels, top=1) == [[60, "c", "d"]]
    assert _idle_gaps([("a", 0, 5), ("b", 5, 9)]) == []
