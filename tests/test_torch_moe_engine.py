"""The serve engine on the MoE family against the JAX reference's, for
deepseek-moe-16b's and llama4-maverick's smoke configs with bf16 and int8
caches: the greedy tokens with the prefix cache warm equal those of a cold
prefill and the reference engine's.  fp32 compute, so that the two
packages' greedy tokens can be compared at all; the port alone also at the
smoke configs' bf16.  Every row is routed as in the reference: a prefill
chunk's padded tail and the idle slots of a decode step compete for the
experts' capacity there too."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _rope_models import tcfg
from repro.configs import get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.convert import params_from_jax
from repro_torch.serve import Request, ServeEngine

torch.set_num_threads(1)

NAMES = ("deepseek-moe-16b", "llama4-maverick-400b-a17b")


def _setup(arch, seed=0):
    """(reference config fp32, reference params, the port's params); a
    uniquely named config, since the reference compiles one program per
    config."""
    cfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                              dtype="float32", name=f"{arch}-moe-engine")
    params = jax_get_model(cfg).init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, params, params_from_jax(jax.tree.map(np.asarray, params),
                                        tcfg(cfg))


PAGE = 8
ENGINE = dict(n_slots=2, cache_len=64, page_len=PAGE, steps_per_tick=4)


def _shared_requests(cfg, cls):
    """5 requests behind a 35-token prefix (4 full pages and 3 tokens),
    tails of 3..11 tokens, 5 tokens each (the prefix-cache tests'
    stream)."""
    rng = np.random.default_rng(42)
    shared = rng.integers(0, cfg.vocab_size, 4 * PAGE + 3)
    return [cls(uid=i, tokens=np.concatenate(
        [shared, rng.integers(0, cfg.vocab_size, 3 + 2 * i)]).astype(
            np.int32), max_new=5) for i in range(5)]


def _run(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return {r.uid: r.tokens for r in eng.run()}


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("arch", NAMES)
def test_engine_tokens_warm_cold_and_reference(arch, kv_dtype):
    """The engine's greedy tokens with the prefix cache on equal those of a
    cold prefill and the reference engine's (prefix cache on), with pages
    reused; and the port alone at the smoke config's bf16 compute, where
    warm equals cold too."""
    cfg, params, tparams = _setup(arch)
    kw = dict(ENGINE, kv_dtype=kv_dtype)
    cold = _run(ServeEngine(tcfg(cfg), tparams, device="cpu", **kw),
                _shared_requests(cfg, Request))
    warm_eng = ServeEngine(tcfg(cfg), tparams, device="cpu",
                           prefix_cache=True, **kw)
    warm = _run(warm_eng, _shared_requests(cfg, Request))
    ref = _run(JServeEngine(cfg, params, prefix_cache=True, **kw),
               _shared_requests(cfg, JRequest))
    assert warm == cold == ref
    assert warm_eng.stats()["prefix_pages_reused"] >= 4
    bf16 = dataclasses.replace(tcfg(cfg), dtype="bfloat16")
    out = [_run(ServeEngine(bf16, tparams, device="cpu", prefix_cache=pc,
                            **kw), _shared_requests(cfg, Request))
           for pc in (False, True)]
    assert out[0] == out[1]
