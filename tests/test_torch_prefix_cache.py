"""The shared-prefix page cache held against the JAX reference: the host
index (``serve/prefix_cache.py``, the port's own copy) run beside the
reference's on the same operations, and the engine's warm (prefix cache
on) greedy tokens against its cold ones and the reference engine's, for
yi-6b's and qwen2-vl-7b's smoke configs with both KV caches, under
eviction pressure, with two prefill chunks a tick, and through the
launcher.  The engines compute in fp32 so that the two packages' greedy
tokens can be compared at all (the ``bf16`` cache then holds the compute
dtype); the port alone also runs the smoke configs' own bf16."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _rope_models import tcfg
from repro.configs import get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro.serve import PrefixCache as JPrefixCache
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import prefix_cache as jpc
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as torch_launch
from repro_torch.serve import PrefixCache, Request, ServeEngine
from repro_torch.serve import prefix_cache as tpc

torch.set_num_threads(1)

PAGE = 8
IMPLS = {"port": (tpc, PrefixCache), "reference": (jpc, JPrefixCache)}


def _chunks(seed, n, lo=0, hi=512):
    rng = np.random.default_rng(seed)
    return [rng.integers(lo, hi, PAGE).astype(np.int32) for _ in range(n)]


# ---------------------------------------------------------------------------
# the host index: the reference's five tests, on both implementations


def _chain_hash(mod, cls):
    c = _chunks(0, 1)[0]
    k1, k2 = mod.chunk_key(mod.ROOT, c), mod.chunk_key(
        mod.chunk_key(mod.ROOT, c), c)
    assert k1 != k2
    return [k1, k2]


def _roundtrip(mod, cls):
    pc = cls(pool_pages=8, page_len=PAGE)
    chunks = _chunks(1, 3)
    key, trace = mod.ROOT, []
    for c in chunks:
        node, fresh = pc.insert(key, c)
        assert fresh
        key = node.key
        trace.append((node.key, node.pool_idx, fresh))
    chain = pc.lookup(np.concatenate(chunks), max_pages=3)
    assert [n.pool_idx for n in chain] == [0, 1, 2]
    other = np.concatenate(chunks[:2] + _chunks(2, 1))
    assert len(pc.lookup(other, max_pages=3)) == 2
    assert pc.hits == 2 and pc.lookups == 2 and pc.pages_reused == 5
    node, fresh = pc.insert(mod.ROOT, chunks[0])
    assert not fresh and node.refcount == 2
    pc.release([node])
    assert node.refcount == 1
    return trace + [[n.key for n in chain], pc.stats()]


def _eviction(mod, cls):
    pc = cls(pool_pages=2, page_len=PAGE)
    a, _ = pc.insert(mod.ROOT, _chunks(3, 1)[0])
    b, _ = pc.insert(a.key, _chunks(4, 1)[0])
    pc.release([a, b])
    c, fresh = pc.insert(mod.ROOT, _chunks(5, 1)[0])
    assert fresh and c.pool_idx == b.pool_idx
    assert pc.evictions == 1 and a.key in pc.nodes and b.key not in pc.nodes
    return [a.key, b.key, c.key, c.pool_idx, sorted(pc.nodes), pc.stats()]


def _all_held(mod, cls):
    pc = cls(pool_pages=1, page_len=PAGE)
    a, _ = pc.insert(mod.ROOT, _chunks(6, 1)[0])
    node, fresh = pc.insert(mod.ROOT, _chunks(7, 1)[0])
    assert node is None and not fresh
    pc.release([a])
    node, fresh = pc.insert(mod.ROOT, _chunks(7, 1)[0])
    assert fresh
    return [a.key, node.key, node.pool_idx, pc.stats()]


def _double_release(mod, cls):
    pc = cls(pool_pages=1, page_len=PAGE)
    a, _ = pc.insert(mod.ROOT, _chunks(8, 1)[0])
    pc.release([a])
    with pytest.raises(RuntimeError, match="double release"):
        pc.release([a])
    return [a.key, a.refcount, pc.stats()]


@pytest.mark.parametrize("scenario", [_chain_hash, _roundtrip, _eviction,
                                      _all_held, _double_release],
                         ids=lambda f: f.__name__.strip("_"))
def test_index_matches_reference(scenario):
    """Each of the reference's index tests (``tests/test_prefix_cache.py``)
    holds on the port's index and on the reference's, and the two give the
    same keys, pool indices, refcounts and counters."""
    assert scenario(*IMPLS["port"]) == scenario(*IMPLS["reference"])


# ---------------------------------------------------------------------------
# the engine


def _setup(arch, seed=0):
    """(reference config fp32, reference params, the port's params)."""
    cfg = dataclasses.replace(jax_get_config(arch, smoke=True),
                              dtype="float32", name=f"{arch}-pfx-port")
    params = jax_get_model(cfg).init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, params, params_from_jax(jax.tree.map(np.asarray, params),
                                        tcfg(cfg))


def _shared_requests(cfg, cls):
    """The reference test's stream: 5 requests behind a 35-token prefix
    (4 full pages and 3 tokens), tails of 3..11 tokens, 5 tokens each."""
    rng = np.random.default_rng(42)
    shared = rng.integers(0, cfg.vocab_size, 4 * PAGE + 3)
    return [cls(uid=i, tokens=np.concatenate(
        [shared, rng.integers(0, cfg.vocab_size, 3 + 2 * i)]).astype(
            np.int32), max_new=5) for i in range(5)]


def _run(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return {r.uid: r.tokens for r in eng.run()}


ENGINE = dict(n_slots=2, cache_len=64, page_len=PAGE, steps_per_tick=4)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("arch", ["yi-6b", "qwen2-vl-7b"])
def test_warm_tokens_equal_cold_and_reference(arch, kv_dtype):
    """Greedy decode over restored pages gives the cold prefill's tokens
    and the reference engine's (prefix cache on), with hits (>= 4 pages
    reused) and the reference's prefix counters; the port alone also at
    the smoke config's bf16 compute, where warm equals cold too."""
    cfg, params, tparams = _setup(arch)
    kw = dict(ENGINE, kv_dtype=kv_dtype)
    cold = _run(ServeEngine(tcfg(cfg), tparams, device="cpu", **kw),
                _shared_requests(cfg, Request))
    warm_eng = ServeEngine(tcfg(cfg), tparams, device="cpu",
                           prefix_cache=True, **kw)
    warm = _run(warm_eng, _shared_requests(cfg, Request))
    ref_eng = JServeEngine(cfg, params, prefix_cache=True, **kw)
    ref = _run(ref_eng, _shared_requests(cfg, JRequest))
    assert warm == cold == ref
    st, ref_st = warm_eng.stats(), ref_eng.stats()
    assert st["prefix_hit_rate"] > 0 and st["prefix_pages_reused"] >= 4
    prefix_keys = sorted(k for k in ref_st if k.startswith("prefix_"))
    assert sorted(k for k in st if k.startswith("prefix_")) == prefix_keys
    assert {k: st[k] for k in prefix_keys} == \
        {k: ref_st[k] for k in prefix_keys}

    bf16 = dataclasses.replace(tcfg(cfg), dtype="bfloat16")
    out = [_run(ServeEngine(bf16, tparams, device="cpu", prefix_cache=pc,
                            **kw), _shared_requests(cfg, Request))
           for pc in (False, True)]
    assert out[0] == out[1]


def test_identity_survives_eviction_pressure():
    """The reference's case: two alternating 3-page prefix chains contend
    for a 4-page pool, one request drained at a time.  Every switch
    evicts the other chain leaf-first and the root page still re-hits;
    the warm tokens equal the cold ones and the reference's, with the
    reference's counters."""
    cfg, params, tparams = _setup("yi-6b")
    rng = np.random.default_rng(40)
    prefixes = [rng.integers(0, cfg.vocab_size, 3 * PAGE) for _ in range(2)]
    tails = [rng.integers(0, cfg.vocab_size, 4) for _ in range(6)]

    def requests(cls):
        return [cls(uid=i, tokens=np.concatenate(
            [prefixes[i % 2], tails[i]]).astype(np.int32), max_new=4)
            for i in range(6)]

    kw = dict(n_slots=2, cache_len=48, page_len=PAGE, steps_per_tick=4,
              prefix_pool_pages=4)
    outs, stats = {}, {}
    for mode in ("cold", "warm", "reference"):
        eng = (JServeEngine(cfg, params, prefix_cache=True, **kw)
               if mode == "reference" else
               ServeEngine(tcfg(cfg), tparams, device="cpu",
                           prefix_cache=mode == "warm", **kw))
        res = []
        for r in requests(JRequest if mode == "reference" else Request):
            eng.submit(r)
            res += eng.run()
            eng.results.clear()
        outs[mode] = {r.uid: r.tokens for r in res}
        stats[mode] = {k: v for k, v in eng.stats().items()
                       if k.startswith("prefix_")}
    assert outs["cold"] == outs["warm"] == outs["reference"]
    s = stats["warm"]
    assert s["prefix_evictions"] > 0 and s["prefix_pool_used"] <= 4
    assert s["prefix_pages_reused"] > 0
    assert s == stats["reference"]


def test_two_prefill_chunks_a_tick_give_the_reference_tokens():
    """``prefill_chunks_per_tick=2`` (mixed lengths over 3 slots, the
    prefix cache on): the reference engine's greedy tokens with the same
    setting, and the port's own with one chunk a tick."""
    cfg, params, tparams = _setup("qwen2-vl-7b", seed=1)
    rng = np.random.default_rng(3)
    lens = [(5, 7), (29, 3), (21, 9), (40, 5), (3, 8)]
    shared = rng.integers(0, cfg.vocab_size, 2 * PAGE)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, sp)])
               .astype(np.int32) for sp, _ in lens]

    def requests(cls):
        return [cls(uid=i, tokens=p, max_new=mn)
                for i, (p, (_, mn)) in enumerate(zip(prompts, lens))]

    kw = dict(n_slots=3, cache_len=80, page_len=PAGE, steps_per_tick=4,
              prefix_cache=True)
    two = _run(ServeEngine(tcfg(cfg), tparams, device="cpu",
                           prefill_chunks_per_tick=2, **kw),
               requests(Request))
    one = _run(ServeEngine(tcfg(cfg), tparams, device="cpu", **kw),
               requests(Request))
    ref = _run(JServeEngine(cfg, params, prefill_chunks_per_tick=2, **kw),
               requests(JRequest))
    assert two == one == ref
    assert [len(two[i]) for i in range(len(lens))] == [m for _, m in lens]


def test_launcher_serves_with_the_prefix_cache(capsys):
    """``--prefix-cache --shared-prefix 32`` on qwen2-vl-7b's smoke config
    on the CPU: every request finishes and the report's prefix line shows
    hits."""
    results = torch_launch.main([
        "--arch", "qwen2-vl-7b", "--smoke", "--device", "cpu",
        "--requests", "4", "--slots", "2", "--prompt-len", "8",
        "--max-new", "4", "--shared-prefix", "32", "--prefix-cache",
        "--prefix-pool-pages", "8"])
    assert len(results) == 4 and all(len(r.tokens) == 4 for r in results)
    out = capsys.readouterr().out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("prefix cache:"))
    assert "pool=" in line and "/8" in line
    assert float(line.split("hit_rate=")[1].split()[0]) > 0
