"""The port's flat-buffer optimizer engine (repro_torch.core.engine) held
against the JAX reference's ``OptimizerEngine(backend="reference")``: the
same leaf order, offsets and tail pad, so raveled shards are bit-identical,
and the same Sophia step and step-with-refresh over several steps with fp32
and bf16 state (the tolerances of tests/test_unified_step.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gpt2 import GPT2_TINY
from repro.core.engine import OptimizerEngine as JEngine
from repro.core.engine import build_layout as jax_build_layout
from repro.core.engine import ravel_shards as jax_ravel_shards
from repro.models import get_model as jax_get_model
from repro_torch.convert import engine_state_from_jax, params_from_jax
from repro_torch.core import build_layout, ravel_shards, unravel_shards
from repro_torch.core.engine import OptimizerEngine
from repro_torch.models import ModelConfig

SOPHIA_HYPERS = dict(beta1=0.96, beta2=0.99, gamma=0.05, eps=1e-12,
                     weight_decay=0.2, clip_threshold=1.0)

# One intra-op thread per process: the suite runs six pytest-xdist workers
# on the machine's cores, and torch's default pool in every worker
# oversubscribes them, slowing every test beside it (JAX's too) severalfold.
torch.set_num_threads(1)


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jnp(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module")
def tiny():
    cfg = dataclasses.replace(GPT2_TINY, dtype="float32")
    params = jax_get_model(cfg).init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, params),
                              ModelConfig(**dataclasses.asdict(cfg)))
    return params, tparams


@pytest.mark.parametrize("block", [128, 128 * 1024])
def test_layout_and_shards_match_reference(tiny, block):
    """Leaf order (sorted keys, each stacked leaf raveled layer 0 first),
    offsets, the tail pad and the raveled shards, bit for bit."""
    params, tparams = tiny
    ref = jax_build_layout(params, block=block)
    tree = tparams.param_tree()
    lay = build_layout(tree, block=block)
    assert lay.leaf_shapes == ref.leaf_shapes
    assert lay.leaf_offset == ref.leaf_offset
    assert lay.leaf_shard == ref.leaf_shard
    assert lay.shard_sizes == ref.shard_sizes
    assert lay.shard_used == ref.shard_used
    assert lay.manifest() == ref.manifest()
    for a, b in zip(ravel_shards(lay, tree), jax_ravel_shards(ref, params)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    # and back: unravel gives the reference's stacked leaves
    for got, want in zip(unravel_shards(lay, ravel_shards(lay, tree)),
                         jax.tree.leaves(params)):
        np.testing.assert_array_equal(_np(got), np.asarray(want))


def _params(rng):
    return {"w": rng.standard_normal((37, 5)).astype(np.float32),
            "b": np.zeros((11,), np.float32),
            "s": np.asarray(rng.standard_normal(), np.float32)}


def _grads(rng, scale=0.1):
    return {"w": rng.standard_normal((37, 5)).astype(np.float32) * scale,
            "b": rng.standard_normal((11,)).astype(np.float32) * scale,
            "s": np.asarray(rng.standard_normal() * scale, np.float32)}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_steps_match_reference_engine(state_dtype):
    """Six steps alternating step_with_refresh (t even, B = 240) and
    step_shards: params, m, h and the clip fraction track the reference
    engine to rtol 1e-6 / atol 3e-6 (clip fraction 1e-7), counts exactly.
    Then the reference's state carries over to the port as a plain copy."""
    rng = np.random.default_rng(0)
    p0 = _params(rng)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jdt = jnp.bfloat16 if state_dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if state_dtype == "bfloat16" else torch.float32
    jeng = JEngine("sophia_g", hypers=SOPHIA_HYPERS, block=128,
                   state_dtype=jdt)
    teng = OptimizerEngine("sophia_g", hypers=SOPHIA_HYPERS, block=128,
                           state_dtype=tdt)
    js, ts = jeng.init(jp), teng.init(tp)
    for t in range(6):
        g = _grads(rng)
        e = _grads(rng)
        lr = np.float32(1e-3 * (1.0 + 0.1 * t))
        jg = jeng.ravel_grads(jp, {k: jnp.asarray(v) for k, v in g.items()})
        tg = teng.ravel_grads(tp, {k: torch.from_numpy(v) for k, v in g.items()})
        np.testing.assert_array_equal(_np(tg[0]), np.asarray(jg[0]))
        if t % 2 == 0:
            je = tuple(jnp.square(x) for x in jeng.ravel_grads(
                jp, {k: jnp.asarray(v) for k, v in e.items()}))
            te = tuple(x.square() for x in teng.ravel_grads(
                tp, {k: torch.from_numpy(v) for k, v in e.items()}))
            jp, js = jeng.step_with_refresh(js, jp, jg, lr, je, 240.0,
                                            jnp.asarray(True))
            tp, ts = teng.step_with_refresh(ts, tp, tg, torch.tensor(lr), te,
                                            240.0, True)
        else:
            jp, js = jeng.step_shards(js, jp, jg, lr)
            tp, ts = teng.step_shards(ts, tp, tg, torch.tensor(lr))
        assert int(ts.count) == int(js.count) == t + 1
        assert int(ts.hess_count) == int(js.hess_count) == t // 2 + 1
        for k in p0:
            np.testing.assert_allclose(_np(tp[k]), _jnp(jp[k]), rtol=1e-6,
                                       atol=3e-6)
        for a, b in zip(ts.m + ts.h, js.m + js.h):
            assert a.dtype == tdt
            np.testing.assert_allclose(_np(a), _jnp(b), rtol=1e-6,
                                       atol=3e-6)
        np.testing.assert_allclose(float(ts.clip_fraction),
                                   float(js.clip_fraction), atol=1e-7)

    moved = engine_state_from_jax(jax.tree.map(np.asarray, js),
                                  teng.layout(tp))
    assert int(moved.count) == int(js.count)
    assert int(moved.hess_count) == int(js.hess_count)
    for a, b in zip(moved.m + moved.h, js.m + js.h):
        assert a.dtype == tdt
        np.testing.assert_array_equal(_np(a), _jnp(b))


def test_refresh_flag_clear_is_the_plain_step():
    rng = np.random.default_rng(1)
    p0 = _params(rng)
    g = {k: torch.from_numpy(v) for k, v in _grads(rng).items()}
    eng = OptimizerEngine("sophia_g", hypers=SOPHIA_HYPERS, block=128)
    pa = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    pb = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    sa, sb = eng.init(pa), eng.init(pb)
    g_sh = eng.ravel_grads(pa, g)
    est = tuple(x.square() for x in g_sh)
    lr = torch.tensor(1e-3)
    pa, sa = eng.step_with_refresh(sa, pa, g_sh, lr, est, 7.0, False)
    pb, sb = eng.step_shards(sb, pb, g_sh, lr)
    assert int(sa.hess_count) == 0
    for k in p0:
        torch.testing.assert_close(pa[k], pb[k], rtol=0, atol=0)


@pytest.mark.parametrize("optimizer,n_h", [("sgd", 0), ("lion", 0),
                                           ("signgd", 0), ("adahessian", 1)])
def test_baseline_engines_build_their_state(optimizer, n_h):
    """The baselines the engine refused before this slice: Lion, SignGD
    and SGD keep no curvature shard (the reference's ``h=()``),
    AdaHessian one v shard; one step moves the parameters and counts."""
    rng = np.random.default_rng(2)
    p = {k: torch.from_numpy(v.copy()) for k, v in _params(rng).items()}
    hyp = dict(beta1=0.9, beta2=0.99, eps=1e-8, weight_decay=0.1,
               momentum=0.5)
    eng = OptimizerEngine(optimizer, hypers=hyp, block=128)
    st = eng.init(p)
    assert len(st.h) == n_h and len(st.m) == 1
    before = {k: v.clone() for k, v in p.items()}
    g = eng.ravel_grads(p, {k: torch.from_numpy(v)
                            for k, v in _grads(rng).items()})
    p, st = eng.step_shards(st, p, g, torch.tensor(1e-3))
    assert int(st.count) == 1 and not torch.equal(p["w"], before["w"])


@pytest.mark.parametrize("optimizer", ["lion", "signgd"])
def test_sign_engines_put_nan_where_the_reference_does(optimizer):
    """Two steps of Lion and SignGD on the port's plain route against the
    reference engine's Pallas backend (interpret mode), with NaN in g at a
    few positions in each step (the first step's NaN reach m): p and m are
    NaN exactly where the reference's are (``jnp.sign`` of NaN is NaN) and
    within rtol 1e-6 / atol 3e-6 of them elsewhere, the bound of
    :func:`test_steps_match_reference_engine` (the reference's jitted step
    contracts products into FMAs)."""
    rng = np.random.default_rng(4)
    p0 = _params(rng)
    hyp = dict(beta1=0.95, beta2=0.98, weight_decay=0.2)
    if optimizer == "signgd":
        hyp = dict(beta1=0.96, weight_decay=0.2)
    jeng = JEngine(optimizer, hypers=hyp, backend="pallas", block=128,
                   interpret=True)
    teng = OptimizerEngine(optimizer, hypers=hyp, backend="reference",
                           block=128)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jeng.init(jp), teng.init(tp)
    for t, rows in enumerate(([2, 30], [7, 31])):
        g = _grads(rng)
        g["w"][rows, t] = np.nan
        lr = np.float32(1e-3)
        jg = jeng.ravel_grads(jp, {k: jnp.asarray(v) for k, v in g.items()})
        tg = teng.ravel_grads(tp, {k: torch.from_numpy(v)
                                   for k, v in g.items()})
        jp, js = jeng.step_shards(js, jp, jg, lr)
        tp, ts = teng.step_shards(ts, tp, tg, torch.tensor(lr))
    pairs = [(_np(tp[k]), _jnp(jp[k])) for k in p0]
    pairs += [(_np(a), _jnp(b)) for a, b in zip(ts.m, js.m)]
    n_nan = 0
    for a, b in pairs:
        nan = np.isnan(b)
        n_nan += int(nan.sum())
        np.testing.assert_array_equal(np.isnan(a), nan)
        np.testing.assert_allclose(a[~nan], b[~nan], rtol=1e-6, atol=3e-6)
    assert n_nan == 8      # 4 NaN of p and 4 of m


@pytest.mark.parametrize("kw,err", [
    (dict(backend="pallas"), ValueError),     # the port's name is "fused"
    (dict(backend="triton"), ValueError),
    (dict(optimizer="nope"), ValueError),
])
def test_unported_engine_options_raise(kw, err):
    args = dict(optimizer="sophia_g", backend="reference")
    args.update(kw)
    with pytest.raises(err):
        OptimizerEngine(args["optimizer"], hypers=SOPHIA_HYPERS,
                        backend=args["backend"])
