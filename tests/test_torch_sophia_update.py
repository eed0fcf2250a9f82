"""The port's engine kernels (repro_torch.kernels.sophia_update, rows 2-10
of the kernel table) held against the JAX reference on the CPU:
each plain version against the reference's Pallas kernel in interpret
mode (rtol 1e-6 / atol 3e-6, the tolerance of tests/test_torch_engine.py;
per-block clip counts exactly equal), the per-tensor harness against the
reference's, the port engine's ``fused`` backend against the reference
engine's ``pallas`` backend and against the port's own ``reference``
backend (bit for bit), and the wrappers' argument checks.  With bf16
state, an output that the reference rounds after an FMA where the port
rounds each product (:func:`_close_state`) may sit one bf16 ulp apart."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gpt2 import GPT2_TINY
from repro.core.engine import OptimizerEngine as JEngine
from repro.kernels import ops as jops
from repro.kernels import sophia_update as jblk
from repro_torch.convert import engine_state_from_jax
from repro_torch.core.engine import OptimizerEngine
from repro_torch.data import DataConfig, make_source
from repro_torch.kernels import ops, sophia_update as blk
from repro_torch.models import ModelConfig
from repro_torch.train import TrainerConfig, make_engine, train_loop

# One intra-op thread per process: the suite runs six pytest-xdist workers
# on the machine's cores, and torch's default pool in every worker
# oversubscribes them, slowing every test beside it (JAX's too) severalfold.
torch.set_num_threads(1)

SOPHIA = dict(beta1=0.96, gamma=0.05, eps=1e-12, weight_decay=0.2)
ADAMW = dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1)
ADAHESSIAN = dict(beta1=0.92, beta2=0.99, eps=1e-8, weight_decay=0.1)
LION = dict(beta1=0.95, beta2=0.98, weight_decay=0.1)
SIGNGD = dict(beta1=0.96, weight_decay=0.1)
TOL = dict(rtol=1e-6, atol=3e-6)
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jnp(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(x, dtype="float32"):
    """One numpy fp32 array as (jax array, torch tensor) in ``dtype``,
    bit-identical (bf16 rounds once, on the torch side, and carries over)."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(_TDT[dtype])
    return jnp.asarray(_np(t)).astype(_JDT[dtype]), t


def _inputs(n, seed, *, p_dtype, state_dtype, h_kind="positive"):
    """p, m, h, g, e as (jax, torch) pairs.  ``h_kind``: "positive",
    "mixed" (zeros and negative entries, the Hutchinson-style case) or
    "tail_pad" (the last quarter of every operand zero, the engine's
    pad)."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(n)
    m = rng.standard_normal(n) * 0.1
    h = np.abs(rng.standard_normal(n)) * 0.01
    g = rng.standard_normal(n) * 0.1
    e = rng.standard_normal(n) ** 2 * 1e-3
    if h_kind == "mixed":
        h = rng.standard_normal(n) * 0.01
        h[::5] = 0.0
    arrays = [p, m, h, g, e]
    if h_kind == "tail_pad":
        for a in arrays:
            a[3 * n // 4:] = 0.0
    dts = (p_dtype, state_dtype, state_dtype, "float32", "float32")
    return [_pair(a, dt) for a, dt in zip(arrays, dts)]


def _close(got, want):
    assert got.dtype == _TDT[str(want.dtype)]
    np.testing.assert_allclose(_np(got), _jnp(want), **TOL)


def _close_state(got, want):
    """Engine state against the reference engine's: fp32 within TOL; bf16
    within one bf16 ulp, on at most 2% of the elements.  The reference's
    jitted step contracts b2 h + (1-b2) e into an FMA where the port
    rounds each product (as the reference's own eager oracle does), so the
    fp32 values differ in their last bits and one near a bf16 rounding
    midpoint lands one ulp apart."""
    if got.dtype != torch.bfloat16:
        np.testing.assert_allclose(_np(got), _jnp(want), **TOL)
        return
    a = got.view(torch.int16).numpy().astype(np.int32)
    b = np.asarray(want).view(np.int16).astype(np.int32)
    assert np.abs(a - b).max() <= 1
    assert (a != b).mean() <= 0.02


SOPHIA_CASES = [
    # n, block, p dtype, state dtype, h kind, rho
    (384, 128, "float32", "float32", "positive", 1.0),
    (512, 256, "float32", "bfloat16", "positive", 1.0),
    (384, 128, "bfloat16", "float32", "mixed", 1.0),
    (384, 128, "float32", "float32", "positive", 1e9),
    (256, 256, "bfloat16", "bfloat16", "tail_pad", 1.0),
]


@pytest.mark.parametrize("n,block,pdt,sdt,h_kind,rho", SOPHIA_CASES)
def test_sophia_step_plain_matches_pallas(n, block, pdt, sdt, h_kind, rho):
    (jp, tp), (jm, tm), (jh, th), (jg, tg), _ = _inputs(
        n, 1, p_dtype=pdt, state_dtype=sdt, h_kind=h_kind)
    lr = np.float32(3e-3)
    want = jblk.sophia_fused_block(jp, jm, jh, jg, lr, clip_threshold=rho,
                                   block=block, interpret=True, **SOPHIA)
    got = blk.sophia_fused_block(tp, tm, th, tg, torch.tensor(lr),
                                 clip_threshold=rho, block=block, **SOPHIA)
    _close(got[0], want[0])
    _close(got[1], want[1])
    assert got[2].dtype == torch.int32 and got[2].shape == (n // block,)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if h_kind == "tail_pad":        # the pad is a fixed point, no clips
        for t in got[:2]:
            assert not _np(t)[3 * n // 4:].any()
    if rho == 1e9:
        assert not got[2].any()


@pytest.mark.parametrize("sdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("square", [False, True])
def test_hessian_ema_plain_matches_pallas(sdt, square):
    _, _, (jh, th), _, (je, te) = _inputs(384, 2, p_dtype="float32",
                                          state_dtype=sdt)
    want = jblk.hessian_ema_block(jh, je, beta2=0.99, scale=240.0,
                                  square=square, block=128, interpret=True)
    got = blk.hessian_ema_block(th, te, beta2=0.99, scale=torch.tensor(240.0),
                                square=square, block=128)
    _close(got, want)


@pytest.mark.parametrize("flag", [0, 1])
@pytest.mark.parametrize("n,block,pdt,sdt,h_kind,rho", [
    (384, 128, "float32", "float32", "positive", 1.0),
    (512, 256, "bfloat16", "bfloat16", "mixed", 1.0),
    (384, 128, "float32", "bfloat16", "positive", 1e9),
])
def test_sophia_refresh_plain_matches_pallas(flag, n, block, pdt, sdt,
                                             h_kind, rho):
    (jp, tp), (jm, tm), (jh, th), (jg, tg), (je, te) = _inputs(
        n, 3, p_dtype=pdt, state_dtype=sdt, h_kind=h_kind)
    lr, scale = np.float32(2e-3), np.float32(240.0)
    want = jblk.sophia_refresh_fused_block(
        jp, jm, jh, jg, je, lr, flag, scale, beta2=0.99, clip_threshold=rho,
        block=block, interpret=True, **SOPHIA)
    got = blk.sophia_refresh_fused_block(
        tp, tm, th, tg, te, torch.tensor(lr), flag, torch.tensor(scale),
        beta2=0.99, clip_threshold=rho, block=block, **SOPHIA)
    for a, b in zip(got[:3], want[:3]):
        _close(a, b)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    if not flag:
        np.testing.assert_array_equal(_np(got[2]), _np(th))


@pytest.mark.parametrize("step", [1, 2, 100, 1000])
@pytest.mark.parametrize("pdt,sdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("float32", "bfloat16")])
def test_adamw_plain_matches_pallas(step, pdt, sdt):
    (jp, tp), (jm, tm), (jv, tv), (jg, tg), _ = _inputs(
        384, 4, p_dtype=pdt, state_dtype=sdt)
    lr = np.float32(1e-3)
    want = jblk.adamw_fused_block(jp, jm, jv, jg, lr, step, block=128,
                                  interpret=True, **ADAMW)
    got = blk.adamw_fused_block(tp, tm, tv, tg, torch.tensor(lr),
                                torch.tensor(float(step)), block=128, **ADAMW)
    for a, b in zip(got, want):
        _close(a, b)


def _close_out(got, want):
    """An output against the reference's: its dtype, and p within TOL;
    state with :func:`_close_state`'s one-ulp allowance when bf16."""
    assert got.dtype == _TDT[str(want.dtype)]
    _close_state(got, want)


@pytest.mark.parametrize("step", [1, 2, 1000])
@pytest.mark.parametrize("pdt,sdt", [("float32", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("float32", "bfloat16")])
def test_adahessian_step_plain_matches_pallas(step, pdt, sdt):
    """Row 7: v read only (its EMA of squared estimates, positive)."""
    (jp, tp), (jm, tm), (jv, tv), (jg, tg), _ = _inputs(
        384, 6, p_dtype=pdt, state_dtype=sdt)
    lr = np.float32(1e-3)
    want = jblk.adahessian_fused_block(jp, jm, jv, jg, lr, step, block=128,
                                       interpret=True, **ADAHESSIAN)
    got = blk.adahessian_fused_block(tp, tm, tv, tg, torch.tensor(lr),
                                     torch.tensor(float(step)), block=128,
                                     **ADAHESSIAN)
    assert len(got) == 2
    for a, b in zip(got, want):
        _close_out(a, b)


@pytest.mark.parametrize("flag", [0, 1])
@pytest.mark.parametrize("step", [1, 1000])
@pytest.mark.parametrize("n,block,pdt,sdt,h_kind", [
    (384, 128, "float32", "float32", "positive"),
    (512, 256, "bfloat16", "bfloat16", "mixed"),
    (256, 256, "float32", "bfloat16", "tail_pad"),
])
def test_adahessian_refresh_plain_matches_pallas(flag, step, n, block, pdt,
                                                 sdt, h_kind):
    """Row 5: when the flag is set, v absorbs (scale e)^2 before the step
    reads it; e is u ⊙ Hu-like (signed), the squares positive.  The
    reference's kernel forms (1-b2) es es, its oracle and the port (1-b2)
    (es es): bf16 v may land one ulp apart."""
    (jp, tp), (jm, tm), (jv, tv), (jg, tg), (je, te) = _inputs(
        n, 7, p_dtype=pdt, state_dtype=sdt, h_kind=h_kind)
    jv, tv = _pair(np.abs(_np(tv)), sdt)
    lr, scale = np.float32(2e-3), np.float32(1.0)
    want = jblk.adahessian_refresh_fused_block(
        jp, jm, jv, jg, je, lr, flag, scale, step, block=block,
        interpret=True, **ADAHESSIAN)
    got = blk.adahessian_refresh_fused_block(
        tp, tm, tv, tg, te, torch.tensor(lr), flag, torch.tensor(scale),
        torch.tensor(float(step)), block=block, **ADAHESSIAN)
    for a, b in zip(got, want):
        _close_out(a, b)
    if not flag:
        assert torch.equal(got[2], tv)
    if h_kind == "tail_pad":
        for t in got:
            assert not _np(t)[3 * n // 4:].any()


MOMENTUM = {
    "lion": (jblk.lion_fused_block, blk.lion_fused_block, LION),
    "signgd": (jblk.signgd_fused_block, blk.signgd_fused_block, SIGNGD),
    "sgd": (jblk.sgd_fused_block, blk.sgd_fused_block, dict(momentum=0.9)),
}


@pytest.mark.parametrize("rule", sorted(MOMENTUM))
@pytest.mark.parametrize("pdt,sdt,zeros", [("float32", "float32", False),
                                           ("float32", "float32", True),
                                           ("bfloat16", "bfloat16", False),
                                           ("float32", "bfloat16", True)])
def test_momentum_steps_plain_match_pallas(rule, pdt, sdt, zeros):
    """Rows 8-10 (Lion, SignGD, SGD): p' and m'.  ``zeros`` sets m and g
    to 0 on every 7th element, where Lion's and SignGD's sign argument is
    exactly 0 (sign 0: p only decays)."""
    (jp, tp), (jm, tm), _, (jg, tg), _ = _inputs(384, 8, p_dtype=pdt,
                                                 state_dtype=sdt)
    if zeros:
        m, g = _np(tm).copy(), _np(tg).copy()
        m[::7] = 0.0
        g[::7] = 0.0
        (jm, tm), (jg, tg) = _pair(m, sdt), _pair(g)
    jfn, tfn, hyp = MOMENTUM[rule]
    lr = np.float32(1e-3)
    want = jfn(jp, jm, jg, lr, block=128, interpret=True, **hyp)
    got = tfn(tp, tm, tg, torch.tensor(lr), block=128, **hyp)
    assert len(got) == 2
    for a, b in zip(got, want):
        _close_out(a, b)
    if zeros and rule != "sgd":
        decay = np.float32(1.0) - lr * np.float32(0.1)
        np.testing.assert_array_equal(
            _np(got[0])[::7],
            _np((tp.float() * torch.tensor(decay)).to(tp.dtype))[::7])


NAN_G, NAN_M = [3, 100, 257], [50, 200]


@pytest.mark.parametrize("rule", ["lion", "signgd"])
@pytest.mark.parametrize("sdt", ["float32", "bfloat16"])
def test_sign_steps_put_nan_where_the_reference_does(rule, sdt):
    """Rows 8-9 with NaN in g and in m: the sign is ``jnp.sign``'s, NaN at
    NaN, so p' and m' are NaN exactly where the reference's are; every
    other element is held as in :func:`test_momentum_steps_plain_match_pallas`
    (the reference's jitted Pallas body contracts p (1 - lr wd) - lr u into
    an FMA, so fp32 p' sits up to one ulp from the port's rounded products
    on ~28% of the elements)."""
    (jp, tp), (jm, tm), _, (jg, tg), _ = _inputs(384, 9, p_dtype="float32",
                                                 state_dtype=sdt)
    m, g = _np(tm).copy(), _np(tg).copy()
    g[NAN_G] = np.nan
    m[NAN_M] = np.nan
    (jm, tm), (jg, tg) = _pair(m, sdt), _pair(g)
    jfn, tfn, hyp = MOMENTUM[rule]
    lr = np.float32(1e-3)
    want = jfn(jp, jm, jg, lr, block=128, interpret=True, **hyp)
    got = tfn(tp, tm, tg, torch.tensor(lr), block=128, **hyp)
    for a, b in zip(got, want):
        a, b = _np(a), _jnp(b)
        nan = np.isnan(b)
        assert nan[NAN_G + NAN_M].all() and nan.sum() == 5
        np.testing.assert_array_equal(np.isnan(a), nan)
    keep = torch.from_numpy(~np.isnan(_jnp(want[0])))
    for a, b in zip(got, want):
        _close_out(a[keep], jnp.asarray(np.asarray(b)[keep.numpy()]))


@pytest.mark.parametrize("shape", [(64,), (8, 128), (3, 5, 7)])
def test_ops_harness_matches_reference(shape):
    """The per-tensor harness (pad each tensor to the block, cut back)
    against the reference's, for the three harness functions."""
    rng = np.random.default_rng(5)
    arrs = [rng.standard_normal(shape).astype(np.float32) * s
            for s in (1.0, 0.1, 0.01, 0.1)]
    arrs[2] = np.abs(arrs[2])
    jt = [{"w": jnp.asarray(a)} for a in arrs]
    tt = [{"w": torch.from_numpy(a.copy())} for a in arrs]
    kw = dict(lr=3e-4, block=128, **SOPHIA)
    jp, jm, jcf = jops.sophia_fused_apply(*jt, **kw)
    tp, tm, tcf = ops.sophia_fused_apply(*tt, **kw)
    np.testing.assert_allclose(_np(tp["w"]), _jnp(jp["w"]), **TOL)
    np.testing.assert_allclose(_np(tm["w"]), _jnp(jm["w"]), **TOL)
    assert float(tcf) == pytest.approx(float(jcf), abs=1e-7)
    jh = jops.hessian_ema_apply(jt[2], jt[3], beta2=0.99, scale=240.0,
                                block=128)
    th = ops.hessian_ema_apply(tt[2], tt[3], beta2=0.99, scale=240.0,
                               block=128)
    np.testing.assert_allclose(_np(th["w"]), _jnp(jh["w"]), **TOL)
    ja = jops.adamw_fused_apply(*jt, lr=1e-3, step=3, block=128, **ADAMW)
    ta = ops.adamw_fused_apply(*tt, lr=1e-3, step=3, block=128, **ADAMW)
    for a, b in zip(ta, ja):
        np.testing.assert_allclose(_np(a["w"]), _jnp(b["w"]), **TOL)


# ---------------------------------------------------------------------------
# the engine on the fused backend


def _params(rng):
    return {"w": rng.standard_normal((37, 5)).astype(np.float32),
            "b": np.zeros((11,), np.float32),
            "s": np.asarray(rng.standard_normal(), np.float32)}


def _grads(rng, scale=0.1):
    return {k: np.asarray(rng.standard_normal(np.shape(v)) * scale,
                          np.float32)
            for k, v in _params(rng).items()}


ENGINE_HYPERS = {
    "sophia_g": dict(beta1=0.96, beta2=0.99, gamma=0.05, eps=1e-12,
                     weight_decay=0.2, clip_threshold=1.0),
    "adamw": dict(beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.2),
    "adahessian": dict(ADAHESSIAN, weight_decay=0.2),
    "lion": dict(LION, weight_decay=0.2),
    "signgd": dict(SIGNGD, weight_decay=0.2),
    "sgd": dict(momentum=0.9),
}


@pytest.mark.parametrize("optimizer", ["sophia_g", "adamw"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_fused_engine_matches_pallas_engine(optimizer, state_dtype):
    """Six steps, Sophia-G refreshing every other step (three full
    intervals, B = 240), AdamW plain: the port's ``fused`` backend tracks
    the reference engine's ``pallas`` backend (interpret mode) to rtol
    1e-6 / atol 3e-6 (bf16 state: :func:`_close_state`), the clip
    fraction to 1e-7, counts exactly; then an out-of-band
    ``update_hessian`` on both."""
    rng = np.random.default_rng(0)
    p0 = _params(rng)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    hyp = ENGINE_HYPERS[optimizer]
    jeng = JEngine(optimizer, hypers=hyp, backend="pallas", block=128,
                   state_dtype=_JDT[state_dtype], interpret=True)
    teng = OptimizerEngine(optimizer, hypers=hyp, backend="fused", block=128,
                           state_dtype=_TDT[state_dtype])
    js, ts = jeng.init(jp), teng.init(tp)
    for t in range(6):
        g, e = _grads(rng), _grads(rng)
        lr = np.float32(1e-3 * (1.0 + 0.1 * t))
        jg = jeng.ravel_grads(jp, {k: jnp.asarray(v) for k, v in g.items()})
        tg = teng.ravel_grads(tp, {k: torch.from_numpy(v)
                                   for k, v in g.items()})
        if optimizer == "sophia_g" and t % 2 == 0:
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
        assert int(ts.hess_count) == int(js.hess_count)
        for k in p0:
            np.testing.assert_allclose(_np(tp[k]), _jnp(jp[k]), **TOL)
        for a, b in zip(ts.m + ts.h, js.m + js.h):
            assert a.dtype == _TDT[state_dtype]
            _close_state(a, b)
        np.testing.assert_allclose(float(ts.clip_fraction),
                                   float(js.clip_fraction), atol=1e-7)
    e = _grads(rng)
    je = jeng.ravel_grads(jp, {k: jnp.asarray(v) for k, v in e.items()})
    te = teng.ravel_grads(tp, {k: torch.from_numpy(v) for k, v in e.items()})
    js = jeng.update_hessian(js, je, scale=240.0, params=jp)
    ts = teng.update_hessian(ts, te, scale=240.0, params=tp)
    assert int(ts.hess_count) == int(js.hess_count)
    for a, b in zip(ts.h, js.h):
        _close_state(a, b)
    # the reference's state (AdamW: v in the h slot) carries over as it is
    moved = engine_state_from_jax(jax.tree.map(np.asarray, js),
                                  teng.layout(tp))
    assert int(moved.count) == 6
    for a, b in zip(moved.m + moved.h, js.m + js.h):
        assert a.dtype == _TDT[state_dtype]
        np.testing.assert_array_equal(_np(a), _jnp(b))


@pytest.mark.parametrize("optimizer", ["adahessian", "lion", "signgd",
                                       "sgd"])
@pytest.mark.parametrize("backend", ["fused", "reference"])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_baseline_engines_match_pallas_engine(optimizer, backend,
                                              state_dtype):
    """Six steps of AdaHessian (refreshing every other step: v absorbs
    the square of a signed estimate, scale 1, then one out-of-band
    ``update_hessian``), Lion, SignGD and SGD on the port's ``fused`` and
    ``reference`` backends against the reference engine's ``pallas``
    backend (interpret mode): parameters within TOL, state per
    :func:`_close_state`; Lion, SignGD and SGD keep no h and no clip
    fraction."""
    rng = np.random.default_rng(1)
    p0 = _params(rng)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    hyp = ENGINE_HYPERS[optimizer]
    jeng = JEngine(optimizer, hypers=hyp, backend="pallas", block=128,
                   state_dtype=_JDT[state_dtype], interpret=True)
    teng = OptimizerEngine(optimizer, hypers=hyp, backend=backend,
                           block=128, state_dtype=_TDT[state_dtype])
    js, ts = jeng.init(jp), teng.init(tp)
    assert len(ts.h) == len(js.h) == (1 if optimizer == "adahessian" else 0)

    def est(e, eng, tree, conv):
        return eng.ravel_grads(tree, {k: conv(v) for k, v in e.items()})

    for t in range(6):
        g, e = _grads(rng), _grads(rng, scale=0.3)
        lr = np.float32(1e-3 * (1.0 + 0.1 * t))
        jg = est(g, jeng, jp, jnp.asarray)
        tg = est(g, teng, tp, torch.from_numpy)
        if optimizer == "adahessian" and t % 2 == 0:
            jp, js = jeng.step_with_refresh(js, jp, jg, lr,
                                            est(e, jeng, jp, jnp.asarray),
                                            1.0, jnp.asarray(True))
            tp, ts = teng.step_with_refresh(
                ts, tp, tg, torch.tensor(lr),
                est(e, teng, tp, torch.from_numpy), 1.0, True)
        else:
            jp, js = jeng.step_shards(js, jp, jg, lr)
            tp, ts = teng.step_shards(ts, tp, tg, torch.tensor(lr))
        assert int(ts.count) == int(js.count) == t + 1
        assert int(ts.hess_count) == int(js.hess_count)
        for k in p0:
            np.testing.assert_allclose(_np(tp[k]), _jnp(jp[k]), **TOL)
        for a, b in zip(ts.m + ts.h, js.m + js.h):
            assert a.dtype == _TDT[state_dtype]
            _close_state(a, b)
        assert float(ts.clip_fraction) == 0.0
    e = _grads(rng, scale=0.3)
    js = jeng.update_hessian(js, est(e, jeng, jp, jnp.asarray), scale=2.0,
                             params=jp)
    ts = teng.update_hessian(ts, est(e, teng, tp, torch.from_numpy),
                             scale=2.0, params=tp)
    assert int(ts.hess_count) == int(js.hess_count)
    for a, b in zip(ts.h, js.h):
        _close_state(a, b)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_update_hessian_matches_reference_engine(state_dtype):
    """``update_hessian`` on the reference backends: the same h and
    hess_count; on the port, ``fused`` equals ``reference`` bit for bit."""
    rng = np.random.default_rng(7)
    p0 = _params(rng)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    hyp = ENGINE_HYPERS["sophia_g"]
    jeng = JEngine("sophia_g", hypers=hyp, block=128,
                   state_dtype=_JDT[state_dtype])
    out = {}
    for backend in ("reference", "fused"):
        teng = OptimizerEngine("sophia_g", hypers=hyp, backend=backend,
                               block=128, state_dtype=_TDT[state_dtype])
        js, ts = jeng.init(jp), teng.init(tp)
        for _ in range(2):
            e = _grads(np.random.default_rng(8))
            js = jeng.update_hessian(js, jeng.ravel_grads(
                jp, {k: jnp.asarray(v) for k, v in e.items()}), scale=240.0,
                params=jp)
            ts = teng.update_hessian(ts, teng.ravel_grads(
                tp, {k: torch.from_numpy(v) for k, v in e.items()}),
                scale=240.0, params=tp)
        assert int(ts.hess_count) == int(js.hess_count) == 2
        for a, b in zip(ts.h, js.h):
            np.testing.assert_allclose(_np(a), _jnp(b), **TOL)
        out[backend] = ts.h
    for a, b in zip(out["reference"], out["fused"]):
        assert torch.equal(a, b)
    # a family without out-of-band curvature keeps its state
    adamw = OptimizerEngine("adamw", hypers=ENGINE_HYPERS["adamw"],
                            backend="fused", block=128)
    st = adamw.init(tp)
    assert adamw.update_hessian(st, tuple(x.clone() for x in st.h),
                                params=tp) is st


def test_fused_backend_equals_reference_backend_in_training():
    """The 13-step Sophia-G run on GPT2_TINY (fp32, refresh every 4) with
    ``fused_kernel`` True and False: on the CPU the fused backend runs the
    same operations, so losses, parameters, m, h and the clip fractions
    are equal bit for bit."""
    cfg = ModelConfig(**dataclasses.asdict(
        dataclasses.replace(GPT2_TINY, dtype="float32")))
    src = make_source(DataConfig(seq_len=32, global_batch=8,
                                 vocab_size=cfg.vocab_size, seed=0))
    runs = {}
    for fused in (False, True):
        tc = TrainerConfig(peak_lr=5e-4, total_steps=64, warmup_steps=4,
                           hess_interval=4, hess_subbatch=4, seed=0,
                           fused_kernel=fused)
        state, hist = train_loop(cfg, tc, src, num_steps=13, device="cpu")
        runs[fused] = (state, hist)
    (s_ref, h_ref), (s_fused, h_fused) = runs[False], runs[True]
    assert int(s_fused.opt_state.hess_count) == 4
    assert h_fused == h_ref
    for a, b in zip(s_fused.params.parameters(), s_ref.params.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(s_fused.opt_state.m + s_fused.opt_state.h,
                    s_ref.opt_state.m + s_ref.opt_state.h):
        assert torch.equal(a, b)


def test_make_engine_maps_options():
    eng = make_engine(TrainerConfig(optimizer="adamw", fused_kernel=True,
                                    weight_decay=0.1))
    assert (eng.backend, eng.family) == ("fused", "adamw")
    assert eng.hypers == dict(beta1=0.9, beta2=0.95, eps=1e-8,
                              weight_decay=0.1)
    assert make_engine(TrainerConfig()).backend == "reference"
    assert not TrainerConfig().fused_kernel


@pytest.mark.parametrize("optimizer", ["sophia_h", "lion", "signgd",
                                       "adahessian", "sgd"])
def test_make_engine_takes_the_reference_table(optimizer):
    """The port's per-optimizer hypers are the reference trainer's, for
    every optimizer of its table."""
    from repro.train import make_engine as jax_make_engine
    from repro.train import TrainerConfig as JTrainerConfig
    over = dict(optimizer=optimizer, weight_decay=0.15, beta1=0.9,
                fused_kernel=True)
    eng = make_engine(TrainerConfig(**over))
    jeng = jax_make_engine(JTrainerConfig(**over))
    assert (eng.family, eng.hypers) == (jeng.family, jeng.hypers)
    assert eng.backend == "fused" and jeng.backend == "pallas"
    assert eng.hessian_aware == (optimizer in ("sophia_h", "adahessian"))


# ---------------------------------------------------------------------------
# argument checks (both routes)


def _flat(n, dtype=torch.float32):
    return torch.zeros((n,), dtype=dtype)


@pytest.mark.parametrize("case", ["not_1d", "strided", "n_not_multiple",
                                  "block_not_multiple_of_8", "fp16",
                                  "g_bf16", "mixed_state", "short_g"])
def test_wrappers_refuse_bad_arguments(case):
    p, m, h, g = (_flat(256) for _ in range(4))
    block = 128
    if case == "not_1d":
        p = p.reshape(2, 128)
    elif case == "strided":
        p = torch.zeros(512)[::2]
    elif case == "n_not_multiple":
        p, m, h, g = (_flat(200) for _ in range(4))
    elif case == "block_not_multiple_of_8":
        block = 12
    elif case == "fp16":
        p = _flat(256, torch.float16)
    elif case == "g_bf16":
        g = _flat(256, torch.bfloat16)
    elif case == "mixed_state":
        h = _flat(256, torch.bfloat16)
    elif case == "short_g":
        g = _flat(128)
    with pytest.raises(ValueError):
        blk.sophia_fused_block(p, m, h, g, 1e-3, block=block, **SOPHIA)
    with pytest.raises(ValueError):
        blk.adamw_fused_block(p, m, h, g, 1e-3, 1, block=block, **ADAMW)
    with pytest.raises(ValueError):
        blk.adahessian_refresh_fused_block(p, m, h, g, g, 1e-3, 1, 1.0, 1,
                                           block=block, **ADAHESSIAN)
    if case != "mixed_state":        # the others take no h
        with pytest.raises(ValueError):
            blk.lion_fused_block(p, m, g, 1e-3, block=block, **LION)
        with pytest.raises(ValueError):
            blk.sgd_fused_block(p, m, g, 1e-3, momentum=0.0, block=block)


def test_engine_kernel_bytes_at_gpt2_small():
    """The byte counts behind chip_smoke.py's bounds at GPT-2 small's
    shard (n = 124,518,400, 950 blocks): 24 / 12 / 32 / 28 bytes per
    element with fp32 state, 18 / 24 for the Sophia steps with bf16."""
    n, f32, bf16 = 124_518_400, torch.float32, torch.bfloat16
    counts = 4 * 950
    assert blk.engine_kernel_bytes("sophia_step", n, f32, f32) == \
        24 * n + counts
    assert blk.engine_kernel_bytes("hessian_ema", n, f32, f32) == 12 * n
    assert blk.engine_kernel_bytes("sophia_refresh", n, f32, f32) == \
        32 * n + counts
    assert blk.engine_kernel_bytes("adamw_step", n, f32, f32) == 28 * n
    assert blk.engine_kernel_bytes("sophia_step", n, f32, bf16) == \
        18 * n + counts
    assert blk.engine_kernel_bytes("sophia_refresh", n, f32, bf16) == \
        24 * n + counts


def test_engine_kernel_bytes_of_rows_5_and_7_to_10():
    """At GPT-2 small's shard with fp32 state: the AdaHessian refresh 32
    bytes per element (p m v g e; p' m' v'), its step 24 (p m v g; p'
    m'), Lion, SignGD and SGD 20 (p m g; p' m'); no counts."""
    n, f32, bf16 = 124_518_400, torch.float32, torch.bfloat16
    assert blk.engine_kernel_bytes("adahessian_refresh", n, f32, f32) == \
        32 * n
    assert blk.engine_kernel_bytes("adahessian_step", n, f32, f32) == 24 * n
    for name in ("lion_step", "signgd_step", "sgd_step"):
        assert blk.engine_kernel_bytes(name, n, f32, f32) == 20 * n
        assert blk.engine_kernel_bytes(name, n, f32, bf16) == 16 * n
