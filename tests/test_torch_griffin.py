"""The Griffin family held against the JAX reference
(``repro.models.griffin``) on recurrentgemma-2b's smoke config (d 64, one
group and two tail layers, window 16), fp32 unless a case says bf16: the
causal conv, the RG-LRU and its scan (gradients and forward-mode rule
included), each block, the logits and recurrent state of ``forward``, the
loss and every gradient on three attention routes, the sampled loss,
remat, the parameter tree and the optimizer engine's layout, and
``check_supported``.  The reference's weights cross by
``params_from_jax``; inputs come from numpy seeds."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _griffin_models import (assert_close, batch, griffin_cfg, port_params,
                             ref_forward_state, ref_params)
from _rope_models import tcfg
from _rwkv_models import REF_BF16
from repro.configs import get_config as jax_get_config
from repro.core.engine import build_layout as jax_build_layout
from repro.core.engine import ravel_shards as jax_ravel_shards
from repro.kernels.fused_ce import seed_from_key
from repro.models import get_model as jax_get_model
from repro.models import griffin as jg
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import build_layout, ravel_shards
from repro_torch.core.types import flat_tensors, tree_leaves
from repro_torch.models import check_supported, get_model
from repro_torch.models import griffin as tg

torch.set_num_threads(1)


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module")
def model():
    """(reference config fp32, reference params, the port's params)."""
    cfg = griffin_cfg()
    params = ref_params(cfg)
    return cfg, params, port_params(cfg, params)


# ---------------------------------------------------------------------------
# conv, RG-LRU, scan


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(with_state, dtype):
    """The depthwise conv over 4 taps, from zeros or a carried state, and
    the state it hands on: fp32 within 1e-6 of the largest element, bf16
    bit for bit against the reference run op by op (each tap's product and
    sum rounded to bf16 in the same order)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 12)).astype(np.float32)
    kern = (0.3 * rng.standard_normal((4, 12))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(12)).astype(np.float32)
    st = (rng.standard_normal((2, 3, 12)).astype(np.float32)
          if with_state else None)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jy, jst = jg.causal_conv1d(jnp.asarray(x).astype(jdt), jnp.asarray(kern),
                               jnp.asarray(bias),
                               None if st is None else jnp.asarray(st))
    ty, tst = tg.causal_conv1d(torch.from_numpy(x).to(tdt),
                               torch.from_numpy(kern), torch.from_numpy(bias),
                               None if st is None else torch.from_numpy(st))
    assert ty.dtype == tst.dtype == tdt and tuple(tst.shape) == (2, 3, 12)
    want_y = np.asarray(jy.astype(jnp.float32))
    want_st = np.asarray(jst.astype(jnp.float32))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(_np(ty), want_y)
        np.testing.assert_array_equal(_np(tst), want_st)
    else:
        assert_close(ty, want_y, 1e-6, "conv")
        np.testing.assert_array_equal(_np(tst), want_st)


def _lru_inputs(B=2, S=37, W=24, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((B, S, W)).astype(np.float32)
    r, i = (rng.random((B, S, W)).astype(np.float32) for _ in range(2))
    lam = np.linspace(2.0, 5.0, W).astype(np.float32)
    h0 = rng.standard_normal((B, W)).astype(np.float32)
    return u, r, i, lam, h0


@pytest.mark.parametrize("with_h0", [False, True])
def test_rg_lru_matches_reference(with_h0):
    """h over 37 steps (6 doubling passes) and its last row, and the
    gradients of sum(h * w) with respect to u, both gates, lam and h0,
    within 1e-5 of each one's largest element: the scan's backward is the
    reverse scan."""
    u, r, i, lam, h0 = _lru_inputs()
    w = np.random.default_rng(9).standard_normal(u.shape).astype(np.float32)
    args = [u, r, i, lam] + ([h0] if with_h0 else [])

    def jfn(*a):
        h, last = jg.rg_lru(*a[:4], a[4] if with_h0 else None)
        return jnp.sum(h * w), (h, last)

    jgrads, (jh, jlast) = jax.jit(jax.grad(
        jfn, argnums=tuple(range(len(args))), has_aux=True))(
            *map(jnp.asarray, args))
    targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    th, tlast = tg.rg_lru(*targs[:4], targs[4] if with_h0 else None)
    assert_close(th, jh, what="h")
    assert_close(tlast, jlast, what="h_last")
    grads = torch.autograd.grad((th * torch.from_numpy(w)).sum(), targs)
    for name, g, want in zip("u r i lam h0".split(), grads, jgrads):
        assert_close(g, want, what=f"d{name}")


def test_linear_scan_gradients_and_forward_mode():
    """The scan's backward, its forward-mode rule and the backward's own
    derivatives (the HVP's forward over reverse) against finite
    differences in fp64 (``gradcheck``, ``gradgradcheck``), and its values
    against the recurrence stepped one token at a time."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.random((2, 9, 3))).requires_grad_(True)
    b = torch.from_numpy(rng.standard_normal((2, 9, 3))).requires_grad_(True)
    h, want = tg.linear_scan(a, b), []
    prev = torch.zeros(2, 3, dtype=torch.float64)
    for t in range(9):
        prev = a[:, t] * prev + b[:, t]
        want.append(prev)
    torch.testing.assert_close(h, torch.stack(want, 1), rtol=1e-12,
                               atol=1e-12)
    assert torch.autograd.gradcheck(tg.linear_scan, (a, b),
                                    check_forward_ad=True)
    assert torch.autograd.gradgradcheck(tg.linear_scan, (a, b))

    def loss(a_, b_):
        return (tg.linear_scan(a_, b_) ** 2).sum()

    ta = torch.from_numpy(rng.standard_normal((2, 9, 3)))
    tb = torch.from_numpy(rng.standard_normal((2, 9, 3)))
    _, hvp = torch.func.jvp(torch.func.grad(loss, argnums=(0, 1)),
                            (a.detach(), b.detach()), (ta, tb))
    eps = 1e-6
    plus = torch.func.grad(loss, argnums=(0, 1))(a.detach() + eps * ta,
                                                 b.detach() + eps * tb)
    minus = torch.func.grad(loss, argnums=(0, 1))(a.detach() - eps * ta,
                                                  b.detach() - eps * tb)
    for got, p, m in zip(hvp, plus, minus):
        torch.testing.assert_close(got, (p - m) / (2 * eps), rtol=1e-6,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# blocks and the model


def test_blocks_match_reference(model):
    """A recurrent block from zeros and from a carried state (its output
    and new state), and the local-attention block over 40 tokens (window
    16 binding), each within 1e-5 of the largest element."""
    cfg, params, tparams = model
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    W = cfg.rnn_width
    st = {"conv": rng.standard_normal((2, 3, W)).astype(np.float32),
          "h": rng.standard_normal((2, W)).astype(np.float32)}
    jp = jax.tree.map(lambda a: a[0], params["groups"])
    tp = tparams.groups[0]
    rec = jax.jit(lambda p, x, s: jg.rec_block_apply(p, x, cfg, s))
    for state in (None, st):
        jx, jst = rec(jp["rec1"], jnp.asarray(x),
                      None if state is None else jax.tree.map(jnp.asarray,
                                                              state))
        tx, tst = tg.rec_block_apply(
            tp["rec1"], torch.from_numpy(x), tcfg(cfg),
            None if state is None else {k: torch.from_numpy(v)
                                        for k, v in state.items()})
        assert_close(tx, jx, what="rec block")
        for k in ("conv", "h"):
            assert_close(tst[k], jst[k], what=f"rec block {k}")
    positions = jnp.broadcast_to(jnp.arange(40)[None], (2, 40))
    want = jax.jit(lambda p, x: jg.attn_block_apply(
        p, x, cfg, positions, attn_impl="full"))(jp["attn"], jnp.asarray(x))
    for impl in ("full", "flash", "chunked"):
        got = tg.attn_block_apply(tp["attn"], torch.from_numpy(x), tcfg(cfg),
                                  impl)
        assert_close(got, want, what=f"attn block {impl}")


def test_parameter_tree_is_the_reference_tree(model):
    """The same leaves in the same sorted order and shapes, bit for bit:
    ``embed/tok``, ``final_norm/scale``, ``groups/{attn, rec1, rec2}``
    stacked over the groups and ``tail`` over the tail layers; the engine's
    layout over it is the reference's, its shards bit for bit."""
    cfg, params, tparams = model
    tree = tparams.param_tree()
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = tree_leaves(tree)
    assert len(got) == len(want)
    for leaf, (path, ref) in zip(got, want):
        arr = torch.stack(leaf) if isinstance(leaf, list) else leaf
        assert tuple(arr.shape) == ref.shape, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(_np(arr), np.asarray(ref))
    n = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    assert sum(p.numel() for p in tparams.parameters()) == n
    # the config's count (the reference's formula) leaves out each
    # recurrent layer's w_a and w_x (2 W^2) and its two norms, counts its
    # conv kernel twice, and leaves out the attention layers' norms, the
    # padded vocabulary's rows and the final norm
    D, W, cw = cfg.d_model, cfg.rnn_width, cfg.conv_width
    n_attn = cfg.n_layers // 3
    n_rec = cfg.n_layers - n_attn
    assert n == (cfg.param_count() + n_rec * (2 * W * W - cw * W + 2 * D)
                 + n_attn * 2 * D + (cfg.padded_vocab - cfg.vocab_size) * D
                 + D)
    ref, lay = jax_build_layout(params, block=128), build_layout(tree,
                                                                 block=128)
    assert lay.leaf_shapes == ref.leaf_shapes and lay.manifest() == \
        ref.manifest()
    for a, b in zip(ravel_shards(lay, tree), jax_ravel_shards(ref, params)):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_params_from_jax_refuses_unknown_keys_and_shapes(model):
    """A top-level key, a leaf inside a group, or a leaf of another shape
    raises."""
    cfg, params, _ = model
    np_params = jax.tree.map(np.asarray, params)
    with pytest.raises(ValueError, match="top-level"):
        params_from_jax(dict(np_params, layers={}), tcfg(cfg))
    groups = dict(np_params["groups"], extra={"x": np.zeros((1, 3))})
    with pytest.raises(ValueError, match="leaves"):
        params_from_jax(dict(np_params, groups=groups), tcfg(cfg))
    tail = dict(np_params["tail"], lam=np.zeros((2, 7), np.float32))
    with pytest.raises(ValueError, match="leaves"):
        params_from_jax(dict(np_params, tail=tail), tcfg(cfg))


# bf16: the port's GeGLU takes ``F.gelu`` (fp32 inside, one rounding),
# the reference's ``jax.nn.gelu`` rounds each of its ops to bf16 (the two
# differ by an ulp in ~40% of the elements); through 5 layers its logits
# lie 2.2% of the largest from the reference's, about where the bf16 model
# lies from its own fp32 logits (2.5-2.8%) on the CPU
# (``tests/_griffin_spread.py --bf16``).  So each is held within 2^-5 of
# its largest element, and the port's bf16 logits as near the
# reference's fp32 ones as the reference's bf16 (RMS, within 1.5x; 0.94x
# measured).
BF16_RTOL = 2.0 ** -5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_and_state_match_reference(model, dtype):
    """``forward``'s logits and the recurrent state after the last token
    (every recurrent layer's conv tail and h), 2 rows of 40 tokens (the
    window 16 binding): fp32 within 1e-5 of the largest element; bf16
    within BF16_RTOL of it against the reference compiled with
    ``xla_allow_excess_precision`` off (REF_BF16; its state from its
    blocks run op by op), and as near the reference's fp32 logits as the
    reference's bf16."""
    cfg, params, tparams = model
    cfg = dataclasses.replace(cfg, dtype=dtype)
    jb, tb = batch(cfg)
    got, aux, state = tg.forward(tcfg(cfg), tparams, tb["tokens"])
    assert float(aux) == 0.0
    want = jax.jit(lambda p: jg.forward(cfg, p, jb["tokens"])[0],
                   compiler_options=REF_BF16 if dtype == "bfloat16"
                   else None)(params)
    wstate = ref_forward_state(cfg, params, jb["tokens"])
    rtol = BF16_RTOL if dtype == "bfloat16" else 1e-5
    assert_close(got, want, rtol, "logits")
    assert sorted(state) == sorted(wstate) == ["rec1", "rec2", "tail"]
    for kind in state:
        assert state[kind]["h"].dtype == torch.float32
        assert state[kind]["conv"].dtype == tcfg(cfg).compute_dtype
        for k in ("conv", "h"):
            assert_close(state[kind][k], wstate[kind][k], rtol,
                         f"{kind}/{k}")
    if dtype == "bfloat16":
        c32 = dataclasses.replace(cfg, dtype="float32")
        f32 = np.asarray(jg.forward(c32, params, jb["tokens"])[0])

        def rms(a):
            return float(np.sqrt(np.mean(np.square(a))))

        assert rms(_np(got) - f32) <= 1.5 * rms(np.asarray(want) - f32)


def _assert_grads(tparams, loss, grads, rtol=1e-5):
    """Every leaf's gradient within ``rtol`` of its largest element."""
    tree = tparams.param_tree()
    it = iter(torch.autograd.grad(loss, flat_tensors(tree)))
    for leaf, want in zip(tree_leaves(tree), jax.tree.leaves(grads)):
        got = (torch.stack([next(it) for _ in leaf])
               if isinstance(leaf, list) else next(it))
        assert np.abs(np.asarray(want)).max() > 0
        assert_close(got, want, rtol, "gradient")


@functools.lru_cache(maxsize=None)
def _ref_loss_and_grads(loss_impl):
    cfg = griffin_cfg()
    jb, _ = batch(cfg)
    return jax.jit(jax.value_and_grad(
        lambda q: jg.loss_fn(cfg, q, jb, loss_impl=loss_impl)[0]))(
            ref_params(cfg))


@pytest.mark.parametrize("loss_impl,attn_impl", [("fused", "flash"),
                                                 ("fused", "full"),
                                                 ("chunked", "chunked")])
def test_loss_and_grads_match_reference(model, loss_impl, attn_impl):
    """``loss_fn`` on the fused-kernel twin route (the final RMSNorm fused
    into the sweep) and the chunked route, over the flash kernels' plain
    versions, the materialized scores and the chunked online softmax: the
    loss, aux 0 and every gradient within 1e-5 of the largest (the
    reference's own route: its ``loss_fn`` takes no attention choice)."""
    cfg, params, tparams = model
    jb, tb = batch(cfg)
    jloss, jgrads = _ref_loss_and_grads(loss_impl)
    loss, met = tg.loss_fn(tcfg(cfg), tparams, tb, attn_impl=attn_impl,
                           loss_impl=loss_impl)
    assert_close(loss.item(), jloss, what="loss")
    assert met["aux"].item() == 0.0 and met["ce"].item() == loss.item()
    _assert_grads(tparams, loss, jgrads)


def test_sampled_loss_matches_reference(model):
    """GNB's sampled NLL on the reference's noise seed (the fused route):
    the count, the NLL and every gradient."""
    cfg, params, tparams = model
    jb, tb = batch(cfg, seed=2)
    key = jax.random.PRNGKey(11)
    (jnll, jn), jgrads = jax.jit(jax.value_and_grad(
        lambda q: jg.sampled_loss_fn(cfg, q, jb, key, loss_impl="fused"),
        has_aux=True))(params)
    nll, n = tg.sampled_loss_fn(tcfg(cfg), tparams, tb,
                                np.asarray(seed_from_key(key)),
                                attn_impl="flash")
    assert float(n) == float(jn)
    assert_close(nll.item(), jnll, what="nll")
    _assert_grads(tparams, nll, jgrads)


@pytest.mark.parametrize("remat", ["full", "dots", "scan2"])
def test_remat_is_bit_identical(remat):
    """Each remat policy ("full" checkpoints every group, as the reference
    does; "dots" and "scan2" run as "none", as in the reference): the loss
    and every gradient equal those without remat, bit for bit."""
    cfg = tcfg(griffin_cfg())
    params = get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0))
    _, tb = batch(cfg)
    out = []
    for policy in ("none", remat):
        loss, _ = get_model(cfg).loss_fn(cfg, params, tb, remat=policy,
                                         attn_impl="flash")
        out.append([loss] + list(torch.autograd.grad(
            loss, flat_tensors(params.param_tree()))))
    for a, b in zip(*out):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# check_supported and the registry


@pytest.mark.parametrize("smoke", [False, True])
def test_recurrentgemma_is_accepted(smoke):
    """recurrentgemma-2b, full and smoke, passes ``check_supported`` and is
    in ``ARCHS`` with the reference's configuration, field for field."""
    assert "recurrentgemma-2b" in ARCHS
    cfg = get_config("recurrentgemma-2b", smoke=smoke)
    check_supported(cfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_get_config("recurrentgemma-2b", smoke=smoke))


@pytest.mark.parametrize("field,value", [("local_window", None),
                                         ("local_window", 0),
                                         ("conv_width", 1),
                                         ("rnn_width", -1),
                                         ("learned_pos", True)])
def test_check_supported_refuses_what_the_reference_fails_on(field, value):
    """A Griffin config without a window (no decode ring), a conv of one
    tap (the reference's conv state keeps the whole segment), a negative
    recurrence width or learned positions (which its embed asserts on)
    raises ``ValueError``; ``norm_type`` is not read (every norm is
    RMSNorm); the encoder-decoder family, refused until it was ported,
    passes ``check_supported`` and ``get_model``, and a family the
    reference does not have is refused by its family in both."""
    cfg = get_config("recurrentgemma-2b", smoke=True)
    check_supported(dataclasses.replace(cfg, norm_type="other"))
    with pytest.raises(ValueError, match=field):
        check_supported(dataclasses.replace(cfg, **{field: value}))
    encdec = tcfg(jax_get_config("seamless-m4t-medium", smoke=True))
    check_supported(encdec)
    assert get_model(encdec).prefill_encoder_slot is not None
    other = dataclasses.replace(encdec, family="other")
    with pytest.raises(NotImplementedError, match="family"):
        check_supported(other)
    with pytest.raises(NotImplementedError, match="other"):
        get_model(other)
