"""The port's logits-free fused CE (repro_torch.kernels.fused_ce), its
plain versions on the CPU, held against the JAX reference: the hash noise,
the forward (loss, lse, sampled labels) against the Pallas kernels in
interpret mode with explicit small blocks, and the gradients against the
``kernels/ref.py`` closed-form oracles; CPU emulations of the bf16
tensor-core routes (the backward's operand split, the forward's per-tile
partials) against the plain versions and the reference.  Inputs come
from numpy with a seed, as in tests/test_fused_ce.py (VOCAB=200 padded to
256)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_ce import _ce_forward as jax_ce_forward
from repro.kernels.fused_ce import (
    _ce_forward_sampled as jax_ce_forward_sampled)
from repro.kernels.fused_ce import _mix32 as jax_mix32
from repro.kernels.fused_ce import fused_lm_loss as jax_fused_lm_loss
from repro.kernels.fused_ce import fused_lm_sample as jax_fused_lm_sample
from repro.kernels.fused_ce import hash_gumbel as jax_hash_gumbel
from repro.kernels.fused_ce import seed_from_key
from repro.kernels.ref import (_lm_logits_ref, lm_loss_grads_ref,
                               lm_loss_sampled_ref)
from repro.models.layers import layer_norm as jax_layer_norm
from repro.models.layers import rms_norm as jax_rms_norm
from repro_torch.kernels import fused_ce as ce

# One intra-op thread per process: the suite runs six pytest-xdist workers
# on the machine's cores, and torch's default pool in every worker
# oversubscribes them, slowing every test beside it (JAX's too) severalfold.
torch.set_num_threads(1)

TOL = 3e-6          # fp32, the reference tests' bound against the oracle
BF16_RTOL = 4e-3    # one bf16 ulp: both sides round an fp32 sum taken in
#                     another order
VOCAB, VP, D = 200, 256, 32
JAX_BLOCKS = dict(block_n=16, block_v=64)
REF_BLOCKS = dict(bn=16, bv=64, interpret=True)   # _ce_forward's own names


def _setup(dtype="float32", tied=True, *, B=4, T=12, seed=0,
           w_dtype="float32"):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, T, D)).astype(np.float32)
    w = (rng.standard_normal((VP, D) if tied else (D, VP)) * 0.2
         ).astype(np.float32)
    labels = rng.integers(0, VOCAB, (B, T)).astype(np.int32)
    mask = (rng.random((B, T)) > 0.3).astype(np.float32)
    scale = (rng.standard_normal(D) * 0.1).astype(np.float32)
    bias = (rng.standard_normal(D) * 0.1).astype(np.float32)
    jd, wd = getattr(jnp, dtype), getattr(jnp, w_dtype)
    jx = dict(h=jnp.asarray(h).astype(jd), w=jnp.asarray(w).astype(wd),
              labels=jnp.asarray(labels), mask=jnp.asarray(mask),
              scale=jnp.asarray(scale), bias=jnp.asarray(bias))
    tx = {k: _to_torch(v) for k, v in jx.items()}
    return jx, tx


def _to_torch(x):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _close(got, want, dtype, atol=TOL):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    rtol = BF16_RTOL if dtype == "bfloat16" else 0.0
    np.testing.assert_allclose(_np(got), want, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the counter-based noise


def test_hash_noise_matches_reference():
    """The hashed uint32 bits and the uniform behind the Gumbel noise are
    bit-identical to the reference's over seeds, rows and columns up to
    2**32 - 1.  The noise itself is ``-log(-log(u))``: XLA's CPU log and
    torch's differ by at most one ulp, so g agrees within 1e-6."""
    seeds = [(0, 0), (1, 2), (0xFFFFFFFF, 0x80000000), (123456789, 987654321)]
    rows = np.array([0, 1, 7, 47, 2**31 - 1, 2**31, 2**32 - 1, 123457],
                    np.uint32)
    cols = np.array([0, 1, 199, 255, 50303, 2**31 - 1, 2**31, 2**32 - 1],
                    np.uint32)
    rng = np.random.default_rng(3)
    big_r = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    big_c = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    for s in seeds:
        seed = np.array(s, np.uint32)
        for r, c in ((rows[:, None], cols[None, :]), (big_r, big_c)):
            x = jax_mix32(jax_mix32(jnp.asarray(r) ^ seed[0])
                          ^ (jnp.asarray(c) * np.uint32(0x9E3779B9)) ^ seed[1])
            u_ref = np.clip((np.asarray(x) >> 8).astype(np.float32)
                            * np.float32(1.0 / (1 << 24)), 1e-7, 1 - 1e-7)
            tr = torch.from_numpy(r.astype(np.int64))
            tc = torch.from_numpy(c.astype(np.int64))
            u = ce.hash_uniform(s, tr, tc).numpy()
            np.testing.assert_array_equal(u.view(np.uint32),
                                          u_ref.view(np.uint32))
            g_ref = np.asarray(jax_hash_gumbel(jnp.asarray(seed),
                                               jnp.asarray(r), jnp.asarray(c)))
            np.testing.assert_allclose(ce.hash_gumbel(s, tr, tc).numpy(),
                                       g_ref, rtol=0, atol=1e-6)


def test_hash_noise_is_gumbel_distributed():
    rows = torch.arange(512)[:, None]
    cols = torch.arange(256)[None, :]
    g = ce.hash_gumbel((17, 4), rows, cols).numpy()
    assert abs(g.mean() - 0.5772) < 0.02
    assert abs(g.var() - np.pi ** 2 / 6) < 0.05


# ---------------------------------------------------------------------------
# forward: loss, lse and the sampled labels


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_forward_matches_reference_kernel(tied, softcap):
    """fp32: the loss equals the Pallas kernel's (interpret mode) and the
    lse and label logit the oracle's, within 3e-6; the plain sweep runs in
    128-column chunks, so the online carries cross chunks."""
    jx, tx = _setup("float32", tied)
    loss_ref, _ = jax_fused_lm_loss(jx["h"], jx["w"], jx["labels"],
                                    jx["mask"], vocab_size=VOCAB,
                                    transpose_w=not tied, softcap=softcap,
                                    **JAX_BLOCKS)
    loss, n_valid = ce.fused_lm_loss(tx["h"], tx["w"], tx["labels"],
                                     tx["mask"], vocab_size=VOCAB,
                                     transpose_w=not tied, softcap=softcap)
    np.testing.assert_allclose(float(loss), float(loss_ref), atol=TOL)
    assert float(n_valid) == float(jx["mask"].sum())
    s, _, _ = _lm_logits_ref(jx["h"], jx["w"], vocab_size=VOCAB,
                             transpose_w=not tied, softcap=softcap)
    lse_ref = jax.nn.logsumexp(s, axis=-1)
    ll_ref = jnp.take_along_axis(s, jx["labels"].reshape(-1, 1), 1)[:, 0]
    lse, ll = ce.ce_forward_plain(
        tx["h"].reshape(-1, D), tx["w"], torch.zeros(2, D),
        tx["labels"].reshape(-1), vocab=VOCAB, transpose_w=not tied,
        softcap=softcap, chunk=128)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=TOL)
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_ref), atol=TOL)


@pytest.mark.parametrize("tied", [True, False])
def test_sampled_labels_identical_to_reference(tied):
    """ŷ from the plain sweep equals the Pallas kernel's draw and the
    oracle's full-grid argmax, for any vocab chunking; never a padded
    column."""
    jx, tx = _setup("float32", tied)
    key = jax.random.PRNGKey(9)
    seed = np.asarray(seed_from_key(key))
    y_kernel = np.asarray(jax_fused_lm_sample(
        jx["h"], jx["w"], key, vocab_size=VOCAB, transpose_w=not tied,
        block_n=16, block_v=128)).reshape(-1)
    for chunk in (128, 256):
        lse, _, y = ce.ce_forward_sampled_plain(
            tx["h"].reshape(-1, D), tx["w"], torch.zeros(2, D), seed,
            vocab=VOCAB, transpose_w=not tied, chunk=chunk)
        np.testing.assert_array_equal(y.numpy(), y_kernel)
    if tied:
        _, y_ref, _, _ = lm_loss_sampled_ref(jx["h"], jx["w"], key,
                                             vocab_size=VOCAB)
        np.testing.assert_array_equal(y.numpy(),
                                      np.asarray(y_ref).reshape(-1))
    assert int(y.max()) < VOCAB


def test_sampled_loss_and_grads_match_oracle():
    jx, tx = _setup("float32", True)
    key = jax.random.PRNGKey(9)
    loss_r, _, dh_r, dw_r = lm_loss_sampled_ref(jx["h"], jx["w"], key,
                                                jx["mask"], vocab_size=VOCAB)
    h = tx["h"].requires_grad_(True)
    w = tx["w"].requires_grad_(True)
    loss, _ = ce.fused_lm_loss_sampled(h, w, np.asarray(seed_from_key(key)),
                                       tx["mask"], vocab_size=VOCAB)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_r), atol=TOL)
    np.testing.assert_allclose(_np(h.grad), np.asarray(dh_r), atol=TOL)
    np.testing.assert_allclose(_np(w.grad), np.asarray(dw_r), atol=TOL)
    np.testing.assert_array_equal(_np(w.grad)[VOCAB:], 0.0)


# ---------------------------------------------------------------------------
# gradients against the closed-form oracle


def _jax_norm(norm, h, scale, bias):
    if norm == "ln":
        return jax_layer_norm(h, scale, bias, 1e-6)
    return jax_rms_norm(h, scale, 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", [None, "ln", "rms"])
@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("tied", [True, False])
def test_grads_match_oracle(tied, softcap, norm, dtype):
    """Loss, d(hidden), dW (and the norm's d(scale), d(bias)) with a mask
    and a padded vocab.  The oracle ``lm_loss_grads_ref`` runs on the
    reference's normed hidden; with a norm its d(normed hidden) is pulled
    back by ``jax.vjp`` of the reference's norm (fp32), and for bf16 —
    where the oracle rounds d(normed hidden) to bf16 before any pullback —
    d(hidden) is held against the reference's Pallas kernel with the norm
    fused, which pulls back the fp32 value as the port does.  The untied
    bf16 cell without a norm is the one the reference's own kernel fails
    (ROADMAP C); the port is held to the oracle there as everywhere."""
    jx, tx = _setup(dtype, tied)
    tw = not tied
    kw = dict(vocab_size=VOCAB, transpose_w=tw, softcap=softcap)
    normp = jnp.stack([jx["scale"], jx["bias"]])

    h = tx["h"].clone().requires_grad_(True)
    w = tx["w"].clone().requires_grad_(True)
    sc = tx["scale"].clone().requires_grad_(True)
    bi = tx["bias"].clone().requires_grad_(True)
    norm_kw = ({} if norm is None else
               dict(norm_kind=norm, norm_scale=sc,
                    norm_bias=bi if norm == "ln" else None))
    loss, _ = ce.fused_lm_loss(h, w, tx["labels"], tx["mask"], **kw,
                               **norm_kw)
    loss.backward()
    assert h.grad.dtype == h.dtype and w.grad.dtype == w.dtype

    hn = jx["h"] if norm is None else _jax_norm(norm, jx["h"], jx["scale"],
                                                jx["bias"])
    loss_r, dhn_r, dw_r = lm_loss_grads_ref(hn, jx["w"], jx["labels"],
                                            jx["mask"], **kw)
    np.testing.assert_allclose(loss.item(), float(loss_r), atol=TOL)
    _close(w.grad, dw_r, "float32")
    if norm is None:
        _close(h.grad, dhn_r, dtype)
        return
    if dtype == "float32":
        def f(x, p):
            from repro.kernels.fused_ce import apply_norm
            return apply_norm(x, p, norm, 1e-6).astype(jnp.float32)
        _, pull = jax.vjp(f, jx["h"], normp)
        dh_r, dnormp_r = pull(dhn_r.astype(jnp.float32))
    else:
        def g(x, s, b):
            return jax_fused_lm_loss(x, jx["w"], jx["labels"], jx["mask"],
                                     norm_kind=norm, norm_scale=s,
                                     norm_bias=b if norm == "ln" else None,
                                     norm_eps=1e-6, **kw, **JAX_BLOCKS)[0]
        dh_r, ds_r, db_r = jax.grad(g, argnums=(0, 1, 2))(
            jx["h"], jx["scale"], jx["bias"])
        dnormp_r = jnp.stack([ds_r, db_r])
    _close(h.grad, dh_r, dtype)
    # d(scale), d(bias): sums over every row of fp32 products of bf16
    # values; 2e-5 as the reference's norm-fusion test
    np.testing.assert_allclose(_np(sc.grad), np.asarray(dnormp_r[0]),
                               atol=2e-5)
    if norm == "ln":
        np.testing.assert_allclose(_np(bi.grad), np.asarray(dnormp_r[1]),
                                   atol=2e-5)


def test_bf16_weights_accumulate_dw_in_fp32():
    """bf16 W: dW sums in fp32 and rounds once, as the oracle does, so the
    two agree to about one bf16 ulp (the reference test's 2e-5)."""
    jx, tx = _setup("bfloat16", True, T=24, w_dtype="bfloat16")
    w = tx["w"].clone().requires_grad_(True)
    loss, _ = ce.fused_lm_loss(tx["h"], w, tx["labels"], tx["mask"],
                               vocab_size=VOCAB)
    loss.backward()
    _, _, dw_r = lm_loss_grads_ref(jx["h"], jx["w"], jx["labels"],
                                   jx["mask"], vocab_size=VOCAB)
    assert w.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(w.grad),
                               np.asarray(dw_r.astype(jnp.float32)),
                               atol=2e-5)


@pytest.mark.parametrize("tied", [True, False])
def test_padded_vocab_columns_get_exactly_zero_grad(tied):
    _, tx = _setup("float32", tied)
    w = tx["w"].clone().requires_grad_(True)
    loss, _ = ce.fused_lm_loss(tx["h"], w, tx["labels"], tx["mask"],
                               vocab_size=VOCAB, transpose_w=not tied)
    loss.backward()
    dw = _np(w.grad)
    pad, live = ((dw[:, VOCAB:], dw[:, :VOCAB]) if not tied
                 else (dw[VOCAB:], dw[:VOCAB]))
    np.testing.assert_array_equal(pad, 0.0)
    assert np.abs(live).max() > 0.0


def test_backward_pieces_agree_with_the_whole():
    """ce_backward_dh / ce_backward_dw on the CPU are the two halves of the
    one plain backward sweep."""
    _, tx = _setup("float32", True)
    h2 = tx["h"].reshape(-1, D)
    lab = tx["labels"].reshape(-1)
    rs, _ = ce.rowscale(h2.shape[0], tx["mask"])
    normp = torch.stack([1.0 + tx["scale"], tx["bias"]])
    opts = dict(vocab=VOCAB, norm="ln", eps=1e-6)
    lse, _ = ce.ce_forward(h2, tx["w"], normp, lab, **opts)
    dh, dw = ce.ce_backward(h2, tx["w"], normp, lab, rs, lse, **opts)
    assert dh.dtype == torch.float32     # d(normed hidden) with a norm
    torch.testing.assert_close(
        ce.ce_backward_dh(h2, tx["w"], normp, lab, rs, lse, **opts), dh,
        rtol=0, atol=0)
    torch.testing.assert_close(
        ce.ce_backward_dw(h2, tx["w"], normp, lab, rs, lse, **opts), dw,
        rtol=0, atol=0)


# ---------------------------------------------------------------------------
# what the CUDA route accepts


@pytest.mark.parametrize("norm", ["ln", "rms"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_given_row_stats_normalize_as_computed_ones(norm, dtype):
    """``apply_norm`` fed ``row_stats`` (on the CPU the plain statistics;
    on the card the kernels', which chip_smoke.py feeds the plain backward)
    gives its own output bit for bit, and the plain backward fed them its
    own dh and dW: the statistics are the only thing ``stats`` replaces."""
    rng = np.random.default_rng(3)
    h = torch.from_numpy((2.0 * rng.standard_normal((6, 256)) + 0.5)
                         .astype(np.float32)).to(dtype)
    normp = torch.from_numpy((0.1 * rng.standard_normal((2, 256)))
                             .astype(np.float32))
    normp[0] += 1.0 if norm == "ln" else 0.0
    stats = ce.row_stats(h, norm=norm, eps=1e-6)
    assert stats.shape == (6, 2) and stats.dtype == torch.float32
    assert torch.equal(ce.apply_norm(h, normp, norm, 1e-6, stats),
                       ce.apply_norm(h, normp, norm, 1e-6))
    w = torch.from_numpy((0.05 * rng.standard_normal((384, 256)))
                         .astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 300, 6).astype(np.int32))
    kw = dict(vocab=300, norm=norm, eps=1e-6)
    lse, _ = ce.ce_forward_plain(h, w, normp, labels, **kw)
    rs = torch.full((6,), 1 / 6)
    for a, b in zip(ce.ce_backward_plain(h, w, normp, labels, rs, lse, **kw,
                                         stats=stats),
                    ce.ce_backward_plain(h, w, normp, labels, rs, lse, **kw)):
        assert torch.equal(a, b)


def test_kernel_argument_checks():
    h = torch.zeros(4, 96)
    with pytest.raises(ValueError, match="multiple of 128"):
        ce.check_kernel_args(h, torch.zeros(256, 96), torch.zeros(2, 96),
                             transpose_w=False, norm=None)
    h = torch.zeros(4, 128)
    with pytest.raises(ValueError, match="padded vocab"):
        ce.check_kernel_args(h, torch.zeros(200, 128), torch.zeros(2, 128),
                             transpose_w=False, norm=None)
    with pytest.raises(ValueError, match="does not match"):
        ce.check_kernel_args(h, torch.zeros(256, 128), torch.zeros(2, 128),
                             transpose_w=True, norm=None)
    with pytest.raises(ValueError, match="normp"):
        ce.check_kernel_args(h, torch.zeros(256, 128), torch.zeros(2, 64),
                             transpose_w=False, norm="ln")
    ce.check_kernel_args(h, torch.zeros(256, 128), torch.zeros(2, 128),
                         transpose_w=False, norm="ln")
    w = torch.zeros(256 * 128 + 1, dtype=torch.bfloat16)[1:].view(256, 128)
    with pytest.raises(ValueError, match="16-byte"):
        ce.check_kernel_args(h.to(torch.bfloat16), w, torch.zeros(2, 128),
                             transpose_w=False, norm=None)


def test_no_route_for_other_devices():
    h = torch.zeros(4, 128, device="meta")
    with pytest.raises(ValueError, match="no route"):
        ce.ce_forward(h, torch.zeros(256, 128, device="meta"),
                      torch.zeros(2, 128, device="meta"),
                      torch.zeros(4, dtype=torch.int32, device="meta"),
                      vocab=200)


@pytest.mark.parametrize("N,Vp", [(8192, 50304), (4096, 50304), (7, 256),
                                  (2048, 1024)])
def test_forward_vocab_splits_cover_every_tile(N, Vp):
    splits, per = ce.forward_splits(N, Vp)
    n_tiles = Vp // 128
    assert splits * per >= n_tiles > (splits - 1) * per
    assert splits * -(-N // 64) <= 2 * 528 or splits == 1


# ---------------------------------------------------------------------------
# the tensor-core backward's operand split, emulated in PyTorch


def _split(x):
    """fp32 -> its two bf16 pieces (as fp32): hi = bf16(x), lo = bf16(x -
    hi), the pieces the dh and dW kernels feed the tensor cores."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _split_backward(h, w, normp, labels, rs, lse, opts, pieces):
    """(dh, dW, S_dh, S_dW): the backward as the bf16 tensor-core route
    sums it, emulated (bf16 values in fp32 tensors: every product exact,
    every sum in fp32): d and an fp32 W in ``pieces`` bf16 pieces each,
    dh = d_hi.W_hi + d_hi.W_lo + d_lo.W_hi and dW = d_hi^T.h_n +
    d_lo^T.h_n with two (one piece: the hi products alone); and each
    element's sum of absolute terms."""
    tw = opts["transpose_w"]
    hn = ce.apply_norm(h, normp, opts["norm"], opts["eps"]).float()
    w32 = w.float()
    w_hi, w_lo = _split(w32)
    Vp = w.shape[1] if tw else w.shape[0]
    dh = torch.zeros(hn.shape)
    dw = torch.zeros(w.shape)
    s_dh, s_dw = torch.zeros(hn.shape), torch.zeros(w.shape)
    for c0 in range(0, Vp, 256):
        s, _, cols, dcap = ce._chunk_logits(hn, w, h.dtype, c0, 256, tw,
                                            opts["softcap"], opts["vocab"])
        onehot = (cols[None] == labels.long()[:, None]).float()
        d = (torch.exp(s - lse[:, None]) - onehot) * rs[:, None]
        d = d if dcap is None else d * dcap
        d_hi, d_lo = _split(d)

        def cols_of(x):
            return x[:, c0:c0 + 256].T if tw else x[c0:c0 + 256]

        prod = d_hi @ cols_of(w_hi)
        if pieces == 2:
            prod = prod + d_hi @ cols_of(w_lo) + d_lo @ cols_of(w_hi)
        dh += prod
        s_dh += d.abs() @ cols_of(w32).abs()
        g = d_hi.T @ hn + (d_lo.T @ hn if pieces == 2 else 0.0)
        g_abs = d.abs().T @ hn.abs()
        if tw:
            dw[:, c0:c0 + 256], s_dw[:, c0:c0 + 256] = g.T, g_abs.T
        else:
            dw[c0:c0 + 256], s_dw[c0:c0 + 256] = g, g_abs
    return dh, dw, s_dh, s_dw


def _contract(got, want, sums):
    """``chip_smoke.check_bf16_grad``'s measures for an fp32 output:
    elements beyond 2^-7 of their absolute sum S (plus 2^-24 max S), and
    the share beyond 2^-16 S."""
    diff = (got - want).abs()
    base = 2 ** -24 * sums.max()
    return (int((diff > 2 ** -7 * sums + base).sum()),
            float((diff > 2 ** -16 * sums + base).float().mean()))


@pytest.mark.parametrize("tied", [True, False])
def test_tensor_core_operand_split_meets_the_bf16_contract(tied):
    """The numerical design of the dh and dW kernels for bf16 h
    (``csrc/fused_ce.cu``, the tensor-core route), emulated at N=300,
    D=128, Vp=1024 (V=1000), bf16 h, fp32 W, ln: two bf16 pieces of d and
    of W, summed in fp32, hold ``chip_smoke.check_bf16_grad``'s contract
    against the plain backward (no element beyond 2^-7 of its sum of
    absolute terms S, at most 0.1% beyond 2^-16 S; measured: none); one
    piece (bf16 d and W alone) breaks it (89-98% of the elements beyond
    2^-16 S), so the second piece is needed."""
    rng = np.random.default_rng(21)
    N, Dm, V, Vp = 300, 128, 1000, 1024
    h = torch.from_numpy((rng.standard_normal((N, Dm)) * 2 + 0.5)
                         .astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((Vp, Dm) if tied
                                              else (Dm, Vp)) * 0.02)
                         .astype(np.float32))
    normp = torch.from_numpy(np.stack([
        1.0 + 0.1 * rng.standard_normal(Dm),
        0.1 * rng.standard_normal(Dm)]).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, V, N).astype(np.int32))
    rs = torch.full((N,), 1.0 / N)
    opts = dict(vocab=V, transpose_w=not tied, softcap=None, norm="ln",
                eps=1e-6)
    lse, _ = ce.ce_forward_plain(h, w, normp, labels, **opts)
    dh_p, dw_p = ce.ce_backward_plain(h, w, normp, labels, rs, lse, **opts)
    dh, dw, s_dh, s_dw = _split_backward(h, w, normp, labels, rs, lse, opts,
                                         pieces=2)
    for got, want, sums in ((dh, dh_p, s_dh), (dw, dw_p, s_dw)):
        n_hard, share = _contract(got, want.float(), sums)
        assert n_hard == 0 and share <= 1e-3, (n_hard, share)
    dh1, dw1, _, _ = _split_backward(h, w, normp, labels, rs, lse, opts,
                                     pieces=1)
    assert max(_contract(dh1, dh_p.float(), s_dh)[1],
               _contract(dw1, dw_p.float(), s_dw)[1]) > 1e-3


# ---------------------------------------------------------------------------
# the tensor-core forward (bf16 h), emulated in PyTorch


def _tc_forward_emulated(h2, w, normp, labels, seed, *, vocab, transpose_w,
                         softcap, norm, eps=1e-6):
    """(lse, label or drawn logit, ŷ) as the bf16-h forward sums them
    (``csrc/fused_ce.cu``: ``ce_mma_kernel``'s fold epilogue, then
    ``ce_combine_kernel``), emulated: h_n in bf16 and W's hi plane
    bf16(W) (bf16 values in fp32 tensors: every product exact, every sum
    in fp32); each 128-column tile folded into one partial per row (m, l
    over its valid columns, and the label logit or the tile's first argmax
    of s + g with its raw logit), the partials merged in column order with
    strict > across tiles."""
    hn = ce.apply_norm(h2, normp, norm, eps).float()
    hi = w.to(torch.bfloat16).float()
    Vp = w.shape[1] if transpose_w else w.shape[0]
    N = hn.shape[0]
    rows = torch.arange(N)[:, None]
    M = torch.full((N,), ce.NEG_INF)
    L, LL = torch.zeros(N), torch.zeros(N)
    Z, I = torch.full((N,), ce.NEG_INF), torch.zeros(N, dtype=torch.int32)
    for c0 in range(0, Vp, 128):
        raw = hn @ (hi[:, c0:c0 + 128] if transpose_w
                    else hi[c0:c0 + 128].T)
        if softcap is not None:
            raw = softcap * torch.tanh(raw / softcap)
        cols = torch.arange(c0, c0 + 128)
        valid = (cols < vocab)[None, :]
        s = torch.where(valid, raw, ce.NEG_INF)
        m = s.amax(-1)
        l = torch.where(valid, torch.exp(s - m[:, None]), 0.0).sum(-1)
        mn = torch.maximum(M, m)
        L = L * torch.exp(M - mn) + l * torch.exp(m - mn)
        M = mn
        if seed is None:
            hit = cols[None, :] == labels.long()[:, None]
            LL = LL + torch.where(hit, s, 0.0).sum(-1)
        else:
            z = torch.where(valid, s + ce.hash_gumbel(seed, rows, cols[None]),
                            ce.NEG_INF)
            Z, I, LL = ce.online_argmax_step((Z, I, LL), s, z, c0)
    return M + torch.log(torch.clamp_min(L, 1e-37)), LL, I


SEED9 = np.asarray(seed_from_key(jax.random.PRNGKey(9)))


@pytest.mark.parametrize("tied,softcap,norm,vocab,w_dtype", [
    (True, None, None, VOCAB, "float32"),
    (False, 30.0, None, VOCAB, "float32"),
    (True, 30.0, "ln", VOCAB, "float32"),
    (False, None, "rms", 100, "float32"),    # a tile wholly past the vocab
    (True, None, "ln", 100, "bfloat16"),
])
def test_tensor_core_forward_emulation_matches_plain(tied, softcap, norm,
                                                     vocab, w_dtype):
    """The bf16-h forward's numerical design against ``ce_forward_plain``
    and ``ce_forward_sampled_plain`` at bf16 h with a mask-free padded
    vocabulary (VP=256): lse and the label or drawn logit within 3e-6
    (fp32 sums in another order), the drawn labels identical and never a
    padded column."""
    _, tx = _setup("bfloat16", tied, w_dtype=w_dtype)
    h2, lab = tx["h"].reshape(-1, D), tx["labels"].reshape(-1) % vocab
    normp = torch.stack([1.0 + tx["scale"], tx["bias"]])
    opts = dict(vocab=vocab, transpose_w=not tied, softcap=softcap,
                norm=norm)
    lse, ll, _ = _tc_forward_emulated(h2, tx["w"], normp, lab, None, **opts)
    lse_p, ll_p = ce.ce_forward_plain(h2, tx["w"], normp, lab, **opts)
    np.testing.assert_allclose(lse.numpy(), lse_p.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(ll.numpy(), ll_p.numpy(), atol=TOL, rtol=0)
    lse, ll, y = _tc_forward_emulated(h2, tx["w"], normp, None, SEED9,
                                      **opts)
    lse_p, ll_p, y_p = ce.ce_forward_sampled_plain(h2, tx["w"], normp, SEED9,
                                                   **opts)
    np.testing.assert_array_equal(y.numpy(), y_p.numpy())
    assert int(y.max()) < vocab
    np.testing.assert_allclose(lse.numpy(), lse_p.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(ll.numpy(), ll_p.numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_tensor_core_forward_emulation_matches_reference(tied, softcap):
    """The same emulation against the reference's ``_ce_forward`` and
    ``_ce_forward_sampled`` (Pallas, interpret mode, blocks of 16 rows and
    64 columns) on the same numpy inputs, bf16 h and fp32 W (cast to bf16
    by both, as the reference's unembed casts it), VOCAB=200 padded to
    256: lse and the label or drawn logit within 3e-6, and the drawn
    labels bit-identical to the reference's."""
    jx, tx = _setup("bfloat16", tied)
    kw = dict(vocab=VOCAB, transpose_w=not tied, softcap=softcap, norm=None,
              eps=1e-6)
    jh, jlab = jx["h"].reshape(-1, D), jx["labels"].reshape(-1)
    h2, lab = tx["h"].reshape(-1, D), tx["labels"].reshape(-1)
    normp = torch.zeros(2, D)
    lse_r, ll_r = jax_ce_forward(jh, jx["w"], None, jlab, **kw,
                                 **REF_BLOCKS)
    lse, ll, _ = _tc_forward_emulated(h2, tx["w"], normp, lab, None, **kw)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_r), atol=TOL)
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_r), atol=TOL)
    lse_r, ll_r, y_r = jax_ce_forward_sampled(jh, jx["w"], None,
                                              jnp.asarray(SEED9), **kw,
                                              **REF_BLOCKS)
    lse, ll, y = _tc_forward_emulated(h2, tx["w"], normp, None, SEED9, **kw)
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_r))
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_r), atol=TOL)
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_r), atol=TOL)
