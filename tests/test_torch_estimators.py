"""The port's diagonal-Hessian estimators in tree form and the GNB sweep
(repro_torch.core.estimators) against the reference's tests/
test_estimators.py and against the JAX functions on the same numpy inputs.

The reference draws its noise with ``jax.random``; the tests rebuild those
draws outside the reference (for vocabulary chunk c of
``chunked_sampled_stats``, ``jax.random.gumbel(fold_in(key, c), (N, bv))``;
for Hutchinson, ``jax.random.normal`` of the leaf's key) and hand them to
the port, which then draws the same labels and probes.  Tolerances: the
sweep's lse and logits within 1e-6 and its labels identical; estimates
within 1e-6 of the reference's largest element (fp32, sums in another
order); the means of many draws within the reference tests' own bounds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (chunked_sampled_stats as j_stats,
                        empirical_fisher_estimator as j_ef,
                        exact_diag_hessian as j_exact,
                        gnb_estimator as j_gnb,
                        gnb_estimator_sq as j_gnb_sq,
                        gnb_ghat_flat as j_gnb_ghat_flat,
                        hutchinson_estimator as j_hutch,
                        sample_labels as j_sample_labels)
from repro.core.engine import build_layout as j_build_layout
from repro.core.engine import ravel_shards as j_ravel_shards
from repro.kernels.fused_ce import vocab_chunk
from repro_torch.core import (build_layout, chunked_sampled_stats,
                              empirical_fisher_estimator, exact_diag_hessian,
                              gnb_estimator, gnb_estimator_sq,
                              gnb_estimator_sq_flat, gnb_ghat_flat,
                              hutchinson_estimator, ravel_shards,
                              sample_labels)

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def reference_noise(key, n_rows, V, chunk=4096):
    """The Gumbel noise ``chunked_sampled_stats(logits, key)`` draws, as
    one (n_rows, V) array: chunk c from ``fold_in(key, c)``."""
    bv = vocab_chunk(V, chunk)
    return np.concatenate([
        np.asarray(jax.random.gumbel(jax.random.fold_in(key, c), (n_rows, bv),
                                     jnp.float32))
        for c in range(V // bv)], axis=1)


# ---------------------------------------------------------------------------
# the sweep


@pytest.mark.parametrize("V,masked", [(5, 0), (10000, 0), (10000, 37)])
def test_chunked_sampled_stats_matches_reference(V, masked):
    """One sweep over 6 x V logits (V = 10000: four chunks of 2500, the
    last ``masked`` columns at the -1e30 sentinel, as the unembedding pads
    them): ŷ identical to the reference's with its own draws passed in,
    lse and the drawn logit within 1e-6, and d(sum(lse - drawn logit)) /
    d logits, softmax - onehot(ŷ), within 1e-6 of ``jax.grad``'s."""
    rng = np.random.default_rng(V + masked)
    logits = (rng.normal(size=(2, 3, V)) * 3).astype(np.float32)
    if masked:
        logits[..., -masked:] = -1e30
    key = jax.random.PRNGKey(7)
    noise = reference_noise(key, 6, V).reshape(2, 3, V)
    jl = jnp.asarray(logits)
    lse_j, ll_j, y_j = j_stats(jl, key)
    x = _t(logits).requires_grad_()
    lse, ll, y = chunked_sampled_stats(x, noise=_t(noise))
    np.testing.assert_array_equal(y.numpy(), np.asarray(y_j))
    assert y.shape == (2, 3) and (y.numpy() < V - masked).all()
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(lse_j),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ll.detach().numpy(), np.asarray(ll_j),
                               rtol=1e-6, atol=1e-6)
    (g,) = torch.autograd.grad((lse - ll).sum(), x)
    g_j = jax.grad(lambda z: jnp.sum(
        jnp.subtract(*j_stats(z, key)[:2])))(jl)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), atol=1e-6)
    # the reference's noise= path is the same function
    _, _, y_n = j_stats(jl, noise=jnp.asarray(noise))
    np.testing.assert_array_equal(np.asarray(y_n), y.numpy())


def test_chunked_sampled_stats_draws_from_a_generator():
    """Drawn from a ``torch.Generator``: the same generator state gives the
    same labels, and ŷ is the Gumbel-argmax of the noise it drew (chunk
    by chunk, in order)."""
    rng = np.random.default_rng(0)
    logits = _t(rng.normal(size=(4, 9000)))
    a = chunked_sampled_stats(logits, torch.Generator().manual_seed(5))[2]
    b = chunked_sampled_stats(logits, torch.Generator().manual_seed(5))[2]
    c = chunked_sampled_stats(logits, torch.Generator().manual_seed(6))[2]
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="exactly one"):
        chunked_sampled_stats(logits)


def test_sample_labels_is_the_references_categorical():
    """Gumbel-max with ``jax.random.gumbel(key, shape)`` passed in gives
    ``jax.random.categorical(key, logits)`` exactly."""
    logits = jax.random.normal(jax.random.PRNGKey(1), (6, 50)) * 2
    for seed in range(5):
        key = jax.random.PRNGKey(seed)
        noise = jax.random.gumbel(key, logits.shape, jnp.float32)
        got = sample_labels(_t(logits), noise=_t(noise))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(j_sample_labels(logits,
                                                                 key)))
    y = sample_labels(_t(logits), torch.Generator().manual_seed(0))
    assert y.shape == (6,) and y.dtype == torch.int64


# ---------------------------------------------------------------------------
# the reference's tests/test_estimators.py


def test_exact_diag_hessian_analytic():
    def f_j(p):
        return 2.0 * p["x"][0] ** 2 + 0.5 * p["x"][1] ** 2 \
            + p["x"][0] * p["x"][1] + jnp.sum(p["y"] ** 4)

    def f_t(p):
        return 2.0 * p["x"][0] ** 2 + 0.5 * p["x"][1] ** 2 \
            + p["x"][0] * p["x"][1] + torch.sum(p["y"] ** 4)

    p = {"x": _t([1.0, 2.0]), "y": _t([1.0, -1.0])}
    d = exact_diag_hessian(f_t, p)
    np.testing.assert_allclose(d["x"].numpy(), [4.0, 1.0], rtol=1e-5)
    np.testing.assert_allclose(d["y"].numpy(), [12.0, 12.0], rtol=1e-5)
    dj = j_exact(f_j, {k: jnp.asarray(v.numpy()) for k, v in p.items()})
    for k in p:
        np.testing.assert_allclose(d[k].numpy(), np.asarray(dj[k]),
                                   rtol=1e-6)


def test_exact_diag_hessian_of_a_softmax_classifier_matches_reference():
    """A stacked leaf (the port's list of layers) and a plain one, a CE
    loss: every diagonal entry within 1e-6 of the reference's largest."""
    W, X, V, D, B = _softmax_model()
    y = np.arange(B) % V
    b = np.zeros((V,), np.float32) + 0.1

    def f_j(p):
        logits = X @ p["W"].reshape(V, D).T + p["b"]
        logp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(logp, jnp.asarray(y)[:, None], 1).mean()

    def f_t(p):
        logits = _t(X) @ torch.stack(p["W"]).reshape(V, D).T + p["b"]
        logp = torch.log_softmax(logits, -1)
        return -logp.gather(1, torch.from_numpy(y)[:, None]).mean()

    Ws = np.asarray(W).reshape(5, 1, D)
    d = exact_diag_hessian(f_t, {"W": [_t(w) for w in Ws], "b": _t(b)})
    dj = j_exact(f_j, {"W": jnp.asarray(Ws), "b": jnp.asarray(b)})
    assert _rel(torch.stack(d["W"]), dj["W"]) <= 1e-6
    assert _rel(d["b"], dj["b"]) <= 1e-6


def test_hutchinson_unbiased():
    """E[u * Hu] = diag(H) on a non-diagonal quadratic, over the
    reference's 4000 probes (passed in): each estimate within 1e-6 of the
    reference's, and the mean within the reference test's bound."""
    A = np.array([[3.0, 1.0, 0.0], [1.0, 2.0, 0.5], [0.0, 0.5, 0.25]],
                 np.float32)
    p = np.array([1.0, -2.0, 0.5], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), 4000)
    ests_j = np.asarray(jax.vmap(lambda k: j_hutch(
        lambda x: 0.5 * x @ jnp.asarray(A) @ x, jnp.asarray(p), k))(keys))
    probes = np.asarray(jax.vmap(lambda k: jax.random.normal(
        jax.random.split(k, 1)[0], (3,), jnp.float32))(keys))
    tA = _t(A)

    def loss(tensors):
        return 0.5 * tensors[0] @ tA @ tensors[0]

    ests = np.stack([
        hutchinson_estimator(loss, _t(p), _t(u)).numpy()
        for u in probes[:400]])
    np.testing.assert_allclose(ests, ests_j[:400], atol=1e-6 * np.abs(
        ests_j).max())
    full = torch.func.vmap(lambda u: hutchinson_estimator(loss, _t(p), u))(
        _t(probes)).numpy()
    np.testing.assert_allclose(full, ests_j, atol=1e-6 * np.abs(
        ests_j).max())
    np.testing.assert_allclose(full.mean(0), np.diag(A), rtol=0.15,
                               atol=0.05)


def _softmax_model():
    """Linear softmax classifier: f(W, x) = W x, CE loss."""
    V, D, B = 5, 3, 8
    rng = np.random.default_rng(0)
    W = rng.normal(size=(V, D)).astype(np.float32) * 0.5
    X = rng.normal(size=(B, D)).astype(np.float32)
    return W, X, V, D, B


def _exact_gn_diag(W, X):
    """diag of J^T S J for the linear softmax model, averaged over the
    batch: GN[v, d] = mean_b S_b[v, v] x_{b,d}^2, S = diag(p) - p p^T."""
    logits = X @ W.T
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bv,bd->vd", p * (1 - p), X ** 2) / X.shape[0]


def _gnb_pairs(W, X, keys, mask=None):
    """(port's estimates with the reference's draws passed in, the
    reference's), one per key, the linear softmax model; the reference
    compiled once over all keys."""
    B, V = X.shape[0], W.shape[0]
    tX = _t(X)
    tmask = None if mask is None else _t(mask)
    got = np.stack([gnb_estimator(lambda w: tX @ w.T, _t(W),
                                  noise=_t(reference_noise(k, B, V)),
                                  mask=tmask).numpy() for k in keys])
    jmask = None if mask is None else jnp.asarray(mask)
    want = jax.jit(jax.vmap(lambda k: j_gnb(
        lambda w: jnp.asarray(X) @ w.T, jnp.asarray(W), k, mask=jmask)))(
            jnp.stack(keys))
    return got, np.asarray(want)


def test_gnb_matches_exact_gauss_newton_diag():
    """Over 3000 draws from a generator the mean is the exact
    Gauss-Newton diagonal (the reference test's bound); on 50 of the
    reference's own draws each estimate is the reference's within 1e-6 of
    its largest element."""
    W, X, V, D, B = _softmax_model()
    got, want = _gnb_pairs(W, X, [jax.random.PRNGKey(s) for s in range(50)])
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-6
    gen = torch.Generator().manual_seed(1)
    tW, tX = _t(W), _t(X)
    mean = sum(gnb_estimator(lambda w: tX @ w.T, tW, gen)
               for _ in range(3000)) / 3000
    np.testing.assert_allclose(mean.numpy(), _exact_gn_diag(W, X),
                               rtol=0.2, atol=0.01)


def test_gnb_is_psd():
    W, X, *_ = _softmax_model()
    (got,), (want,) = _gnb_pairs(W, X, [jax.random.PRNGKey(2)])
    assert got.min() >= 0.0  # B * g*g is non-negative by construction
    assert _rel(got, want) <= 1e-6


def test_empirical_fisher_uses_true_labels():
    """E-F (the Fig. 8b ablation): no label resampling; the reference's
    estimate within 1e-6 of its largest element."""
    W, X, V, D, B = _softmax_model()

    def loss_t(w):
        logp = torch.log_softmax(_t(X) @ w.T, -1)
        return -logp[:, 0].mean()

    def loss_j(w):
        logp = jax.nn.log_softmax(jnp.asarray(X) @ w.T)
        return -logp[:, 0].mean()

    ef = empirical_fisher_estimator(loss_t, _t(W), B)
    assert ef.shape == W.shape and float(ef.min()) >= 0.0
    assert _rel(ef, j_ef(loss_j, jnp.asarray(W), B)) <= 1e-6


def test_gnb_mask_excludes_padding():
    """B counts the valid positions only, as in the reference."""
    W, X, V, D, B = _softmax_model()
    mask = np.array([1.0] * 4 + [0.0] * 4, np.float32)
    (got,), (want,) = _gnb_pairs(W, X, [jax.random.PRNGKey(3)], mask=mask)
    assert got.shape == W.shape and np.isfinite(got).all()
    assert _rel(got, want) <= 1e-6


# ---------------------------------------------------------------------------
# the GNB pieces on a tree, in tree and flat form


def test_gnb_pieces_on_a_tree_match_reference():
    """A two-leaf tree (W, b), 3 x 4 positions with a mask, V = 4100 (two
    vocabulary chunks of 2050): ``gnb_estimator_sq`` (ĝ², B),
    ``gnb_ghat_flat`` and ``gnb_estimator_sq_flat`` against the reference's
    on its own draws, the flat shards against the reference's ravel."""
    rng = np.random.default_rng(4)
    V, D = 4100, 6
    X = rng.normal(size=(3, 4, D)).astype(np.float32)
    params = {"W": rng.normal(size=(V, D)).astype(np.float32) * 0.3,
              "b": rng.normal(size=(V,)).astype(np.float32) * 0.1}
    mask = (rng.random((3, 4)) > 0.3).astype(np.float32)
    key = jax.random.PRNGKey(9)
    noise = reference_noise(key, 12, V).reshape(3, 4, V)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: _t(v) for k, v in params.items()}

    def lf_j(p):
        return jnp.asarray(X) @ p["W"].T + p["b"]

    def lf_t(p):
        return _t(X) @ p["W"].T + p["b"]

    sq_j, B_j = j_gnb_sq(lf_j, jp, key, mask=jnp.asarray(mask))
    sq, B = gnb_estimator_sq(lf_t, tp, noise=_t(noise), mask=_t(mask))
    assert float(B) == float(B_j) == mask.sum()
    for k in params:
        assert _rel(sq[k], sq_j[k]) <= 1e-6, k
    lay, jlay = build_layout(tp), j_build_layout(jp)
    g_sh, B2 = gnb_ghat_flat(lf_t, tp, None, lay, noise=_t(noise),
                             mask=_t(mask))
    g_sh_j, _ = j_gnb_ghat_flat(lf_j, jp, key, jlay, mask=jnp.asarray(mask))
    assert float(B2) == float(B_j) and len(g_sh) == len(g_sh_j)
    for a, b in zip(g_sh, g_sh_j):
        assert a.shape == b.shape and _rel(a, b) <= 1e-6
    s_sh, _ = gnb_estimator_sq_flat(lf_t, tp, None, lay, noise=_t(noise),
                                    mask=_t(mask))
    for a, b in zip(s_sh, ravel_shards(lay, sq, dtype=torch.float32)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(s_sh, j_ravel_shards(jlay, sq_j, dtype=jnp.float32)):
        assert _rel(a, b) <= 1e-6
    full = gnb_estimator(lf_t, tp, noise=_t(noise), mask=_t(mask))
    torch.testing.assert_close(full["W"], B * sq["W"], rtol=0, atol=0)
