"""Diagonal-Hessian estimators (paper Section 2.3): the counterpart of
``repro/core/estimators.py``.

* GNB (Algorithm 2): sample ŷ ~ softmax(logits) from the model's own
  logits, take the mini-batch gradient ĝ of the CE against ŷ, return
  B · ĝ ⊙ ĝ.  Two routes, as in the reference:
  - logits-free: ``gnb_ghat_flat_from_loss`` differentiates a model-level
    sampled-label loss whose labels are drawn inside the fused CE forward
    sweep (``models/loss.py:lm_loss_sampled``) and ravels ĝ into the
    engine's flat fp32 shards; B is the sweep's valid-position count;
  - from materialized logits: :func:`gnb_estimator` (a tree) and
    :func:`gnb_ghat_flat` (flat shards) take ``logits_fn(params)`` and one
    online vocab-chunk sweep (:func:`chunked_sampled_stats`) that draws ŷ
    by chunked Gumbel-argmax and accumulates the log-sum-exp in the same
    pass.  The reference draws its Gumbel noise with ``jax.random``, which
    PyTorch cannot reproduce: the port draws its own from a
    ``torch.Generator``, or takes the whole noise tensor (``noise=``), as
    the reference's ``chunked_sampled_stats(noise=...)`` does.
* Hutchinson (Algorithm 1): u ⊙ (H u) with u ~ N(0, I), unbiased for
  diag(H).  H u is taken forward-over-reverse, as the reference takes it
  (``jax.jvp`` of ``jax.grad``): ``torch.func.jvp`` of ``torch.func.grad``
  of a loss written as a function of the parameter tensors (the trainer
  builds it with ``torch.func.functional_call``).  The loss runs on the
  loss and attention twins (``fused_jvp``, ``flash_jvp``) or the chunked
  loss, whose backward and tangent rules are plain PyTorch.
* Empirical Fisher (the paper's Fig. 8b ablation): the squared gradient of
  the TRUE-label loss, B = the sub-batch's positions.
* :func:`exact_diag_hessian`: diag(H) from one HVP per basis vector (tests
  and tiny models only).

A function of ``params`` (``logits_fn``, ``loss_fn``) is differentiated
with respect to the tensors of ``params``: a tensor that requires a
gradient (a model's parameter, which the function may also reach through
its module) is used as it is, any other is replaced by a detached copy
that requires one.  Each ``*_flat`` form emits the estimate as the
engine's flat fp32 shards.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from ..kernels.fused_ce import (NEG_INF, online_argmax_step,
                                online_lse_step, vocab_chunk)
from .engine import ShardLayout, ravel_shards, unravel_shards
from .types import Tree, flat_tensors, tree_leaves, tree_map, tree_unflatten

_f32 = torch.float32
_DEFAULT_VCHUNK = 4096


def subsample_batch(batch: dict, n: int) -> dict:
    """First-n sub-batch for the estimator (paper Section 3.1)."""
    return {key: value[:n] for key, value in batch.items()}


def gnb_ghat_flat_from_loss(
    sampled_loss_fn: Callable[[], Tuple[torch.Tensor, torch.Tensor]],
    params: Tree,
    layout: ShardLayout,
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """GNB ``(ghat shards, B)``: ``sampled_loss_fn() -> (mean_nll,
    n_valid)`` runs the model on ``params`` (a parameter tree) and draws
    its own labels; ĝ is its gradient with respect to every tensor of
    ``params``, raveled to flat fp32 shards; B is ``n_valid`` in fp32."""
    loss, n_valid = sampled_loss_fn()
    tensors = flat_tensors(params)
    # a parameter the loss does not reach (patch_proj on a text-only
    # batch) gets zeros, as from jax.grad
    grads = torch.autograd.grad(loss, tensors, materialize_grads=True)
    g_sh = ravel_shards(layout, tree_unflatten(params, grads),
                        dtype=torch.float32)
    return g_sh, n_valid.to(torch.float32)


def _hvp(loss_fn: Callable[[Sequence[torch.Tensor]], torch.Tensor],
         tensors: List[torch.Tensor],
         u: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """H u, forward-over-reverse: the tangent along ``u`` of the gradient
    of ``loss_fn(tensors)``, one tensor per entry of ``tensors``; a tensor
    the loss does not depend on (a zero row of H) gets zeros."""
    primals = tuple(t.detach() for t in tensors)
    _, hv = torch.func.jvp(torch.func.grad(loss_fn), (primals,),
                           (tuple(u),))
    return list(hv)


class _Call(torch.nn.Module):
    """``fn(module)`` as a module's forward, for ``functional_call``."""

    def __init__(self, module: torch.nn.Module, fn: Callable):
        super().__init__()
        self.module = module
        self.fn = fn

    def forward(self):
        return self.fn(self.module)


def functional_loss(module: torch.nn.Module,
                    tensors: Sequence[torch.Tensor],
                    fn: Callable[[torch.nn.Module], torch.Tensor]
                    ) -> Callable[[Sequence[torch.Tensor]], torch.Tensor]:
    """``fn(module)`` as a function of the values of ``tensors``, which
    are parameters of ``module`` (each once): ``loss(values)`` runs ``fn``
    with ``torch.func.functional_call`` swapping them in, the form that
    ``torch.func.grad`` differentiates."""
    names = {id(p): f"module.{n}" for n, p in module.named_parameters()}
    keys = [names[id(t)] for t in tensors]
    call = _Call(module, fn)

    def loss(values: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.func.functional_call(call, dict(zip(keys, values)), ())
    return loss


def hutchinson_estimator(
        loss_fn: Callable[[Sequence[torch.Tensor]], torch.Tensor],
        params: Tree, u: Tree) -> Tree:
    """u ⊙ (H u) as a tree of fp32 tensors shaped like ``params``:
    ``loss_fn(tensors)`` is the scalar loss on the estimator sub-batch as a
    function of the tensors of ``params`` (in :func:`flat_tensors` order)
    and ``u`` a probe tree shaped like ``params`` in its dtypes (``u ~ N(0,
    I)`` makes the product an unbiased estimate of diag(H))."""
    tensors = flat_tensors(params)
    probe = flat_tensors(u)
    hv = _hvp(loss_fn, tensors, probe)
    return tree_unflatten(params, [(v * h).to(_f32)
                                   for v, h in zip(probe, hv)])


def hutchinson_estimator_flat(
        loss_fn: Callable[[Sequence[torch.Tensor]], torch.Tensor],
        params: Tree, u_sh: Sequence[torch.Tensor], layout: ShardLayout
) -> Tuple[torch.Tensor, ...]:
    """:func:`hutchinson_estimator` on flat shards: the probe shards
    ``u_sh`` are unraveled through the layout (cast to the leaf dtypes)
    for the HVP, and u ⊙ (H u) is raveled back to fp32 shards, so the tail
    pad, whose probe noise no parameter sees, stays zero."""
    values = unravel_shards(layout, tuple(u_sh))
    probe = [part for leaf, value in zip(tree_leaves(params), values)
             for part in (value.unbind(0) if isinstance(leaf, (list, tuple))
                          else (value,))]
    hv = _hvp(loss_fn, flat_tensors(params), probe)
    prod = [v.to(_f32) * h.to(_f32) for v, h in zip(probe, hv)]
    return ravel_shards(layout, tree_unflatten(params, prod), dtype=_f32)


def empirical_fisher_ghat_flat(loss_fn: Callable[[], torch.Tensor],
                               params: Tree, layout: ShardLayout
                               ) -> Tuple[torch.Tensor, ...]:
    """The gradient of the TRUE-label loss ``loss_fn()`` as flat fp32
    shards, before squaring."""
    grads = torch.autograd.grad(loss_fn(), flat_tensors(params),
                                materialize_grads=True)
    return ravel_shards(layout, tree_unflatten(params, grads), dtype=_f32)


def empirical_fisher_estimator_flat(loss_fn: Callable[[], torch.Tensor],
                                    params: Tree, layout: ShardLayout
                                    ) -> Tuple[torch.Tensor, ...]:
    """E-F's g ⊙ g as flat fp32 shards; the batch factor B is left to
    the engine's Hessian EMA (its ``scale``), as GNB's is."""
    return tuple(g * g for g in
                 empirical_fisher_ghat_flat(loss_fn, params, layout))


# ---------------------------------------------------------------------------
# GNB from materialized logits


def _requiring_grad(params: Tree) -> Tuple[Tree, List[torch.Tensor]]:
    """``params`` with every tensor one that requires a gradient (see the
    module docstring), and those tensors in :func:`flat_tensors` order."""
    tensors = [t if t.requires_grad else t.detach().requires_grad_()
               for t in flat_tensors(params)]
    return tree_unflatten(params, tensors), tensors


def _grad_tree(out: torch.Tensor, params: Tree,
               tensors: List[torch.Tensor]) -> Tree:
    """d out / d tensors as a tree shaped like ``params``; zeros where the
    output does not depend on a tensor."""
    grads = torch.autograd.grad(out, tensors, allow_unused=True)
    return tree_unflatten(params, [torch.zeros_like(t) if g is None else g
                                   for g, t in zip(grads, tensors)])


def gumbel(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """Gumbel(0, 1) fp32 noise from ``generator``: -log(-log u), u uniform
    in [tiny, 1), the form of ``jax.random.gumbel``."""
    u = torch.rand(shape, generator=generator, dtype=_f32,
                   device=device or generator.device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(_f32).tiny)))


def sample_labels(logits: torch.Tensor,
                  generator: Optional[torch.Generator] = None, *,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ŷ ~ Categorical(softmax(logits)) by Gumbel-max over the last axis:
    ``argmax(logits + noise)``, the noise drawn from ``generator`` or
    given whole (exactly one of the two)."""
    if (generator is None) == (noise is None):
        raise ValueError("exactly one of generator / noise")
    if noise is None:
        noise = gumbel(logits.shape, generator, logits.device)
    return torch.argmax(logits.detach().to(_f32) + noise, dim=-1)


class _SampledStats(torch.autograd.Function):
    """(lse, logit at ŷ, ŷ) of (N, V) fp32 logits, one online vocab-chunk
    sweep (:func:`chunked_sampled_stats`).  The sweep runs without a graph;
    the backward is the derivative of the reference's sweep, softmax for
    lse and the one-hot of ŷ for the drawn logit, formed in one pass (the
    reference recomputes each chunk under ``jax.checkpoint``); the draw
    takes no derivative."""

    @staticmethod
    def forward(ctx, flat, draw, bv):
        N, V = flat.shape
        dev = flat.device
        m = torch.full((N,), NEG_INF, dtype=_f32, device=dev)
        l = torch.zeros((N,), dtype=_f32, device=dev)
        best = (torch.full((N,), NEG_INF, dtype=_f32, device=dev),
                torch.zeros((N,), dtype=torch.int32, device=dev),
                torch.zeros((N,), dtype=_f32, device=dev))
        for c0 in range(0, V, bv):
            s = flat[:, c0:c0 + bv]
            # masked columns arrive as the -1e30 sentinel (the unembedding)
            m, l = online_lse_step(m, l, s, valid=s > NEG_INF / 2)
            best = online_argmax_step(best, s, s + draw(c0, bv), c0)
        lse = m + torch.log(torch.clamp_min(l, 1e-37))
        yhat = best[1]
        ctx.save_for_backward(flat, lse, yhat)
        ctx.mark_non_differentiable(yhat)
        return lse, best[2], yhat

    @staticmethod
    def backward(ctx, g_lse, g_ll, _):
        flat, lse, yhat = ctx.saved_tensors
        d = torch.exp(flat - lse[:, None]) * g_lse[:, None]
        d.scatter_add_(1, yhat.to(torch.int64)[:, None], g_ll[:, None])
        return d, None, None


def chunked_sampled_stats(logits: torch.Tensor,
                          generator: Optional[torch.Generator] = None, *,
                          chunk: int = _DEFAULT_VCHUNK,
                          noise: Optional[torch.Tensor] = None):
    """One online vocab-chunk sweep over ``logits`` (..., V): ``(lse,
    logit_at_yhat, yhat)``, each shaped like ``logits[..., 0]``.

    Draws ŷ ~ softmax(logits) by online chunked Gumbel-argmax (chunks of
    ``vocab_chunk(V, chunk)`` columns, the reference's widths, so that ties
    break the same way) and accumulates the log-sum-exp in the same pass.
    Differentiating ``lse - logit_at_yhat`` gives ``softmax - onehot(ŷ)``.
    The noise of each chunk is drawn from ``generator`` in chunk order; a
    full ``noise`` tensor shaped like ``logits`` replaces the draws, which
    makes ŷ ``argmax(logits + noise)`` exactly (exactly one of the two)."""
    if (generator is None) == (noise is None):
        raise ValueError("exactly one of generator / noise")
    V = logits.shape[-1]
    lead = logits.shape[:-1]
    flat = logits.to(_f32).reshape(-1, V)
    bv = vocab_chunk(V, chunk)
    if noise is not None:
        nflat = noise.to(_f32).reshape(-1, V)

        def draw(c0, width):
            return nflat[:, c0:c0 + width]
    else:
        def draw(c0, width):
            return gumbel((flat.shape[0], width), generator, flat.device)
    lse, ll, yhat = _SampledStats.apply(flat, draw, bv)
    return lse.reshape(lead), ll.reshape(lead), yhat.reshape(lead)


def _gnb_ghat(logits_fn: Callable[[Tree], torch.Tensor], params: Tree,
              generator: Optional[torch.Generator],
              mask: Optional[torch.Tensor], *, chunk: int = _DEFAULT_VCHUNK,
              noise: Optional[torch.Tensor] = None):
    """Shared GNB core: ``(ghat, B)``, the gradient tree of the mean CE
    against the model's sampled labels and the batch factor B (fp32; the
    valid positions when ``mask`` is given)."""
    tree, tensors = _requiring_grad(params)
    logits = logits_fn(tree)
    lse, ll, _ = chunked_sampled_stats(logits, generator, chunk=chunk,
                                       noise=noise)
    nll = lse - ll
    if mask is not None:
        count = torch.clamp_min(mask.to(_f32).sum(), 1)
        loss = (nll * mask).sum() / count
        batch_size = count.detach()
    else:
        loss = nll.mean()
        batch_size = torch.tensor(float(nll.numel()), dtype=_f32,
                                  device=nll.device)
    return _grad_tree(loss, params, tensors), batch_size


def gnb_estimator_sq(logits_fn, params: Tree, generator=None, *, mask=None,
                     noise=None):
    """GNB's pieces ``(ĝ ⊙ ĝ, B)`` with the batch factor unfolded (the
    engine folds B into its Hessian EMA)."""
    ghat, batch_size = _gnb_ghat(logits_fn, params, generator, mask,
                                 noise=noise)
    return tree_map(lambda g: g.to(_f32) * g.to(_f32), ghat), batch_size


def gnb_ghat_flat(logits_fn, params: Tree, generator, layout: ShardLayout, *,
                  mask=None, noise=None):
    """GNB's pieces before squaring as flat fp32 shards: ``(ĝ shards,
    B)``."""
    ghat, batch_size = _gnb_ghat(logits_fn, params, generator, mask,
                                 noise=noise)
    return ravel_shards(layout, ghat, dtype=_f32), batch_size


def gnb_estimator_sq_flat(logits_fn, params: Tree, generator,
                          layout: ShardLayout, *, mask=None, noise=None):
    """:func:`gnb_estimator_sq` as flat fp32 shards: ``(ĝ ⊙ ĝ shards, B)``,
    squared in flat space."""
    g_sh, batch_size = gnb_ghat_flat(logits_fn, params, generator, layout,
                                     mask=mask, noise=noise)
    return tuple(g * g for g in g_sh), batch_size


def gnb_estimator(logits_fn: Callable[[Tree], torch.Tensor], params: Tree,
                  generator: Optional[torch.Generator] = None, *,
                  mask: Optional[torch.Tensor] = None,
                  noise: Optional[torch.Tensor] = None) -> Tree:
    """Gauss-Newton-Bartlett estimator (Algorithm 2): ``B · ĝ ⊙ ĝ`` as a
    tree shaped like ``params``.

    ``logits_fn(params) -> logits`` (..., V) over the estimator sub-batch;
    every leading position is one CE example (for an LM every token).
    ``mask`` (shaped like ``logits[..., 0]``) marks the valid positions,
    which B counts.  ĝ is the gradient of the mean CE against labels drawn
    from the model's own softmax (noise from ``generator``, or ``noise``
    whole)."""
    sq, batch_size = gnb_estimator_sq(logits_fn, params, generator,
                                      mask=mask, noise=noise)
    return tree_map(lambda s: batch_size * s, sq)


# ---------------------------------------------------------------------------
# tree forms of E-F and the exact diagonal


def empirical_fisher_estimator(loss_fn: Callable[[Tree], torch.Tensor],
                               params: Tree, batch_size) -> Tree:
    """E-F (the Fig. 8b baseline): ``B · g ⊙ g`` in fp32 with g the
    gradient of the TRUE-label loss ``loss_fn(params)``; GNB without the
    label sampling."""
    tree, tensors = _requiring_grad(params)
    g = _grad_tree(loss_fn(tree), params, tensors)
    return tree_map(lambda g_: batch_size * g_.to(_f32) * g_.to(_f32), g)


def exact_diag_hessian(loss_fn: Callable[[Tree], torch.Tensor],
                       params: Tree) -> Tree:
    """Exact diag(H) of ``loss_fn(params)`` from one forward-over-reverse
    HVP per basis vector (``torch.func``): tests and tiny d only."""
    tensors = flat_tensors(params)
    sizes = [t.numel() for t in tensors]
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])

    def unravel(x):
        return tree_unflatten(params, [
            part.reshape(t.shape).to(t.dtype)
            for part, t in zip(torch.split(x, sizes), tensors)])

    grad = torch.func.grad(lambda x: loss_fn(unravel(x)))
    diag = torch.empty_like(flat)
    for i in range(flat.numel()):
        e = torch.zeros_like(flat)
        e[i] = 1.0
        diag[i] = torch.func.jvp(grad, (flat,), (e,))[1][i]
    return unravel(diag)
