"""The LM loss from final hidden states: the counterpart of
``repro/models/loss.py``, every route of the reference.

  fused     the logits-free kernels of ``kernels/fused_ce.py``: the hidden
            states, the unembedding in its stored layout and (with
            ``pre_norm``) the final norm's parameters go to the CE sweep,
            the norm is applied inside it and the [B*T, V] logits never
            exist; the sampled-label GNB draw happens in the same sweep.
            The tied weight is the embedding table itself, so autograd sums
            its gradient from the CE with the one from the embedding
            lookup.  The default of :func:`lm_loss` here (the reference's
            module default is "chunked"; its trainer names the route either
            way, as the port's does);
  fused_jvp the twin of the Hutchinson HVP: the final norm in PyTorch, then
            the CE forward kernel's value with a backward and a tangent
            rule that ``torch.func.jvp`` carries through;
  chunked   the plain vocab sweep (2048-column chunks) on every device,
            logits-free in the forward, its backward and tangent
            recomputing each chunk (``fused_ce.chunked_lm_loss``): the
            trainer's loss with ``fused_loss=False`` and its HVP's;
  unfused   materialized logits (``layers.unembed``) and
            ``layers.cross_entropy``, the memory-hungry oracle.

The routes share one compute convention: W cast to the hidden dtype, fp32
products and sums, softcap then the padded columns at the sentinel.

The sampled routes draw ŷ ~ softmax(logits): "fused" from the hash noise
of a seed (two uint32 values, the reference's draws exactly); "chunked"
and "unfused" from a ``torch.Generator`` (the reference draws them with
``jax.random``, which PyTorch cannot reproduce), or from given Gumbel
``noise`` (shaped like the logits), or, "unfused" only, given labels
``yhat``.
"""
from __future__ import annotations

from ..core.estimators import gumbel, sample_labels
from ..kernels.fused_ce import (_pack_norm, apply_norm,
                                chunked_lm_loss, chunked_lm_loss_sampled,
                                fused_lm_loss, fused_lm_loss_jvp,
                                fused_lm_loss_sampled, rowscale)
from .common import ModelConfig
from .layers import cross_entropy, unembed

IMPLS = ("fused", "fused_jvp", "chunked", "unfused")


def _check_impl(impl) -> str:
    impl = impl or "fused"
    if impl not in IMPLS:
        raise ValueError(f"unknown loss impl {impl!r}")
    return impl


def unembed_weights(cfg: ModelConfig, params):
    """(w, transpose_w): the unembedding in its stored layout, (Vp, D)
    tied or (D, Vp) untied."""
    if cfg.tie_embeddings:
        return params.embed["tok"], False
    return params.embed["unembed"], True


def _kernel_kw(cfg: ModelConfig, params, pre_norm) -> dict:
    w, tw = unembed_weights(cfg, params)
    kw = dict(w=w, vocab_size=cfg.vocab_size, transpose_w=tw,
              softcap=cfg.final_logit_softcap)
    if pre_norm is not None:
        p = params.final_norm
        kw.update(norm_kind=pre_norm, norm_scale=p["scale"],
                  norm_bias=p["bias"] if "bias" in p else None,
                  norm_eps=cfg.norm_eps)
    return kw


def _apply_final_norm(cfg: ModelConfig, params, hidden, pre_norm):
    """The final norm in PyTorch for the routes that do not fuse it
    (the fused sweep's formulas, ``fused_ce.apply_norm``)."""
    if pre_norm is None:
        return hidden
    p = params.final_norm
    norm, normp = _pack_norm(pre_norm, p["scale"],
                             p["bias"] if "bias" in p else None,
                             hidden.shape[-1], hidden.device)
    return apply_norm(hidden, normp, norm, cfg.norm_eps)


def _n_valid(hidden, mask):
    return rowscale(hidden[..., 0].numel(), mask, device=hidden.device)[1]


def lm_loss(cfg: ModelConfig, params, hidden, labels, mask=None, *,
            impl=None, pre_norm=None):
    """Masked-mean LM cross-entropy: ``(ce, n_valid)``.  With ``pre_norm``
    ("ln" | "rms") ``hidden`` is PRE-final-norm and the norm
    (``params.final_norm``) is fused into the sweep on "fused" and applied
    in PyTorch first on the other routes, as in the reference."""
    impl = _check_impl(impl)
    if impl == "fused":
        kw = _kernel_kw(cfg, params, pre_norm)
        return fused_lm_loss(hidden, kw.pop("w"), labels, mask, **kw)
    hidden = _apply_final_norm(cfg, params, hidden, pre_norm)
    if impl == "unfused":
        logits = unembed(params.embed, hidden, cfg)
        return cross_entropy(logits, labels, mask), _n_valid(hidden, mask)
    w, tw = unembed_weights(cfg, params)
    route = fused_lm_loss_jvp if impl == "fused_jvp" else chunked_lm_loss
    return route(hidden, w, labels, mask, vocab_size=cfg.vocab_size,
                 transpose_w=tw, softcap=cfg.final_logit_softcap)


def lm_loss_sampled(cfg: ModelConfig, params, hidden, seed, mask=None, *,
                    impl=None, pre_norm=None, noise=None, yhat=None):
    """GNB's sampled-label CE (Algorithm 2 lines 3-5): ŷ ~ softmax(logits)
    and the masked-mean NLL against it as ``(nll, n_valid)``, whose
    gradient is ĝ.  ``seed``: on "fused" two uint32 values (the hash
    noise); on "chunked" and "unfused" a ``torch.Generator``, or None with
    ``noise`` (Gumbel noise shaped like the logits, (..., Vp)) or, on
    "unfused", ``yhat`` (the labels).  Sampling has no HVP route:
    "fused_jvp" takes the same kernels as "fused", as in the reference."""
    impl = _check_impl(impl)
    if impl in ("fused", "fused_jvp"):
        kw = _kernel_kw(cfg, params, pre_norm)
        return fused_lm_loss_sampled(hidden, kw.pop("w"), seed, mask, **kw)
    hidden = _apply_final_norm(cfg, params, hidden, pre_norm)
    if impl == "unfused":
        logits = unembed(params.embed, hidden, cfg)
        if yhat is None:
            yhat = sample_labels(logits, seed, noise=noise)
        return cross_entropy(logits, yhat, mask), _n_valid(hidden, mask)
    if yhat is not None:
        raise ValueError("the chunked route draws its own labels (pass "
                         "noise to fix them)")
    if noise is not None:
        nflat = noise.reshape(-1, noise.shape[-1])

        def draw(c0, width):
            return nflat[:, c0:c0 + width].to(hidden.device)
    else:
        n_rows = hidden[..., 0].numel()

        def draw(c0, width):
            return gumbel((n_rows, width), seed, hidden.device)
    w, tw = unembed_weights(cfg, params)
    return chunked_lm_loss_sampled(hidden, w, draw, mask,
                                   vocab_size=cfg.vocab_size, transpose_w=tw,
                                   softcap=cfg.final_logit_softcap)

