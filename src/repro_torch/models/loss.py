"""The LM loss from final hidden states, logits-free: the counterpart of
``repro/models/loss.py`` on its "fused" route.

:func:`lm_loss` and :func:`lm_loss_sampled` hand the hidden states, the
unembedding in its stored layout and (with ``pre_norm``) the final norm's
parameters to ``kernels/fused_ce.py``: the norm is applied inside the
vocab sweep and the [B*T, V] logits never exist.  The tied weight is the
embedding table itself, so autograd sums its gradient from the CE with the
one from the embedding lookup.

"fused_jvp" is the twin of the Hutchinson HVP: the final norm applied in
PyTorch, then the CE forward kernel's value with a backward and a tangent
rule that ``torch.func.jvp`` carries through (``fused_lm_loss_jvp``).  The reference's other
routes are not ported: "chunked" and "unfused" draw GNB's labels with
``jax.random`` (no PyTorch code reproduces those draws); each raises
``NotImplementedError``.
"""
from __future__ import annotations

from ..kernels.fused_ce import (_pack_norm, apply_norm, fused_lm_loss,
                                fused_lm_loss_jvp, fused_lm_loss_sampled)
from .common import ModelConfig

IMPLS = ("fused", "fused_jvp", "chunked", "unfused")


def _check_impl(impl) -> str:
    impl = impl or "fused"
    if impl not in IMPLS:
        raise ValueError(f"unknown loss impl {impl!r}")
    if impl not in ("fused", "fused_jvp"):
        raise NotImplementedError(
            f"loss impl {impl!r} is not ported: the port's LM loss is the "
            "fused logits-free kernel ('fused', and its HVP twin "
            "'fused_jvp'); the chunked and unfused routes draw with "
            "jax.random")
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


def lm_loss(cfg: ModelConfig, params, hidden, labels, mask=None, *,
            impl=None, pre_norm=None):
    """Masked-mean LM cross-entropy: ``(ce, n_valid)``.  With ``pre_norm``
    ("ln" | "rms") ``hidden`` is PRE-final-norm and the norm
    (``params.final_norm``) is fused into the sweep; on "fused_jvp" it is
    applied in PyTorch first, as in the reference."""
    if _check_impl(impl) == "fused_jvp":
        if pre_norm is not None:
            p = params.final_norm
            norm, normp = _pack_norm(pre_norm, p["scale"],
                                     p["bias"] if "bias" in p else None,
                                     hidden.shape[-1], hidden.device)
            hidden = apply_norm(hidden, normp, norm, cfg.norm_eps)
        w, tw = unembed_weights(cfg, params)
        return fused_lm_loss_jvp(hidden, w, labels, mask,
                                 vocab_size=cfg.vocab_size, transpose_w=tw,
                                 softcap=cfg.final_logit_softcap)
    kw = _kernel_kw(cfg, params, pre_norm)
    return fused_lm_loss(hidden, kw.pop("w"), labels, mask, **kw)


def lm_loss_sampled(cfg: ModelConfig, params, hidden, seed, mask=None, *,
                    impl=None, pre_norm=None):
    """GNB's sampled-label CE (Algorithm 2 lines 3-5): ŷ ~ softmax(logits)
    drawn inside the sweep from the hash noise of ``seed`` (two uint32
    values); returns ``(nll, n_valid)``, whose gradient is ĝ.  Sampling has
    no HVP route: "fused_jvp" takes the same kernels as "fused", as in the
    reference."""
    _check_impl(impl)
    kw = _kernel_kw(cfg, params, pre_norm)
    return fused_lm_loss_sampled(hidden, kw.pop("w"), seed, mask, **kw)
