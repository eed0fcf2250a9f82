"""The RWKV-6 smoke config the port's tests hold against the reference
(rwkv6-7b's: d 128, 2 layers, two heads of 64, d_ff 256, untied vocab 512)
and its helpers: the reference's weights with every all-zero leaf (the
RMSNorm and ``ln_x`` scales) drawn from a seed, numpy batches and states,
and the reference's own spread under a one-ulp change of its weights.

The model is ill-conditioned at some tokens: ``ln_x`` normalizes each
head's WKV output by its RMS (eps 1e-5), and where a head's output is
near zero (early tokens, from a zero state) it multiplies that output's
fp32 rounding by up to ~300.  There the reference itself moves by ~1e-4
of its largest logit when its weights move by one ulp.  So each
comparison's bound is 1e-5 of the largest element plus a few times that
spread, element by element (:func:`ref_spread`)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _moe_models import seeded_zeros
from _rope_models import tcfg
from repro.configs import get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro_torch.convert import params_from_jax

ARCH = "rwkv6-7b"
RTOL = 1e-5            # of the largest element
SPREAD_FACTOR = 4      # times the reference's own one-ulp spread
# XLA on the CPU may skip a bf16 rounding between fused ops (a bf16
# product cast to fp32 for the WKV stays unrounded); the port rounds at
# every cast, as the reference's code says.  Compiled with this option
# the reference rounds there too, and its bf16 logits lie within ~1e-7 of
# the port's over the first tokens; with excess precision the two differ
# by up to ~9% of the largest logit at the fourth token.
REF_BF16 = {"xla_allow_excess_precision": False}


def rwkv_cfg(**over):
    return dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               **{"dtype": "float32", **over})


def ref_params(cfg, seed=0):
    return seeded_zeros(jax_get_model(cfg).init_params(
        cfg, jax.random.PRNGKey(seed)))


def port_params(cfg, params, device="cpu"):
    return params_from_jax(jax.tree.map(np.asarray, params), tcfg(cfg),
                           device)


def batch(cfg, B=2, S=64, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "mask": (rng.random((B, S)) > 0.25).astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def random_state(cfg, B, seed=2, scale=0.5):
    """A nonzero stacked state (numpy): shifts N(0, scale^2) in the
    compute dtype's values, WKV matrices N(0, scale^2) fp32."""
    rng = np.random.default_rng(seed)
    L, D, H = cfg.n_layers, cfg.d_model, cfg.d_model // 64
    return {"tm_shift": (scale * rng.standard_normal((L, B, D))).astype(
                np.float32),
            "cm_shift": (scale * rng.standard_normal((L, B, D))).astype(
                np.float32),
            "wkv": (scale * rng.standard_normal((L, B, H, 64, 64))).astype(
                np.float32)}


def perturbed(params, seed):
    """The weights times (1 + 2^-23 s), s = +-1 at random: each moved by
    about one ulp."""
    rng = np.random.default_rng(seed)

    def move(x):
        x = np.asarray(x)
        s = rng.choice(np.array([-1.0, 1.0], np.float32), x.shape)
        return jnp.asarray((x * (1 + s * 2.0 ** -23)).astype(x.dtype))
    return jax.tree.map(move, params)


def ref_spread(fn, params, seeds=(11, 12)):
    """The largest elementwise move of ``fn(params)`` (a pytree of arrays)
    over weights each moved by one ulp (:func:`perturbed`), per seed."""
    base = jax.tree.map(np.asarray, fn(params))
    spread = jax.tree.map(np.zeros_like, base)
    for seed in seeds:
        moved = jax.tree.map(np.asarray, fn(perturbed(params, seed)))
        spread = jax.tree.map(lambda s, a, b: np.maximum(s, np.abs(a - b)),
                              spread, base, moved)
    return base, spread


def assert_close(got, want, spread, rtol=RTOL, what=""):
    """Elementwise within ``rtol`` of the largest element of ``want`` plus
    SPREAD_FACTOR times the reference's own spread there."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = rtol * np.abs(want).max() + SPREAD_FACTOR * np.asarray(spread)
    err = np.abs(got - want)
    assert (err <= bound).all(), (
        f"{what}: {int((err > bound).sum())} of {err.size} elements beyond "
        f"the bound; worst err {err.max():.3g}, largest "
        f"{np.abs(want).max():.3g}")
