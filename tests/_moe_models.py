"""The MoE smoke configs the port's tests hold against the reference
(deepseek-moe-16b's and llama4-maverick's, fp32) and their helpers: the
reference's weights with every all-zero leaf drawn from a seed, numpy
batches, and the gradient check of every leaf."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro_torch.core.types import flat_tensors, tree_leaves

NAMES = ("deepseek-moe-16b", "llama4-maverick-400b-a17b")
# fp32 sums over D = 64 and 2-4 layers in other orders: outputs, losses
# and gradients (of magnitude <= 1) within 3e-6, the dense configs' bound
# (tests/test_torch_dense_features.py); logits and gradients that pass 1
# (the FFN's under a cotangent of N(0, 1) entries reach ~16) also get 1e-6
# of the largest one
ATOL = 3e-6
LOGIT_RTOL = 1e-6


def moe_cfg(arch, **over):
    return dataclasses.replace(jax_get_config(arch, smoke=True),
                               **{"dtype": "float32", **over})


def seeded_zeros(params, seed=3):
    """The reference tree with every all-zero leaf (the RMSNorm scales)
    drawn from N(0, 0.1^2), so that it shows."""
    rng = np.random.default_rng(seed)

    def fill(x):
        x = np.asarray(x)
        if np.any(x):
            return jnp.asarray(x)
        return jnp.asarray((0.1 * rng.standard_normal(x.shape))
                           .astype(x.dtype))
    return jax.tree.map(fill, params)


def ref_params(cfg, seed=0):
    return seeded_zeros(jax_get_model(cfg).init_params(
        cfg, jax.random.PRNGKey(seed)))


def batch(cfg, B=2, S=40, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "mask": (rng.random((B, S)) > 0.25).astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def assert_grads(tparams, loss, jgrads):
    """Every leaf's gradient within 3e-6 plus 1e-6 of its largest element
    (some embedding and unembedding gradients pass 1)."""
    tree = tparams.param_tree()
    grads = iter(torch.autograd.grad(loss, flat_tensors(tree)))
    for leaf, want in zip(tree_leaves(tree), jax.tree.leaves(jgrads)):
        got = (torch.stack([next(grads) for _ in leaf])
               if isinstance(leaf, list) else next(grads))
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, atol=ATOL + LOGIT_RTOL * np.abs(want).max())
