"""seamless-m4t-medium's smoke config, which the port's encoder-decoder
tests hold against the reference (d 64, 2 encoder + 2 decoder layers, 4
heads of 16, GELU d_ff 128 with biases, tied vocab 512, rope), and its
helpers: the reference's weights with every all-zero leaf (the RMSNorm
scales, the MLP biases) drawn from a seed, numpy batches with frames of
another length than the target, and a frame-carrying batch source for
both trainers."""
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

ARCH = "seamless-m4t-medium"
# fp32 sums in other orders over 2 + 2 layers: outputs, losses and
# gradients within 1e-5 of each one's largest element (the Griffin
# family's bound, tests/_griffin_models.py)
RTOL = 1e-5
S_TGT, S_SRC = 12, 20        # target tokens and frames: Sq != Sk


def encdec_cfg(**over):
    return dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               **{"dtype": "float32", **over})


def ref_params(cfg, seed=0):
    init = jax.jit(lambda key: jax_get_model(cfg).init_params(cfg, key))
    return seeded_zeros(init(jax.random.PRNGKey(seed)))


def port_params(cfg, params, device="cpu"):
    return params_from_jax(jax.tree.map(np.asarray, params), tcfg(cfg),
                           device)


def np_batch(cfg, B=2, S=S_TGT, S_src=S_SRC, seed=1, mask=True):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "frames": rng.standard_normal((B, S_src, cfg.d_model))
           .astype(np.float32)}
    if mask:
        out["mask"] = (rng.random((B, S)) > 0.25).astype(np.float32)
    return out


def batch(cfg, **kw):
    out = np_batch(cfg, **kw)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


class FrameSource:
    """Batches of B x S target tokens and labels with S_src frames, a
    numpy seed per step, for either trainer's ``train_loop``."""

    def __init__(self, cfg, B=4, S=16, S_src=24, seed=0):
        self.cfg, self.B, self.S, self.S_src = cfg, B, S, S_src
        self.seed = seed

    def batch_at(self, t):
        return np_batch(self.cfg, B=self.B, S=self.S, S_src=self.S_src,
                        seed=(self.seed, t), mask=False)


def assert_close(got, want, rtol=RTOL, what=""):
    """Elementwise within ``rtol`` of the largest element of ``want``."""
    got = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (
        f"{what}: worst err {err:.3g}, largest {np.abs(want).max():.3g}, "
        f"limit {rtol:g} of it")
