"""recurrentgemma-2b's smoke config, which the port's Griffin tests hold
against the reference (d 64, 5 layers: one group of (recurrent,
recurrent, local attention) and two tail recurrent layers, 4 query heads
over 1 KV head of 16, window 16, conv width 4, tied vocab 512 with the
embedding scale), and its helpers: the reference's weights with every
all-zero leaf (the RMSNorm scales, the gate and conv biases) drawn from a
seed, numpy batches, and the reference's recurrent state after a forward
(its ``forward_hidden`` drops it: the blocks are run here one by one,
compiled with excess precision off, ``REF_BF16``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _moe_models import seeded_zeros
from _rope_models import tcfg
from _rwkv_models import REF_BF16
from repro.configs import get_config as jax_get_config
from repro.models import get_model as jax_get_model
from repro.models import griffin as jg
from repro.models.layers import embed as jax_embed
from repro_torch.convert import params_from_jax

ARCH = "recurrentgemma-2b"
# fp32 sums in other orders (the scan's tree among them), over 5 layers:
# outputs, losses and gradients within 1e-5 of each one's largest element
RTOL = 1e-5


def griffin_cfg(**over):
    return dataclasses.replace(jax_get_config(ARCH, smoke=True),
                               **{"dtype": "float32", **over})


def ref_params(cfg, seed=0):
    init = jax.jit(lambda key: jax_get_model(cfg).init_params(cfg, key))
    return seeded_zeros(init(jax.random.PRNGKey(seed)))


def port_params(cfg, params, device="cpu"):
    return params_from_jax(jax.tree.map(np.asarray, params), tcfg(cfg),
                           device)


def batch(cfg, B=2, S=40, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "mask": (rng.random((B, S)) > 0.25).astype(np.float32)}
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def ref_forward_state(cfg, params, tokens):
    """The reference's trunk (``forward_hidden``'s body, block by block)
    keeping each recurrent layer's state: {"rec1", "rec2", "tail"} each
    {"conv", "h"} stacked over its layers (numpy)."""
    return jax.tree.map(np.asarray, jax.jit(
        lambda p, t: _ref_forward_state(cfg, p, t),
        compiler_options=REF_BF16)(params, tokens))


def _ref_forward_state(cfg, params, tokens):
    B, S = tokens.shape
    x = jax_embed(params["embed"], tokens, cfg)
    positions = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    out = {"rec1": [], "rec2": [], "tail": []}
    take = lambda tree, i: jax.tree.map(lambda a: a[i], tree)  # noqa: E731
    for i in range(jg.n_groups(cfg)):
        g = take(params["groups"], i)
        x, s = jg.rec_block_apply(g["rec1"], x, cfg)
        out["rec1"].append(s)
        x, s = jg.rec_block_apply(g["rec2"], x, cfg)
        out["rec2"].append(s)
        x = jg.attn_block_apply(g["attn"], x, cfg, positions)
    for j in range(jg.n_tail(cfg)):
        x, s = jg.rec_block_apply(take(params["tail"], j), x, cfg)
        out["tail"].append(s)
    return {kind: {k: jnp.stack([s[k].astype(jnp.float32) for s in v])
                   for k in ("conv", "h")}
            for kind, v in out.items() if v}


def assert_close(got, want, rtol=RTOL, what=""):
    """Elementwise within ``rtol`` of the largest element of ``want``."""
    got = (got.detach().float().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float32))
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (
        f"{what}: worst err {err:.3g}, largest {np.abs(want).max():.3g}, "
        f"limit {rtol:g} of it")
