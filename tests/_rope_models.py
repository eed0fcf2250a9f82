"""The small rope configs the port's tests hold against the reference: a
GPT-NeoX-shaped config (``NEOX_1_5B`` at d 128, 2 layers, 4 heads, vocab
512: rope, untied embeddings, GELU) and stablelm-1.6b's smoke config
(rope, untied, SwiGLU, hd 8), fp32; a module fixture of each with the
reference's weights and the port's copy of them; and
:func:`trajectories`, a few steps of both trainers on one config."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.gpt2 import NEOX_1_5B
from repro.core.engine import ravel_shards as jax_ravel_shards
from repro.data import DataConfig as JDataConfig
from repro.data import make_source as jax_make_source
from repro.kernels.fused_ce import seed_from_key
from repro.models import get_model as jax_get_model
from repro.train import TrainerConfig as JTrainerConfig
from repro.train import make_engine as jax_make_engine
from repro.train import make_train_fns as jax_make_train_fns
from repro.train import train_loop as jax_train_loop
from repro.train.trainer import RNG_TAG_HESS
from repro_torch.convert import params_from_jax
from repro_torch.core import build_layout, ravel_shards
from repro_torch.data import DataConfig, make_source
from repro_torch.models import ModelConfig
from repro_torch.train import TrainerConfig, make_train_fns, train_loop

NEOX_TINY = dataclasses.replace(NEOX_1_5B, name="neox-tiny", d_model=128,
                                n_layers=2, n_heads=4, n_kv_heads=4,
                                d_ff=512, vocab_size=512, dtype="float32")
STABLELM = dataclasses.replace(jax_get_config("stablelm-1.6b", smoke=True),
                               dtype="float32")
CFGS = {"neox_tiny": NEOX_TINY, "stablelm_smoke": STABLELM}
# the reference's flash kernel takes hd 32 and up: stablelm's smoke hd 8
# runs the materialized-scores route on both sides
ATTN = {"neox_tiny": "flash", "stablelm_smoke": "full"}


def tcfg(cfg):
    """The port's copy of a reference config."""
    return ModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module", params=sorted(CFGS))
def model(request):
    """(name, reference config, reference params, the port's params)."""
    cfg = CFGS[request.param]
    params = jax_get_model(cfg).init_params(cfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg(cfg))
    return request.param, cfg, params, tparams


TRAIN = dict(peak_lr=5e-4, total_steps=64, warmup_steps=4, hess_interval=4,
             hess_subbatch=2, seed=0)


def trajectories(cfg, attn, over, steps, params=None):
    """``steps`` steps of the reference trainer and of the port on its
    weights (``params``, a reference tree, replaces the initial ones when
    given), batches, noise seeds and Hutchinson probes: (port history,
    reference history, the two parameter vectors, the two states)."""
    over = dict(TRAIN, fused_loss=True, attn_impl=attn, **over)
    jtc = JTrainerConfig(**over)
    src_cfg = JDataConfig(seq_len=16, global_batch=4,
                          vocab_size=cfg.vocab_size)
    s0 = jax_make_train_fns(cfg, jtc)[0](jax.random.PRNGKey(0))
    if params is not None:
        s0 = s0._replace(params=params)
    s_ref, hist_ref = jax_train_loop(cfg, jtc, jax_make_source(src_cfg),
                                     num_steps=steps, state=s0)

    def rng(step):
        return jax.random.fold_in(jax.random.fold_in(s0.rng, RNG_TAG_HESS),
                                  step)

    def probe(step, layout):
        keys = jax.random.split(rng(step), layout.n_shards)
        return tuple(torch.from_numpy(np.array(jax.random.normal(
            k, (n,), jnp.float32))) for k, n in zip(keys, layout.shard_sizes))

    tc = TrainerConfig(**over)
    tparams = params_from_jax(jax.tree.map(np.asarray, s0.params), tcfg(cfg))
    state = make_train_fns(tcfg(cfg), tc, device="cpu")[0](tparams)
    s_port, hist = train_loop(
        tcfg(cfg), tc,
        make_source(DataConfig(**dataclasses.asdict(src_cfg))),
        num_steps=steps, state=state, device="cpu",
        hess_seed_fn=lambda step: np.asarray(seed_from_key(rng(step))),
        probe_fn=probe)
    lay = jax_make_engine(jtc).layout(s_ref.params)
    a = np.asarray(jax_ravel_shards(lay, s_ref.params)[0])[:lay.n_params]
    tree = s_port.params.param_tree()
    b = ravel_shards(build_layout(tree), tree)[0].detach().numpy()[
        :lay.n_params]
    return hist, hist_ref, a, b, s_port, s_ref
