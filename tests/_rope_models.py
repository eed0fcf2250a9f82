"""The small rope configs the port's tests hold against the reference: a
GPT-NeoX-shaped config (``NEOX_1_5B`` at d 128, 2 layers, 4 heads, vocab
512: rope, untied embeddings, GELU) and stablelm-1.6b's smoke config
(rope, untied, SwiGLU, hd 8), fp32; and a module fixture of each with the
reference's weights and the port's copy of them."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs.gpt2 import NEOX_1_5B
from repro.models import get_model as jax_get_model
from repro_torch.convert import params_from_jax
from repro_torch.models import ModelConfig

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
