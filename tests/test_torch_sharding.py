"""The port's placement table (``repro_torch/distributed/sharding.py``)
against the reference's ``partition_params``, the grid's shapes, and the
refusals of what a model axis does not run.

The reference's table runs over ``jax.eval_shape`` trees of every
architecture's full config, on a stand-in mesh carrying ``.shape`` and
``.axis_names``; the port's over the same abstract shapes.  They agree
leaf by leaf, but for the leaves ``PORT_LEAVES`` lists: attention leaves
where the reference's element-wise split would cut through a head, and the
routed experts, whose expert rule the reference's dense ``w_gate``/
``w_up``/``w_down`` patterns shadow.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import partition_params as jax_partition
from repro.models import get_model as jax_get_model
from repro_torch.distributed.sharding import (PORT_LEAVES, attention_split,
                                              batch_specs, cache_specs,
                                              partition_params)
from repro_torch.launch.mesh import build_mesh, make_mesh, mesh_shape
from repro_torch.models import ModelConfig

GRIDS = ((2, 1), (2, 2), (1, 4), (4, 2))


class StandInMesh:
    def __init__(self, shape):
        self.shape = dict(zip(("data", "model"), shape))
        self.axis_names = ("data", "model")


@pytest.fixture(scope="module")
def abstract_trees():
    out = {}
    for arch in sorted(JARCHS):
        cfg = jax_get_config(arch)
        out[arch] = (cfg, jax.eval_shape(
            lambda k, c=cfg: jax_get_model(c).init_params(c, k),
            jax.random.PRNGKey(0)))
    return out


def _pairs(ref, port, names=()):
    if isinstance(port, dict):
        for k in sorted(port):
            yield from _pairs(ref[k], port[k], names + (k,))
    else:
        yield names, tuple(ref), port


@pytest.mark.parametrize("shape", GRIDS)
def test_placement_table_is_the_references(abstract_trees, shape):
    """Every leaf of all 11 architectures' full configs: the port's
    placement is the reference's PartitionSpec, but on the listed leaves,
    where the port splits attention by whole heads and the routed experts
    by expert."""
    mesh = StandInMesh(shape)
    M = shape[1]
    n_diff = 0
    for arch, (cfg, tree) in abstract_trees.items():
        tcfg = ModelConfig(**dataclasses.asdict(cfg))
        ref = jax_partition(tree, mesh, fsdp=True)
        port = partition_params(tree, mesh.shape, cfg=tcfg)
        for names, want, got in _pairs(ref, port):
            if got == want:
                continue
            n_diff += 1
            leaf, parent = names[-1], names[-2]
            if parent == "moe":
                assert leaf in PORT_LEAVES["experts"], (arch, names)
                assert got[0 if names[0] != "layers" else 1] == "model"
                continue
            assert leaf in PORT_LEAVES["heads"], (arch, names, want, got)
            # the reference's split of this leaf cuts through a head
            heads = (cfg.n_heads if leaf in ("wq", "bq", "wo")
                     else cfg.n_kv_heads)
            assert "model" in want and "model" not in got
            assert heads % M or attention_split(tcfg, M) != "heads", \
                (arch, names)
    # the differences are the ones the module lists, and there are some
    assert n_diff > 0


def test_attention_split_by_whole_heads():
    """yi (32 heads, 4 KV heads) splits both on 2 and 4 model ranks;
    recurrentgemma (10 heads, 1 KV head) only its query heads on 2 and
    nothing on 4; yi's smoke config (8, 2) its query heads on 4."""
    def split(arch, M, smoke=False):
        cfg = ModelConfig(**dataclasses.asdict(
            jax_get_config(arch, smoke=smoke)))
        return attention_split(cfg, M)
    assert split("yi-6b", 2) == split("yi-6b", 4) == "heads"
    assert split("recurrentgemma-2b", 2) == "query"
    assert split("recurrentgemma-2b", 4) == "none"
    assert split("yi-6b", 4, smoke=True) == "query"
    assert split("yi-6b", 2, smoke=True) == "heads"


def test_batch_and_cache_specs():
    import torch
    grid = {"data": 2, "model": 2}
    b = batch_specs({"tokens": torch.zeros(4, 8), "odd": torch.zeros(3, 8),
                     "scalar": torch.zeros(())}, grid)
    assert b == {"tokens": ("data", None), "odd": (None, None),
                 "scalar": ()}
    c = cache_specs({"k": torch.zeros(2, 4, 16, 3, 8)}, grid)
    assert c == {"k": (None, "data", "model", None, None)}


def test_build_mesh_shapes():
    """The reference's auto shapes for 1-16 ranks: None for one, model 4
    where it fits under data, else 2, else 1."""
    want = {1: None, 2: (2, 1), 3: (3, 1), 4: (2, 2), 5: (5, 1),
            6: (3, 2), 8: (4, 2), 9: (9, 1), 12: (6, 2), 16: (4, 4)}
    for n, shape in want.items():
        assert mesh_shape(n) == shape, n
    for n in range(1, 17):
        shape = mesh_shape(n)
        if shape is not None:
            assert shape[0] * shape[1] == n and shape[0] >= shape[1]


def test_one_process_grid():
    """Without a process group: no auto grid, and the explicit grid is
    (1, 1) with no groups; any other shape raises."""
    assert build_mesh() is None
    grid = make_mesh((1, 1))
    assert (grid.shape, grid.coords, grid.data_group,
            grid.model_group) == ((1, 1), (0, 0), None, None)
    with pytest.raises(ValueError, match="needs 4 processes"):
        make_mesh((2, 2))


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-2b",
                                  "seamless-m4t-medium"])
def test_a_model_axis_refuses_other_families(arch):
    """RWKV, Griffin and the encoder-decoder raise before the first step on
    a model axis above one, naming the ROADMAP item; with a model axis of
    one they are not refused."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Grid
    from repro_torch.train.trainer import TrainerConfig, check_grid
    cfg = get_config(arch, smoke=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A5b"):
        check_grid(cfg, TrainerConfig(), Grid(shape=(1, 2), rank=0))
    check_grid(cfg, TrainerConfig(), Grid(shape=(2, 1), rank=0))


def test_a_model_axis_refuses_hutchinson_and_unknown_dispatch():
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Grid
    from repro_torch.models.moe import set_moe_impl
    from repro_torch.train.trainer import (TrainerConfig, check_grid,
                                           check_ported)
    cfg = get_config("gpt2-small", smoke=True)
    with pytest.raises(NotImplementedError, match="Hutchinson"):
        check_grid(cfg, TrainerConfig(estimator="hutchinson"),
                   Grid(shape=(1, 2), rank=0))
    with pytest.raises(ValueError, match="moe_impl"):
        check_ported(TrainerConfig(moe_impl="ragged"))
    with pytest.raises(ValueError, match="moe impl"):
        set_moe_impl("ragged")


def test_one_process_placements_keep_every_leaf_whole():
    """On (1, 1) the placements are the reference's (an axis of one
    divides every dim) and every block is the whole leaf: the one-process
    module itself."""
    import torch
    from repro_torch.configs.gpt2 import GPT2_TINY
    from repro_torch.convert import shard_params
    from repro_torch.models.transformer import init_params
    full = init_params(GPT2_TINY, torch.Generator().manual_seed(0))
    local = shard_params(full, make_mesh((1, 1)))
    assert local is full
    assert local.placements["embed"]["tok"] == ("model", "data")
    from repro_torch.distributed.sharding import shard_tree
    blocks = shard_tree(full.param_tree(), local.placements, local.grid)
    assert blocks["embed"]["tok"] is full.embed["tok"]
    assert np.isfinite(sum(float(t.sum()) for t in local.parameters()))


def test_a_model_axis_that_does_not_divide_a_split_leaf_raises():
    """NeoX-6.6B on (1, 3): the table replicates ``w_up`` (d_ff 16384),
    ``tok`` and ``unembed`` (Vp 50432), which the layers would split all
    the same, so the check refuses it, and GPT-2 tiny's trainer on (1, 3)
    raises in ``init_fn``, before the first step; (1, 4) passes."""
    from repro_torch.configs.gpt2 import GPT2_TINY
    from repro_torch.distributed.sharding import Grid, check_splits, set_grid
    from repro_torch.train.trainer import TrainerConfig, make_train_fns
    from repro.configs.gpt2 import NEOX_6_6B as cfg
    tree = jax.eval_shape(lambda k: jax_get_model(cfg).init_params(cfg, k),
                          jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="model axis of 3") as err:
        check_splits(partition_params(tree, {"data": 1, "model": 3},
                                      cfg=cfg), {"data": 1, "model": 3})
    assert "['embed']['tok']" in str(err.value)
    check_splits(partition_params(tree, {"data": 1, "model": 4}, cfg=cfg),
                 {"data": 1, "model": 4})
    try:
        init_fn, _ = make_train_fns(dataclasses.replace(GPT2_TINY,
                                                        dtype="float32"),
                                    TrainerConfig(), device="cpu",
                                    grid=Grid(shape=(1, 3), rank=0))
        with pytest.raises(ValueError, match="model axis of 3"):
            init_fn()
    finally:
        set_grid(None)     # make_train_fns installs its grid
