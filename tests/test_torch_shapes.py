"""``configs/shapes.py`` held against the reference's: the assigned
shapes, which family each runs for, and every cell's input specs (the
step function's inputs as ``meta`` tensors) against the reference's
``jax.ShapeDtypeStruct`` trees, leaf by leaf, for every architecture and
shape at its full size (no storage is allocated) and at its smoke size."""
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import shapes as jshapes
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs import shapes

torch.set_num_threads(1)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _hold(cfg_ref, cfg, shape):
    want = jshapes.input_specs(cfg_ref, shape)
    got = shapes.input_specs(cfg, shape)
    assert shapes.applicable(cfg, shape)[0] == jshapes.applicable(
        cfg_ref, shape)[0]
    if want is None:
        assert got is None
        return
    assert (got.kind, got.note) == (want.kind, want.note)
    g, w = _flat(got.specs), _flat(want.specs)
    assert sorted(g) == sorted(w)
    for name, ref in w.items():
        leaf = g[name]
        if isinstance(ref, int):
            assert leaf == ref, name
            continue
        assert leaf.device.type == "meta", name
        assert tuple(leaf.shape) == tuple(ref.shape), name
        assert str(leaf.dtype) == f"torch.{ref.dtype}", name


def test_shapes_and_families_are_the_reference_ones():
    """The four assigned shapes and the bounded-state families, as the
    reference's; the port names every architecture the reference does."""
    assert shapes.SHAPES == jshapes.SHAPES
    assert shapes.BOUNDED_STATE_FAMILIES == jshapes.BOUNDED_STATE_FAMILIES
    assert shapes.N_PATCHES == jshapes.N_PATCHES
    assert sorted(ARCHS) == sorted(JARCHS)


@pytest.mark.parametrize("shape", sorted(jshapes.SHAPES))
@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_input_specs_match_reference(arch, shape):
    """The cell of (arch, shape) at the full config: skipped where the
    reference skips it (long_500k for every family but rwkv and griffin),
    else the same kind, note and inputs, each a meta tensor of the
    reference's shape and dtype (the encoder-decoder's train batch with
    its (B, S, d) frames, its prefill and decode caches with S_src = S)."""
    _hold(jax_get_config(arch), get_config(arch), shape)


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_smoke_input_specs_match_reference(arch):
    """Every shape at the smoke config."""
    for shape in jshapes.SHAPES:
        _hold(jax_get_config(arch, smoke=True), get_config(arch, smoke=True),
              shape)


def test_specs_hold_no_storage():
    """The largest cell (qwen1.5-110b's decode_32k cache, 80 layers x 128
    rows x 32,768 positions) is described without allocating it."""
    cell = shapes.input_specs(get_config("qwen1.5-110b"), "decode_32k")
    k = cell.specs["cache"]["k"]
    assert tuple(k.shape) == (80, 128, 32768, 8, 128) and k.is_meta
