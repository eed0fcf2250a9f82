"""``launch/roofline.py``'s formulas and the byte formulas beside the CE
and flash kernels held against the reference's, integer for integer, over
every configuration of both registries (full and smoke) at a few lengths;
the stage times and roofline terms against the reference's once each is
multiplied back by its own package's peak.  Pure arithmetic: no kernel, no
JAX compile."""
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import flash_attention as jfa
from repro.kernels import fused_ce as jce
from repro.launch import roofline as jroof
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_ce as ce
from repro_torch.launch import roofline as roof

torch.set_num_threads(1)

CONFIGS = [(arch, smoke) for arch in ARCHS for smoke in (False, True)]
IDS = [f"{a}-{'smoke' if s else 'full'}" for a, s in CONFIGS]
LENGTHS = (1, 128, 2048, 32768)


def _pair(arch, smoke):
    return get_config(arch, smoke=smoke), jax_get_config(arch, smoke=smoke)


def test_the_peaks_are_the_h100s():
    assert roof.PEAK_FLOPS == 989e12
    assert roof.HBM_BW == 3.35e12
    assert roof.FP32_FLOPS == 67e12
    assert roof.LINK_BW == 450e9


@pytest.mark.parametrize("arch,smoke", CONFIGS, ids=IDS)
def test_kv_cache_formulas_match_the_reference(arch, smoke):
    cfg, ref = _pair(arch, smoke)
    for C in LENGTHS:
        for kv in (None, "bf16", "int8"):
            got = roof.kv_cache_slot_bytes(cfg, C, kv_dtype=kv)
            want = jroof.kv_cache_slot_bytes(ref, C, kv_dtype=kv)
            assert type(got) is int and got == want
            budget = 80 * 10 ** 9
            assert (roof.kv_slots_at_budget(cfg, C, budget, kv_dtype=kv)
                    == jroof.kv_slots_at_budget(ref, C, budget,
                                                kv_dtype=kv))


@pytest.mark.parametrize("arch,smoke", CONFIGS, ids=IDS)
def test_model_flops_match_the_reference(arch, smoke):
    cfg, ref = _pair(arch, smoke)
    n = cfg.active_param_count()
    assert n == ref.active_param_count()
    for T in LENGTHS:
        assert roof.model_flops_train(n, T) == jroof.model_flops_train(n, T)
        assert roof.model_flops_infer(n, T) == jroof.model_flops_infer(n, T)


@pytest.mark.parametrize("arch,smoke", CONFIGS, ids=IDS)
def test_loss_bytes_and_stage_match_the_reference(arch, smoke):
    cfg, ref = _pair(arch, smoke)
    D, Vp = cfg.d_model, cfg.padded_vocab
    assert (D, Vp) == (ref.d_model, ref.padded_vocab)
    for N in LENGTHS:
        for bytes_h, bytes_w in ((2, 4), (4, 4), (2, 2)):
            for nf in (False, True):
                got = ce.lm_loss_hbm_bytes_fused(
                    N, D, Vp, bytes_h=bytes_h, bytes_w=bytes_w,
                    norm_fused=nf)
                assert type(got) is int and got == jce.lm_loss_hbm_bytes_fused(
                    N, D, Vp, bytes_h=bytes_h, bytes_w=bytes_w,
                    norm_fused=nf)
            for passes in (2, 5):
                assert ce.lm_loss_hbm_bytes_unfused(
                    N, D, Vp, bytes_h=bytes_h, bytes_w=bytes_w,
                    passes=passes) == jce.lm_loss_hbm_bytes_unfused(
                    N, D, Vp, bytes_h=bytes_h, bytes_w=bytes_w,
                    passes=passes)
        for fused in (False, True):
            got = roof.loss_stage_seconds(N, D, Vp, fused=fused)
            want = jroof.loss_stage_seconds(N, D, Vp, fused=fused)
            assert got * roof.HBM_BW == pytest.approx(
                want * jroof.HBM_BW, rel=1e-12)


@pytest.mark.parametrize("arch,smoke", CONFIGS, ids=IDS)
def test_attention_bytes_and_stage_match_the_reference(arch, smoke):
    cfg, ref = _pair(arch, smoke)
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    assert (H, Hkv, hd) == (ref.n_heads, ref.n_kv_heads, ref.hd)
    for S in LENGTHS:
        for B in (1, 8):
            for el in (2, 4):
                for f in ("attention_hbm_bytes_flash",
                          "attention_hbm_bytes_train_flash"):
                    got = getattr(fa, f)(B, H, Hkv, S, hd, bytes_per_el=el)
                    assert type(got) is int
                    assert got == getattr(jfa, f)(B, H, Hkv, S, hd,
                                                  bytes_per_el=el)
            for passes in (2, 5):
                for bk in (512, 1024):
                    assert fa.attention_hbm_bytes_unfused(
                        B, H, S, hd, block_k=bk, passes=passes) == \
                        jfa.attention_hbm_bytes_unfused(
                            B, H, S, hd, block_k=bk, passes=passes)
            for fused in (False, True):
                for train in (False, True):
                    got = roof.attention_stage_seconds(
                        B, H, Hkv, S, hd, fused=fused, train=train)
                    want = jroof.attention_stage_seconds(
                        B, H, Hkv, S, hd, fused=fused, train=train)
                    assert got * roof.HBM_BW == pytest.approx(
                        want * jroof.HBM_BW, rel=1e-12)


@pytest.mark.parametrize("flops,nbytes,coll", [
    (1e15, 1e9, 1e6), (1e9, 1e12, 0), (0.0, 0.0, 5e12), (7e14, 2e11, 3e9)])
def test_roofline_terms_match_the_reference(flops, nbytes, coll):
    cost = {"flops": flops, "bytes accessed": nbytes}
    got, want = roof.roofline_terms(cost, coll), jroof.roofline_terms(
        cost, coll)
    for k in ("flops_per_device", "bytes_per_device",
              "collective_bytes_per_device"):
        assert got[k] == want[k]
    assert got["t_compute_s"] * roof.PEAK_FLOPS == pytest.approx(
        want["t_compute_s"] * jroof.PEAK_FLOPS, rel=1e-12)
    assert got["t_memory_s"] * roof.HBM_BW == pytest.approx(
        want["t_memory_s"] * jroof.HBM_BW, rel=1e-12)
    assert got["t_collective_s"] * roof.LINK_BW == pytest.approx(
        want["t_collective_s"] * jroof.ICI_BW, rel=1e-12)
    assert roof.dominant_term(got) == max(
        ("compute", "memory", "collective"),
        key=lambda k: got[f"t_{k}_s"])
