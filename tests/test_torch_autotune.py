"""``kernels/autotune.py``, the shape-keyed tuner of the CE and flash
kernels' tiles.  On the CPU: the seeds are the picks the wrappers made
before the tuner (the CE forward's pieces and row group, the backward's
256-MiB chunk width, each flash kernel's first tile) at every loss shape
``chip_smoke.py`` times; every candidate is one the kernels take; the
cache's round trip under a temporary ``$REPRO_TORCH_AUTOTUNE_CACHE``, with
seed picks never written and the key following the device; a CPU tensor
never consults the tuner; ``--retune`` on the CPU raises.  On the card
(``cuda`` marker, skipped here inside a fixture): every candidate's launch
against the seed's output, the workspace formula against the C side's,
unknown choices refused, and a tuned shape's launches taking the pick.
No JAX: the tuner has no counterpart to compare against."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import autotune as at
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_ce as ce

torch.set_num_threads(1)

CARD = ("NVIDIA H100 80GB HBM3", 132)
CUDA0 = torch.device("cuda", 0)
# the loss shapes chip_smoke.py phase 5 times (PERF.md §6), with the GNB
# refresh's half batch of GPT-2 small's, and ragged ones
LOSS_SHAPES = [
    ("gpt2-small", 8192, 768, 50304), ("gpt2-small-refresh", 4096, 768, 50304),
    ("neox-1.5b", 8192, 1536, 50432), ("stablelm-1.6b", 8192, 2048, 100352),
    ("neox-6.6b", 4096, 4096, 50432), ("yi-6b", 4096, 4096, 64000),
    ("qwen1.5-110b", 2048, 8192, 152064), ("gemma2-9b", 8192, 3584, 256000),
    ("qwen2-vl-7b", 4096, 3584, 152064),
    ("deepseek-moe-16b", 4096, 2048, 102400),
    ("rwkv6-7b", 4096, 4096, 65536),
    ("recurrentgemma-2b", 8192, 2560, 256000),
    ("seamless-m4t-medium", 8192, 1024, 256256),
    ("N7", 7, 768, 256), ("N8000", 8000, 768, 50304),
    ("Vp1024", 300, 4096, 1024),
]
LOSS_IDS = [s[0] for s in LOSS_SHAPES]


def _old_forward_plan(N, Vp, D, sms=132):
    """``fused_ce.forward_plan``'s (pieces, group) as the wrapper computed
    them before the tuner (commit 24be049), copied here as the check."""
    n_rt, T = -(-N // 128), Vp // 128
    G = n_rt if n_rt * 256 * D <= 20 << 20 else min(n_rt, 12)
    best = None
    for k in range(1, T + 1):
        units = n_rt * k
        grid = min(sms, units)
        q, rem = divmod(T, k)
        load = q * -(-units // grid) + -(-(rem * n_rt) // grid)
        if best is None or load < best[0]:
            best = (load, k)
    return best[1], G


def _old_chunk_width(N, Vp):
    """The C side's chunk width before the tuner (``tc_plan`` with
    ``kWsBudget`` = 256 MiB, commit 24be049), copied here as the check."""
    Np = (N + 127) // 128 * 128
    tiles = Vp // 128
    per_tile = 4 * Np * 128
    max_tiles = min(tiles, max(1, (256 << 20) // per_tile))
    n = (tiles + max_tiles - 1) // max_tiles
    per = (tiles + n - 1) // n
    return per * 128


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """A private cache file and a fresh in-memory cache, on a stand-in
    H100 (no card is touched)."""
    path = tmp_path / "autotune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    monkeypatch.setattr(at, "device_info", lambda index: CARD)
    at.clear_memory_cache()
    yield path
    at.clear_memory_cache()


def _lookup(N=8192, D=768, Vp=50304, **kw):
    args = dict(h_dtype=torch.bfloat16, w_dtype=torch.float32,
                transpose_w=False, softcap=None, norm="ln", device=CUDA0)
    args.update(kw)
    return at.get_tuned(N, D, Vp, **args)


@pytest.mark.parametrize("name,N,D,Vp", LOSS_SHAPES, ids=LOSS_IDS)
def test_seed_is_the_pick_before_the_tuner(name, N, D, Vp):
    seed = at.ce_seed(N, D, Vp, 132)
    assert (seed.pieces, seed.group) == _old_forward_plan(N, Vp, D)
    assert seed.cw == ce.backward_plan(N, Vp) == _old_chunk_width(N, Vp)
    assert seed.source == "seed"
    if name == "gpt2-small":     # the chunk-width note in csrc/fused_ce.cu
        assert (seed.cw, -(-Vp // seed.cw)) == (7296, 7)


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_flash_seed_is_the_tile_before_the_tuner(hd):
    t = at.attn_seed(hd)
    key = 32 if hd == 256 else 64
    assert (t.fwd, t.dq) == (key, key)
    assert (t.dkv_bq, t.dkv_ho) == (32 if hd >= 128 else 64,
                                    128 if hd == 256 else hd)
    assert t.tiles == fa.seed_tiles(hd)


@pytest.mark.parametrize("name,N,D,Vp", LOSS_SHAPES, ids=LOSS_IDS)
def test_every_candidate_is_legal(name, N, D, Vp):
    n_rt, T = -(-N // 128), Vp // 128
    for w_bf16 in (False, True):
        for norm in ("ln", None):
            seed_ws = ce.backward_ws_bytes(N, D, Vp, w_bf16=w_bf16,
                                           dh_f32=norm is not None,
                                           cw=ce.backward_plan(N, Vp))
            fwd, bwd = at.candidate_blocks(N, D, Vp, sms=132, w_bf16=w_bf16,
                                           norm=norm, ws_limit=seed_ws)
            seed = at.ce_seed(N, D, Vp, 132)
            assert fwd[0] == (seed.pieces, seed.group)
            assert bwd[0] == seed.cw
            assert len(set(fwd)) == len(fwd) and len(set(bwd)) == len(bwd)
            for k, g in fwd:
                assert 1 <= k <= T and 1 <= g <= n_rt
                plan = ce.plan_at(N, Vp, k, g)
                assert 0 <= plan.idle_share < 1
                assert at.predict_seconds(N, D, Vp, pieces=k, group=g,
                                          sms=132, bytes_w=4) > 0
            for cw in bwd:
                assert cw % 128 == 0 and 128 <= cw <= Vp
                # never more workspace than the caller allows
                assert ce.backward_ws_bytes(
                    N, D, Vp, w_bf16=w_bf16, dh_f32=norm is not None,
                    cw=cw) <= seed_ws
    _, bwd = at.candidate_blocks(N, D, Vp, sms=132, w_bf16=False, norm="ln")
    assert sorted(bwd) == sorted({ce.backward_plan(N, Vp, b)
                                  for b in (256 << 20,) + at.WS_BUDGETS})


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
def test_every_flash_candidate_is_built(hd):
    cands = at.attn_candidate_blocks(hd)
    for which in ("attn_fwd", "attn_bwd_dq"):
        assert cands[which] == list(fa.KEY_TILES[hd])
        assert all(bn in (32, 64) for bn in cands[which])
    for bq, ho in cands["attn_bwd_dkv"]:
        assert bq in (32, 64) and hd % ho == 0 and ho in (32, 64, 128)


def test_a_lookup_without_an_entry_is_the_seed_and_writes_nothing(cache):
    t = _lookup()
    assert t == at.ce_seed(8192, 768, 50304, 132)
    assert t.source == "seed"
    a = at.get_tuned_attn(8, 12, 12, 1024, 1024, 64, dtype=torch.bfloat16,
                          causal=True, window=None, softcap=None,
                          device=CUDA0)
    assert a == at.attn_seed(64)
    assert not cache.exists()


def test_cache_round_trip(cache):
    _lookup(N=4096)                 # a seed pick beside them: never written
    key = at.cache_key(8192, 768, 50304, h_dtype=torch.bfloat16,
                       w_dtype=torch.float32, transpose_w=False,
                       softcap=None, norm="ln", device_name=CARD[0],
                       sms=CARD[1])
    picked = at.TunedCE(35, 12, 12672, "measured", measured_ms=8.5, seed_ms=9.0,
                        timings={"ce_forward pieces=35 group=12": 1.5})
    at._remember(at._CE, key, picked)
    akey = at.attn_cache_key(8, 12, 12, 1024, 1024, 64,
                             dtype=torch.bfloat16, causal=True, window=None,
                             softcap=None, device_name=CARD[0], sms=CARD[1])
    apicked = at.TunedAttn(32, 64, 32, 64, "measured", measured_ms=0.3,
                           seed_ms=0.31)
    at._remember(at._ATTN, akey, apicked)
    blob = json.loads(cache.read_text())
    assert blob["version"] == at.CACHE_VERSION
    assert list(blob["ce"]) == [key] and list(blob["attn"]) == [akey]
    assert not any(f.name.startswith("autotune.json.tmp")
                   for f in cache.parent.iterdir())
    at.clear_memory_cache()
    assert _lookup() == picked
    assert at.get_tuned_attn(8, 12, 12, 1024, 1024, 64,
                             dtype=torch.bfloat16, causal=True, window=None,
                             softcap=None, device=CUDA0) == apicked
    # after the first lookup a process reads no file
    cache.write_text("not json")
    assert _lookup() == picked
    at.drop_entry(key)
    assert _lookup() == at.ce_seed(8192, 768, 50304, 132)
    assert list(json.loads(cache.read_text())["ce"]) == []


def test_a_save_keeps_the_entries_other_runs_wrote(cache):
    """Each run writes its own picks into the file as it finds it: an
    entry written before this process read the file, and one another
    process wrote after, both survive this process's save."""
    def key(N):
        return at.cache_key(N, 768, 50304, h_dtype=torch.bfloat16,
                            w_dtype=torch.float32, transpose_w=False,
                            softcap=None, norm="ln", device_name=CARD[0],
                            sms=CARD[1])

    first = at.TunedCE(35, 12, 12672, "measured", measured_ms=8.5)
    at._remember(at._CE, key(8192), first)
    at.clear_memory_cache()             # a later run: nothing read yet
    second = at.TunedCE(33, 32, 25216, "measured", measured_ms=4.0)
    at._remember(at._CE, key(4096), second)
    blob = json.loads(cache.read_text())
    blob["ce"][key(2048)] = dict(blob["ce"][key(4096)], pieces=17)
    cache.write_text(json.dumps(blob))  # another process, after our read
    akey = at.attn_cache_key(8, 12, 12, 1024, 1024, 64,
                             dtype=torch.bfloat16, causal=True, window=None,
                             softcap=None, device_name=CARD[0], sms=CARD[1])
    at._remember(at._ATTN, akey, at.TunedAttn(32, 32, 32, 64, "measured"))
    blob = json.loads(cache.read_text())
    assert sorted(blob["ce"]) == sorted([key(8192), key(4096), key(2048)])
    assert list(blob["attn"]) == [akey]
    at.clear_memory_cache()
    assert _lookup(N=8192) == first and _lookup(N=4096) == second
    assert _lookup(N=2048).pieces == 17


def test_the_key_follows_the_device(cache, monkeypatch):
    key = at.cache_key(8192, 768, 50304, h_dtype=torch.bfloat16,
                       w_dtype=torch.float32, transpose_w=False,
                       softcap=None, norm="ln", device_name=CARD[0],
                       sms=CARD[1])
    at._remember(at._CE, key, at.TunedCE(35, 12, 12672, "measured"))
    assert _lookup().source == "measured"
    for other in (("NVIDIA H200", 132), (CARD[0], 114)):
        monkeypatch.setattr(at, "device_info", lambda index, o=other: o)
        assert _lookup() == at.ce_seed(8192, 768, 50304, other[1])
    for kw in (dict(norm="rms"), dict(transpose_w=True), dict(softcap=30.0),
               dict(w_dtype=torch.bfloat16)):
        monkeypatch.setattr(at, "device_info", lambda index: CARD)
        assert _lookup(**kw).source == "seed"


def test_a_cpu_tensor_never_consults_the_tuner(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the tuner was consulted")

    monkeypatch.setattr(at, "get_tuned", refuse)
    monkeypatch.setattr(at, "get_tuned_attn", refuse)
    g = torch.Generator().manual_seed(0)
    h = torch.randn(2, 8, 128, generator=g).to(torch.bfloat16)
    h.requires_grad_(True)
    w = (torch.randn(256, 128, generator=g) * 0.02).requires_grad_(True)
    labels = torch.randint(0, 256, (2, 8), generator=g)
    loss, _ = ce.fused_lm_loss(h, w, labels, vocab_size=250,
                               norm_kind="ln", norm_scale=torch.ones(128),
                               norm_bias=torch.zeros(128))
    loss.backward()
    q = torch.randn(1, 2, 16, 64, generator=g).to(torch.bfloat16)
    k, v = q.clone(), q.clone()
    for t in (q, k, v):
        t.requires_grad_(True)
    fa.flash_attention(q, k, v).float().sum().backward()
    assert h.grad is not None and q.grad is not None


def test_tuning_refuses_the_cpu_and_fp32():
    with pytest.raises(ValueError, match="CUDA device"):
        at.tune_shape(256, 128, 1024, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        at.tune_attn_shape(1, 2, 2, 64, 64, 64, device="cpu")
    with pytest.raises(ValueError, match="only bf16"):
        at.tune_shape(256, 128, 1024, h_dtype=torch.float32, device=CUDA0)
    with pytest.raises(ValueError, match="only bf16"):
        at.tune_attn_shape(1, 2, 2, 64, 64, 64, dtype=torch.float32,
                           device=CUDA0)
    with pytest.raises(ValueError, match="CUDA device"):
        at.get_tuned(256, 128, 1024, h_dtype=torch.bfloat16,
                     w_dtype=torch.float32, transpose_w=False, softcap=None,
                     norm=None, device="cpu")


def test_retune_on_the_cpu_raises():
    from repro_torch.launch import train
    with pytest.raises(ValueError, match="--retune"):
        train.main(["--smoke", "--device", "cpu", "--retune", "--steps",
                    "1", "--seq-len", "16", "--global-batch", "2"])


def test_retune_on_several_ranks_takes_rank_0s_picks(tmp_path):
    """``--retune`` on two gloo ranks (``tests/_torch_dist_driver.py``
    ``--mode retune``) whose stand-in tuners would pick differently: rank
    r's would pick r + 1 of every choice.  Rank 0 alone measures and
    writes the cache; both ranks' lookups then give rank 0's picks."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(root, "tests", "_torch_dist_driver.py"),
         "--mode", "retune", "--store", f"file://{tmp_path}/store",
         "--world", "2", "--rank", str(r), "--out", str(tmp_path)], env=env)
        for r in range(2)]
    try:
        codes = [p.wait(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0, 0]
    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    assert [int(g["measured"]) for g in got] == [2, 0]
    for g in got:
        assert g["ce"].tolist() == [1, 1, 128]
        assert g["attn"].tolist() == [16, 16, 16, 16]
        assert str(g["source"]) == "measured"
    blob = json.loads((tmp_path / "autotune.json").read_text())
    assert [e["pieces"] for e in blob["ce"].values()] == [1]
    assert [e["fwd"] for e in blob["attn"].values()] == [16]


@pytest.mark.parametrize("arch", ["gpt2-small", "gemma2-9b", "rwkv6-7b",
                                  "recurrentgemma-2b"])
def test_retune_tunes_the_runs_shapes(arch):
    """The launcher's shapes: the loss's rows a step and the norm the
    family fuses; one attention shape a distinct window."""
    from repro_torch.launch import train
    from repro_torch.train import TrainerConfig
    args = train.parse_args(["--arch", arch, "--seq-len", "1024",
                             "--global-batch", "8", "--retune"])
    cfg = get_config(arch)
    ce_shape, attn = train._retune_shapes(args, cfg, TrainerConfig(), None)
    assert ce_shape == dict(
        N=8192, D=cfg.d_model, Vp=cfg.padded_vocab, h_dtype=torch.bfloat16,
        w_dtype=torch.float32, transpose_w=not cfg.tie_embeddings,
        softcap=cfg.final_logit_softcap,
        norm=cfg.norm_type if cfg.family in ("dense", "moe") else "rms")
    windows = {"gpt2-small": [None], "gemma2-9b": [cfg.local_window, None],
               "rwkv6-7b": [], "recurrentgemma-2b": [cfg.local_window]}
    assert sorted((s["window"] for s in attn), key=str) == sorted(
        windows[arch], key=str)
    for s in attn:
        assert (s["B"], s["Sq"], s["Sk"], s["hd"], s["H"], s["Hkv"]) == (
            8, 1024, 1024, cfg.hd, cfg.n_heads, cfg.n_kv_heads)
    _, none = train._retune_shapes(args, cfg, TrainerConfig(fused_attn=False),
                                   None)
    assert none == []


# ---------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _cs():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import chip_smoke
    return chip_smoke


CARD_CE = dict(N=1000, D=256, V=8000, Vp=8064, tied=True, norm="ln",
               softcap=None, h="bfloat16", w="float32", mask=False)


@pytest.mark.cuda
@pytest.mark.parametrize("over", [{}, dict(tied=False, norm="rms",
                                           softcap=30.0, w="bfloat16")],
                         ids=["tied-ln", "untied-rms-cap-bf16w"])
def test_every_ce_candidate_against_the_seed(cuda_device, over):
    """Each candidate's forward and combined backward against the seed's
    on the same inputs: the label logit and dW bit for bit, lse within
    1e-4, dh within 1e-5 of its largest element."""
    cs = _cs()
    spec = dict(CARD_CE, **over)
    h, w, normp, labels, rs, opts = cs._ce_inputs(torch, **spec)
    N, D, Vp = spec["N"], spec["D"], spec["Vp"]
    sms = at.device_info(torch.cuda.current_device())[1]
    seed = at.ce_seed(N, D, Vp, sms)
    fwd, bwd = at.candidate_blocks(N, D, Vp, sms=sms,
                                   w_bf16=spec["w"] == "bfloat16",
                                   norm=spec["norm"])
    lse0, ll0, _ = ce._forward_kernel(h, w, normp, labels, None, **opts,
                                      plan=(seed.pieces, seed.group))
    for plan in fwd:
        lse, ll, _ = ce._forward_kernel(h, w, normp, labels, None, **opts,
                                        plan=plan)
        assert torch.equal(ll, ll0), plan
        assert (lse - lse0).abs().max().item() <= 1e-4, plan
    dh0, dw0 = ce._backward_kernel("both", h, w, normp, labels, rs, lse0,
                                   **opts, cw=seed.cw)
    widths = set(bwd) | {128, 1024, Vp}
    for cw in sorted(widths):
        dh, dw = ce._backward_kernel("both", h, w, normp, labels, rs, lse0,
                                     **opts, cw=cw)
        assert torch.equal(dw, dw0), cw
        rel = ((dh.float() - dh0.float()).abs().max()
               / dh0.float().abs().max()).item()
        assert rel <= 1e-5, (cw, rel)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_ce_workspace_formula_matches_the_kernels(cuda_device):
    fn = ce._launch_fn("ce_backward_ws_bytes")
    for N, D, Vp in ((1000, 256, 8064), (8192, 768, 50304),
                     (4096, 4096, 64000)):
        for w_bf16 in (0, 1):
            for dh_f32 in (0, 1):
                for cw in (128, ce.backward_plan(N, Vp), Vp):
                    assert fn(N, D, Vp, 1, w_bf16, dh_f32, cw) == \
                        ce.backward_ws_bytes(N, D, Vp, w_bf16=bool(w_bf16),
                                             dh_f32=bool(dh_f32), cw=cw)
                for bad in (0, 100, Vp + 128):
                    assert fn(N, D, Vp, 1, w_bf16, dh_f32, bad) == -1


@pytest.mark.cuda
def test_unknown_choices_are_refused(cuda_device):
    cs = _cs()
    h, w, normp, labels, rs, opts = cs._ce_inputs(torch, **CARD_CE)
    lse, _, _ = ce._forward_kernel(h, w, normp, labels, None, **opts)
    for cw in (100, CARD_CE["Vp"] + 128):
        with pytest.raises(ValueError, match="chunk width"):
            ce._backward_kernel("both", h, w, normp, labels, rs, lse,
                                **opts, cw=cw)
    for plan in ((0, 1), (1, 9), (CARD_CE["Vp"] // 128 + 1, 1)):
        with pytest.raises(RuntimeError, match="launch failed"):
            ce._forward_kernel(h, w, normp, labels, None, **opts, plan=plan)
    spec = dict(cs.ATTN_MAIN, B=1, H=2, Hkv=2, Sq=128, Sk=128)
    q, k, v, g, kw = cs._attn_inputs(torch, spec, torch.bfloat16)
    seed = fa.seed_tiles(64)
    for tiles in (seed._replace(fwd=16), seed._replace(fwd=128)):
        with pytest.raises(RuntimeError, match="launch failed"):
            fa._forward_kernel(q, k, v, tiles=tiles, **kw)
    o, lse = fa._forward_kernel(q, k, v, tiles=seed, **kw)
    delta = (g.float() * o.float()).sum(-1)
    with pytest.raises(RuntimeError, match="launch failed"):
        fa._dq_kernel(q, k, v, g, lse, delta, tiles=seed._replace(dq=48),
                      **kw)
    with pytest.raises(RuntimeError, match="launch failed"):
        fa._dkv_kernel(q, k, v, g, lse, delta,
                       tiles=seed._replace(dkv=(64, 128)), **kw)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [
    dict(B=2, H=4, Hkv=2, Sq=512, Sk=512, hd=64, causal=True, window=None,
         softcap=None, q_offset=0),
    dict(B=2, H=4, Hkv=4, Sq=300, Sk=300, hd=64, causal=True, window=48,
         softcap=20.0, q_offset=0),
    dict(B=1, H=4, Hkv=2, Sq=384, Sk=384, hd=128, causal=True, window=None,
         softcap=None, q_offset=0),
    dict(B=1, H=2, Hkv=2, Sq=200, Sk=256, hd=128, causal=False, window=None,
         softcap=None, q_offset=0)],
    ids=["hd64-gqa", "hd64-window-softcap", "hd128-gqa", "hd128-noncausal"])
def test_every_flash_tile_against_the_plain_version(cuda_device, spec):
    """Each built tile of each kernel within the bf16 contract of the
    plain version (every element of o, dq, dk, dv within 2^-7 of its
    absolute sum)."""
    cs = _cs()
    q, k, v, g, kw = cs._attn_inputs(torch, spec, torch.bfloat16)
    seed = fa.seed_tiles(spec["hd"])
    o_p, _ = fa.flash_forward_plain(q, k, v, **kw)
    _, lse = fa._forward_kernel(q, k, v, tiles=seed, **kw)
    o0 = fa._forward_kernel(q, k, v, tiles=seed, **kw)[0]
    delta = (g.float() * o0.float()).sum(-1)
    dq_p = fa.flash_backward_dq_plain(q, k, v, g, lse, delta, **kw)
    dk_p, dv_p = fa.flash_backward_dkv_plain(q, k, v, g, lse, delta, **kw)
    sums = fa.contract_sums(q, k, v, g, lse, delta, **kw)
    cands = at.attn_candidate_blocks(spec["hd"])
    for t in cands["attn_fwd"]:
        o, _ = fa._forward_kernel(q, k, v, tiles=seed._replace(fwd=t), **kw)
        assert fa.contract_misses(o, o_p, sums["o"])[0] == 0, t
    for t in cands["attn_bwd_dq"]:
        dq = fa._dq_kernel(q, k, v, g, lse, delta,
                           tiles=seed._replace(dq=t), **kw)
        assert fa.contract_misses(dq, dq_p, sums["dq"])[0] == 0, t
    for t in cands["attn_bwd_dkv"]:
        dk, dv = fa._dkv_kernel(q, k, v, g, lse, delta,
                                tiles=seed._replace(dkv=t), **kw)
        assert fa.contract_misses(dk, dk_p, sums["dk"])[0] == 0, t
        assert fa.contract_misses(dv, dv_p, sums["dv"])[0] == 0, t
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_a_tuned_shape_launches_the_pick(cuda_device, tmp_path,
                                         monkeypatch):
    """tune_shape and tune_attn_shape at small shapes: the picks are
    measured, written, read back by a fresh lookup and taken by the
    wrappers, whose outputs then equal the explicit pick's; the tuner's
    own launches leave the counts as they were."""
    from repro_torch.kernels import KERNEL_LAUNCHES
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    at.clear_memory_cache()
    cs = _cs()
    try:
        before = dict(KERNEL_LAUNCHES)
        t = at.tune_shape(1000, 256, 8064, norm="ln", refresh=True)
        a = at.tune_attn_shape(2, 4, 2, 512, 512, 64, refresh=True)
        assert dict(KERNEL_LAUNCHES) == before
        assert t.source == a.source == "measured"
        assert t.timings and a.timings and t.seed_ms > 0 and a.seed_ms > 0
        at.clear_memory_cache()
        assert _lookup(N=1000, D=256, Vp=8064,
                       device=torch.device("cuda", 0)) == t
        h, w, normp, labels, rs, opts = cs._ce_inputs(torch, **CARD_CE)
        lse, ll = ce.ce_forward(h, w, normp, labels, **opts)
        lse_t, ll_t, _ = ce._forward_kernel(h, w, normp, labels, None,
                                            **opts, plan=(t.pieces, t.group))
        assert torch.equal(lse, lse_t) and torch.equal(ll, ll_t)
        dh, dw = ce.ce_backward(h, w, normp, labels, rs, lse, **opts)
        dh_t, dw_t = ce._backward_kernel("both", h, w, normp, labels, rs,
                                         lse, **opts, cw=t.cw)
        assert torch.equal(dh, dh_t) and torch.equal(dw, dw_t)
        spec = dict(cs.ATTN_MAIN, B=2, H=4, Hkv=2, Sq=512, Sk=512)
        q, k, v, g, kw = cs._attn_inputs(torch, spec, torch.bfloat16)
        o, lse_a = fa.flash_forward(q, k, v, **kw)
        o_t, _ = fa._forward_kernel(q, k, v, tiles=a.tiles, **kw)
        assert torch.equal(o, o_t)
        torch.cuda.synchronize()
    finally:
        at.clear_memory_cache()
