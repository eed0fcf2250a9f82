"""Expert parallelism on 4 gloo ranks on the CPU
(``tests/_torch_dist_driver.py --mode moe`` and ``--mode grid``),
deepseek-moe-16b's and llama4-maverick's smoke configs in fp32.

  * the default dispatch on (1, 4) and (2, 2): each model rank runs its
    E/M experts, each data rank its rows of the batch, and the output, aux
    and every gradient (the router's among them) equal the reference's
    one-process ``moe_ffn_gspmd`` on the whole batch, drops included
    (capacity factor 0.5);
  * ``moe_ffn_a2a`` on (2, 2) and (1, 4) against the reference's
    ``moe_ffn_a2a`` on a 4-device CPU mesh (a subprocess with
    ``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
    ``tests/test_moe_a2a.py`` runs it), at ``capacity_factor`` 1.25
    and 8.0): output, aux and gradients within 1e-5;
  * llama4-maverick's smoke config trains 3 Sophia-G steps on (2, 2) and
    on (1, 4) within 2e-4 of the reference's one process.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
DRIVER = os.path.join(HERE, "_torch_dist_driver.py")
ROOT = os.path.dirname(HERE)
SRC = os.path.join(ROOT, "src")
TOL = 1e-5


def port_cfg(cf=None):
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("deepseek-moe-16b", smoke=True),
                              dtype="float32")
    return cfg if cf is None else dataclasses.replace(cfg,
                                                      capacity_factor=cf)


def inputs(tmp_path, cf, B=4, S=32, seed=0):
    """x, a cotangent and one MoE layer's parameters, drawn with numpy."""
    cfg = port_cfg()
    rng = np.random.default_rng(seed)
    D, F, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    Fs = F * cfg.n_shared_experts

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])
                ).astype(np.float32)
    data = {"x": rng.standard_normal((B, S, D)).astype(np.float32),
            "ct": rng.standard_normal((B, S, D)).astype(np.float32),
            "p_router": w(D, E), "p_w_gate": w(E, D, F),
            "p_w_up": w(E, D, F), "p_w_down": w(E, F, D),
            "p_shared_w_gate": w(D, Fs), "p_shared_w_up": w(D, Fs),
            "p_shared_w_down": w(Fs, D), "cf": np.array(cf)}
    path = tmp_path / f"moe_{cf}.npz"
    np.savez(path, **data)
    return path, data


def spawn(tmp_path, mode, shape, world=4, **kw):
    out = tmp_path / f"{mode}-{len(list(tmp_path.iterdir()))}"
    out.mkdir()
    extra = []
    for k, v in kw.items():
        extra += [f"--{k.replace('_', '-')}", str(v)]
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen(
        [sys.executable, DRIVER, "--mode", mode, "--store",
         f"file://{out}/store", "--world", str(world), "--rank", str(r),
         "--out", str(out), "--shape", f"{shape[0]},{shape[1]}", *extra],
        env=env) for r in range(world)]
    try:
        codes = [p.wait(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert codes == [0] * world, codes
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


def _params(data):
    p = {k[2:]: torch.from_numpy(v) for k, v in data.items()
         if k.startswith("p_") and not k.startswith("p_shared_")}
    p["shared"] = {k[9:]: torch.from_numpy(v) for k, v in data.items()
                   if k.startswith("p_shared_")}
    return p


def _leaves(p, pre=""):
    for k in sorted(p):
        if isinstance(p[k], dict):
            yield from _leaves(p[k], pre + k + "_")
        else:
            yield pre + k, p[k]


def one_process(data, cf):
    """The reference's one-process ``moe_ffn_gspmd`` on the whole batch:
    the output, aux and the gradients of sum(out * ct) + aux."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get_config
    from repro.models import moe as jmoe
    cfg = dataclasses.replace(jax_get_config("deepseek-moe-16b", smoke=True),
                              dtype="float32", capacity_factor=cf)
    p = jax.tree.map(lambda t: jnp.asarray(t.numpy()), _params(data))
    ct = jnp.asarray(data["ct"])

    def f(p, x):
        y, aux = jmoe.moe_ffn_gspmd(p, x, cfg)
        return (y * ct).sum() + aux, (y, aux)
    (_, (y, aux)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(p, jnp.asarray(data["x"]))
    grads = {name: np.asarray(g) for name, g in _leaves(gp)}
    return np.asarray(y), float(aux), np.asarray(gx), grads


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_default_dispatch_is_one_process(tmp_path, shape):
    """E/M experts a rank, each data rank its rows d, d + D, ... of the
    batch (``data.host_slice``): the output, aux and every gradient (the
    router's among them) equal the reference's one process on the whole
    batch, its routing groups and drops included (capacity factor 0.5
    drops entries here; checked)."""
    from repro_torch.models.moe import moe_ffn, record_routing
    cf = 0.5
    path, data = inputs(tmp_path, cf)
    res = spawn(tmp_path, "moe", shape, cfg="deepseek_smoke", inp=path,
                impl="gspmd")
    with record_routing() as calls:
        moe_ffn(_params(data), torch.from_numpy(data["x"]), port_cfg(cf))
    assert not bool(calls[0]["keep"].all())                # drops on
    out, aux, gx, grads = one_process(data, cf)
    D, M = shape
    for r, got in enumerate(res):
        d = r // M
        np.testing.assert_allclose(got["out"], out[d::D], rtol=0, atol=TOL)
        np.testing.assert_allclose(got["aux"], aux, rtol=TOL)
        np.testing.assert_allclose(got["gx"], gx[d::D], rtol=0, atol=TOL)
        # the gradients sum the data ranks' rows in another order: within
        # 1e-5 of the leaf's largest element where it passes 1, as the
        # all-to-all's are held below
        for name, want in grads.items():
            np.testing.assert_allclose(
                got[f"g_{name}"], want, rtol=0,
                atol=TOL * max(1.0, np.abs(want).max()), err_msg=name)


def reference_a2a(path, shape, tmp_path):
    """The reference's ``moe_ffn_a2a`` on a ``shape`` CPU mesh of 4
    devices: output, aux, and the gradients of sum(out * ct) + aux."""
    out = tmp_path / f"ref_{shape[0]}{shape[1]}_{path.stem}.npz"
    prog = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        os.environ["JAX_PLATFORMS"] = "cpu"
        import sys, dataclasses
        sys.path.insert(0, {json.dumps(SRC)})
        import jax, jax.numpy as jnp, numpy as np
        from repro.configs import get_config
        from repro.distributed.sharding import set_activation_mesh
        from repro.launch.mesh import make_mesh
        from repro.models import moe as M

        d = dict(np.load({json.dumps(str(path))}))
        cfg = dataclasses.replace(get_config("deepseek-moe-16b", smoke=True),
                                  dtype="float32",
                                  capacity_factor=float(d["cf"]))
        p = {{k[2:]: jnp.asarray(v) for k, v in d.items()
              if k.startswith("p_") and not k.startswith("p_shared_")}}
        p["shared"] = {{k[9:]: jnp.asarray(v) for k, v in d.items()
                       if k.startswith("p_shared_")}}
        mesh = make_mesh({shape}, ("data", "model"))
        set_activation_mesh(mesh)
        M.set_moe_impl("a2a")
        x, ct = jnp.asarray(d["x"]), jnp.asarray(d["ct"])

        def f(p, x):
            y, aux = M.moe_ffn(p, x, cfg)
            return (y * ct).sum() + aux, (y, aux)
        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(p, x)
        res = {{"out": np.asarray(y), "aux": np.asarray(aux),
               "gx": np.asarray(gx)}}
        for k, v in gp.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    res["g_" + k + "_" + kk] = np.asarray(vv)
            else:
                res["g_" + k] = np.asarray(v)
        np.savez({json.dumps(str(out))}, **res)
        print("REF_OK")
    """)
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=600)
    assert "REF_OK" in r.stdout, r.stderr[-3000:]
    return dict(np.load(out))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_a2a_is_the_references(tmp_path, shape, cf):
    """The all-to-all dispatch over the model group against the
    reference's shard_map dispatch: the output, aux and every gradient
    (the router's, fed different tokens on each model rank, among them)
    within 1e-5, with drops (1.25) and without (8.0)."""
    path, _ = inputs(tmp_path, cf)
    ref = reference_a2a(path, shape, tmp_path)
    res = spawn(tmp_path, "moe", shape, cfg="deepseek_smoke", inp=path,
                impl="a2a")
    D, M = shape
    B = ref["out"].shape[0] // D
    for r, got in enumerate(res):
        d = r // M
        rows = slice(d * B, (d + 1) * B)
        np.testing.assert_allclose(got["out"], ref["out"][rows], rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(got["gx"], ref["gx"][rows], rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(float(got["aux"]) if D == 1 else
                                   float(np.mean([x["aux"] for x in res])),
                                   float(ref["aux"]), rtol=TOL)
        for k, want in ref.items():
            if k.startswith("g_"):
                np.testing.assert_allclose(got[k], want, rtol=0,
                                           atol=TOL * max(1.0, np.abs(
                                               want).max()), err_msg=k)


def _reference_run(tmp_path, tc, steps):
    """The reference's one process on llama4-maverick's smoke config:
    its initial state saved as a checkpoint, its refresh seeds, and the
    losses of ``steps`` steps of its trainer."""
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.data import DataConfig as JDataConfig
    from repro.data import make_source as jax_make_source
    from repro.kernels.fused_ce import seed_from_key
    from repro.train import TrainerConfig as JTrainerConfig
    from repro.train import checkpoint as jax_checkpoint
    from repro.train import make_train_fns as jax_make_train_fns
    from repro.train.trainer import RNG_TAG_HESS
    from repro.train.trainer import train_loop as jax_train_loop
    cfg = dataclasses.replace(
        jax_get_config("llama4-maverick-400b-a17b", smoke=True),
        dtype="float32")
    jtc = JTrainerConfig(**tc)
    s0 = jax_make_train_fns(cfg, jtc)[0](jax.random.PRNGKey(jtc.seed))
    ck = tmp_path / "init"
    jax_checkpoint.save(str(ck), 0, s0)
    fold = jax.random.fold_in(s0.rng, RNG_TAG_HESS)
    np.savez(tmp_path / "seeds.npz", hess=np.array(
        [np.asarray(seed_from_key(jax.random.fold_in(fold, t)))
         for t in range(steps)]))
    src = JDataConfig(seq_len=16, global_batch=4, vocab_size=cfg.vocab_size)
    _, hist = jax_train_loop(cfg, jtc, jax_make_source(src), num_steps=steps)
    return ck, [h["loss"] for h in hist]


def test_llama4_smoke_trains_on_a_grid(tmp_path):
    """llama4-maverick's smoke config, (dense, MoE) groups, 3 Sophia-G
    steps with refreshes at 0 and 2 from the reference's initial state on
    its seeds: on (2, 2) and on (1, 4) the losses within rtol = atol =
    2e-4 of the reference's one process (each data rank routes its rows
    in the global batch's groups, its aux the global batch's), and the
    ranks agree on them bit for bit."""
    tc = dict(optimizer="sophia_g", peak_lr=5e-4, total_steps=64,
              warmup_steps=4, hess_interval=2, hess_subbatch=2,
              fused_attn=False, fused_loss=True, seed=0)
    ck, want = _reference_run(tmp_path, tc, 3)
    for shape in ((2, 2), (1, 4)):
        res = spawn(tmp_path, "grid", shape, cfg="llama4_smoke",
                    tc=json.dumps(tc), steps=3, ckpt_dir=ck,
                    seeds=tmp_path / "seeds.npz")
        for r in res[1:]:
            np.testing.assert_array_equal(r["loss"], res[0]["loss"])
        np.testing.assert_allclose(res[0]["loss"], want, rtol=2e-4,
                                   atol=2e-4, err_msg=str(shape))
