"""The numbers behind the bounds of ``tests/test_torch_rwkv.py``: on
rwkv6-7b's smoke config, the port's error against the reference and the
reference's own spread under a one-ulp move of its weights
(``_rwkv_models.ref_spread``), each over the largest element: the fp32
logits and final state at S 64 (chunked WKV) and S 40 (scan), the loss
and the worst gradient leaf on the fused and chunked loss routes; and the
bf16 logits' worst element against the reference compiled with
``REF_BF16`` and with XLA's default excess precision.  On the CPU (~1
min):

    JAX_PLATFORMS=cpu PYTHONPATH=src:tests python tests/_rwkv_ref_spread.py
"""
import dataclasses

import jax
import numpy as np
import torch

from _rope_models import tcfg
from _rwkv_models import (REF_BF16, batch, port_params, ref_params,
                          ref_spread, rwkv_cfg)
from repro.models import get_model as jax_get_model
from repro_torch.core.types import flat_tensors, tree_leaves
from repro_torch.models import get_model


def rel(got, want, spread):
    """(error, spread), each over the largest element of ``want``."""
    want = np.asarray(want, np.float32)
    big = np.abs(want).max()
    return (float(np.abs(np.asarray(got, np.float32) - want).max() / big),
            float(np.asarray(spread).max() / big))


def main():
    torch.set_num_threads(4)
    cfg = rwkv_cfg()
    params = ref_params(cfg)
    tparams = port_params(cfg, params)
    for S in (64, 40):
        jb, tb = batch(cfg, S=S)
        fwd = jax.jit(lambda p: jax_get_model(cfg).forward(cfg, p,
                                                           jb["tokens"]))
        (want, _, wstate), (spread, _, sstate) = ref_spread(fwd, params)
        with torch.no_grad():
            got, _, state = get_model(tcfg(cfg)).forward(
                tcfg(cfg), tparams, tb["tokens"])
        print(f"fp32 S {S}: logits (error, spread) "
              f"{rel(got.numpy(), want, spread)}; state "
              + ", ".join(f"{k} {rel(state[k].numpy(), wstate[k], sstate[k])}"
                          for k in wstate))
        c16 = dataclasses.replace(cfg, dtype="bfloat16")
        jb16, tb16 = batch(c16, S=S)
        with torch.no_grad():
            got16 = get_model(tcfg(c16)).forward(
                tcfg(c16), tparams, tb16["tokens"])[0].float().numpy()
        for name, opts in (("REF_BF16", REF_BF16), ("excess precision", None)):
            want16 = np.asarray(jax.jit(
                lambda p: jax_get_model(c16).forward(c16, p, tb16["tokens"]
                                                     .numpy())[0],
                compiler_options=opts)(params))
            err = np.abs(got16 - want16).max(-1) / np.abs(want16).max()
            print(f"bf16 S {S}, reference with {name}: worst element "
                  f"{err.max():.3g} of the largest logit, at (row, token) "
                  f"{tuple(int(i) for i in np.unravel_index(err.argmax(), err.shape))}")
    for impl in ("fused", "chunked"):
        jb, tb = batch(cfg)
        vg = jax.jit(lambda p: jax.value_and_grad(
            lambda q: jax_get_model(cfg).loss_fn(cfg, q, jb,
                                                 loss_impl=impl)[0])(p))
        (jloss, jgrads), (_, sgrads) = ref_spread(vg, params)
        loss, _ = get_model(tcfg(cfg)).loss_fn(tcfg(cfg), tparams, tb,
                                               loss_impl=impl)
        tree = tparams.param_tree()
        it = iter(torch.autograd.grad(loss, flat_tensors(tree)))
        worst = []
        for leaf, want, spread, (path, _) in zip(
                tree_leaves(tree), jax.tree.leaves(jgrads),
                jax.tree.leaves(sgrads),
                jax.tree_util.tree_flatten_with_path(jgrads)[0]):
            g = (torch.stack([next(it) for _ in leaf])
                 if isinstance(leaf, list) else next(it))
            worst.append(rel(g.numpy(), want, spread)
                         + (jax.tree_util.keystr(path),))
        worst.sort(reverse=True)
        print(f"{impl} loss: relative error "
              f"{abs(loss.item() - float(jloss)) / abs(float(jloss)):.3g}; "
              f"the worst gradient leaves (error, spread, leaf) {worst[:3]}")


if __name__ == "__main__":
    main()
