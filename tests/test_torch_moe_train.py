"""The MoE family's training held against the JAX reference trainer, for
deepseek-moe-16b's and llama4-maverick's smoke configs (fp32, the
reference's weights, batches, GNB noise seeds and Hutchinson probes passed
to the port): Sophia-G with the GNB refresh and Sophia-H with the
Hutchinson refresh (its HVP forward-over-reverse through the MoE FFN with
``torch.func``).
Each trajectory also counts the tokens whose expert set differs between
the two trainers' final weights; a token that flips must be a near tie
(its k-th and (k+1)-th router probabilities within 1e-4 of each other)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _rope_models import tcfg, trajectories
from repro.configs import get_config as jax_get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import get_model
from repro_torch.models import moe as tmoe

torch.set_num_threads(1)

NAMES = ("deepseek-moe-16b", "llama4-maverick-400b-a17b")
NEAR_TIE = 1e-4


def _cfg(arch):
    return dataclasses.replace(jax_get_config(arch, smoke=True),
                               dtype="float32")


def _routing(cfg, tparams, tokens):
    """Each MoE layer's (expert sets (T, k) sorted, gap between the k-th
    and (k+1)-th probabilities (T,)) on ``tokens`` (numpy (B, S))."""
    with torch.no_grad(), tmoe.record_routing() as calls:
        get_model(tcfg(cfg)).forward_hidden(
            tcfg(cfg), tparams, torch.from_numpy(tokens), attn_impl="full")
    out = []
    for c in calls:
        top = torch.sort(c["probs"], dim=-1, descending=True).values
        k = c["expert_idx"].shape[1]
        gap = (top[:, k - 1] - top[:, k] if k < top.shape[1]
               else torch.full_like(top[:, 0], np.inf))
        out.append((np.sort(c["expert_idx"].numpy(), axis=1), gap.numpy()))
    return out


def _expert_set_flips(cfg, s_port, s_ref, tokens):
    """The tokens whose expert set differs between the two final weights,
    with the port's gap at each; printed."""
    ref = params_from_jax(jax.tree.map(np.asarray, s_ref.params), tcfg(cfg))
    flips = []
    for (a, gap), (b, _) in zip(_routing(cfg, s_port.params, tokens),
                                _routing(cfg, ref, tokens)):
        rows = np.nonzero((a != b).any(axis=1))[0]
        flips.extend(float(gap[r]) for r in rows)
    print(f"{cfg.name}: {len(flips)} of {tokens.size} tokens route to "
          f"another expert set at some layer (gaps {flips})")
    return flips


def _hold(hist, hist_ref, a, b, s_port, s_ref):
    """The trajectory contract of tests/test_torch_train.py: losses to rtol
    1e-4 / atol 1e-5, every parameter coordinate within 2e-3 and >= 99.95%
    of them within 3e-6 + 1e-5 |a|, m and h within 2e-3."""
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [h["loss"] for h in hist_ref], rtol=1e-4,
                               atol=1e-5)
    bad = np.abs(b - a) > (3e-6 + 1e-5 * np.abs(a))
    assert bad.mean() <= 5e-4, f"{bad.sum()} / {bad.size} beyond 3e-6"
    np.testing.assert_allclose(b, a, rtol=1e-2, atol=2e-3)
    for x, y in zip(s_port.opt_state.m + s_port.opt_state.h,
                    s_ref.opt_state.m + s_ref.opt_state.h):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-2,
                                   atol=2e-3)


@pytest.mark.parametrize("over,steps,refreshes", [
    (dict(optimizer="sophia_g"), 5, 2),
    (dict(optimizer="sophia_h", estimator="hutchinson"), 3, 1)])
@pytest.mark.parametrize("arch", NAMES)
def test_trajectory_matches_reference_trainer(arch, over, steps, refreshes):
    """Sophia-G with GNB refreshes at 0 and 4 (5 steps), or Sophia-H with a
    Hutchinson refresh at 0 (3 steps), on the fused loss: the trajectory
    contract, equal refresh counts, and the expert sets of a fresh batch
    under the final weights equal but for near ties."""
    cfg = _cfg(arch)
    hist, hist_ref, a, b, s_port, s_ref = trajectories(cfg, "full", over,
                                                       steps)
    assert int(s_port.opt_state.hess_count) == \
        int(s_ref.opt_state.hess_count) == refreshes
    _hold(hist, hist_ref, a, b, s_port, s_ref)
    tokens = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32)
    flips = _expert_set_flips(cfg, s_port, s_ref, tokens)
    assert all(g < NEAR_TIE for g in flips), flips
