"""Training loop, Algorithm 3 with the refresh at ``t % k == 0``: the
counterpart of ``repro/train/trainer.py`` for every optimizer of the
paper's comparison (Sophia-G and Sophia-H, AdamW, Lion, SignGD, SGD,
AdaHessian) and the GNB, Hutchinson and empirical-Fisher estimators, on
every training-attention route (flash attention with ``fused_attn``, the
default; ``attn_impl`` "full" or "chunked"), both loss routes (the
logits-free fused CE with ``fused_loss``, the default, else the plain
chunked sweep), every remat policy and, with ``fused_kernel``, the engine
kernels.

Every step:
  grad accumulation over microbatches -> global-norm clip (threshold 1.0,
  trigger telemetry) -> ravel to flat fp32 shards -> engine update.
On a refresh step of a hessian-aware optimizer (Sophia, AdaHessian) the
engine update is ``step_with_refresh``: before it, the estimate is taken
on the first ``hess_subbatch`` rows of the batch from the pre-update
parameters and folds into the Hessian EMA with its scale.
  * GNB with ``fused_loss`` draws ŷ inside the fused CE forward sweep and
    takes ĝ by autograd, B = the sweep's valid-position count; without it,
    the sub-batch's logits are materialized (``logits_fn``) and one chunked
    sweep draws ŷ and forms the log-sum-exp (``gnb_ghat_flat``), B = the
    valid positions.  ĝ is squared in flat space.
  * Hutchinson takes u ⊙ Hu forward-over-reverse (``torch.func.jvp`` of
    ``torch.func.grad`` of the loss as a function of the parameters)
    through the loss twin ("fused_jvp", or the chunked loss without
    ``fused_loss``) and the attention twin ("flash_jvp"), scale 1.  Its
    trunk runs without remat: ``torch.utils.checkpoint`` does not compose
    with ``torch.func`` (the reference remats there; remat changes memory,
    not values).
  * The empirical Fisher squares the true-label gradient, B = the
    sub-batch's positions.
The reference makes this one compiled program under a traced flag; the
port runs eagerly and branches in Python on the same flag.

The state's ``rng`` is the reference's key, ``split(PRNGKey(seed))[1]``
(``train_state.train_key``), so that the two packages' checkpoints carry
the same leaf.  The reference draws the refresh's randomness from its JAX
key stream (``fold_in(fold_in(rng, RNG_TAG_HESS), step)``), which PyTorch
cannot reproduce; the port derives its own from ``(rng, RNG_TAG_HESS,
step)`` with numpy, the key's two words as the seed: GNB's noise seed of
the fused sweep (:func:`hess_seed`), and a ``torch.Generator`` seeded from
it (:func:`hess_generator`) for Hutchinson's probe (:func:`hess_probe`) and
the Gumbel noise of the chunked GNB sweep.  A restored key (the port's or
the reference's) continues that stream.  ``hess_seed_fn(step)``,
``probe_fn(step, layout)`` and ``noise_fn(step, shape)`` replace those
draws; the parity tests use them to pass in the reference's.

Options of the reference trainer this slice does not port raise
``NotImplementedError`` (:func:`check_ported`).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..core import (OptimizerEngine, clip_by_global_norm, constant,
                    empirical_fisher_estimator_flat, functional_loss,
                    gnb_ghat_flat, gnb_ghat_flat_from_loss,
                    hessian_aware_optimizer, hutchinson_estimator_flat,
                    linear_warmup_cosine, subsample_batch)
from ..core.types import flat_tensors, tree_unflatten
from ..models import ModelConfig, get_model
from ..models.layers import TRAIN_ATTN_IMPLS
from ..models.transformer import REMATS
from ..serve.engine import resolve_device
from .train_state import TrainState, train_key

RNG_TAG_HESS = 1           # estimator label sampling (the reference's tag)
ESTIMATORS = ("gnb", "hutchinson", "empirical_fisher")


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    optimizer: str = "sophia_g"
    peak_lr: float = 4e-4
    total_steps: int = 10_000
    warmup_steps: int = 2_000
    schedule: str = "cosine"           # cosine | constant
    weight_decay: float = 0.2
    beta1: float = 0.96
    beta2: float = 0.99
    gamma: float = 0.05
    eps: float = 1e-12
    hess_interval: int = 10            # k in Algorithm 3
    hess_subbatch: int = 240           # paper: 240/480 (G)
    estimator: str = "gnb"
    grad_clip: float = 1.0
    clip_threshold: float = 1.0        # Sophia rho
    grad_accum: int = 1
    remat: str = "none"                # none | full | dots | scan2
    attn_impl: str = "auto"
    fused_attn: bool = True            # flash attention (rows 16-18) while
    #                                    attn_impl is "auto"; False trains
    #                                    on the materialized-scores route
    fused_kernel: bool = False         # engine kernels (rows 2-10):
    #                                    the engine's "fused" backend
    fused_loss: bool = True            # the logits-free fused CE kernels;
    #                                    False: the plain chunked sweep
    compress_grads: bool = False
    compress_hess: bool = False
    comm_telemetry: bool = False
    state_dtype: str = "float32"       # optimizer m/h dtype
    seed: int = 0


def check_ported(tc: TrainerConfig) -> None:
    """Raise ``NotImplementedError`` for an option this slice does not
    port (gradient and estimator compression, communication telemetry),
    rather than quietly running something else, and ``ValueError`` for an
    unknown one."""
    refused = {"compress_grads": tc.compress_grads,
               "compress_hess": tc.compress_hess,
               "comm_telemetry": tc.comm_telemetry}
    bad = [name for name, hit in refused.items() if hit]
    if bad:
        raise NotImplementedError(
            "not ported yet (the port trains on one device, without "
            f"compression): {', '.join(bad)}")
    if tc.attn_impl not in TRAIN_ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {tc.attn_impl!r}")
    if tc.remat not in REMATS:
        raise ValueError(f"unknown remat {tc.remat!r} (one of {REMATS})")
    if tc.state_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"state_dtype {tc.state_dtype!r}")
    if tc.estimator not in ESTIMATORS:
        raise ValueError(f"unknown estimator {tc.estimator!r}")


def make_schedule(tc: TrainerConfig):
    if tc.schedule == "constant":
        return constant(tc.peak_lr)
    return linear_warmup_cosine(tc.peak_lr, tc.total_steps, tc.warmup_steps)


def make_engine(tc: TrainerConfig) -> OptimizerEngine:
    """Engine for ``tc.optimizer`` with the paper's per-optimizer hypers
    (the reference's table, ``trainer.py:133-155``), on the ``fused``
    backend (the engine kernels) with ``tc.fused_kernel`` and the
    ``reference`` backend without."""
    name = tc.optimizer
    if name in ("sophia_g", "sophia_h"):
        hypers = dict(beta1=tc.beta1, beta2=tc.beta2, gamma=tc.gamma,
                      eps=tc.eps, weight_decay=tc.weight_decay,
                      clip_threshold=tc.clip_threshold)
    elif name == "adamw":
        hypers = dict(beta1=0.9, beta2=0.95, eps=1e-8,
                      weight_decay=tc.weight_decay)
    elif name == "lion":
        hypers = dict(beta1=0.95, beta2=0.98, weight_decay=tc.weight_decay)
    elif name == "signgd":
        hypers = dict(beta1=tc.beta1, weight_decay=tc.weight_decay)
    elif name == "adahessian":
        hypers = dict(beta1=0.92, beta2=0.99, eps=1e-8,
                      weight_decay=tc.weight_decay)
    elif name == "sgd":
        hypers = dict(momentum=0.0)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    sdt = torch.bfloat16 if tc.state_dtype == "bfloat16" else torch.float32
    return OptimizerEngine(tc.optimizer, hypers=hypers,
                           backend="fused" if tc.fused_kernel
                           else "reference", state_dtype=sdt)


def _stream(rng, step: int) -> np.random.Generator:
    """numpy's generator of the refresh at ``step``, seeded with ``(rng,
    RNG_TAG_HESS, step)``; ``rng`` an int seed or a key's two words."""
    words = tuple(int(w) for w in np.atleast_1d(np.asarray(rng)))
    return np.random.default_rng(words + (RNG_TAG_HESS, step))


def hess_seed(rng, step: int):
    """The port's noise seed of the refresh at ``step``: two uint32 values
    from numpy's generator seeded with ``(rng, RNG_TAG_HESS, step)``,
    ``rng`` an int seed or the state's key words."""
    bits = _stream(rng, step).integers(0, 1 << 32, size=2, dtype=np.uint64)
    return int(bits[0]), int(bits[1])


def hess_generator(rng, step: int, device) -> torch.Generator:
    """The port's generator of the refresh at ``step``: a
    ``torch.Generator`` on ``device`` seeded from numpy with ``(rng,
    RNG_TAG_HESS, step)``."""
    gen_seed = int(_stream(rng, step).integers(0, 1 << 63, dtype=np.int64))
    return torch.Generator(device=device).manual_seed(gen_seed)


def hess_probe(rng, step: int, layout, device):
    """The port's Hutchinson probe u ~ N(0, I) of the refresh at ``step``:
    one fp32 draw per flat shard (as the reference draws it, per shard)
    from :func:`hess_generator`."""
    gen = hess_generator(rng, step, device)
    return tuple(torch.randn((n,), generator=gen, dtype=torch.float32,
                             device=device) for n in layout.shard_sizes)


def to_device_batch(batch: dict, device) -> dict:
    return {key: torch.as_tensor(np.asarray(value)).to(device)
            for key, value in batch.items()}


def make_train_fns(cfg: ModelConfig, tc: TrainerConfig, *, device=None,
                   hess_seed_fn: Optional[Callable] = None,
                   probe_fn: Optional[Callable] = None,
                   noise_fn: Optional[Callable] = None):
    """Returns ``(init_fn, train_step)``.  ``hess_seed_fn(step)`` replaces
    GNB's noise seed of the fused sweep, ``probe_fn(step, layout)``
    Hutchinson's probe shards (:func:`hess_seed`, :func:`hess_probe`) and
    ``noise_fn(step, shape)`` the Gumbel noise of the chunked GNB sweep
    (``fused_loss=False``): the whole (B, S, Vp) tensor of the sub-batch's
    logits, in place of draws from :func:`hess_generator` on the state's
    key.

    ``init_fn(params=None) -> TrainState``: random parameters from a
    ``torch.Generator`` seeded with ``tc.seed`` on the device, or the given
    ``Transformer``; the key ``train_key(tc.seed)``.
    ``train_step(state, batch, do_refresh) -> (state, metrics)``: one step
    on a batch of device tensors; the parameters are updated in place."""
    check_ported(tc)
    device = resolve_device(device)
    model = get_model(cfg)
    engine = make_engine(tc)
    schedule = make_schedule(tc)
    clipper = clip_by_global_norm(tc.grad_clip)
    # fused_attn applies only while attn_impl is "auto"; an explicit impl
    # wins (the reference's mapping, trainer.py:216-221)
    attn_impl = (tc.attn_impl if tc.attn_impl != "auto"
                 else ("flash" if tc.fused_attn else "auto"))
    # the HVP differentiates twice (forward over reverse): it takes the
    # attention and loss twins, as the reference does (trainer.py:222,278)
    hvp_attn_impl = "flash_jvp" if attn_impl == "flash" else attn_impl
    loss_impl = "fused" if tc.fused_loss else "chunked"
    hvp_loss_impl = "fused_jvp" if tc.fused_loss else "chunked"

    def init_fn(params=None) -> TrainState:
        if params is None:
            gen = torch.Generator(device=device).manual_seed(tc.seed)
            params = model.init_params(cfg, gen)
        tree = params.param_tree()
        return TrainState(step=0, params=params, opt_state=engine.init(tree),
                          clip_state=clipper.init(tree),
                          rng=train_key(tc.seed))

    def grads_of(params, batch):
        """(loss, metrics, grads as a flat tensor list): the mean over
        ``tc.grad_accum`` microbatches."""
        tensors = flat_tensors(params.param_tree())
        n = tc.grad_accum
        micro = ([batch] if n <= 1 else
                 [{k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
                   for k, v in batch.items()} for i in range(n)])
        loss_sum, met_sum, g_sum = None, None, None
        for mb in micro:
            loss, met = model.loss_fn(cfg, params, mb, attn_impl=attn_impl,
                                      remat=tc.remat, loss_impl=loss_impl)
            g = torch.autograd.grad(loss, tensors)
            loss = loss.detach()
            met = {k: v.detach() for k, v in met.items()}
            if loss_sum is None:
                loss_sum, met_sum, g_sum = loss, met, list(g)
            else:
                loss_sum = loss_sum + loss
                met_sum = {k: met_sum[k] + met[k] for k in met}
                g_sum = [a + b for a, b in zip(g_sum, g)]
        if n <= 1:
            return loss_sum, met_sum, g_sum
        inv = 1.0 / n
        return (loss_sum * inv, {k: v * inv for k, v in met_sum.items()},
                [g * inv for g in g_sum])

    def estimate_flat(params, batch, step, rng):
        """(estimate shards, scale) on the estimator sub-batch, dispatched
        on ``tc.estimator`` (the reference's ``_estimate_flat``), with the
        refresh's randomness from the key ``rng``."""
        tree = params.param_tree()
        lay = engine.layout(tree)
        sub = (subsample_batch(batch, tc.hess_subbatch) if tc.hess_subbatch
               else batch)
        if tc.estimator == "gnb" and tc.fused_loss:
            def sampled_loss():
                seed = (hess_seed_fn(step) if hess_seed_fn
                        else hess_seed(rng, step))
                return model.sampled_loss_fn(cfg, params, sub, seed,
                                             attn_impl=attn_impl,
                                             remat=tc.remat)

            g_sh, scale = gnb_ghat_flat_from_loss(sampled_loss, tree, lay)
            return tuple(g * g for g in g_sh), scale
        if tc.estimator == "gnb":
            # the sub-batch's logits materialized, one chunked sweep
            def logits(_):
                return model.logits_fn(cfg, params, sub, attn_impl=attn_impl,
                                       remat=tc.remat)

            shape = tuple(sub["tokens"].shape) + (cfg.padded_vocab,)
            noise = noise_fn(step, shape) if noise_fn else None
            gen = (None if noise_fn else
                   hess_generator(rng, step, device))
            g_sh, scale = gnb_ghat_flat(logits, tree, gen, lay,
                                        mask=sub.get("mask"), noise=noise)
            return tuple(g * g for g in g_sh), scale
        if tc.estimator == "hutchinson":
            # no remat under torch.func (see the module docstring)
            loss = functional_loss(
                params, flat_tensors(tree),
                lambda m: model.loss_fn(cfg, m, sub, attn_impl=hvp_attn_impl,
                                        remat="none",
                                        loss_impl=hvp_loss_impl)[0])
            probe = (probe_fn(step, lay) if probe_fn
                     else hess_probe(rng, step, lay, device))
            return hutchinson_estimator_flat(loss, tree, probe, lay), 1.0
        # empirical Fisher: B counts the sub-batch's positions
        def loss():
            return model.loss_fn(cfg, params, sub, attn_impl=attn_impl,
                                 remat=tc.remat, loss_impl=loss_impl)[0]

        lead = sub[sorted(sub)[0]]
        n = lead.shape[0] * (lead.shape[1] if lead.dim() > 1 else 1)
        return empirical_fisher_estimator_flat(loss, tree, lay), float(n)

    def train_step(state: TrainState, batch, do_refresh=False):
        """One step (Algorithm 3 lines 6-13, the refresh on the flag)."""
        params = state.params
        tree = params.param_tree()
        loss, metrics, g_flat = grads_of(params, batch)
        grads, clip_state = clipper.update(tree_unflatten(tree, g_flat),
                                           state.clip_state)
        del g_flat
        g_sh = engine.ravel_grads(tree, grads)
        # the shards carry the gradient from here: the trees go before the
        # refresh and the update allocate theirs (two parameter-sized
        # buffers, ~12 GB at 1.5 B parameters)
        del grads
        lr = schedule(state.opt_state.count)
        if do_refresh and engine.hessian_aware:
            est_sh, scale = estimate_flat(params, batch, state.step,
                                          state.rng)
            _, opt_state = engine.step_with_refresh(
                state.opt_state, tree, g_sh, lr, est_sh, scale, True)
        else:
            _, opt_state = engine.step_shards(state.opt_state, tree, g_sh,
                                              lr)
        metrics = dict({"loss": loss}, **metrics,
                       grad_norm=clip_state.last_norm,
                       clip_triggers=clip_state.triggers, lr=lr)
        if engine.tracks_clip_fraction:
            metrics["sophia_clip_fraction"] = opt_state.clip_fraction
        return TrainState(step=state.step + 1, params=params,
                          opt_state=opt_state, clip_state=clip_state,
                          rng=state.rng), metrics

    return init_fn, train_step


def train_loop(cfg: ModelConfig, tc: TrainerConfig, source, *,
               num_steps: int, state: Optional[TrainState] = None,
               device=None, hess_seed_fn: Optional[Callable] = None,
               probe_fn: Optional[Callable] = None,
               noise_fn: Optional[Callable] = None,
               callback: Optional[Callable] = None, start_step: int = 0):
    """Single-process loop: the batch of step t from ``source.batch_at(t)``
    and the refresh at ``t % hess_interval == 0``.  Returns ``(state,
    history)``, the history one dict of floats per step."""
    device = resolve_device(device)
    init_fn, train_step = make_train_fns(cfg, tc, device=device,
                                         hess_seed_fn=hess_seed_fn,
                                         probe_fn=probe_fn,
                                         noise_fn=noise_fn)
    if state is None:
        state = init_fn()
    needs_hess = hessian_aware_optimizer(tc.optimizer)
    history = []
    for t in range(start_step, start_step + num_steps):
        batch = to_device_batch(source.batch_at(t), device)
        state, metrics = train_step(state, batch,
                                    needs_hess and t % tc.hess_interval == 0)
        history.append({k: float(v) for k, v in metrics.items()})
        if callback is not None:
            callback(t, state, metrics)
    return state, history
