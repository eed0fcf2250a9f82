"""Optimizer substrate of the port: the counterpart of ``repro/core``.

Public API:
    sophia, sophia_h, sophia_g          — Algorithm 3, per leaf of a tree
    OptimizerEngine, EngineState        — the flat-buffer engine (the
                                          trainer's one update path; the
                                          engine kernels or plain PyTorch
                                          over flat shards)
    hutchinson_estimator, gnb_estimator — Section 2.3 estimators (tree and
                                          flat forms)
    adamw, lion, signgd, adahessian     — the paper's baselines
    clip_by_global_norm                 — stability telemetry (Fig 7a)
    linear_warmup_cosine                — the paper's lr protocol
"""
from .types import (EmptyState, GradientTransformation,
                    HessianAwareTransformation, apply_updates, chain,
                    flat_tensors, global_norm, tree_leaves, tree_map,
                    tree_unflatten, tree_zeros_like)
from .sophia import (SophiaState, add_decayed_weights, scale_by_learning_rate,
                     scale_by_sophia, sophia, sophia_g, sophia_h)
from .estimators import (chunked_sampled_stats, empirical_fisher_estimator,
                         empirical_fisher_estimator_flat,
                         empirical_fisher_ghat_flat, exact_diag_hessian,
                         functional_loss, gnb_estimator, gnb_estimator_sq,
                         gnb_estimator_sq_flat, gnb_ghat_flat,
                         gnb_ghat_flat_from_loss, hutchinson_estimator,
                         hutchinson_estimator_flat, sample_labels,
                         subsample_batch)
from .baselines import adahessian, adamw, lion, sgd, signgd
from .engine import (BLOCK, EngineState, OptimizerEngine, ShardLayout,
                     build_layout, hessian_aware_optimizer, ravel_shards,
                     unravel_shards, write_shards)
from .clipping import ClipState, clip_by_global_norm, clip_trigger_rate
from .schedule import (constant, inverse_sqrt, linear_warmup_cosine,
                       linear_warmup_linear_decay)

OPTIMIZERS = {
    "sophia_h": sophia_h,
    "sophia_g": sophia_g,
    "adamw": adamw,
    "lion": lion,
    "signgd": signgd,
    "adahessian": adahessian,
    "sgd": sgd,
}
