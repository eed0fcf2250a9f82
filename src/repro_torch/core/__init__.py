"""Optimizer substrate of the port: parameter trees, schedules, global-norm
clipping, the flat-buffer engine (every optimizer family; the reference
and the fused backends) and the GNB, Hutchinson and empirical-Fisher
estimators.  The counterpart of ``repro/core``."""
from .clipping import ClipState, clip_by_global_norm
from .engine import (BLOCK, EngineState, OptimizerEngine, ShardLayout,
                     build_layout, hessian_aware_optimizer, ravel_shards,
                     unravel_shards, write_shards)
from .estimators import (empirical_fisher_estimator_flat,
                         empirical_fisher_ghat_flat, gnb_ghat_flat_from_loss,
                         functional_loss, hutchinson_estimator,
                         hutchinson_estimator_flat,
                         subsample_batch)
from .schedule import constant, linear_warmup_cosine
from .types import (flat_tensors, global_norm, tree_leaves, tree_map,
                    tree_unflatten)
