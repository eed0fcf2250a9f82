from . import checkpoint
from .train_state import TrainState, train_key
from .trainer import (TrainerConfig, check_ported, compress_seed,
                      hess_generator, hess_probe, hess_seed, make_engine,
                      make_schedule, make_train_fns, train_loop)
