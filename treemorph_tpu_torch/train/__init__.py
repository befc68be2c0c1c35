from .schedule import cosine_annealing_warm_restarts
from .harness import (
    TrainState,
    make_accum_steps,
    make_eval_step,
    make_optimizer,
    make_train_step,
    optimizer_step,
    run_training,
)

__all__ = [
    "cosine_annealing_warm_restarts",
    "TrainState",
    "make_accum_steps",
    "make_optimizer",
    "make_train_step",
    "make_eval_step",
    "optimizer_step",
    "run_training",
]
