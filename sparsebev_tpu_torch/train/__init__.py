from .optim import build_optimizer, cosine_warmup_schedule  # noqa: F401
from .step import (StepGroups, TrainState, create_train_state,  # noqa: F401
                   data_parallel_groups, hybrid_step_groups, make_multi_step,
                   make_train_step)
