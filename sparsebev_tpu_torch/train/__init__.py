from .optim import build_optimizer, cosine_warmup_schedule  # noqa: F401
from .step import (TrainState, create_train_state, make_multi_step,  # noqa: F401
                   make_train_step)
