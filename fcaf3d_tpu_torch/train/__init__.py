"""Training of the port: optimizer, schedule and the train step."""
from .optim import ClipAdamW, make_optimizer, step_lr_schedule  # noqa: F401
from .trainer import create_train_state, make_train_step  # noqa: F401
