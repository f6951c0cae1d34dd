"""Training of the port: optimizer, schedule and the train step."""
from .optim import ClipAdamW, make_optimizer, step_lr_schedule  # noqa: F401
from .trainer import (  # noqa: F401
    create_train_state,
    create_votenet_train_state,
    make_train_step,
    make_votenet_train_step,
    make_votenet_v1_train_step,
)
