"""Training of the port: optimizer, schedule, the train steps and
checkpoints."""
from .optim import (  # noqa: F401
    ClipAdamW,
    constant_schedule,
    make_optimizer,
    step_lr_schedule,
)
from .trainer import (  # noqa: F401
    create_detector2d_train_state,
    create_imvotenet_train_state,
    create_train_state,
    create_votenet_train_state,
    make_detector2d_train_step,
    make_imvotenet_train_step,
    make_train_step,
    make_votenet_train_step,
    make_votenet_v1_train_step,
)
from .checkpoint import (  # noqa: F401
    latest_epoch,
    load_checkpoint,
    load_meta,
    load_params,
    restore_checkpoint,
    save_checkpoint,
    saved_epochs,
    save_meta,
)
