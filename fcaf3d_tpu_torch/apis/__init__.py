from .inference import (  # noqa: F401
    inference_detector,
    inference_imvotenet,
    inference_votenet,
    init_detector,
    init_detector2d,
    init_imvotenet,
    init_votenet,
)
from .test import detections_to_numpy  # noqa: F401
from .train import train_model  # noqa: F401
