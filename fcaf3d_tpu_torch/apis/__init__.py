from .inference import inference_detector, init_detector  # noqa: F401
from .test import detections_to_numpy  # noqa: F401
from .train import train_model  # noqa: F401
