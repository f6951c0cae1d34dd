"""Host-side data of the port: the JAX package's datasets, pipelines and
loader (numpy copies, held equal to them by tests), the camera calibration
of the ImVoteNet path and the synthetic scenes of the tests and the
smoke run."""
from .calib import sunrgbd_depth2img  # noqa: F401
from .datasets import (  # noqa: F401
    S3DIS_CLASSES,
    SCANNET_CLASSES,
    SUNRGBD_CLASSES,
    ConcatDataset,
    IndoorDetDataset,
    RepeatDataset,
    build_s3dis,
    build_scannet,
    build_sunrgbd,
)
from .loader import Loader, collate  # noqa: F401
from .pipelines import (  # noqa: F401
    Compose,
    GlobalAlignment,
    GlobalRotScaleTrans,
    ObjectNameFilter,
    PointSample,
    PointShuffle,
    PointsRangeFilter,
    RandomDropPointsColor,
    RandomFlip,
    RandomJitterPoints,
    ShiftHeight,
)
