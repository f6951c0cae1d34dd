from .detector import FCAF3D, infer_config  # noqa: F401
from .detector2d import (  # noqa: F401
    Detections2D,
    Detector2D,
    detector2d_get_bboxes,
    detector2d_loss,
    extract_bboxes_2d,
)
from .fcaf3d_head import (  # noqa: F401
    Detections,
    FcafTestConfig,
    HeadLevelOutput,
    fcaf3d_get_bboxes,
)
from .imvotenet import ImVoteNet, imvotenet_loss  # noqa: F401
from .votenet import (  # noqa: F401
    VoteDetections,
    VoteNet,
    votenet_get_bboxes,
    votenet_loss,
    votenet_targets,
)
from .votenet_v1 import (  # noqa: F401
    PartialBinBasedBBoxCoder,
    VoteNetV1,
    scannet_coder,
    sunrgbd_coder,
    votenet_v1_get_bboxes,
    votenet_v1_loss,
)
