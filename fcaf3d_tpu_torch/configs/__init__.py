from .fcaf3d import (  # noqa: F401
    FCAF3DConfig,
    config_from_dict,
    fcaf3d_nano,
    fcaf3d_s3dis,
    fcaf3d_scannet,
    fcaf3d_scannet_2scales,
    fcaf3d_scannet_3scales,
    fcaf3d_sunrgbd,
    fcaf3d_tiny,
)
from .override import add_set_argument, apply_overrides  # noqa: F401
from .votenet import (  # noqa: F401
    VoteNetConfig,
    votenet_sunrgbd,
    votenet_tiny,
    votenet_v1_scannet,
    votenet_v1_sunrgbd,
)
