from .fcaf3d import (  # noqa: F401
    FCAF3DConfig,
    fcaf3d_nano,
    fcaf3d_scannet,
    fcaf3d_tiny,
)
from .votenet import (  # noqa: F401
    VoteNetConfig,
    votenet_sunrgbd,
    votenet_tiny,
)
