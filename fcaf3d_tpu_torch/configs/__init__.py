from .fcaf3d import (  # noqa: F401
    FCAF3DConfig,
    fcaf3d_nano,
    fcaf3d_scannet,
    fcaf3d_tiny,
)
