"""PointNet++ and sparse-voxel ops of the reference, plain PyTorch."""
