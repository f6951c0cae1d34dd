"""Sparse voxel engine: sorted coordinate maps, kernel maps, gather-GEMM."""
from .conv import (  # noqa: F401
    ConvEpilogue,
    build_kernel_map,
    build_kernel_map_self,
    conv_plan,
    gather_gemm,
    gather_gemm_inference,
    kernel_offsets,
    sparse_conv,
    sparse_max_pool,
)
from .tensor import (  # noqa: F401
    EXTENT,
    SENTINEL,
    SparseTensor,
    compact_positions,
    compact_unique,
    decode_coords,
    downsample_coords,
    encode_coords,
    lookup,
    sort_rows,
    take_rows,
    voxelize,
)
