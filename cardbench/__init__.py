"""The benchmark of fcaf3d_tpu_torch on NVIDIA cards (see README.md)."""
