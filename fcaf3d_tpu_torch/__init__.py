"""fcaf3d_tpu_torch: the PyTorch/CUDA port of `fcaf3d_tpu`.

FCAF3D inference and single-card training on one NVIDIA Hopper GPU
(ScanNet 18-class, HDResNet34, 4 scales, prune-early neck). The package
mirrors `fcaf3d_tpu`'s layout and names and is held against it by
`tests/test_torch_*.py`. It imports torch and never jax; its configs are
copies of `fcaf3d_tpu.configs`, held equal by a test.

The four kernels of the path are hand-written CUDA C++ in `csrc/`, built
with nvcc at first use (`_native.py`); on CPU tensors each wrapper runs its
plain PyTorch version instead.
"""

__version__ = "0.2.0"
