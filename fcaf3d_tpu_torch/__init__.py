"""fcaf3d_tpu_torch: the PyTorch/CUDA port of `fcaf3d_tpu`.

FCAF3D inference and training on NVIDIA Hopper GPUs, one card or data
parallel over `torch.distributed` (`parallel/`), with VoteNet and
ImVoteNet beside it. The package mirrors `fcaf3d_tpu`'s layout and names
and is held against it by `tests/test_torch_*.py`. It imports torch and
never jax; its configs are copies of `fcaf3d_tpu.configs`, held equal by a
test.

The four kernels of the path are hand-written CUDA C++ in `csrc/`, built
with nvcc at first use (`_native.py`); on CPU tensors each wrapper runs its
plain PyTorch version instead.
"""

__version__ = "0.2.0"
