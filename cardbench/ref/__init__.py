"""The plain PyTorch reference of the benchmark: FCAF3D and VoteNet-v2
forward, loss, backward and AdamW, and FCAF3D post-processing, frozen
from the port's plain paths with the kernel dispatch removed. It imports
nothing of the port."""
