"""The optimizer's kernel on the card: K8, the global-norm clip and AdamW
over every leaf of a train state."""
from .clip_adamw import ClipAdamWKernel  # noqa: F401
