"""Parameter-tree utilities and the model-FLOP counter of the port."""
from .flops import flop_counter, record_flops  # noqa: F401
