"""The training step's model FLOPs (``counts.train_model_flops``) times the
window's steps, over the window's host-clock seconds, as a share of the
H100's bf16 peak (989 TFLOP/s, at 700 W)."""
from cbench.readers import train_mfu as read  # noqa: F401
