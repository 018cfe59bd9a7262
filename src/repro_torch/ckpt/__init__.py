from .checkpointer import Checkpointer, CheckpointError
from .manager import CheckpointManager

__all__ = ["CheckpointError", "CheckpointManager", "Checkpointer"]
