"""Atomic, asynchronous, keep-k checkpoints (twin of ``repro.checkpoint``)."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
