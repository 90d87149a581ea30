"""Utilities: printing, profiling, checkpointing, compile cache."""

from . import checkpoint, printing, profiling

__all__ = ["checkpoint", "printing", "profiling"]
