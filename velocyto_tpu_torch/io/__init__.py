"""Loom file I/O and checkpoints for the port."""
from . import loom
from .loom import LoomConnection, connect, create

__all__ = ["loom", "connect", "create", "LoomConnection"]
