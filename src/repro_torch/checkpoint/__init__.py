"""Atomic, hashed, async checkpoints (the port of `repro.checkpoint`)."""
from .manager import CheckpointManager, flat_to_tree, tree_to_flat  # noqa: F401
