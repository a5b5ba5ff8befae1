"""Shard-aware checkpoints (``manager.CheckpointManager``)."""
