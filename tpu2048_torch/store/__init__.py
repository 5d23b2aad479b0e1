"""Checkpoints of the port: the reference's format, torch tensors out."""
