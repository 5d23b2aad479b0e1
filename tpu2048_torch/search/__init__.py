"""Batched sampled expectimax (``tpu2048/search``)."""
