"""Packed row-code 2048 engine on torch tensors (``tpu2048/engine``)."""
