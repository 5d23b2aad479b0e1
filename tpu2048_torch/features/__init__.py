"""N-tuple features, D4 symmetry and canonical-orbit form on torch
tensors (``tpu2048/features``)."""
