"""The TD(0) n-tuple actor-learner on torch tensors (``tpu2048/agent``)."""
