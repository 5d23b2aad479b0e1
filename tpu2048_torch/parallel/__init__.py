"""Data-parallel training across processes: the mesh, which leaves of
the train state are per-env and which replicated, and the bring-up of
``torch.distributed`` (``tpu2048/parallel``)."""
