"""Training across processes: the (data, model) mesh, which leaves of
the train state are per-env, sharded along the model axis or
replicated, and the bring-up of ``torch.distributed``
(``tpu2048/parallel``)."""
