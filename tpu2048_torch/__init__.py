"""tpu2048_torch — the PyTorch + CUDA port of ``tpu2048``.

A second package beside the JAX reference, module for module at the
same paths.  It imports ``torch`` and never ``jax``: tensors carry
their device, random draws come from an explicit draw source
(``draws.py``), and every Pallas kernel of the reference becomes a
CUDA kernel written for Hopper (``ops/csrc/``), built with ``nvcc``
at first use.

This slice covers greedy play of a stored agent:

    store/checkpoint.load_agent_dense -> train/trial.trial
      -> engine/fast (packed row-code engine)
      -> ops/dispatch.make_evaluator
           -> features/ntuple.feature_indices
           -> ops/kernels.eval_class (CUDA) for the 16^2..16^4 classes
           -> plain gathers for the 16^5 classes

Framework-neutral modules (``tpu2048.config``, ``tpu2048.store``,
``tpu2048.obs.logging``) are imported from the reference, not copied.
"""

__version__ = "0.1.0"
