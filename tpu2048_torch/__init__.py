"""tpu2048_torch — the PyTorch + CUDA port of ``tpu2048``.

A second package beside the JAX reference, module for module at the
same paths.  It imports ``torch`` and never ``jax``: tensors carry
their device, random draws come from an explicit draw source
(``draws.py``), and every Pallas kernel of the reference becomes a
CUDA kernel written for Hopper (``ops/csrc/``), built with ``nvcc``
at first use.

Two paths are ported.  Greedy play of a stored agent:

    store/checkpoint.load_agent_dense -> train/trial.trial
      -> engine/fast (packed row-code engine)
      -> ops/dispatch.make_evaluator
           -> features/ntuple.feature_indices
           -> ops/kernels.eval_class (CUDA) for the 16^2..16^4 classes
           -> plain gathers for the 16^5 classes

and training at the shipped configuration on one device:

    train/loop.Trainer -> agent/td.make_train_segment -> make_train_step
      -> ops/dispatch.make_train_evaluator (eval_class, bf16) and
         make_mxu_eval_idx (eval_class, exact bootstrap)
      -> ops/dispatch.make_class_grads (grad_class) -> ops/kernels.fold_class
         -> the class block's temporal-coherence update
      -> the crosses' sparse update at canonical-orbit indices
      -> spawn, metrics rings, auto-reset, staged recorder rows

Framework-neutral modules (``tpu2048.config``, ``tpu2048.store``,
``tpu2048.obs``) are imported from the reference, not copied.
"""

__version__ = "0.1.0"
