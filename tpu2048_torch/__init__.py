"""tpu2048_torch — the PyTorch + CUDA port of ``tpu2048``.

A second package beside the JAX reference, module for module at the
same paths.  It imports ``torch`` and never ``jax``: tensors carry
their device, random draws come from an explicit draw source
(``draws.py``), and every Pallas kernel of the reference becomes a
CUDA kernel written for Hopper (``ops/csrc/``), built with ``nvcc``
at first use.

Three paths are ported.  Greedy play of a stored agent:

    store/checkpoint.load_agent_dense -> train/trial.trial
      -> engine/fast (packed row-code engine)
      -> ops/dispatch.make_evaluator
           -> features/ntuple.feature_indices
           -> ops/kernels.eval_class (CUDA) for the 16^2..16^4 classes
           -> plain gathers for the 16^5 classes

and training on one device, at the shipped configuration:

    train/loop.Trainer -> agent/td.make_train_segment -> make_train_step
      -> ops/dispatch.make_train_evaluator (eval_class, bf16) and
         make_mxu_eval_idx (eval_class, exact bootstrap)
      -> ops/dispatch.make_class_grads (grad_class) -> ops/kernels.fold_class
         -> the class block's temporal-coherence update
      -> the crosses' sparse update at canonical-orbit indices
      -> spawn, metrics rings, auto-reset, staged recorder rows

and at every other learner setting of ``AgentConfig`` (the sgd rule
and its alpha schedule, "sum" updates, "fold", "index", "periodic"
and "none" symmetry, the "bf16x2" actor, the cells engine), whose
whole-table updates go through ``ops/dispatch.make_delta_accumulator``
and ``make_updater`` (``grad_class`` for the 16^2..16^4 classes),

and expectimax search through ``trial(search=SearchConfig(depth>0))``.

The apps drive these paths as the reference's users drive them:

    apps/server.AppServer (HTTP, the page of apps/webui) -> apps/service
      .AppService jobs: train -> train/loop.Trainer; test and the
      "device" watch -> train/trial.trial (on the card by default)

The port imports nothing of ``tpu2048``: what it needs of the
reference's framework-neutral modules has its own copy here
(``config.py``, ``store/``, ``obs/``, ``engine/parity.py``, ``native/``
and the apps' shared parts), held equal to the original by
``tests/test_torch_shared.py``, so checkpoints cross both ways.
"""

__version__ = "0.1.0"
