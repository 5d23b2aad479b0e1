"""Multi-process bring-up (``tpu2048/parallel/distributed.py``).

The data plane is ``torch.distributed``: NCCL between cards, gloo
between CPU processes.  One process drives one device (PyTorch's
idiom): rank r of a host runs on ``cuda:<r mod the host's cards>``.
This module owns the control-plane bring-up:

  * ``initialize()`` wraps ``torch.distributed.init_process_group``
    with the reference's resolution order, explicit arguments before
    the environment (COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID);
    call it once per process before building a mesh.  Without a
    coordinator it changes nothing and returns False.
  * ``global_mesh()`` builds the (data, model) mesh over all
    processes, so the same ``make_sharded_train_segment`` spans them:
    each process steps its share of the env batch and holds the weight
    table whole (``model == 1``) or its shard of it, and the TD updates
    and the shards' values are all-reduced or all-gathered by the step
    itself (``agent/td.py``, ``parallel/mesh.py``).

The reference also detects a TPU pod from its metadata and joins it
with no arguments; a CUDA host advertises no such thing, so that path
has no twin here: a multi-process run names its coordinator.

Host-side coordination above this (job registry, leases, heartbeats)
stays in ``tpu2048_torch.obs.jobs``.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..config import MeshConfig
from ..train import card_device
from .mesh import Mesh, make_mesh, set_process_device

# how long a rank waits for its peers at the rendezvous and in a
# collective before it raises instead of hanging
TIMEOUT = datetime.timedelta(minutes=10)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
    backend: Optional[str] = None,
) -> bool:
    """Bring up ``torch.distributed`` for a multi-process run.

    Resolution order: explicit args > env vars (COORDINATOR_ADDRESS /
    NUM_PROCESSES / PROCESS_ID).  ``coordinator_address`` is
    ``host:port`` (rank 0 listens there) or a full init method such as
    ``file:///path``.  ``device`` defaults to this rank's card
    (``cuda:<process_id mod the host's cards>``, made the current
    device); ``device="cpu"`` runs the rank on the CPU.  ``backend``
    None takes NCCL on a card and gloo on the CPU; ``backend="gloo"``
    with a card is the one way to put several ranks on one card (the
    collectives then stage through the host, ``parallel/mesh.py``).
    gloo is taken only when asked for or on the CPU: if NCCL fails,
    this raises.  The rank's device is recorded for ``make_mesh``.
    Returns True if distributed mode was initialized, False without a
    coordinator.  Safe to call more than once.
    """
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS"
    )
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in os.environ:
        process_id = int(os.environ["PROCESS_ID"])
    if coordinator_address is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError(
            "a coordinator needs num_processes and process_id too "
            "(NUM_PROCESSES / PROCESS_ID)")
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"backend must be None, 'nccl' or 'gloo', not "
                         f"{backend!r}")
    if device is None or torch.device(device).type == "cuda":
        if device is None and torch.cuda.is_available():
            device = f"cuda:{process_id % torch.cuda.device_count()}"
        device = card_device(device, "distributed.initialize")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        backend = backend or "nccl"
        extra = {"device_id": device} if backend == "nccl" else {}
    else:
        device = torch.device("cpu")
        if backend == "nccl":
            raise ValueError("NCCL runs between cards, not on the CPU")
        backend, extra = "gloo", {}
    method = (coordinator_address if "://" in coordinator_address
              else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=method,
                            world_size=num_processes, rank=process_id,
                            timeout=TIMEOUT, **extra)
    set_process_device(device)
    return True


def global_mesh(cfg: Optional[MeshConfig] = None, device=None) -> Mesh:
    """(data, model) mesh over all processes.  ``device`` matters only
    before ``initialize`` (a mesh of one process, see ``make_mesh``)."""
    return make_mesh(cfg, device=device)


def process_env_slice(num_envs: int) -> slice:
    """The half-open env range this process steps when every process
    lies on the data axis (``model == 1``; under a model axis, the
    mesh's ``env_slice``)."""
    p = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    per = num_envs // p
    return slice(i * per, (i + 1) * per)
