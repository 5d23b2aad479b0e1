"""Agent loading for the port (``tpu2048/store/checkpoint.py``).

Checkpoints keep one format: the port reads what
``tpu2048.store.checkpoint.save_agent`` writes, through the
reference's own jax-free ``load_agent``, and turns the weights into a
tensor on the device asked for.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from tpu2048.config import AgentConfig
from tpu2048.store.artifacts import ArtifactStore
from tpu2048.store.checkpoint import load_agent

from ..features.canonical import is_canonical, to_dense_table
from ..features.ntuple import get_tuple_set


def from_numpy_weights(w_np: np.ndarray, device) -> torch.Tensor:
    """The reference's flat f32 table (numpy) as a tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(w_np, np.float32)).to(device)


def load_agent_dense(
    store: ArtifactStore, name: str, device
) -> Tuple[AgentConfig, torch.Tensor, Dict[str, Any]]:
    """``load_agent`` for identity-index consumers such as ``trial``:
    an agent stored in canonical-orbit form is expanded on ``device``
    to the equivalent orbit-constant dense table; any other passes
    through unchanged."""
    acfg, weights, meta = load_agent(store, name)
    w = from_numpy_weights(weights, device)
    if is_canonical(acfg):
        w = to_dense_table(get_tuple_set(acfg.n), w)
    return acfg, w, meta
