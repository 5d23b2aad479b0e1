"""Agent loading for the port (``tpu2048/store/checkpoint.py``).

Checkpoints keep one format: the port reads what
``tpu2048.store.checkpoint.save_agent`` writes, through the
reference's own jax-free ``load_agent``, and turns the weights into a
tensor on the device asked for.  ``td_state_from_numpy`` does the same
for a whole train state of the reference, so both packages can step
one state.
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


def td_state_from_numpy(state, device):
    """The reference's ``TDState`` (any arrays ``np.asarray`` takes,
    e.g. a JAX state) as the port's ``agent.td.TDState`` on
    ``device``.  Its RNG key has no torch twin and is left out: the
    port draws from a draw source.  The recorder's logs gain the
    port's zeroed spill column."""
    from ..agent import td
    from ..engine.fast import EnvStateC

    def t(x):
        return torch.from_numpy(np.array(x)).to(device)

    def logs(x):
        x = np.asarray(x)
        return t(np.concatenate([x, np.zeros_like(x[:, :1])], axis=1))

    rec = state.recorder
    return td.TDState(
        weights=t(state.weights), opt_e=t(state.opt_e),
        opt_a=t(state.opt_a), alpha=t(state.alpha),
        next_decay=t(state.next_decay), top_tile=t(state.top_tile),
        env=EnvStateC(*(t(x) for x in state.env)),
        prev_idx=t(state.prev_idx), prev_value=t(state.prev_value),
        prev_valid=t(state.prev_valid),
        metrics=td.Metrics(*(t(x) for x in state.metrics)),
        recorder=td.Recorder(
            moves=logs(rec.moves), spawns=logs(rec.spawns),
            **{f: t(getattr(rec, f)) for f in td.Recorder._fields[2:]}),
        prev_cidx=t(state.prev_cidx), prev_cmult=t(state.prev_cmult),
    )
