"""Agent and game checkpoints of the port (``tpu2048/store/checkpoint.py``).

Checkpoints keep one format, so an agent or a game saved by either
package loads in the other: metadata under ``a/<name>.json``, the
weight table and its extras (TC accumulators, generator state) under
``weights/<name>.npz``, game records under ``g/<name>.npz``.
``agent_key`` .. ``load_game`` are copies of the reference's;
``load_agent_dense`` turns the weights into a tensor on the device
asked for, and ``td_state_from_numpy`` does the same for a whole train
state of the reference, so both packages can step one state.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import AgentConfig, agent_config_from_dict, to_dict
from ..features.canonical import is_canonical, to_dense_table
from ..features.ntuple import get_tuple_set
from .artifacts import ArtifactStore


def agent_key(name: str) -> str:
    return f"a/{name}.json"


def weights_key(name: str) -> str:
    return f"weights/{name}.npz"


def game_key(name: str) -> str:
    return f"g/{name}.npz"


def save_agent(
    store: ArtifactStore,
    name: str,
    acfg: AgentConfig,
    weights: np.ndarray,
    meta: Optional[Dict[str, Any]] = None,
    extras: Optional[Dict[str, np.ndarray]] = None,
) -> None:
    """Atomic two-part save: JSON metadata + npz weights.

    ``extras`` carries additional state arrays (the temporal-coherence
    E/A accumulators, the generator state) in the same npz; their
    dtypes are preserved.
    """
    doc = {
        "name": name,
        "config": to_dict(acfg),
        "meta": meta or {},
        "format_version": 1,
    }
    arrays = {"weights": np.asarray(weights, np.float32)}
    for k, v in (extras or {}).items():
        arrays[k] = np.asarray(v)
    store.save(weights_key(name), arrays)
    store.save(agent_key(name), doc)


def load_agent(
    store: ArtifactStore, name: str
) -> Tuple[AgentConfig, np.ndarray, Dict[str, Any]]:
    doc = store.load(agent_key(name))
    if doc is None:
        raise FileNotFoundError(f"no agent '{name}' in store")
    w = store.load(weights_key(name))
    if w is None:
        raise FileNotFoundError(f"agent '{name}' has no weights")
    acfg = agent_config_from_dict(doc.get("config", {}))
    meta = doc.get("meta", {})
    extras = {k: w[k] for k in w if k != "weights"}
    if extras:
        meta = {**meta, "extras": extras}
    return acfg, w["weights"], meta


def save_game(store: ArtifactStore, name: str, record: Dict[str, Any]) -> None:
    """Game record: starting board + move/spawn logs (replayable)."""
    store.save(
        game_key(name),
        {
            "starting_position": np.asarray(
                record["starting_position"], np.int8
            ),
            "moves": np.asarray(record["moves"], np.int8),
            "tiles": np.asarray(record["tiles"], np.int8).reshape(-1, 3),
            "score": np.asarray([record["score"]], np.int64),
            "odometer": np.asarray([record["odometer"]], np.int64),
            "final_board": np.asarray(record["final_board"], np.int8),
        },
    )


def load_game(store: ArtifactStore, name: str) -> Dict[str, Any]:
    z = store.load(game_key(name))
    if z is None:
        raise FileNotFoundError(f"no game '{name}' in store")
    return {
        "starting_position": z["starting_position"],
        "moves": z["moves"],
        "tiles": z["tiles"],
        "score": int(z["score"][0]),
        "odometer": int(z["odometer"][0]),
        "final_board": z["final_board"],
    }


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
    ``device``, of any learner setting: the engine state of either
    engine (chosen by its fields), ``prev_idx`` of any width, and the
    (0,) TC placeholders of "sgd" as they are.  Its RNG key has no
    torch twin and is left out: the port draws from a draw source.
    The recorder's logs gain the port's zeroed spill column."""
    from ..agent import td
    from ..engine.core import EnvState
    from ..engine.fast import EnvStateC

    def t(x):
        return torch.from_numpy(np.array(x)).to(device)

    def logs(x):
        x = np.asarray(x)
        return t(np.concatenate([x, np.zeros_like(x[:, :1])], axis=1))

    rec = state.recorder
    env_cls = EnvStateC if hasattr(state.env, "codes") else EnvState
    return td.TDState(
        weights=t(state.weights), opt_e=t(state.opt_e),
        opt_a=t(state.opt_a), alpha=t(state.alpha),
        next_decay=t(state.next_decay), top_tile=t(state.top_tile),
        env=env_cls(*(t(x) for x in state.env)),
        prev_idx=t(state.prev_idx), prev_value=t(state.prev_value),
        prev_valid=t(state.prev_valid),
        metrics=td.Metrics(*(t(x) for x in state.metrics)),
        recorder=td.Recorder(
            moves=logs(rec.moves), spawns=logs(rec.spawns),
            **{f: t(getattr(rec, f)) for f in td.Recorder._fields[2:]}),
        prev_cidx=t(state.prev_cidx), prev_cmult=t(state.prev_cmult),
    )
