"""Device mesh, the split of the train state, and the collectives
(``tpu2048/parallel/mesh.py``).

  * a ``Mesh`` with a ``data`` axis (environments sharded across
    processes, one device each) and a ``model`` axis that must be 1:
    weight-table sharding is not ported yet (ROADMAP.md Queue 1);
  * ``td_state_shardings``: which leaves of the TD train state each
    rank holds its share of (the env batch, the per-env bootstrap
    state and the recorder's logs) and which every rank holds whole
    (the weight table, the TC sums, the schedule scalars, the metrics
    and the best game);
  * the reference gets its collectives from GSPMD: its sharded segment
    is its single-device segment on the global batch.  Here the step
    asks for them by hand (``agent/td.py``): the class gradient pairs
    are all-reduced, the sparse updates, the episode metrics and the
    best-game candidates all-gathered in rank order, so that every
    rank applies the same update to its replica and the replicas stay
    bitwise equal.  ``Mesh`` counts the collectives it runs and their
    bytes, as the kernels' wrappers count their launches.

Each rank draws the global batch's random numbers from the same seed
and keeps its env range (``draws.EnvSliceDraws``), so the games do not
depend on the number of ranks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..agent import td
from ..agent.td import Metrics, Recorder, TDState
from ..config import MeshConfig
from ..engine.core import EnvState
from ..engine.fast import EnvStateC
from ..train import card_device

# how a leaf of the train state lies on the mesh
DATA = "data"  # one row per env: each rank holds its env range
RECORD = "record"  # one row per recorded env, held by the env's rank
REPLICATED = "replicated"  # every rank holds the same whole value


class Mesh:
    """This process's place in a (data, model) mesh: rank ``rank`` of
    ``data`` on ``device``, talking to its peers through ``group``
    (None: a mesh of this process alone, whose collectives return
    their input).

    ``counts`` holds the collectives run so far and the bytes each
    handed back to this rank; set its entries to 0 to count a stretch.
    """

    def __init__(self, data: int, model: int, rank: int,
                 device: torch.device, group=None):
        self.data, self.model, self.rank = data, model, rank
        self.device = device
        self.group = group
        self.counts = {"all_reduce": 0, "all_gather": 0, "bytes": 0}

    # -- the env batch's split ------------------------------------------------

    def local_envs(self, num_envs: int) -> int:
        """Envs per rank of a global batch of ``num_envs``."""
        if num_envs % self.data:
            raise ValueError(f"num_envs={num_envs} does not divide by the "
                             f"mesh's data axis ({self.data})")
        return num_envs // self.data

    def env_slice(self, num_envs: int) -> slice:
        """This rank's half-open range of the global env batch."""
        per = self.local_envs(num_envs)
        return slice(self.rank * per, (self.rank + 1) * per)

    def record_rows(self, num_envs: int, record_envs: int) -> int:
        """How many of the first ``record_envs`` global envs (the ones
        that record their games) lie in this rank's range; they are
        its first envs."""
        per = self.local_envs(num_envs)
        return max(0, min(per, record_envs - self.rank * per))

    # -- collectives ----------------------------------------------------------

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, in place; every rank gets
        the same bits."""
        if self.group is not None:
            dist.all_reduce(x, group=self.group)
            self.counts["all_reduce"] += 1
            self.counts["bytes"] += x.numel() * x.element_size()
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' ``x`` (one shape on all) joined along dim 0 in
        rank order."""
        if self.group is None:
            return x
        parts = [torch.empty_like(x) for _ in range(self.data)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        self.counts["all_gather"] += 1
        self.counts["bytes"] += self.data * x.numel() * x.element_size()
        return torch.cat(parts)

    def all_gather_rows(self, *cols: torch.Tensor):
        """One all-gather of several per-env tensors, each (n,) or
        (n, c) of int32, float32 or bool: packed side by side as int32
        (a float by its bit pattern, never by its value), gathered in
        rank order and unpacked to (world * n, ...) each."""
        if self.group is None:
            return cols
        n = cols[0].shape[0]
        packed = []
        for c in cols:
            c = c.reshape(n, -1)
            if c.dtype == torch.bool:
                c = c.to(torch.int32)
            elif c.dtype == torch.float32:
                c = c.view(torch.int32)
            elif c.dtype != torch.int32:
                raise TypeError(f"all_gather_rows takes int32, float32 or "
                                f"bool, not {c.dtype}")
            packed.append(c)
        out = self.all_gather(torch.cat(packed, dim=1))
        res, at = [], 0
        for c, p in zip(cols, packed):
            g = out[:, at: at + p.shape[1]]
            at += p.shape[1]
            if c.dtype == torch.bool:
                g = g != 0
            elif c.dtype == torch.float32:
                g = g.view(torch.float32)
            res.append(g.reshape((out.shape[0],) + c.shape[1:]))
        return res

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)


def make_mesh(cfg: Optional[MeshConfig] = None, device=None) -> Mesh:
    """Build the (data, model) mesh.  Defaults to all processes on the
    data axis.

    After ``distributed.initialize`` the mesh spans the process group,
    ``cfg.data`` must be its size, and the device is the rank's own
    (its card under NCCL, the CPU under gloo).  Before it the mesh is
    this process alone on ``device`` (default: the card)."""
    if dist.is_initialized():
        world, rank, group = dist.get_world_size(), dist.get_rank(), \
            dist.group.WORLD
        own = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
        if device is not None and torch.device(device).type != own.type:
            raise ValueError(f"the process group runs on {own.type}, not "
                             f"on {device}")
        device = own
    else:
        world, rank, group = 1, 0, None
        device = card_device(device, "make_mesh")
    if cfg is None:
        cfg = MeshConfig(data=world, model=1)
    if cfg.model != 1:
        raise NotImplementedError(
            f"MeshConfig.model={cfg.model}: sharding the weight table along "
            "a model axis is not ported yet (ROADMAP.md Queue 1, the model "
            "axis); use model=1")
    if cfg.data != world:
        raise ValueError(f"MeshConfig.data={cfg.data}, but {world} "
                         "process(es) are up: one process drives one device")
    return Mesh(cfg.data, cfg.model, rank, device, group)


def td_state_shardings(mesh: Mesh, engine_mode: str = "cells") -> TDState:
    """How each leaf of a TDState lies on the mesh (``DATA``,
    ``RECORD`` or ``REPLICATED``), as a TDState of those words: the env
    batch and the per-env bootstrap state by env range; the weight
    table, the TC sums, the scalars, the metrics and the best game
    whole on every rank.

    The recorder's logs are held by the rank of each recorded env
    whether all envs record or only the first ``record_envs``: a
    replicated log, as the reference keeps for a small ``record_envs``,
    would take a gather of its rows on every step, and the best game is
    found across ranks either way (``td._global_best``)."""
    if engine_mode == "codes":
        env_sh = EnvStateC(codes=DATA, score=DATA, odometer=DATA)
    else:
        env_sh = EnvState(boards=DATA, score=DATA, odometer=DATA)
    rep = REPLICATED
    return TDState(
        weights=rep,
        opt_e=rep,
        opt_a=rep,
        alpha=rep,
        next_decay=rep,
        top_tile=rep,
        env=env_sh,
        prev_idx=DATA,
        prev_value=DATA,
        prev_valid=DATA,
        prev_cidx=DATA,
        prev_cmult=DATA,
        metrics=Metrics(
            episodes=rep,
            score_ring=rep,
            tile_ring=rep,
            ring_pos=rep,
            best_score=rep,
        ),
        recorder=Recorder(
            moves=RECORD,
            spawns=RECORD,
            starts=RECORD,
            overflow=RECORD,
            best_moves=rep,
            best_spawns=rep,
            best_start=rep,
            best_len=rep,
            best_score=rep,
        ),
    )


def _map_state(fn, state: TDState, specs: TDState) -> TDState:
    """``fn(leaf, spec)`` over a TDState and its shardings."""
    def sub(x, s):
        return type(x)(*(fn(a, b) for a, b in zip(x, s)))

    return TDState(*(
        sub(x, s) if f in ("env", "metrics", "recorder") else fn(x, s)
        for f, x, s in zip(TDState._fields, state, specs)))


def _engine_mode(state: TDState) -> str:
    return "codes" if isinstance(state.env, EnvStateC) else "cells"


def shard_td_state(state: TDState, mesh: Mesh) -> TDState:
    """Cut a TDState of the global batch (built on the host, the same
    on every rank) to this rank's share on the mesh's device.  A run
    that should build only its share from the start uses
    ``init_sharded_td_state``."""
    num_envs = state.prev_value.shape[0]
    envs = mesh.env_slice(num_envs)
    rows = mesh.record_rows(num_envs, state.recorder.moves.shape[0])
    rec = slice(envs.start, envs.start + rows)
    cut = {DATA: envs, RECORD: rec, REPLICATED: slice(None)}

    def place(x, spec):
        x = x[cut[spec]] if x.dim() else x
        return x.to(mesh.device, copy=True)

    return _map_state(place, state,
                      td_state_shardings(mesh, _engine_mode(state)))


def init_sharded_td_state(ts, acfg, tcfg, mesh: Mesh, draws,
                          weights=None) -> TDState:
    """Build a TDState directly ONTO the mesh: each rank builds only
    its share of the env batch, from the global batch's draws
    (``draws`` is the run's draw source, seeded alike on every rank).
    ``weights`` (resume) must be the same on every rank, which holds
    because all load the same checkpoint."""
    return td.init_td_state(ts, acfg, tcfg, draws, mesh.device,
                            weights=weights, mesh=mesh)


def replicate_to_mesh(x, mesh: Mesh) -> torch.Tensor:
    """Place a host array on this rank's device as a replicated value
    (all ranks must hold the same value: true for checkpoint-loaded
    state)."""
    return torch.as_tensor(x).to(mesh.device)


def host_full(x: torch.Tensor, mesh: Optional[Mesh] = None,
              spec: str = REPLICATED) -> np.ndarray:
    """Read a leaf of the train state fully onto this host.

    A replicated leaf (and any leaf without a mesh) is read with no
    collective: every rank already holds a complete copy, so a lone
    writer can snapshot the state while its peers keep training.  A
    ``DATA`` or ``RECORD`` leaf is all-gathered in rank order, which is
    a COLLECTIVE: every rank of the mesh must call ``host_full`` on it
    together.  Ranks may hold different row counts (``RECORD``)."""
    if mesh is None or mesh.group is None or spec == REPLICATED:
        return x.detach().cpu().numpy()
    rows = mesh.all_gather(torch.tensor([x.shape[0]], device=x.device)
                           ).tolist()
    pad = torch.zeros((max(rows),) + x.shape[1:], dtype=x.dtype,
                      device=x.device)
    pad[: x.shape[0]] = x
    parts = mesh.all_gather(pad[None])
    return np.concatenate([parts[r, :n].cpu().numpy()
                           for r, n in enumerate(rows)])


def host_full_state(state: TDState, mesh: Mesh) -> TDState:
    """``host_full`` of every leaf: the global TDState as numpy arrays
    (a collective, see ``host_full``)."""
    return _map_state(lambda x, spec: host_full(x, mesh, spec), state,
                      td_state_shardings(mesh, _engine_mode(state)))


def make_sharded_train_segment(ts, acfg, tcfg, mesh: Mesh, draws):
    """The K-step train segment of this rank's share of the batch:
    ``segment(state) -> state`` computes, with the other ranks', the
    single-device segment on the global batch (``tcfg.num_envs`` envs),
    up to the f32 summation order of the all-reduced sums."""
    return td.make_train_segment(ts, acfg, tcfg, draws, mesh=mesh)
