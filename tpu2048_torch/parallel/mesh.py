"""Device mesh, the split of the train state, and the collectives
(``tpu2048/parallel/mesh.py``).

  * a ``Mesh`` with a ``data`` axis (environments sharded across
    processes, one device each) and a ``model`` axis (the weight table
    and the TC sums sharded across processes): ``data * model``
    processes, rank ``d * model + m`` at ``(data_rank, model_rank) =
    (d, m)`` (the reference's row-major ``(data, model)`` device mesh).
    The ranks of one model group (one ``d``) step the same envs and
    hold the table's shards between them; the ranks of one data group
    (one ``m``) hold the same shard and step the envs between them;
  * ``td_state_shardings``: which leaves of the TD train state each
    rank holds its share of (the env batch, the per-env bootstrap
    state and the recorder's logs by env range; the weight table and
    the TC sums by shard when ``model > 1``) and which every rank holds
    whole (the schedule scalars, the metrics and the best game; the
    tables when ``model == 1``);
  * the reference gets its collectives from GSPMD: its sharded segment
    is its single-device segment on the global batch.  Here the step
    asks for them by hand (``agent/td.py``, ``ops/dispatch.py``): over
    the data group the class gradient pairs are all-reduced, the
    sparse updates, the episode metrics and the best-game candidates
    all-gathered in rank order, so that every rank applies the same
    update to its replica (or shard) and the replicas stay bitwise
    equal; over the model group the values of the pieces a rank owns
    are summed and, where a D4 fold needs other shards' entries, the
    shards all-gathered.  ``Mesh`` counts the collectives it runs and
    their bytes per axis, as the kernels' wrappers count their
    launches.

The shard layout (``table_layout``), the port's own contract: rank
``m`` of the model axis holds the flat range ``[bounds[m],
bounds[m + 1])`` of the table, whole tuple tables only.  Each inner
bound is the tuple-table end nearest to ``m * total / model`` (a tie
to the later end), where the ends inside a 16^2..16^4 kernel class
that fits in one share (``size <= total / model``) are not candidates,
so such a class lies whole on one rank (n >= 5).  Where a kernel class
is larger than a share (n = 2..4, where it is the whole table) it is
split by tuples.  A shard then holds at most ``total / model`` plus one
tuple table (n = 6, model = 2: 50.5 M of the 95.7 M entries on rank 0,
the kernel class, the crosses and six 14^6 tables).  Every shard must
hold one tuple at least.

Each rank draws the global batch's random numbers from the same seed
and keeps its env range (``draws.EnvSliceDraws``), so the games do not
depend on the number of ranks.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..agent import td
from ..agent.td import Metrics, Recorder, TDState
from ..config import MeshConfig
from ..engine.core import EnvState
from ..engine.fast import EnvStateC
from ..features.ntuple import TupleSet, get_tuple_set
from ..ops.onehot import build_table_classes
from ..train import card_device

# how a leaf of the train state lies on the mesh
DATA = "data"  # one row per env: each rank holds its env range
RECORD = "record"  # one row per recorded env, held by the env's rank
REPLICATED = "replicated"  # every rank holds the same whole value
MODEL = "model"  # the table's entries: each rank holds its shard

AXES = ("data", "model")

# the device ``distributed.initialize`` gave this process (None: not
# initialized through it)
_process_device: Optional[torch.device] = None


def set_process_device(device: Optional[torch.device]) -> None:
    """Record the device of this process's rank (``distributed.initialize``
    calls it); ``make_mesh`` places the mesh there."""
    global _process_device
    _process_device = None if device is None else torch.device(device)


@lru_cache(maxsize=None)
def table_layout(n: int, model: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """``(bounds, feats)``, each ``model + 1`` long: rank ``m`` of the
    model axis holds flat entries ``[bounds[m], bounds[m + 1])``, the
    whole tables of tuples ``[feats[m], feats[m + 1])``.  The rule is
    the module doc's."""
    ts = get_tuple_set(n)
    ends = np.concatenate([[0], np.cumsum(ts.sizes.astype(np.int64))])
    share = ts.total / model
    inner = set()  # tuple ends inside a kernel class that fits a share
    for c in build_table_classes(ts).matmul:
        if c.g * c.h * c.l <= share:
            inner.update(range(c.feat0 + 1, c.feat0 + c.g))
    cands = [f for f in range(1, ts.num_feat) if f not in inner]
    feats = [0]
    for m in range(1, model):
        target = m * share
        # the nearest end, a tie to the later one
        feats.append(min(cands, key=lambda f: (abs(ends[f] - target),
                                               -ends[f])))
    feats.append(ts.num_feat)
    if any(b <= a for a, b in zip(feats, feats[1:])):
        raise ValueError(f"model={model} leaves a shard of n={n}'s table "
                         f"without a tuple (tuple bounds {feats})")
    return tuple(int(ends[f]) for f in feats), tuple(feats)


class TableShard(NamedTuple):
    """This rank's shard of a tuple set's table (``table_layout``):
    flat entries ``[lo, hi)``, the tables of tuples ``[f0, f1)``; the
    bounds of every rank of the model axis in ``bounds`` and ``feats``."""

    rank: int  # the model rank
    bounds: Tuple[int, ...]
    feats: Tuple[int, ...]

    @property
    def lo(self) -> int:
        return self.bounds[self.rank]

    @property
    def hi(self) -> int:
        return self.bounds[self.rank + 1]

    @property
    def size(self) -> int:
        return self.hi - self.lo

    def tuples(self, feat0: int, g: int, rank: Optional[int] = None
               ) -> Tuple[int, int]:
        """The range ``[a, b)`` of the class ``feat0 .. feat0 + g - 1``'s
        tuples that model rank ``rank`` (default: this one) holds, local
        to the class (``a == b``: none)."""
        r = self.rank if rank is None else rank
        a = min(max(self.feats[r] - feat0, 0), g)
        b = min(max(self.feats[r + 1] - feat0, 0), g)
        return a, max(a, b)

    def split(self, feat0: int, g: int) -> bool:
        """True when the class's tuples lie on more than one rank."""
        return self.tuples(feat0, g, self.owner(feat0)) != (0, g)

    def owner(self, feat: int) -> int:
        """The model rank that holds tuple ``feat``."""
        return int(np.searchsorted(self.feats, feat, side="right")) - 1


class Mesh:
    """This process's place in a (data, model) mesh: rank ``rank`` at
    ``(data_rank, model_rank)`` on ``device``, talking to its peers
    through one process group per axis (``groups``; None for an axis:
    its collectives return their input).  ``group``, the data axis's,
    is the whole process group when ``model == 1``.

    ``counts`` holds the collectives run so far and the bytes each
    handed back to this rank: the data axis's under ``all_reduce``,
    ``all_gather`` and ``bytes``, and when ``model > 1`` the model
    axis's under ``model_all_reduce``, ``model_all_gather`` and
    ``model_bytes``; set its entries to 0 to count a stretch.

    Under gloo with a card device (two ranks on one card) each
    collective stages its tensor through the host."""

    def __init__(self, data: int, model: int, rank: int,
                 device: torch.device, group=None, model_group=None,
                 staged: bool = False):
        self.data, self.model, self.rank = data, model, rank
        self.data_rank, self.model_rank = divmod(rank, model)
        self.device = device
        self.groups = {"data": group, "model": model_group}
        self.staged = staged
        self.counts = {"all_reduce": 0, "all_gather": 0, "bytes": 0}
        if model > 1:
            self.counts.update(model_all_reduce=0, model_all_gather=0,
                               model_bytes=0)

    @property
    def group(self):
        """The data axis's process group (``groups["data"]``)."""
        return self.groups["data"]

    def table_shard(self, ts: TupleSet) -> Optional[TableShard]:
        """This rank's shard of ``ts``'s table; None without a model
        axis (the table is whole on every rank)."""
        if self.model == 1:
            return None
        bounds, feats = table_layout(ts.n, self.model)
        return TableShard(self.model_rank, bounds, feats)

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
        return slice(self.data_rank * per, (self.data_rank + 1) * per)

    def record_rows(self, num_envs: int, record_envs: int) -> int:
        """How many of the first ``record_envs`` global envs (the ones
        that record their games) lie in this rank's range; they are
        its first envs."""
        per = self.local_envs(num_envs)
        return max(0, min(per, record_envs - self.data_rank * per))

    # -- collectives ----------------------------------------------------------

    def _count(self, axis: str, kind: str, nbytes: int) -> None:
        pre = "" if axis == "data" else "model_"
        self.counts[pre + kind] += 1
        self.counts[pre + "bytes"] += nbytes

    def _group(self, axis: str):
        if axis not in AXES:
            raise ValueError(f"axis must be one of {AXES}, not {axis!r}")
        return self.groups[axis]

    def all_reduce(self, x: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """The sum of ``x`` over the ranks of ``axis``, in place; every
        rank gets the same bits."""
        group = self._group(axis)
        if group is None:
            return x
        if self.staged and x.device.type == "cuda":
            host = x.cpu()
            dist.all_reduce(host, group=group)
            x.copy_(host)
        else:
            dist.all_reduce(x, group=group)
        self._count(axis, "all_reduce", x.numel() * x.element_size())
        return x

    def all_gather(self, x: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """The ranks' ``x`` (one shape on all) joined along dim 0 in
        rank order, over the ranks of ``axis``."""
        group = self._group(axis)
        if group is None:
            return x
        size = self.data if axis == "data" else self.model
        src = x.contiguous()
        if self.staged and x.device.type == "cuda":
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(size)]
        dist.all_gather(parts, src, group=group)
        self._count(axis, "all_gather", size * x.numel() * x.element_size())
        return torch.cat(parts).to(x.device)

    def all_gather_cat(self, x: torch.Tensor, sizes: Sequence[int],
                       dim: int = -1, axis: str = "model") -> torch.Tensor:
        """The ranks' ``x`` joined along ``dim`` in rank order, rank r's
        ``x`` ``sizes[r]`` long there (each padded to the longest for
        one all-gather)."""
        if self._group(axis) is None:
            return x
        dim = dim % x.dim()
        pad = list(x.shape)
        pad[dim] = max(sizes)
        buf = x.new_zeros(pad)
        buf.narrow(dim, 0, x.shape[dim]).copy_(x)
        parts = self.all_gather(buf[None], axis)
        return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, sizes)
                          if n], dim=dim)

    def all_gather_rows(self, *cols: torch.Tensor):
        """One all-gather of several per-env tensors, each (n,) or
        (n, c) of int32, float32 or bool: packed side by side as int32
        (a float by its bit pattern, never by its value), gathered in
        rank order over the data axis and unpacked to (ranks * n, ...)
        each."""
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
        """Wait for every rank of the mesh."""
        if self.group is not None or self.groups["model"] is not None:
            dist.barrier()


def _axis_groups(data: int, model: int, rank: int):
    """(data group, model group) of ``rank``: every group built with
    ``dist.new_group`` in the same order on every rank, as it must be;
    an axis of one rank gets none."""
    data_group = model_group = None
    if data > 1:
        for m in range(model):
            g = dist.new_group([d * model + m for d in range(data)])
            if rank % model == m:
                data_group = g
    for d in range(data):
        g = dist.new_group([d * model + m for m in range(model)])
        if rank // model == d:
            model_group = g
    return data_group, model_group


def make_mesh(cfg: Optional[MeshConfig] = None, device=None) -> Mesh:
    """Build the (data, model) mesh.  Defaults to all processes on the
    data axis.

    After ``distributed.initialize`` the mesh spans the process group,
    ``cfg.data * cfg.model`` must be its size, and the device is the
    one ``initialize`` gave this rank (its card under NCCL, or under
    gloo when asked for; the CPU under gloo).  Before it the mesh is
    this process alone on ``device`` (default: the card)."""
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        backend = dist.get_backend()
        own = _process_device or (
            torch.device("cuda", torch.cuda.current_device())
            if backend == "nccl" else torch.device("cpu"))
        if device is not None and torch.device(device).type != own.type:
            raise ValueError(f"the process group runs on {own.type}, not "
                             f"on {device}")
        device = own
    else:
        world, rank, backend = 1, 0, None
        device = card_device(device, "make_mesh")
    if cfg is None:
        cfg = MeshConfig(data=world, model=1)
    if cfg.data < 1 or cfg.model < 1 or cfg.data * cfg.model != world:
        raise ValueError(f"MeshConfig(data={cfg.data}, model={cfg.model}) "
                         f"needs {cfg.data * cfg.model} processes, but "
                         f"{world} are up: one process drives one device")
    staged = backend == "gloo" and device.type == "cuda"
    if backend is None:
        return Mesh(cfg.data, cfg.model, rank, device)
    if cfg.model == 1:
        return Mesh(cfg.data, 1, rank, device, dist.group.WORLD,
                    staged=staged)
    data_group, model_group = _axis_groups(cfg.data, cfg.model, rank)
    return Mesh(cfg.data, cfg.model, rank, device, data_group, model_group,
                staged=staged)


def td_state_shardings(mesh: Mesh, engine_mode: str = "cells") -> TDState:
    """How each leaf of a TDState lies on the mesh (``DATA``,
    ``RECORD``, ``REPLICATED`` or ``MODEL``), as a TDState of those
    words: the env batch and the per-env bootstrap state by env range;
    the weight table and the TC sums by shard under a model axis, else
    whole; the scalars, the metrics and the best game whole on every
    rank.

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
    table = MODEL if mesh.model > 1 else rep
    return TDState(
        weights=table,
        opt_e=table,
        opt_a=table,
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


def shard_table(x, mesh: Mesh, ts: TupleSet):
    """This rank's shard of ``ts``'s whole table (or TC sum) ``x``, a
    tensor or an array: the whole of it without a model axis, and a
    (0,) placeholder as it is."""
    if mesh.model == 1 or x.shape[0] == 0:
        return x
    sh = mesh.table_shard(ts)
    return x[sh.lo: sh.hi]


def shard_td_state(state: TDState, mesh: Mesh, ts: TupleSet) -> TDState:
    """Cut a TDState of ``ts``'s global batch (built on the host, the
    same on every rank) to this rank's share on the mesh's device.  A run
    that should build only its share from the start uses
    ``init_sharded_td_state``."""
    num_envs = state.prev_value.shape[0]
    envs = mesh.env_slice(num_envs)
    rows = mesh.record_rows(num_envs, state.recorder.moves.shape[0])
    rec = slice(envs.start, envs.start + rows)
    cut = {DATA: envs, RECORD: rec, REPLICATED: slice(None)}

    def place(x, spec):
        if spec == MODEL:
            x = shard_table(x, mesh, ts)
        elif x.dim():
            x = x[cut[spec]]
        return x.to(mesh.device, copy=True)

    return _map_state(place, state,
                      td_state_shardings(mesh, _engine_mode(state)))


def init_sharded_td_state(ts, acfg, tcfg, mesh: Mesh, draws,
                          weights=None) -> TDState:
    """Build a TDState directly ONTO the mesh: each rank builds only
    its share of the env batch, from the global batch's draws, and its
    shard of the tables (``draws`` is the run's draw source, seeded
    alike on every rank).  ``weights`` (resume), the whole table, must
    be the same on every rank, which holds because all load the same
    checkpoint."""
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
    ``DATA`` or ``RECORD`` leaf is all-gathered in rank order over the
    data axis, and a ``MODEL`` leaf (a table's shard) over the model
    axis, which is a COLLECTIVE: every rank of the mesh must call
    ``host_full`` on it together.  Ranks may hold different row counts
    (``RECORD``, ``MODEL``)."""
    axis = "model" if spec == MODEL else "data"
    if mesh is None or spec == REPLICATED or mesh.groups[axis] is None:
        return x.detach().cpu().numpy()
    # staged through the host anyway, the gather runs there
    x = x.detach().cpu() if mesh.staged else x
    rows = mesh.all_gather(torch.tensor([x.shape[0]], device=x.device),
                           axis).tolist()
    if not max(rows):
        return x.cpu().numpy()
    return mesh.all_gather_cat(x, rows, dim=0, axis=axis).cpu().numpy()


def host_full_state(state: TDState, mesh: Mesh) -> TDState:
    """``host_full`` of every leaf: the global TDState as numpy arrays
    (a collective, see ``host_full``)."""
    return _map_state(lambda x, spec: host_full(x, mesh, spec), state,
                      td_state_shardings(mesh, _engine_mode(state)))


def make_sharded_train_segment(ts, acfg, tcfg, mesh: Mesh, draws):
    """The K-step train segment of this rank's share of the batch and
    shard of the tables: ``segment(state) -> state`` computes, with the
    other ranks', the single-device segment on the global batch
    (``tcfg.num_envs`` envs), up to the f32 summation order of the
    all-reduced sums."""
    return td.make_train_segment(ts, acfg, tcfg, draws, mesh=mesh)
