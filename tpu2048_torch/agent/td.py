"""Batched TD(0) n-tuple actor-learner (``tpu2048/agent/td.py``).

N environments step in lockstep on one device.  Per step the actor
picks the greedy afterstate of every env, and the learner updates the
previous afterstate with the reference's semantics: gamma 1, greedy
play, the TD error ``reward + V(s'_best) - V(s_prev)`` with
``V(s'_best)`` read before this step's update, ``-V(s_last)`` at game
over, and the same update on all 8 D4 images of the board.  Every
setting of ``AgentConfig`` trains:

  * ``optimizer``: "tc", temporal coherence (per-weight rate |E| / A,
    ``alpha`` a meta-rate, ``dw = td / num_feat``); or "sgd", the
    reference's own rule (``dw = td * alpha / num_feat``) with its
    alpha decay every ``decay_step`` episodes and at every new top
    tile;
  * ``update_mode``: "mean", each entry's summed update divided by its
    hit count this step; or "sum", the raw scatter-add;
  * ``sym_mode="scatter"`` with ``sym_impl``: "canonical", one entry
    per D4 orbit of the gather classes (16^5 and up) and a class-local
    fold of the 16^2..16^4 classes' gradient; "fold", identity updates
    into a full-table [dsum; hits] pair and its D4 orbit sum; "index",
    explicit (N, 8, F) image indices.  ``sym_mode="periodic"``:
    identity updates, the tables projected onto the D4-symmetric
    subspace at each segment's end; "none": identity updates only;
  * ``actor_precision``: "bf16", selection over 4N rows with bf16
    class weights and an exact re-evaluation of the chosen afterstate
    as the bootstrap; or "bf16x2", exact selection whose chosen value
    is the bootstrap;
  * ``engine_mode``: "codes", packed row codes; or "cells", (N, 4, 4)
    boards through ``engine.core``.

As in the reference, the learners off the canonical form divide each
entry's summed TC update by its hits whatever ``update_mode`` says.

Forms that differ from the reference, with the same results:
  * the weight table and the TC accumulators are flat tensors updated
    IN PLACE (about 64 MB of copies a step saved at n=5); so are the
    metrics rings and the recorder's logs.  A caller that needs the
    state before a step keeps a copy.  The reference's read-before-
    write order holds: the bootstrap value reads the weights before
    the update, each table rule reads its own w/E/A before writing it,
    and the crosses gather E/A before their scatters;
  * randomness comes from a draw source (``..draws``), not a key in
    the state;
  * ``make_train_step`` stages its recorder rows (``RecStep``) unless
    asked not to (``staged=False``, the reference's default, writes
    the logs and the best game every step); the segment stages and
    merges them once (``_merge_staged_recorder``).  The reference's
    packed (3, total) scan carry is a TPU layout and is not ported;
  * the recorder's (R, S) logs carry one spill column S, where writes
    of lanes that do not record land (the reference drops them); the
    merged segment writes 0 there, as the rings' trash slot takes 0.

Every float sum that feeds a table runs in a fixed order on the card
as on the CPU, as the reference's do on its chip: the class gradients
in ``grad_class``'s (``ops/csrc/grad_class.cu``), the canonical crosses
in ``cross_apply``'s (``ops/csrc/cross_apply.cu``), the other sparse
adds in ``ops/kernels.py::scatter_add_ordered``'s; only 0/1 hit
counts, exact in any order, take ``index_add_``.  So a seed, its
inputs and one card give one run, bit for bit.

Data parallel (``mesh=``, a ``parallel.mesh.Mesh``): each rank steps
its env range of the global batch and holds the tables whole.  The
reference's sharded step is its single-device step under GSPMD; here
the same function is computed by hand.  Every sum over envs that feeds
a table is made global before it is used: the class gradient pairs
(and, off the canonical form, the table-sized pair) are all-reduced
before the fold and the divide by hits; the sparse updates' rows are
all-gathered in rank order and every rank applies the whole list in
the list's order; the completed episodes are all-gathered and written
to the rings in global env order; the best game is chosen among the
ranks' candidates with the single-device tie-break.  So the replicas
stay bitwise equal, and the games do not depend on the number of ranks
until f32 summation order flips an argmax.  Without a mesh no
collective runs and the step is the single-device step as it was.

Under a mesh's model axis (``mesh.model > 1``) the weights and the TC
sums are this rank's shard (``parallel/mesh.py::table_layout``), and
the ranks of one model group step the same envs.  The evaluators
value the shard's pieces and sum them over the model group
(``ops/dispatch.py``); the class gradients are taken on the shard's
tuples of each 16^2..16^4 class and all-reduced over the data group,
and where a class is split across ranks its pair's tuple slices are
all-gathered over the model group before the fold (the D4 orbits span
tuples); every rule then applies to the shard's entries only, the
sparse updates masked to the shard.  The D4 sums that read other
tuples' entries (the "fold" learners' pair and the "periodic"
projection) all-gather the shard-sized input over the model group
once and cut the shard's entries from the whole table's sum.  The
metrics, the best game and the recorder meet over the data group
only: the model group's ranks hold the same envs.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, NamedTuple, Optional, Union

import numpy as np
import torch

from ..config import AgentConfig, TrainConfig
from ..draws import Draws, EnvSliceDraws
from ..engine import core as engine
from ..engine import fast as engf
from ..features import ntuple
from ..features.canonical import (_gather_feat_ids, canonical_gather_indices,
                                  is_canonical)
from ..features.ntuple import TupleSet
from ..features.symmetry import symmetrize_class_sum, symmetrize_sum
from ..obs.profiler import span
from ..ops import dispatch as table_dispatch
from ..ops import kernels

# the documented values of the learner's settings (``config.py``)
_SETTINGS = {
    "optimizer": ("tc", "sgd"),
    "update_mode": ("mean", "sum"),
    "sym_mode": ("scatter", "periodic", "none"),
    "sym_impl": ("canonical", "fold", "index"),
    "actor_precision": ("bf16", "bf16x2"),
    "engine_mode": ("codes", "cells"),
}


class Metrics(NamedTuple):
    """Device-resident episode statistics (host reads per segment)."""

    episodes: torch.Tensor  # i32 scalar, completed episodes
    score_ring: torch.Tensor  # (R+1,) i32 completed scores (slot R = trash)
    tile_ring: torch.Tensor  # (R+1,) i32 max tile exponent at completion
    ring_pos: torch.Tensor  # i32 monotonic write counter
    best_score: torch.Tensor  # i32 best completed-episode score


class Recorder(NamedTuple):
    """Move/spawn logs of the recorded envs + the best finished game.
    Spawn byte layout: ``pos | (val-1) << 4``."""

    moves: torch.Tensor  # (R_env, S+1) i8; column S is the spill column
    spawns: torch.Tensor  # (R_env, S+1) i8
    starts: torch.Tensor  # (R_env, 4, 4) i8
    overflow: torch.Tensor  # (R_env,) bool: game outran S, not replayable
    best_moves: torch.Tensor  # (S,) i8
    best_spawns: torch.Tensor  # (S,) i8
    best_start: torch.Tensor  # (4, 4) i8
    best_len: torch.Tensor  # i32
    best_score: torch.Tensor  # i32


class TDState(NamedTuple):
    weights: torch.Tensor  # (total,) f32 flat n-tuple table
    # TC signed / absolute delta sums: (total,) f32 under "tc", (0,)
    # placeholders under "sgd"
    opt_e: torch.Tensor
    opt_a: torch.Tensor
    alpha: torch.Tensor  # f32 scalar (sgd rate, or the TC meta-rate)
    next_decay: torch.Tensor  # i32 scalar: episode count of the next decay
    top_tile: torch.Tensor  # i32 scalar (exponent; starts at 10)
    env: Union[engf.EnvStateC, engine.EnvState]  # codes or cells engine
    prev_idx: torch.Tensor  # (N, num_sym, F) i32 features of prev afterstate
    prev_value: torch.Tensor  # (N,) f32
    prev_valid: torch.Tensor  # (N,) bool
    metrics: Metrics
    recorder: Recorder
    # canonical gather-class indices of the prev afterstate and their
    # orbit multiplicities: (N, K) under sym_impl="canonical", else (N, 0)
    prev_cidx: torch.Tensor
    prev_cmult: torch.Tensor


class RecStep(NamedTuple):
    """One step's recorder rows, one per recorded env; the segment
    stacks K of them and merges them into the logs once."""

    mv: torch.Tensor  # (R,) i8 chosen direction
    sp: torch.Tensor  # (R,) i8 spawn byte
    wslot: torch.Tensor  # (R,) i32 target column (S = no write)
    done: torch.Tensor  # (R,) bool episode completed this step
    cand: torch.Tensor  # (R,) i32 completed score (or -1)
    odo: torch.Tensor  # (R,) i32 odometer at step start
    sb: torch.Tensor  # (R, 16) i8 completing episode's start board


def record_env_count(tcfg: TrainConfig) -> int:
    """Envs with trajectory recording: ``record_envs <= 0`` means all."""
    n = tcfg.num_envs
    r = tcfg.record_envs
    return n if r <= 0 else max(1, min(r, n))


def _num_sym(acfg: AgentConfig) -> int:
    """Width of the per-step index block: 8 images only for the
    explicit-index "scatter" implementation, else 1."""
    if acfg.sym_mode == "scatter" and acfg.sym_impl == "index":
        return 8
    return 1


def _canon_feat_count(ts: TupleSet, acfg: AgentConfig) -> int:
    """K: gather-class feature count in canonical form, else 0."""
    return len(_gather_feat_ids(ts.n)) if is_canonical(acfg) else 0


def _check_settings(acfg: AgentConfig) -> None:
    for name, values in _SETTINGS.items():
        if getattr(acfg, name) not in values:
            raise ValueError(f"AgentConfig.{name}={getattr(acfg, name)!r}: "
                             f"expected one of {values}")


def _round4(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``round(alpha, 4)`` in f32, halves to even.  XLA
    turns the reference's division by 10000 into a product with the f32
    reciprocal, which rounds differently; the product keeps alpha
    bitwise the reference's."""
    return torch.round(x * 10000.0) * 1e-4


def evaluate_boards(ts: TupleSet, weights: torch.Tensor,
                    boards: torch.Tensor) -> torch.Tensor:
    """V(s) of (..., 4, 4) boards: num_feat gathers and their sum."""
    return ntuple.evaluate(ts, weights,
                           boards.reshape(boards.shape[:-2] + (16,)))


def make_select_greedy(ts: TupleSet, eval_fn=None):
    """The batched greedy afterstate selector of the cells engine over
    a table evaluator (``ops/dispatch.py``; default ``ntuple.evaluate``).

    ``select(weights, boards (N, 4, 4))`` returns (chosen (N, 4, 4),
    best_dir (N,) i32, best_val (N,), delta (N,), done (N,)); ``done``
    is no legal move.  Ties go to the lowest direction, as in the
    reference's strict ``>`` scan over directions 0..3."""
    if eval_fn is None:
        def eval_fn(weights, flat_boards):
            return ntuple.evaluate(ts, weights, flat_boards)

    def select(weights: torch.Tensor, boards: torch.Tensor):
        aft, delta, legal = engine.afterstates(boards)  # (4, N, ...)
        vals = eval_fn(weights, aft.reshape(aft.shape[:-2] + (16,)))
        masked = torch.where(legal, vals, float("-inf"))
        best_dir = masked.argmax(dim=0).to(torch.int32)
        ar = torch.arange(boards.shape[0], device=boards.device)
        sel_i = best_dir.long()
        return (aft[sel_i, ar], best_dir, masked[sel_i, ar],
                delta[sel_i, ar], ~legal.any(dim=0))

    return select


def select_greedy(ts: TupleSet, weights: torch.Tensor, boards: torch.Tensor):
    """``make_select_greedy`` over plain gathers."""
    return make_select_greedy(ts)(weights, boards)


def _mesh_sizes(tcfg: TrainConfig, mesh) -> tuple:
    """(envs, recorded envs) of this rank: the global counts without a
    mesh."""
    n, r_env = tcfg.num_envs, record_env_count(tcfg)
    if mesh is None:
        return n, r_env
    return mesh.local_envs(n), mesh.record_rows(n, r_env)


def _mesh_draws(draws: Draws, mesh) -> Draws:
    """This rank's env range of the global batch's draws."""
    if mesh is None:
        return draws
    return EnvSliceDraws(draws, mesh.data_rank, mesh.data)


def init_td_state(ts: TupleSet, acfg: AgentConfig, tcfg: TrainConfig,
                  draws: Draws, device,
                  weights: Optional[torch.Tensor] = None,
                  mesh=None) -> TDState:
    """A fresh train state on ``device``: U[0, 0.01) weights from
    ``draws.uniform`` unless ``weights`` is given, fresh boards from
    ``draws.new``, zeroed TC accumulators (placeholders under "sgd"),
    rings and logs.  Under a ``mesh``: this rank's share of the global
    batch of ``tcfg.num_envs`` envs, from the global batch's draws, and
    under its model axis this rank's shard of the tables (``weights``,
    and the fresh table drawn whole, are cut to it)."""
    device = torch.device(device)
    shard = None if mesh is None else mesh.table_shard(ts)
    s = tcfg.max_record_steps
    n, r_env = _mesh_sizes(tcfg, mesh)
    draws = _mesh_draws(draws, mesh)
    if weights is None:
        weights = draws.uniform((ts.total,)) * 0.01
    if shard is not None:
        weights = weights[shard.lo: shard.hi].clone()
    weights = weights.to(device=device, dtype=torch.float32).contiguous()
    if acfg.engine_mode == "codes":
        env = engf.init_env_codes(n, draws)
        env = engf.EnvStateC(*(t.to(device) for t in env))
        starts = engf.boards_from_codes(env.codes[:r_env])
    else:
        env = engine.init_env(n, draws)
        env = engine.EnvState(*(t.to(device) for t in env))
        starts = env.boards[:r_env].clone()

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=device)

    i8, i32 = torch.int8, torch.int32
    rec = Recorder(
        moves=zeros((r_env, s + 1), i8),
        spawns=zeros((r_env, s + 1), i8),
        starts=starts,
        overflow=zeros((r_env,), torch.bool),
        best_moves=zeros((s,), i8),
        best_spawns=zeros((s,), i8),
        best_start=zeros((4, 4), i8),
        best_len=scalar(0, i32),
        best_score=scalar(0, i32),
    )
    met = Metrics(
        episodes=scalar(0, i32),
        score_ring=zeros((tcfg.ring_size + 1,), i32),
        tile_ring=zeros((tcfg.ring_size + 1,), i32),
        ring_pos=scalar(0, i32),
        best_score=scalar(0, i32),
    )
    opt_shape = (weights.shape[0],) if acfg.optimizer == "tc" else (0,)
    kc = _canon_feat_count(ts, acfg)
    return TDState(
        weights=weights,
        opt_e=zeros(opt_shape, torch.float32),
        opt_a=zeros(opt_shape, torch.float32),
        alpha=scalar(acfg.alpha, torch.float32),
        next_decay=scalar(acfg.decay_step, i32),
        top_tile=scalar(10, i32),  # the reference's starting top tile
        env=env,
        prev_idx=zeros((n, _num_sym(acfg), ts.num_feat), i32),
        prev_value=zeros((n,), torch.float32),
        prev_valid=zeros((n,), torch.bool),
        metrics=met,
        recorder=rec,
        prev_cidx=zeros((n, kc), i32),
        prev_cmult=zeros((n, kc), i32),
    )


@lru_cache(maxsize=None)
def _tperm(device: torch.device) -> torch.Tensor:
    """Transposed-cell -> canonical-cell permutation (cell (i, j) of
    the transposed board is cell (j, i) of the canonical one), moved
    to the device once: a per-step host copy would synchronise."""
    return torch.from_numpy(np.arange(16).reshape(4, 4).T.reshape(16)
                            ).to(device)


def _tc_apply(w: torch.Tensor, e: torch.Tensor, a: torch.Tensor,
              alpha: torch.Tensor, dbar: torch.Tensor) -> None:
    """The TC rule on one table (or block), in place: the rate from E
    and A before they take ``dbar``."""
    lr = kernels.tc_rate(e, a)
    w.add_(alpha * lr * dbar)
    e.add_(dbar)
    a.add_(dbar.abs())


def make_train_step(ts: TupleSet, acfg: AgentConfig, tcfg: TrainConfig,
                    draws: Draws, staged: bool = True, mesh=None):
    """The batched TD(0) train step.  Updates the state's tables,
    rings and recorder in place (see the module doc); draws its spawns
    and resets from ``draws``.

    ``staged=True`` (the port's default): ``step(state) -> (state,
    RecStep)``; the logs and the best game are left to the segment's
    merge.  ``staged=False`` (the reference's default): ``step(state)
    -> state``, the step's moves and spawns written into the logs and
    the best finished game kept, as the reference's unstaged step does.

    ``acfg.table_ops`` resolves per call from the weights' device:
    "auto" takes the CUDA kernels (``eval_class``, ``grad_class``,
    ``fold_class``) on the card and plain torch elsewhere; "pallas"
    takes the kernels' wrappers on any device (their plain versions on
    CPU tensors); "search" is "pallas" on the card and "gather"
    elsewhere; "gather" takes plain torch everywhere, and "onehot" the
    one-hot products for the class gradients and the updater (and for
    the cells engine's evaluator) everywhere (``ops/dispatch.py``).

    Under a ``mesh`` the state is this rank's share (and shard) and the
    step is the global batch's (see the module doc); ``draws`` is the
    run's source, seeded alike on every rank."""
    _check_settings(acfg)
    shard = None if mesh is None else mesh.table_shard(ts)
    lo = 0 if shard is None else shard.lo
    num_feat = ts.num_feat
    ring = tcfg.ring_size
    r_env = _mesh_sizes(tcfg, mesh)[1]
    draws = _mesh_draws(draws, mesh)
    s_max = tcfg.max_record_steps
    num_sym = _num_sym(acfg)
    ops = acfg.table_ops
    canon = is_canonical(acfg)
    tc = acfg.optimizer == "tc"
    mean = acfg.update_mode == "mean"
    fold_step = acfg.sym_mode == "scatter" and acfg.sym_impl == "fold"
    codes_mode = acfg.engine_mode == "codes"
    actor_bf16 = acfg.actor_precision == "bf16"

    if canon:
        classes_c, class_grads = table_dispatch.make_class_grads(ts, ops,
                                                                 mesh)
    elif tc or fold_step:
        accumulate = table_dispatch.make_delta_accumulator(ts, ops, mesh)
    else:
        update = table_dispatch.make_updater(ts, ops, mean=mean, mesh=mesh)
    if codes_mode:
        # "bf16": selection in bf16 over 4N rows, the chosen
        # afterstate's value then re-derived exactly from its indices
        # (the TD bootstrap); "bf16x2": exact selection
        train_ev = table_dispatch.make_train_evaluator(
            ts, ops, canonical=canon,
            precision="bf16" if actor_bf16 else None, mesh=mesh)
        if actor_bf16:
            mxu_exact = table_dispatch.make_mxu_eval_idx(ts, ops, mesh)
    else:
        select = make_select_greedy(
            ts, table_dispatch.make_evaluator(ts, ops, canonical=canon,
                                              mesh=mesh))

    def fold(c, pair):
        if table_dispatch.uses_kernels(ops, pair.device):
            return kernels.fold_class(ts, c.feat0, c.g, pair)
        return symmetrize_class_sum(ts, c.feat0, c.g, pair)

    def whole_class(c, pair: Optional[torch.Tensor]) -> torch.Tensor:
        """The class's (2, g, h * l) pair from its owners' tuple slices,
        all-gathered over the model group (every rank of it calls)."""
        hl = c.h * c.l
        sizes = [b - a for a, b in (shard.tuples(c.feat0, c.g, r)
                                    for r in range(mesh.model))]
        if pair is None:
            pair = torch.zeros((2, 0, hl), dtype=torch.float32,
                               device=mesh.device)
        return mesh.all_gather_cat(pair.view(2, -1, hl), sizes, dim=1,
                                   axis="model")

    def class_block_update(state: TDState, delta: torch.Tensor) -> None:
        """Canonical form, 16^2..16^4 classes: [dsum; hits] pairs,
        their D4 fold, and the optimizer's rule on each class block (on
        this rank's tuples of it, under a model axis), in place."""
        pairs = class_grads(state.prev_idx.reshape(-1, num_feat), delta,
                            state.prev_valid)
        for c, pair in zip(classes_c.matmul, pairs):
            hl = c.h * c.l
            a, b = (0, c.g) if shard is None else shard.tuples(c.feat0, c.g)
            if pair is not None and mesh is not None:
                # global sums and hits before the fold and the divide
                mesh.all_reduce(pair)
            if shard is not None and shard.split(c.feat0, c.g):
                # the fold's orbits span tuples: the whole class pair
                pair = whole_class(c, pair)
                if a == b:
                    continue
                pair = fold(c, pair)[:, a:b]
            elif pair is None:
                continue
            else:
                # the gradient pair is the fold's input as it stands
                pair = fold(c, pair.view(2, c.g, hl))
            nsz = (b - a) * hl
            dsum, hits = pair[0].reshape(nsz), pair[1].reshape(nsz)
            at = c.start + a * hl - lo
            blk = slice(at, at + nsz)
            if tc:
                _tc_apply(state.weights[blk], state.opt_e[blk],
                          state.opt_a[blk], state.alpha,
                          dsum / hits.clamp(min=1.0))
            else:
                state.weights[blk].add_(dsum / hits.clamp(min=1.0)
                                        if mean else dsum)

    def cross_update(state: TDState, delta: torch.Tensor) -> None:
        """Canonical form, gather classes: one sparse update at the
        canonical-orbit indices, in place.  "sum" scales each hit by
        its orbit multiplicity (the exact 8-image total); "mean"
        divides it by the entry's exact hit count this step (canonical
        indices collide often: near-empty boards share orbits)."""
        cidx = state.prev_cidx
        per = delta[:, None].expand(cidx.shape)
        if not mean:
            per = per * state.prev_cmult.to(torch.float32)
        valid = state.prev_valid
        if mesh is not None:
            # every rank applies the global batch's list, in its order
            cidx, per, valid = mesh.all_gather_rows(cidx, per, valid)
        valid = valid[:, None].expand(cidx.shape)
        flat = cidx.reshape(-1).long()
        if shard is not None:
            # the entries of other shards add exact zeros at entry 0
            held, flat = table_dispatch._owned(shard, flat)
            valid = valid & held.view(cidx.shape)
        per = torch.where(valid, per, 0.0)
        # one stable order of the list for the three tables and the
        # mean's hits, each entry's terms summed in a fixed order: one
        # seed gives one table on the card, and every replica of a mesh
        # takes the same bits
        apply = kernels.cross_apply if table_dispatch.uses_kernels(
            ops, flat.device) else kernels.cross_apply_reference
        apply(state.weights, state.opt_e, state.opt_a, state.alpha, flat,
              per.reshape(-1), valid.reshape(-1), mean)

    def global_pair(pair: torch.Tensor) -> torch.Tensor:
        """The table-sized (under a model axis, shard-sized) [dsum;
        hits] pair (or its dsum) summed over the data group: as heavy
        as the table, and as the reference's all-reduce under GSPMD
        off the canonical form."""
        return pair if mesh is None else mesh.all_reduce(pair)

    def table_update(state: TDState, td_err: torch.Tensor) -> None:
        """Off the canonical form: the update over the whole table, at
        the (N * num_sym, F) rows of ``prev_idx``, in place."""
        n = td_err.shape[0]
        idx = state.prev_idx.reshape(n * num_sym, num_feat)
        valid = state.prev_valid[:, None].expand(n, num_sym).reshape(-1)
        if tc:
            delta = torch.where(state.prev_valid, td_err, 0.0) / float(num_feat)
            pair = global_pair(accumulate(
                state.weights, idx,
                delta[:, None].expand(n, num_sym).reshape(-1), valid))
            if fold_step:
                pair = _symmetrize_sum(ts, pair, mesh)
            # the hit mean whatever update_mode says, as the reference
            _tc_apply(state.weights, state.opt_e, state.opt_a, state.alpha,
                      pair[0] / pair[1].clamp(min=1.0))
            return
        dw = torch.where(state.prev_valid, td_err, 0.0) * (
            state.alpha / float(num_feat))
        dw = dw[:, None].expand(n, num_sym).reshape(-1)
        if not fold_step:
            update(state.weights, idx, dw, valid)
        elif mean:
            pair = _symmetrize_sum(ts, global_pair(accumulate(
                state.weights, idx, dw, valid)), mesh)
            state.weights.add_(pair[0] / pair[1].clamp(min=1.0))
        else:
            dsum = global_pair(accumulate(state.weights, idx, dw, valid)[0])
            state.weights.add_(_symmetrize_sum(ts, dsum, mesh))

    def train_step(state: TDState):
        draws.split()
        score = state.env.score
        device = score.device
        n = score.shape[0]
        ar = torch.arange(n, device=device)

        # --- greedy selection over the 4 afterstates ------------------
        with span("td.actor"):
            if codes_mode:
                codes = state.env.codes
                aftc, delta4, legal, _t = engf.afterstates_full(codes)
                cells4 = engf.cells_from_codes(aftc)  # (4, N, 16)
                # up/down come back transposed: permute their cells back
                tperm = _tperm(device)
                cells4 = torch.stack([cells4[0], cells4[1][..., tperm],
                                      cells4[2], cells4[3][..., tperm]])
                mxu4, gth4, idx4, cidx4, mult4 = train_ev(state.weights,
                                                          cells4)
                masked = torch.where(legal, mxu4 + gth4, float("-inf"))
                # argmax takes the first maximum in both frameworks
                best_dir = masked.argmax(dim=0).to(torch.int32)
                sel_i = best_dir.long()

                def sel(x4):
                    return x4[sel_i, ar]

                best_delta = sel(delta4)
                done = ~legal.any(dim=0)
                idx_c = sel(idx4)  # (N, F)
                # the chosen board's cells: for its 8 images under "index"
                chosen_cells = sel(cells4) if num_sym == 8 else None
                if actor_bf16:
                    # exact TD bootstrap from the chosen afterstate's
                    # indices, read before this step's update (unused on
                    # done rows)
                    best_val = mxu_exact(state.weights, idx_c) + sel(gth4)
                else:
                    best_val = sel(masked)
                chosen_codes = engf.canonicalize_chosen(sel(aftc), best_dir)
            else:
                boards = state.env.boards
                chosen, best_dir, best_val, best_delta, done = select(
                    state.weights, boards)
                chosen_cells = chosen.reshape(n, 16)

        # --- TD update of the previous afterstate ---------------------
        with span("td.class_chain"):
            td_err = torch.where(done, -state.prev_value,
                                 best_delta.to(torch.float32) + best_val
                                 - state.prev_value)
            if canon:
                delta = torch.where(state.prev_valid, td_err,
                                    0.0) / float(num_feat)
                if not tc:
                    delta = delta * state.alpha
                class_block_update(state, delta)
            else:
                table_update(state, td_err)
        with span("td.crosses"):
            if canon and state.prev_cidx.shape[1]:
                cross_update(state, delta)

        # --- advance the environments ---------------------------------
        with span("td.env"):
            new_score = torch.where(done, score, score + best_delta)
            new_odo = torch.where(done, state.env.odometer,
                                  state.env.odometer + 1)
            if codes_mode:
                done_c = done[:, None]
                moved = torch.where(done_c, codes, chosen_codes)
                spawned, pos, val = engf.spawn_codes(moved, draws)
                env = engf.EnvStateC(codes=torch.where(done_c, codes, spawned),
                                     score=new_score, odometer=new_odo)
                tiles = engf.max_tile_codes(codes)
            else:
                done_b = done[:, None, None]
                moved = torch.where(done_b, boards, chosen)
                spawned, pos, val = engine.spawn(moved, draws)
                env = engine.EnvState(boards=torch.where(done_b, boards,
                                                         spawned),
                                      score=new_score, odometer=new_odo)
                tiles = engine.max_tile(boards)

        # --- recorder: rows staged, or written into the logs ----------
        with span("td.recorder"):
            rec = state.recorder
            done_r = done[:r_env]
            odo_r = state.env.odometer[:r_env]
            overflow = rec.overflow | (~done_r & (odo_r >= s_max))
            rec_on = ~done_r & ~overflow
            done_rec = done_r & ~overflow
            mv = best_dir[:r_env].to(torch.int8)
            sp = (pos[:r_env] | ((val[:r_env] - 1) << 4)).to(torch.int8)
            wslot = torch.where(rec_on, odo_r, s_max).to(torch.int32)
            cand = torch.where(done_rec, score[:r_env], -1)
            if staged:
                recinfo = RecStep(
                    mv=mv, sp=sp, wslot=wslot, done=done_r, cand=cand,
                    odo=odo_r,
                    sb=torch.where(done_rec[:, None],
                                   rec.starts.reshape(r_env, 16), 0
                                   ).to(torch.int8),
                )
            else:
                # non-recording lanes write the spill column S
                rows = torch.arange(r_env, device=device)
                rec.moves.index_put_((rows, wslot.long()), mv)
                rec.spawns.index_put_((rows, wslot.long()), sp)
                # the best finished game, from its log row after this write
                if r_env:
                    best_i = cand.argmax().view(1)
                    best = _BestGame(
                        score=cand[best_i][0],
                        moves=rec.moves.index_select(0, best_i)[0, :s_max],
                        spawns=rec.spawns.index_select(0, best_i)[0, :s_max],
                        start=rec.starts.index_select(0, best_i)[0],
                        length=state.env.odometer[best_i][0].clamp(max=s_max))
                else:
                    best = _no_best_game(s_max, device)
                if mesh is not None:
                    best = _global_best(mesh, best,
                                        torch.zeros_like(best.score), span=1)
                rec = _take_best(rec, best)

        # --- episode-completion metrics -------------------------------
        with span("td.episodes"):
            met = state.metrics
            # the rings are replicated and written in global env order
            done_g, score_g, tiles_g = (done, score, tiles) if mesh is None else \
                mesh.all_gather_rows(done, score, tiles.to(torch.int32))
            n_done = done_g.sum(dtype=torch.int32)
            order = done_g.cumsum(0, dtype=torch.int32) - 1
            wpos = torch.where(done_g, (met.ring_pos + order) % ring,
                               ring).long()
            # the lanes that finished nothing all write 0 into the trash
            # slot, so that it holds the same bits whichever write lands
            score_done = torch.where(done_g, score_g, 0)
            tiles_done = torch.where(done_g, tiles_g, 0)
            met.score_ring.index_put_((wpos,), score_done)
            met.tile_ring.index_put_((wpos,), tiles_done)
            metrics = Metrics(
                episodes=met.episodes + n_done,
                score_ring=met.score_ring,
                tile_ring=met.tile_ring,
                ring_pos=met.ring_pos + n_done,
                best_score=torch.maximum(met.best_score, score_done.max()),
            )

            # --- alpha schedule (skipped by the self-annealing TC rule)
            alpha, next_decay = state.alpha, state.next_decay
            mt_done = tiles_done.max()
            top_tile = torch.maximum(state.top_tile, mt_done)
            if not tc:
                # f32 throughout: the Python floats take the tensor's type
                low = acfg.low_alpha_limit

                def decayed(a):
                    return _round4((a * acfg.decay).clamp(min=low))

                # every decay_step episodes (the count after this step's
                # completions), and at a new top tile (against the old one)
                trig1 = (metrics.episodes > next_decay) & (alpha > low)
                alpha = torch.where(trig1, decayed(alpha), alpha)
                trig2 = mt_done > state.top_tile
                alpha = torch.where(trig2, decayed(alpha), alpha)
                next_decay = torch.where(trig1 | trig2,
                                         metrics.episodes + acfg.decay_step,
                                         next_decay)

        # --- auto-reset finished envs ---------------------------------
        with span("td.reset"):
            if codes_mode:
                env = engf.reset_where_codes(env, done, draws)
                fresh = engf.boards_from_codes(env.codes[:r_env])
            else:
                env = engine.reset_where(env, done, draws)
                fresh = env.boards[:r_env]
            starts = torch.where(done_r[:, None, None], fresh, rec.starts)
            overflow = overflow & ~done_r

            # --- next step's bootstrap state --------------------------
            if num_sym == 8:
                sym_idx = ntuple.all_symmetry_indices(ts, chosen_cells)
            elif codes_mode:
                sym_idx = idx_c[:, None, :]  # selected, not recomputed
            else:
                sym_idx = ntuple.feature_indices(ts,
                                                 chosen_cells)[:, None, :]
            prev_cidx, prev_cmult = state.prev_cidx, state.prev_cmult
            if prev_cidx.shape[1]:
                if codes_mode:
                    cidx_n, cmult_n = sel(cidx4), sel(mult4)
                else:
                    cidx_n, cmult_n = canonical_gather_indices(ts,
                                                               chosen_cells)
                prev_cidx = torch.where(done[:, None], prev_cidx, cidx_n)
                prev_cmult = torch.where(done[:, None], prev_cmult, cmult_n)
            out = state._replace(
                alpha=alpha,
                next_decay=next_decay,
                top_tile=top_tile,
                env=env,
                prev_idx=torch.where(done[:, None, None], state.prev_idx,
                                     sym_idx),
                prev_value=torch.where(done, 0.0, best_val),
                prev_valid=~done,
                metrics=metrics,
                recorder=rec._replace(starts=starts, overflow=overflow),
                prev_cidx=prev_cidx,
                prev_cmult=prev_cmult,
            )
        return (out, recinfo) if staged else out

    return train_step


def _symmetrize_sum(ts: TupleSet, x: torch.Tensor, mesh=None
                    ) -> torch.Tensor:
    """``symmetrize_sum`` of a table (..., total), or of this rank's
    shard of it (..., shard) under a model axis: one all-gather of the
    shards over the model group, then the shard's entries of the whole
    table's sum."""
    shard = None if mesh is None else mesh.table_shard(ts)
    if shard is None:
        return symmetrize_sum(ts, x)
    sizes = [b - a for a, b in zip(shard.bounds, shard.bounds[1:])]
    whole = mesh.all_gather_cat(x, sizes, dim=-1, axis="model")
    return symmetrize_sum(ts, whole)[..., shard.lo: shard.hi]


class _BestGame(NamedTuple):
    """A candidate for the recorder's best game."""

    score: torch.Tensor  # i32 scalar (-1: none)
    moves: torch.Tensor  # (S,) i8
    spawns: torch.Tensor  # (S,) i8
    start: torch.Tensor  # (4, 4) i8
    length: torch.Tensor  # i32 scalar


def _no_best_game(s_max: int, device) -> _BestGame:
    """The candidate of a rank that records no env."""
    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return _BestGame(score=torch.tensor(-1, dtype=torch.int32, device=device),
                     moves=zeros((s_max,), torch.int8),
                     spawns=zeros((s_max,), torch.int8),
                     start=zeros((4, 4), torch.int8),
                     length=zeros((), torch.int32))


def _global_best(mesh, best: _BestGame, order: torch.Tensor,
                 span: int) -> _BestGame:
    """The ranks' candidates all-gathered once (one int8 row each:
    score, ``order`` and length as bytes, start board, moves, spawns)
    and the winner picked on the device: the largest score, then the
    largest ``order`` (in [0, span)), then the lowest rank, which is the
    single-device pick when ``order`` ranks a rank's candidate as the
    single device's scan would."""
    i8, i32 = torch.int8, torch.int32
    s_max = best.moves.shape[0]
    head = torch.stack([best.score.to(i32), order.to(i32),
                        best.length.to(i32)])
    row = torch.cat([head.view(i8), best.start.reshape(16).to(i8),
                     best.moves, best.spawns])
    rows = mesh.all_gather(row[None])  # (world, 12 + 16 + 2 S)
    heads = rows[:, :12].contiguous().view(i32)  # (world, 3)
    key = heads[:, 0].long() * span + heads[:, 1].long()
    win = rows[key.argmax()]  # argmax: the first maximum, the lowest rank
    head = win[:12].contiguous().view(i32)
    return _BestGame(score=head[0], moves=win[28: 28 + s_max],
                     spawns=win[28 + s_max:], start=win[12:28].reshape(4, 4),
                     length=head[2])


def _take_best(rec: Recorder, best: _BestGame) -> Recorder:
    """The recorder with ``best`` as its best game if it beats the one
    it holds."""
    take = best.score > rec.best_score
    return rec._replace(
        best_moves=torch.where(take, best.moves, rec.best_moves),
        best_spawns=torch.where(take, best.spawns, rec.best_spawns),
        best_start=torch.where(take, best.start, rec.best_start),
        best_len=torch.where(take, best.length, rec.best_len),
        best_score=torch.where(take, best.score, rec.best_score),
    )


def _merge_staged_recorder(rec: Recorder, starts0: torch.Tensor,
                           recs: RecStep, s_max: int, mesh=None) -> Recorder:
    """Fold a segment's stacked (K, R) ``RecStep`` rows into the
    recorder (``tpu2048/agent/td.py::_merge_staged_recorder``).

    One scatter per log buffer: the steps of each env's episode that
    was running at segment start (before its first completion) and of
    the episode running at segment end (from its last completion on).
    Start-episode writes below the end episode's slot count are masked
    out, so the two slot ranges are disjoint and nothing depends on
    the order of duplicate writes; the masked writes belong to an
    episode whose row is never read again.  The best finished game
    among the first completions is composed from the OLD log row and
    the staged window, so it is read before the scatter; episodes
    that start and finish inside the segment are rebuilt from the
    staged rows.  ``starts0`` is the start boards at segment start.
    Updates the logs in place.

    Under a ``mesh`` the rows are this rank's recorded envs; its
    candidate meets the other ranks' once (``_global_best``), and the
    winner is the single device's: the first maximum in global env
    order among the first completions, an in-segment game (the
    earliest step, then the lowest env) only when strictly greater.
    """
    mv, sp, wslot, done_k, cand_k, odo_k, sb_k = recs
    k, r = mv.shape
    dev = mv.device
    if r == 0:  # a rank that records no env still meets the others
        best = _global_best(mesh, _no_best_game(s_max, dev),
                            torch.zeros((), dtype=torch.int32, device=dev),
                            span=k + 1)
        return _take_best(rec, best)
    kk = torch.arange(k, device=dev)[:, None]
    fdone = torch.where(done_k, kk, k).amin(dim=0)  # first completion
    ldone = torch.where(done_k, kk, -1).amax(dim=0)  # last completion
    ldone_eff = torch.where(ldone >= 0, ldone, k)
    end_cnt = torch.where(ldone >= 0, k - 1 - ldone, 0)
    col = torch.where(
        kk < fdone[None, :],
        torch.where(wslot >= end_cnt[None, :], wslot, s_max),
        torch.where(kk >= ldone_eff[None, :], wslot, s_max),
    ).long()

    # best among this segment's first completions: old log row (slots
    # [0, L - f)) + the staged window (slots [L - f, L) = steps [0, f))
    fidx = fdone.clamp(max=k - 1)[None, :]
    cand_fd = torch.where(fdone < k, cand_k.gather(0, fidx)[0], -1)
    len_fd = odo_k.gather(0, fidx)[0]
    best_i = cand_fd.argmax()
    cand_cross = cand_fd[best_i]
    l_cr = len_fd[best_i].clamp(max=s_max)
    off_cr = l_cr - fdone[best_i]
    pos = torch.arange(s_max, device=dev)
    t_cr = (pos - off_cr).clamp(0, k - 1)
    in_win = (pos >= off_cr) & (pos < l_cr)
    bm_cross = torch.where(in_win, mv[:, best_i][t_cr],
                           rec.moves[best_i, :s_max])
    bs_cross = torch.where(in_win, sp[:, best_i][t_cr],
                           rec.spawns[best_i, :s_max])

    # best among episodes contained entirely in this segment
    in_seg = done_k & (kk - odo_k >= 0)
    cand_in = torch.where(in_seg, cand_k, -1).reshape(-1)
    flat_in = cand_in.argmax()
    k_in, r_in = flat_in // r, flat_in % r
    cand_ins = cand_in[flat_in]
    len_in = odo_k[k_in, r_in]
    w = min(k, s_max)
    win = (k_in - len_in).clamp(min=0) + torch.arange(k, device=dev)
    live = torch.arange(w, device=dev) < len_in

    def window(x):  # (K, R) staged rows -> (S,) log of the in-segment best
        padded = torch.cat([x[:, r_in], torch.zeros(k, dtype=x.dtype,
                                                   device=dev)])
        out = torch.zeros(s_max, dtype=x.dtype, device=dev)
        out[:w] = torch.where(live, padded[win][:w], 0)
        return out

    bm_in, bs_in = window(mv), window(sp)
    start_in = sb_k[k_in, r_in].reshape(4, 4)

    use_in = cand_ins > cand_cross
    best = _BestGame(
        score=torch.maximum(cand_ins, cand_cross),
        moves=torch.where(use_in, bm_in, bm_cross),
        spawns=torch.where(use_in, bs_in, bs_cross),
        start=torch.where(use_in, start_in, starts0[best_i]),
        length=torch.where(use_in, len_in, l_cr))
    if mesh is not None:
        # at one score a first completion beats any in-segment game,
        # and an in-segment game of an earlier step a later one's
        best = _global_best(mesh, best,
                            torch.where(use_in, k - 1 - k_in, k), span=k + 1)

    # the scatter, after every read of the old rows above; the steps
    # that record nothing all write 0 into the spill column, so that it
    # holds the same bits whichever write lands
    rows = torch.arange(r, device=dev).expand(k, r)
    spill = col == s_max
    rec.moves.index_put_((rows, col), torch.where(spill, 0, mv))
    rec.spawns.index_put_((rows, col), torch.where(spill, 0, sp))
    return _take_best(rec, best)


def make_train_segment(ts: TupleSet, acfg: AgentConfig, tcfg: TrainConfig,
                       draws: Draws, mesh=None):
    """``tcfg.steps_per_call`` staged train steps, then one merge of
    their recorder rows: ``segment(state) -> state``.  The reference's
    ``lax.scan`` is a Python loop here; the host reads nothing from the
    device inside it.  Under ``sym_mode="periodic"`` the segment ends
    by projecting the weights (and the TC sums) onto the D4-symmetric
    subspace (``symmetrize_table``), as the reference's does; the
    tables are replicated under a ``mesh`` without a model axis, so
    every rank projects its own with no collective, and under one each
    rank projects its shard from one all-gather of each table
    (``_symmetrize_sum``).  Under a profiler the segment, its steps and
    each step's stages are spans (``obs/profiler.py``)."""
    step = make_train_step(ts, acfg, tcfg, draws, mesh=mesh)

    def segment(state: TDState) -> TDState:
        with span("td.segment"):
            starts0 = state.recorder.starts
            recs: List[RecStep] = []
            for _ in range(tcfg.steps_per_call):
                with span("td.step"):
                    state, rs = step(state)
                recs.append(rs)
            with span("td.merge"):
                stacked = RecStep(*(torch.stack(f) for f in zip(*recs)))
                state = state._replace(recorder=_merge_staged_recorder(
                    state.recorder, starts0, stacked, tcfg.max_record_steps,
                    mesh))
            if acfg.sym_mode == "periodic":
                with span("td.symmetrize"):
                    # symmetrize_table: the orbit sum over 8
                    state = state._replace(
                        weights=_symmetrize_sum(ts, state.weights, mesh) / 8.0)
                    if acfg.optimizer == "tc":
                        state = state._replace(
                            opt_e=_symmetrize_sum(ts, state.opt_e, mesh) / 8.0,
                            opt_a=_symmetrize_sum(ts, state.opt_a, mesh) / 8.0)
        return state

    return segment
