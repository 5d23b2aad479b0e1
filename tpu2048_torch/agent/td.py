"""Batched TD(0) n-tuple actor-learner (``tpu2048/agent/td.py``).

N environments step in lockstep on one device.  Per step the actor
picks the greedy afterstate of every env, and the learner applies the
temporal-coherence (TC) update of the previous afterstate with the
reference's semantics: gamma 1, greedy play, ``dw = (reward +
V(s'_best) - V(s_prev)) / num_feat`` with ``V(s'_best)`` read before
this step's update, ``-V(s_last) / num_feat`` at game over, the same
dw on all 8 D4 images, and each entry's summed update divided by its
hit count this step ("mean").

The port covers the shipped configuration only: ``sym_impl=
"canonical"``, ``optimizer="tc"``, ``update_mode="mean"``,
``engine_mode="codes"``, ``actor_precision="bf16"``.  Every other
setting raises ``NotImplementedError``.

Forms that differ from the reference, with the same results:
  * the weight table and the TC accumulators are three flat tensors,
    updated IN PLACE (about 64 MB of copies a step saved at n=5); so
    are the metrics rings and the recorder's logs.  A caller that
    needs the state before a step keeps a copy.  The reference's
    read-before-write order holds: the bootstrap value reads the
    weights before the update, each class block's TC rule reads its
    own w/E/A block before writing it, and the crosses gather E/A
    before their scatters;
  * randomness comes from a draw source (``..draws``), not a key in
    the state;
  * the step always stages its recorder rows (``RecStep``); the
    segment merges them once (``_merge_staged_recorder``).  The
    reference's per-step log scatter and its packed (3, total) scan
    carry are TPU layouts and are not ported;
  * the recorder's (R, S) logs carry one spill column S, where writes
    of lanes that do not record land (the reference drops them).
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import AgentConfig, TrainConfig
from ..draws import Draws
from ..engine import fast as engf
from ..features.canonical import _gather_feat_ids, is_canonical
from ..features.ntuple import TupleSet
from ..features.symmetry import symmetrize_class_sum
from ..ops import dispatch as table_dispatch
from ..ops import kernels

NOT_PORTED = ('ROADMAP.md Queue 1 item 4 ("Learner variants off the '
              'defaults")')


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
    opt_e: torch.Tensor  # (total,) f32 TC signed delta sums
    opt_a: torch.Tensor  # (total,) f32 TC absolute delta sums
    alpha: torch.Tensor  # f32 scalar (TC meta-rate)
    next_decay: torch.Tensor  # i32 scalar
    top_tile: torch.Tensor  # i32 scalar (exponent; starts at 10)
    env: engf.EnvStateC
    prev_idx: torch.Tensor  # (N, 1, F) i32 features of prev afterstate
    prev_value: torch.Tensor  # (N,) f32
    prev_valid: torch.Tensor  # (N,) bool
    metrics: Metrics
    recorder: Recorder
    prev_cidx: torch.Tensor  # (N, K) i32 canonical gather-class indices
    prev_cmult: torch.Tensor  # (N, K) i32 their orbit multiplicities


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


def _check_supported(acfg: AgentConfig) -> None:
    shipped = AgentConfig()
    for name in ("optimizer", "update_mode", "sym_mode", "sym_impl",
                 "actor_precision", "engine_mode"):
        got, want = getattr(acfg, name), getattr(shipped, name)
        if got != want:
            raise NotImplementedError(
                f"{name}={got!r} is not ported yet (the port trains "
                f"{name}={want!r} only); it waits for {NOT_PORTED}")


def init_td_state(ts: TupleSet, acfg: AgentConfig, tcfg: TrainConfig,
                  draws: Draws, device,
                  weights: Optional[torch.Tensor] = None) -> TDState:
    """A fresh train state on ``device``: U[0, 0.01) weights from
    ``draws.uniform`` unless ``weights`` is given, fresh boards from
    ``draws.new``, zeroed TC accumulators, rings and logs."""
    device = torch.device(device)
    n, s = tcfg.num_envs, tcfg.max_record_steps
    r_env = record_env_count(tcfg)
    if weights is None:
        weights = draws.uniform((ts.total,)) * 0.01
    weights = weights.to(device=device, dtype=torch.float32).contiguous()
    env = engf.init_env_codes(n, draws)
    env = engf.EnvStateC(*(t.to(device) for t in env))

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=device)

    i8, i32 = torch.int8, torch.int32
    rec = Recorder(
        moves=zeros((r_env, s + 1), i8),
        spawns=zeros((r_env, s + 1), i8),
        starts=engf.boards_from_codes(env.codes[:r_env]),
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
    opt_shape = (ts.total,) if acfg.optimizer == "tc" else (0,)
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


def _tc_rate(e: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The TC per-weight rate |E| / A (1 where A is still 0)."""
    return torch.where(a > 0.0, e.abs() / a.clamp(min=1e-30), 1.0)


def make_train_step(ts: TupleSet, acfg: AgentConfig, tcfg: TrainConfig,
                    draws: Draws):
    """The batched TD(0) train step: ``step(state) -> (state,
    RecStep)``.  Updates the state's tables, rings and its step-local
    recorder fields in place (see the module doc); draws its spawns
    and resets from ``draws``.

    ``acfg.table_ops`` resolves per call from the weights' device:
    "auto" takes the CUDA kernels (``eval_class``, ``grad_class``,
    ``fold_class``) on the card and plain torch elsewhere; "pallas"
    takes the kernels' wrappers on any device (their plain versions on
    CPU tensors); "search" is "pallas" on the card and "gather"
    elsewhere; "gather" takes plain torch everywhere."""
    _check_supported(acfg)
    num_feat = ts.num_feat
    ring = tcfg.ring_size
    r_env = record_env_count(tcfg)
    s_max = tcfg.max_record_steps
    classes_c, class_grads = table_dispatch.make_class_grads(
        ts, acfg.table_ops)
    # selection in bf16 over 4N rows; the chosen afterstate's value is
    # re-derived exactly from its indices (the TD bootstrap)
    train_ev = table_dispatch.make_train_evaluator(
        ts, acfg.table_ops, canonical=True, precision="bf16")
    mxu_exact = table_dispatch.make_mxu_eval_idx(ts, acfg.table_ops)

    def fold(c, pair):
        if table_dispatch.uses_kernels(acfg.table_ops, pair.device):
            return kernels.fold_class(ts, c.feat0, c.g, pair)
        return symmetrize_class_sum(ts, c.feat0, c.g, pair)

    def class_block_update(state: TDState, delta: torch.Tensor) -> None:
        """16^2..16^4 classes: [dsum; hits] pairs, their D4 fold, and
        the TC rule on each class block, in place."""
        pairs = class_grads(state.prev_idx.reshape(-1, num_feat), delta,
                            state.prev_valid)
        for c, pair in zip(classes_c.matmul, pairs):
            nsz = c.g * c.h * c.l
            # the gradient pair is the fold's input as it stands
            pair = fold(c, pair.view(2, c.g, c.h * c.l))
            dbar = pair[0].reshape(nsz) / pair[1].reshape(nsz).clamp(min=1.0)
            blk = slice(c.start, c.start + nsz)
            w_blk = state.weights[blk]
            e_blk = state.opt_e[blk]
            a_blk = state.opt_a[blk]
            lr_b = _tc_rate(e_blk, a_blk)
            w_blk.add_(state.alpha * lr_b * dbar)
            e_blk.add_(dbar)
            a_blk.add_(dbar.abs())

    def cross_update(state: TDState, delta: torch.Tensor) -> None:
        """Gather classes: one sparse TC update at the canonical-orbit
        indices, each hit divided by its entry's exact hit count this
        step (canonical indices collide often: near-empty boards share
        orbits), in place."""
        cidx = state.prev_cidx
        valid = state.prev_valid[:, None].expand(cidx.shape)
        per = torch.where(valid, delta[:, None], 0.0)
        flat = cidx.reshape(-1).long()
        hits_g = torch.zeros(ts.total, dtype=torch.float32,
                             device=cidx.device)
        hits_g.index_add_(0, flat, valid.to(torch.float32).reshape(-1))
        per = per / hits_g[cidx.long()].clamp(min=1.0)
        # gather E/A before any of the three scatters
        lr_g = _tc_rate(state.opt_e[flat], state.opt_a[flat]).view(cidx.shape)
        state.weights.index_add_(0, flat,
                                 (state.alpha * lr_g * per).reshape(-1))
        state.opt_e.index_add_(0, flat, per.reshape(-1))
        state.opt_a.index_add_(0, flat, per.abs().reshape(-1))

    def train_step(state: TDState) -> Tuple[TDState, RecStep]:
        draws.split()
        codes = state.env.codes
        score = state.env.score
        device = codes.device
        n = codes.shape[0]
        ar = torch.arange(n, device=device)

        # --- greedy selection over the 4 afterstates ------------------
        aftc, delta4, legal, _t = engf.afterstates_full(codes)
        cells4 = engf.cells_from_codes(aftc)  # (4, N, 16)
        # up/down come back transposed: permute their cells back
        tperm = _tperm(device)
        cells4 = torch.stack([cells4[0], cells4[1][..., tperm],
                              cells4[2], cells4[3][..., tperm]])
        mxu4, gth4, idx4, cidx4, mult4 = train_ev(state.weights, cells4)
        masked = torch.where(legal, mxu4 + gth4, float("-inf"))
        # argmax takes the first maximum in both frameworks
        best_dir = masked.argmax(dim=0).to(torch.int32)
        sel_i = best_dir.long()

        def sel(x4):
            return x4[sel_i, ar]

        best_delta = sel(delta4)
        done = ~legal.any(dim=0)
        idx_c = sel(idx4)  # (N, F)
        # exact TD bootstrap from the chosen afterstate's indices, read
        # before this step's update (unused on done rows)
        best_val = mxu_exact(state.weights, idx_c) + sel(gth4)
        chosen_codes = engf.canonicalize_chosen(sel(aftc), best_dir)

        # --- TD update of the previous afterstate ---------------------
        td_err = torch.where(done, -state.prev_value,
                             best_delta.to(torch.float32) + best_val
                             - state.prev_value)
        delta = torch.where(state.prev_valid, td_err, 0.0) / float(num_feat)
        class_block_update(state, delta)
        if state.prev_cidx.shape[1]:
            cross_update(state, delta)

        # --- advance the environments ---------------------------------
        done_c = done[:, None]
        new_score = torch.where(done, score, score + best_delta)
        new_odo = torch.where(done, state.env.odometer,
                              state.env.odometer + 1)
        moved = torch.where(done_c, codes, chosen_codes)
        spawned, pos, val = engf.spawn_codes(moved, draws)
        env = engf.EnvStateC(codes=torch.where(done_c, codes, spawned),
                             score=new_score, odometer=new_odo)

        # --- recorder rows (merged once per segment) ------------------
        rec = state.recorder
        done_r = done[:r_env]
        odo_r = state.env.odometer[:r_env]
        overflow = rec.overflow | (~done_r & (odo_r >= s_max))
        rec_on = ~done_r & ~overflow
        done_rec = done_r & ~overflow
        recinfo = RecStep(
            mv=best_dir[:r_env].to(torch.int8),
            sp=(pos[:r_env] | ((val[:r_env] - 1) << 4)).to(torch.int8),
            wslot=torch.where(rec_on, odo_r, s_max).to(torch.int32),
            done=done_r,
            cand=torch.where(done_rec, score[:r_env], -1),
            odo=odo_r,
            sb=torch.where(done_rec[:, None], rec.starts.reshape(r_env, 16),
                           0).to(torch.int8),
        )

        # --- episode-completion metrics -------------------------------
        met = state.metrics
        n_done = done.sum(dtype=torch.int32)
        order = done.cumsum(0, dtype=torch.int32) - 1
        wpos = torch.where(done, (met.ring_pos + order) % ring, ring).long()
        tiles = engf.max_tile_codes(codes)
        met.score_ring.index_put_((wpos,), score)
        met.tile_ring.index_put_((wpos,), tiles)
        metrics = Metrics(
            episodes=met.episodes + n_done,
            score_ring=met.score_ring,
            tile_ring=met.tile_ring,
            ring_pos=met.ring_pos + n_done,
            best_score=torch.maximum(met.best_score,
                                     torch.where(done, score, 0).max()),
        )
        # the TC rule skips the alpha schedule; the top tile still moves
        top_tile = torch.maximum(state.top_tile,
                                 torch.where(done, tiles, 0).max())

        # --- auto-reset finished envs ---------------------------------
        env = engf.reset_where_codes(env, done, draws)
        fresh = engf.boards_from_codes(env.codes[:r_env])
        starts = torch.where(done_r[:, None, None], fresh, rec.starts)
        overflow = overflow & ~done_r

        # --- next step's bootstrap state ------------------------------
        prev_cidx, prev_cmult = state.prev_cidx, state.prev_cmult
        if prev_cidx.shape[1]:
            prev_cidx = torch.where(done_c, prev_cidx, sel(cidx4))
            prev_cmult = torch.where(done_c, prev_cmult, sel(mult4))
        out = state._replace(
            top_tile=top_tile,
            env=env,
            prev_idx=torch.where(done[:, None, None], state.prev_idx,
                                 idx_c[:, None, :]),
            prev_value=torch.where(done, 0.0, best_val),
            prev_valid=~done,
            metrics=metrics,
            recorder=rec._replace(starts=starts, overflow=overflow),
            prev_cidx=prev_cidx,
            prev_cmult=prev_cmult,
        )
        return out, recinfo

    return train_step


def _merge_staged_recorder(rec: Recorder, starts0: torch.Tensor,
                           recs: RecStep, s_max: int) -> Recorder:
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
    """
    mv, sp, wslot, done_k, cand_k, odo_k, sb_k = recs
    k, r = mv.shape
    dev = mv.device
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
    seg_best = torch.maximum(cand_ins, cand_cross)
    take = seg_best > rec.best_score
    best_moves = torch.where(take, torch.where(use_in, bm_in, bm_cross),
                             rec.best_moves)
    best_spawns = torch.where(take, torch.where(use_in, bs_in, bs_cross),
                              rec.best_spawns)
    best_start = torch.where(take, torch.where(use_in, start_in,
                                               starts0[best_i]),
                             rec.best_start)
    best_len = torch.where(take, torch.where(use_in, len_in, l_cr),
                           rec.best_len)

    # the scatter, after every read of the old rows above
    rows = torch.arange(r, device=dev).expand(k, r)
    rec.moves.index_put_((rows, col), mv)
    rec.spawns.index_put_((rows, col), sp)
    return rec._replace(
        best_moves=best_moves,
        best_spawns=best_spawns,
        best_start=best_start,
        best_len=best_len,
        best_score=torch.where(take, seg_best, rec.best_score),
    )


def make_train_segment(ts: TupleSet, acfg: AgentConfig, tcfg: TrainConfig,
                       draws: Draws):
    """``tcfg.steps_per_call`` train steps, then one merge of their
    staged recorder rows: ``segment(state) -> state``.  The
    reference's ``lax.scan`` is a Python loop here; the host reads
    nothing from the device inside it."""
    step = make_train_step(ts, acfg, tcfg, draws)

    def segment(state: TDState) -> TDState:
        starts0 = state.recorder.starts
        recs: List[RecStep] = []
        for _ in range(tcfg.steps_per_call):
            state, rs = step(state)
            recs.append(rs)
        stacked = RecStep(*(torch.stack(f) for f in zip(*recs)))
        return state._replace(recorder=_merge_staged_recorder(
            state.recorder, starts0, stacked, tcfg.max_record_steps))

    return segment
