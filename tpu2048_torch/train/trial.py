"""Batched greedy evaluation (``tpu2048/train/trial.py``).

Plays N games with a stored agent, all in lockstep on one device, each
exactly once (active mask, no auto-reset), with move and spawn logs
for replay; then reports average score, tile-reach shares, the top-3
final boards, timing, and the best game as a replayable record.  With
``SearchConfig.depth > 0`` each move's afterstates are valued by
root-compacted expectimax (``search/expectimax.py``).

The reference rolls ``steps_per_call`` steps into one ``lax.scan``;
here a segment is a Python loop of the same steps, and the host reads
the device once per segment, and with search once more per step (the
compacted estimator's tier choice).  Under a profiler each step, its
stages and the reads are spans, and the search counts its reads and
roots (``obs/profiler.py``).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..config import SearchConfig
from ..draws import Draws, TorchDraws
from ..engine import core as engine
from ..engine import fast as engf
from ..features import ntuple
from ..obs.logging import Logger
from ..obs.profiler import count, span
from ..search.expectimax import make_compacted_estimator
from . import card_device


class TrialResult(NamedTuple):
    scores: np.ndarray  # (N,) final scores
    tiles: np.ndarray  # (N,) final max-tile exponents
    odometers: np.ndarray  # (N,) moves per game
    final_boards: np.ndarray  # (N,4,4)
    elapsed: float
    report: str
    best_game: Optional[Dict[str, Any]]  # replayable record
    # with search: steps per compaction tier (0: no root needed the
    # tree), tree chunks run, and steps taken
    search_stats: Optional[Dict[str, Any]] = None


class _EvalState(NamedTuple):
    codes: torch.Tensor  # (N, 4) int32 packed row codes
    score: torch.Tensor  # (N,) int32
    odometer: torch.Tensor  # (N,) int32
    active: torch.Tensor  # (N,) bool
    # (N, S+1) int8 logs; column S takes the writes of lanes that did
    # not step and is sliced off at the end
    moves: torch.Tensor
    spawns: torch.Tensor


# transposed-cell -> canonical-cell permutation
_TPERM = np.arange(16).reshape(4, 4).T.reshape(16)


def _make_eval_segment(ts, scfg: SearchConfig, n: int, s_cap: int,
                       k: int, limit_tile: int, draws: Draws,
                       table_ops: str = "auto", policy: str = "value"):
    """A segment: ``k`` steps of the packed row-code engine, updating
    the state's logs in place.  ``segment.search_stats`` sums the
    search's counters over the segment's calls (None without search):
    steps per compaction tier and tree chunks."""
    from ..ops import dispatch as table_dispatch

    if table_ops == "auto" and scfg.depth > 0:
        # the tree values (4 * width)^depth leaves per root: "search"
        # sends the 16^2..16^4 classes through eval_class in
        # single-pass bf16 on the card (a sampled heuristic needs no
        # more) and resolves to "gather" off it, as in the reference
        table_ops = "search"
    search = policy == "value" and scfg.depth > 0
    stats = {"tiers": {}, "chunks": 0} if search else None
    if policy == "value":
        eval_fn = table_dispatch.make_evaluator(ts, table_ops)
    elif policy not in ("random", "score"):
        raise ValueError(f"unknown policy: {policy}")

    def search_values(weights, roots, need):
        def value_fn(b):
            return eval_fn(weights, b.reshape(b.shape[:-2] + (16,)))

        estimator = make_compacted_estimator(
            value_fn, scfg.depth, scfg.width, scfg.since_empty,
            batch=4 * n, input_rep="codes",
        )
        vals = estimator(roots, draws.search(), need)
        for tier, c in estimator.tier_counts.items():
            stats["tiers"][tier] = stats["tiers"].get(tier, 0) + c
        stats["chunks"] += estimator.tree.chunks
        return vals

    def step(st: _EvalState, weights, tperm, ar) -> _EvalState:
        draws.split()
        with span("trial.engine"):
            aft, delta, legal, _t = engf.afterstates_full(st.codes)
            # canonical cells for all 4 afterstates (up/down come back
            # transposed; a cell permutation restores canonical order)
            cells4 = engf.cells_from_codes(aft)  # (4, N, 16)
            cells4 = torch.stack([cells4[0], cells4[1][..., tperm],
                                  cells4[2], cells4[3][..., tperm]])
            if search:
                # root compaction: only legal afterstates of active
                # games that are crowded (empty < since_empty) enter
                # the tree; the rest take the base estimate, as the
                # pruning would
                aftc = torch.stack([
                    aft[0], engf.transpose_codes(aft[1]),
                    aft[2], engf.transpose_codes(aft[3]),
                ]).reshape(4 * n, 4)  # canonical codes
                empty_cnt = (cells4.reshape(4 * n, 16) == 0).sum(dim=1)
                act = st.active[None, :].expand(4, n).reshape(4 * n)
                need = (legal.reshape(4 * n) & act
                        & (empty_cnt < scfg.since_empty))
        if policy == "random":
            # the reference's random_eval baseline: a uniform value per
            # candidate move
            vals = draws.uniform((4, n))
        elif policy == "score":
            # score_eval: greedy on immediate reward
            vals = delta.to(torch.float32)
        elif not search:
            vals = eval_fn(weights, cells4)  # (4, N)
        else:
            count("search.steps")
            vals = search_values(weights, aftc, need).reshape(4, n)
        with span("trial.select"):
            # argmax picks the first maximum in both frameworks: keep the
            # mask and the direction order
            masked = torch.where(legal, vals, float("-inf"))
            best_dir = masked.argmax(dim=0).to(torch.int32)
            sel = best_dir.long()
            aft_sel = aft[sel, ar]
            best_delta = delta[sel, ar]
            chosen = engf.canonicalize_chosen(aft_sel, best_dir)
            done = ~legal.any(dim=0)
            stepping = st.active & ~done
            moved = torch.where(stepping[:, None], chosen, st.codes)
            spawned, pos, val = engf.spawn_codes(moved, draws)
            codes = torch.where(stepping[:, None], spawned, st.codes)
            # lanes that do not step write to the spill column s_cap
            sp = (pos | ((val - 1) << 4)).to(torch.int8)
            wslot = torch.where(stepping, st.odometer.clamp(max=s_cap - 1),
                                s_cap)
            st.moves[ar, wslot] = best_dir.to(torch.int8)
            st.spawns[ar, wslot] = sp
            score = torch.where(stepping, st.score + best_delta, st.score)
            odometer = torch.where(stepping, st.odometer + 1, st.odometer)
            active = st.active & ~done
            if limit_tile:
                active = active & (engf.max_tile_codes(codes) < limit_tile)
        return _EvalState(codes, score, odometer, active, st.moves, st.spawns)

    def segment(st: _EvalState, weights) -> _EvalState:
        device = st.codes.device
        tperm = torch.from_numpy(_TPERM).to(device)
        ar = torch.arange(n, device=device)
        for _ in range(k):
            with span("trial.step"):
                st = step(st, weights, tperm, ar)
        return st

    segment.search_stats = stats
    return segment


def trial(
    ts: ntuple.TupleSet,
    weights: Optional[torch.Tensor],
    num: int = 20,
    seed: int = 0,
    search: Optional[SearchConfig] = None,
    limit_tile: int = 0,
    step_cap: int = 32768,
    steps_per_call: int = 256,
    logger: Optional[Logger] = None,
    game_init: Optional[np.ndarray] = None,
    progress_cb=None,
    stop_cb=None,
    policy: str = "value",
    table_ops: str = "auto",
    device=None,
    draws: Optional[Draws] = None,
) -> TrialResult:
    """Play ``num`` games to completion on the device of ``weights``
    (or ``device`` for the baselines, whose weights may be None: the
    CUDA card unless ``device`` says otherwise; without a card that
    raises) and aggregate statistics.

    ``policy`` selects the estimator: "value" (the agent's n-tuple
    table) or the baselines "random" / "score".  Draws come from
    ``draws`` when given, else from a ``torch.Generator`` on the
    device seeded with ``seed``.
    """
    scfg = search or SearchConfig(depth=0)
    log = logger or Logger(console=False)
    device = (weights.device if weights is not None
              else card_device(device, "trial"))
    if draws is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        draws = TorchDraws(gen)
    seg = _make_eval_segment(
        ts, scfg, num, step_cap, steps_per_call, limit_tile, draws,
        table_ops=table_ops, policy=policy,
    )

    if game_init is not None:
        start = torch.as_tensor(np.asarray(game_init, np.int8), device=device)
        codes = engf.codes_from_boards(start).expand(num, 4).contiguous()
    else:
        codes = engf.new_codes(num, draws)
    logs = torch.zeros((2, num, step_cap + 1), dtype=torch.int8,
                       device=device)
    st = _EvalState(codes=codes,
                    score=torch.zeros(num, dtype=torch.int32, device=device),
                    odometer=torch.zeros(num, dtype=torch.int32,
                                         device=device),
                    active=torch.ones(num, dtype=torch.bool, device=device),
                    moves=logs[0], spawns=logs[1])
    starts = engf.boards_from_codes(st.codes).cpu().numpy()
    if weights is None:
        weights = torch.zeros(0, dtype=torch.float32, device=device)
    t0 = time.time()
    prev_active = np.ones(num, bool)
    steps = 0
    while True:
        if stop_cb is not None and stop_cb():
            break
        st = seg(st, weights)
        steps += steps_per_call
        with span("trial.read"):
            # the one host read of the segment
            host = torch.stack(
                [st.active.to(torch.int32), st.score, st.odometer]
            ).cpu().numpy()
            count("host_reads")
        active_np, scores_np, odos_np = host[0].astype(bool), host[1], host[2]
        n_active = int(active_np.sum())
        with span("trial.progress"):
            # per-game completion log: each game's score/moves as it
            # finishes, plus a running average over completed games
            newly = np.nonzero(prev_active & ~active_np)[0]
            if newly.size:
                for i in newly:
                    log.add(
                        f"game {int(i) + 1}/{num}: score = "
                        f"{int(scores_np[i])}, moves = {int(odos_np[i])}"
                    )
                done_mask = ~active_np
                log.add(
                    f"-- {int(done_mask.sum())}/{num} games done, running "
                    f"average = {float(scores_np[done_mask].mean()):.1f}, "
                    f"{round(time.time() - t0, 1)} s elapsed"
                )
            prev_active = active_np
            if progress_cb is not None:
                progress_cb(st)
        if n_active == 0:
            break
        if int(odos_np.max()) >= step_cap:
            log.add(f"step cap {step_cap} reached with {n_active} active")
            break
    elapsed = time.time() - t0

    scores = st.score.cpu().numpy()
    tiles = engf.max_tile_codes(st.codes).cpu().numpy()
    odos = st.odometer.cpu().numpy()
    finals = engf.boards_from_codes(st.codes).cpu().numpy()
    order = np.argsort(-scores)

    def share(exp: int) -> float:
        return float((tiles >= exp).mean() * 100)

    lines = ["\nBest games:"]
    for i in order[:3]:
        for row in finals[i]:
            lines.append(
                "".join(f"{(1 << int(v)) if v else 0}".ljust(7) for v in row)
            )
        lines.append(f"score = {scores[i]} moves = {odos[i]} "
                     f"reached {1 << int(tiles[i])}\n")
    total_moves = int(odos.sum())
    # one shuffle = one row-LUT move resolution.  Each move resolves
    # the 4 root afterstates, and with search each chance child 4 more
    # at every level: the full tree, an UPPER bound on the work done,
    # since compaction sends only the needy roots into the tree
    expand = 0  # move resolutions per searched board
    for _ in range(scfg.depth):
        expand = scfg.width * (4 + 4 * expand)
    shuffles_per_move = 4 + 4 * expand
    total_shuffles = total_moves * shuffles_per_move
    lines += [
        f"average score of {num} runs = {round(float(scores.mean()), 3)}",
        f"16384 reached in {share(14)}%",
        f"8192 reached in {share(13)}%",
        f"4096 reached in {share(12)}%",
        f"2048 reached in {share(11)}%",
        f"1024 reached in {share(10)}%",
        f"total time = {round(elapsed, 2)}",
        f"average time per move = "
        f"{round(elapsed / max(total_moves, 1) * 1000, 3)} ms",
        f"total env-moves = {total_moves}",
        f"total shuffles = {total_shuffles} "
        f"({shuffles_per_move} per move"
        + (", upper bound: compacted roots skip the tree)"
           if scfg.depth > 0 else ")"),
        f"average time per shuffle = "
        f"{round(elapsed / max(total_shuffles, 1) * 1000, 4)} ms"
        + (" (lower bound)" if scfg.depth > 0 else ""),
    ]
    search_stats = None
    if seg.search_stats is not None:
        search_stats = {**seg.search_stats, "steps": steps}
        lines.append(f"search steps per compaction tier (roots) = "
                     f"{search_stats['tiers']}, tree chunks = "
                     f"{search_stats['chunks']}")
    report = "\n".join(lines)
    log.add(report)

    best = int(order[0])
    if int(odos[best]) >= step_cap:
        best_game = None  # log overflowed; replay would be wrong
    else:
        best_game = _game_record(
            starts[best],
            st.moves[best, :step_cap].cpu().numpy(),
            st.spawns[best, :step_cap].cpu().numpy(),
            int(odos[best]),
        )
    return TrialResult(
        scores=scores,
        tiles=tiles,
        odometers=odos,
        final_boards=finals,
        elapsed=elapsed,
        report=report,
        best_game=best_game,
        search_stats=search_stats,
    )


def _game_record(start, moves, spawns, length) -> Dict[str, Any]:
    """Replay device logs into a portable game record."""
    board = np.asarray(start, np.int8).copy()
    score = 0
    tiles: List = []
    length = min(length, len(moves))
    for t in range(length):
        nb, delta, _ = engine.np_move(board, int(moves[t]))
        score += delta
        sp = int(spawns[t]) & 0xFF
        pos, val = sp & 0xF, (sp >> 4) + 1
        nb = nb.reshape(16).copy()
        nb[pos] = val
        board = nb.reshape(4, 4)
        tiles.append((val, pos // 4, pos % 4))
    return {
        "starting_position": np.asarray(start, np.int8),
        "moves": np.asarray(moves[:length], np.int8),
        "tiles": np.asarray(tiles, np.int8).reshape(-1, 3),
        "score": score,
        "odometer": length,
        "final_board": board,
    }
