"""The comparisons that decide ``correct``: what the timed path produced,
against the plain reference (``benchmark/reference``) on the same
inputs.

Training.  The reference starts from the benchmark's own weights and
boards and follows the program's first ``checked_segments`` segments
step by step, on the same draws.  It plays the program's moves, read
from the program's move logs, and judges each (``move_gap``); where the
log no longer holds a move (a game that started and ended inside one
segment is not kept), it chooses by its own table from then on and that
game is no longer judged.  After the segments it compares the program's
games (``env_diverged_share``), its tables, leaf by leaf
(``table_gap_worst_leaf``), and its bootstrap values (``value_gap_p90``).

Search.  For a sample of the window's steps, drawn from the seed, the
reference values every game's four afterstates with its own expectimax
on the same draws, and judges the program's moves (``move_gap``) and
the boards they led to (``board_mismatch_share``).
"""

from __future__ import annotations

from typing import Dict

import torch

def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """Each number beside its limit; correct when none is above it (a
    missing number, or NaN, fails)."""
    out = {}
    ok = True
    for name, lim in limits.items():
        v = numbers.get(name)
        good = v is not None and v == v and v <= lim
        ok = ok and good
        out[name] = {"value": v, "limit": lim}
    return {"correct": ok, "compared": out}


# -- training ------------------------------------------------------------------


def train_snapshot(state) -> dict:
    """The program's state after the checked segments, on the host."""
    env = state.env
    return {k: v.detach().to("cpu", copy=True) for k, v in {
        "w": state.weights, "e": state.opt_e, "a": state.opt_a,
        "codes": env.codes, "score": env.score, "odo": env.odometer,
        "prev_value": state.prev_value, "prev_valid": state.prev_valid,
    }.items()}


def follow_train(ts, cfg: dict, seed: int, device, n: int, k: int,
                 segments: int, logs, odos, dtype=torch.float32,
                 ref_moves=None, step_moves=None):
    """The reference over ``segments`` segments of ``k`` steps.

    ``logs[c]`` (n, slots) int8 and ``odos[c]`` (n,) are the program's
    move logs and odometers after segment c; ``step_moves``, a list of
    each step's (n,) moves, stands in for them where the moves come
    whole (the control); with neither the reference plays by its own
    table (``ref_moves``, if a list, gets each step's moves).  Returns
    (state, largest move gap)."""
    from reference import game, learner

    from .draws import KeyedDraws
    from .train import make_weights

    src = KeyedDraws(seed, device).remake()
    w0 = make_weights(ts.total, seed, device, cfg["weights"])
    st = learner.start(w0, game.fresh(*src.starts(("new", 0), n)), dtype)
    del w0
    gap = torch.zeros((), device=device)
    lost = torch.zeros(n, dtype=torch.bool, device=device)
    ar = torch.arange(n, device=device)
    odo_before = torch.zeros(n, dtype=torch.int64, device=device)
    for c in range(segments):
        if logs is not None:
            log = logs[c].to(device).long()
            odo_end = odos[c].to(device).long()
            ended = odo_end != odo_before + k
            # the episode running at the segment's end holds slots
            # [0, odo_end); the one running at its start keeps its slots
            # from odo_end on
            end_cnt = torch.where(ended, odo_end, 0)
            phase = torch.zeros(n, dtype=torch.int64, device=device)
        for t in range(k):
            s = c * k + t
            moves = None if step_moves is None else step_moves[s]
            if logs is not None:
                slot = st.odo.clamp(max=log.shape[1] - 1)
                m = log[ar, slot]
                in_start = (phase == 0) & (st.odo >= end_cnt)
                in_end = phase == 2
                known = (in_start | in_end) & ~lost
                moves = torch.where(known, m, -1)
            st, g, chosen = learner.step(
                ts, st, src.spawn_pair(("spawn", s), n),
                src.starts(("reset", s), n), moves)
            if ref_moves is not None:
                ref_moves.append(chosen)
            if moves is not None:
                gap = torch.maximum(gap, g.max())
            if logs is not None:
                done = chosen < 0
                # a legal move the log did not hold: the game is the
                # reference's own from here on
                lost = lost | (~known & ~done)
                # a game that ended: the next one is the segment's last
                # when the program's odometer says it ran k - 1 - t steps
                last = ended & (end_cnt == k - 1 - t)
                phase = torch.where(done, torch.where(last, 2, 1), phase)
        if logs is not None:
            odo_before = odo_end
    return st, float(gap)


def quantile(x: torch.Tensor, q: float) -> float:
    """The q-quantile of a 1-d tensor (a strided sample of at most 8 M
    of its values when it is longer)."""
    x = x.reshape(-1)
    if x.numel() == 0:
        return float("inf")
    step = -(-x.numel() // 8_000_000)
    x = x[::step].sort().values
    return float(x[min(x.numel() - 1, int(q * x.numel()))])


def entry_gaps(prog, ref, base, touched) -> torch.Tensor:
    """Per touched entry: |prog - ref| over the reference's change there
    plus the median change of all touched entries."""
    change = (ref - base).abs()[touched] if base is not None \
        else ref.abs()[touched]
    s = quantile(change, 0.5)
    return (prog[touched] - ref[touched]).abs() / (change + s)


def train_numbers(ts, cfg: dict, seed: int, snap: dict, ref, gap: float,
                  device) -> Dict[str, float]:
    """The compared numbers, and beside them the readings the look at
    their causes used (``*_max``, ``*_p50``, the worst leaf)."""
    from reference import game

    from .train import make_weights

    codes = snap["codes"].to(device)
    diverged = ((game.from_codes(codes) != ref.boards).any(dim=1)
                | (snap["score"].to(device).long() != ref.score)
                | (snap["odo"].to(device).long() != ref.odo))
    out = {"env_diverged_share": float(diverged.float().mean()),
           "move_gap_max": gap}
    w0 = make_weights(ts.total, seed, device, cfg["weights"])
    touched = ref.a.float() > 0
    leaves, p90, p50 = [], [], []
    for name, prog, refv, base in (("w", snap["w"], ref.w, w0),
                                   ("e", snap["e"], ref.e, None),
                                   ("a", snap["a"], ref.a, None)):
        prog, refv = prog.to(device), refv.float()
        leaves.append(leaf_gap(ts, prog, refv, base, ref.e.float()))
        g = entry_gaps(prog, refv, base, touched)
        p90.append(quantile(g, 0.9))
        p50.append(quantile(g, 0.5))
        del g
    del w0
    same = ~diverged & ref.prev_valid
    pv, rv = snap["prev_value"].to(device), ref.prev_value
    if bool(same.any()):
        size = rv.abs().clamp(min=quantile(rv[same].abs(), 0.5))
        vg = ((pv - rv).abs() / size)[same]
    else:
        vg = torch.full((1,), float("inf"), device=device)
    out.update({"table_gap_p90": max(p90), "table_gap_p50": max(p50),
                "table_gap_worst_leaf": max(leaves),
                "value_gap_p90": quantile(vg, 0.9),
                "value_gap_p50": quantile(vg, 0.5),
                "value_gap_max": float(vg.max())})
    return out


def leaf_gap(ts, prog, ref, base, ref_e) -> float:
    """The worst leaf's gap of norms of change: a leaf is one tuple's
    table; its gap is | |prog - base| - |ref - base| | over the larger
    of its reference norm and the median leaf's.  Leaves whose
    reference E (the summed steps) is under a thousandth of the median
    leaf's moved by round-off alone and are left out."""
    pn, rn, en = [], [], []
    for f, cells in enumerate(ts.cells):
        at = ts.offsets[f]
        sl = slice(at, at + ts.bases[f] ** len(cells))
        b = 0.0 if base is None else base[sl]
        pn.append(float((prog[sl] - b).norm()))
        rn.append(float((ref[sl] - b).norm()))
        en.append(float(ref_e[sl].norm()))
    med = sorted(rn)[len(rn) // 2]
    emed = sorted(en)[len(en) // 2]
    worst = 0.0
    for p, r, e in zip(pn, rn, en):
        if e < 1e-3 * emed:
            continue
        worst = max(worst, abs(p - r) / max(r, med, 1e-30))
    return worst


def train_check(cell) -> Dict[str, float]:
    snap = cell.snapshot
    ref, gap = follow_train(
        cell.ts_ref, cell.config, cell.seed, cell.device, cell.n_envs,
        cell.k, cell.checked, cell.logs, cell.odos)
    return train_numbers(cell.ts_ref, cell.config, cell.seed, snap, ref,
                         gap, cell.device)


# -- search ------------------------------------------------------------------


def search_judge(cell, steps, lower: bool = False):
    """Over the sampled steps: (largest move gap, boards that differ,
    games judged).  With ``lower`` the control's own moves (the reference
    in lower precision) are judged instead of the program's, and the
    boards are not compared."""
    from reference import game, search

    from .draws import KeyedDraws
    from .train import make_weights

    dev = cell.device
    ts, sc = cell.ts_ref, cell.scfg
    src = KeyedDraws(cell.seed, dev).remake()
    w = make_weights(ts.total, cell.seed, dev, cell.config["weights"])
    gap, mismatched, judged = 0.0, 0, 0
    cap = int(cell.traffic["checked_steps"])
    for prev, cur in zip(steps, steps[1:]):
        if cur.log is None or cur.start:
            continue
        if judged >= cap:
            break
        boards = game.from_codes(prev.codes.to(dev))
        active = prev.active.to(dev)
        n = boards.shape[0]
        ar = torch.arange(n, device=dev)
        aft, sc4, legal = game.afterstates(boards)
        roots = aft.reshape(4 * n, 16)
        need = (legal & active[None, :]).reshape(-1) & \
            (game.empties(roots) < sc.since_empty)
        path = ("search", cur.draw_step)
        vals = search.root_values(ts, w, roots, need, src, path, sc.depth,
                                  sc.width, sc.since_empty).reshape(4, n)
        masked = torch.where(legal, vals, float("-inf"))
        stepping = active & legal.any(dim=0)
        if lower:
            low = search.root_values(ts, w, roots, need, src, path,
                                     sc.depth, sc.width, sc.since_empty,
                                     lower=True).reshape(4, n)
            m = torch.where(legal, low, float("-inf")).argmax(dim=0)
        else:
            slot = prev.odo.to(dev).long().clamp(max=cur.log.shape[1] - 1)
            m = cur.log.to(dev)[ar, slot].long()
        top = masked.max(dim=0).values
        got = masked[m.clamp(0, 3), ar]
        size = top.abs().clamp(min=float(top[stepping].abs().median())
                               if bool(stepping.any()) else 1.0)
        g = torch.where(stepping, (top - got) / size, 0.0)
        gap = max(gap, float(g.max()))
        if not lower:
            u, v = src.spawn_pair(("spawn", cur.draw_step), n)
            moved = aft[m.clamp(0, 3), ar]
            spawned, _, _ = game.spawn(moved, u, v)
            want = torch.where(stepping[:, None], spawned, boards)
            got_b = game.from_codes(cur.codes.to(dev))
            mismatched += int((want != got_b).any(dim=1).sum())
        judged += 1
    return gap, mismatched, judged


def search_check(cell) -> Dict[str, float]:
    gap, mismatched, judged = search_judge(cell, cell.steps)
    games = judged * cell.games
    return {"move_gap": gap if judged else float("inf"),
            "board_mismatch_share": mismatched / games if games
            else float("inf")}
