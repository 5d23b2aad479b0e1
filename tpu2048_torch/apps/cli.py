"""Terminal client of the port (``tpu2048/apps/cli.py``).

Capability parity with the desktop client menu of abachurin/2048
(``show.py:184-216`` there): option 0 play yourself, 1 replay a stored
game, 2 run a trial and replay the best game, 3 watch an agent live —
rendered with ANSI colors in the terminal (the pygame window client
lives in ``viewer.py``).  The trial runs on the CUDA card unless
``--device`` names another device, such as ``cpu``.

Run: ``python -m tpu2048_torch.apps.cli --store ~/.tpu2048``
"""

from __future__ import annotations

import argparse
import random
import sys
import time
from typing import Dict, Optional

import numpy as np

from ..config import SearchConfig
from ..engine.parity import ParityGame
from ..features import ntuple
from ..store import checkpoint as ckpt
from ..store.artifacts import ArtifactStore, open_store

ANSI_COLORS = [240, 196, 199, 127, 93, 33, 37, 107, 34, 208, 202, 94,
               160, 174, 129, 57, 196]


def render_board(board: np.ndarray, score: int, odometer: int,
                 msg: str = "", out=sys.stdout) -> None:
    lines = [f" score = {score}   moves = {odometer}   {msg}"]
    for row in np.asarray(board):
        cells = []
        for v in row:
            v = int(v)
            text = f"{(1 << v) if v else '.':^7}"
            cells.append(f"\x1b[48;5;{ANSI_COLORS[min(v, 16)]}m\x1b[97m"
                         f"{text}\x1b[0m")
        lines.append("".join(cells))
    out.write("\n".join(lines) + "\n\n")
    out.flush()


def np_estimator(ts: ntuple.TupleSet, weights: np.ndarray):
    matrix, offsets = ts.matrix, ts.offsets

    def estimator(row: np.ndarray, score: int) -> float:
        v = np.concatenate([row.ravel(), np.minimum(row.ravel(), 13)])
        idx = (matrix @ v.astype(np.float64)).astype(np.int64) + offsets
        return float(weights[idx].sum())

    return estimator


def play_yourself() -> None:
    """Arrow-key play in the terminal (WASD fallback)."""
    game = ParityGame(rng=random.Random())
    keymap = {"a": 0, "w": 1, "d": 2, "s": 3}
    print("\nWASD to move, r to restart, q to quit\n")
    while True:
        over = game.game_over(game.row)
        render_board(game.row, game.score, game.odometer,
                     "GAME OVER" if over else "")
        cmd = input("> ").strip().lower()
        if cmd == "q":
            return
        if cmd == "r":
            game = ParityGame(rng=random.Random())
            continue
        if cmd in keymap and not over:
            new_row, new_score, changed = game.pre_move(
                game.row, game.score, keymap[cmd]
            )
            if changed:
                game.row, game.score = new_row, new_score
                game.odometer += 1
                game.new_tile()


def replay_game(store: ArtifactStore, name: str, speed_ms: int = 200,
                out=sys.stdout) -> None:
    rec = ckpt.load_game(store, name)
    g = ParityGame(row=np.array(rec["starting_position"], np.int32))
    for t in range(rec["odometer"]):
        move = int(rec["moves"][t])
        render_board(g.row, g.score, t, f"next = {ParityGame.actions[move]}",
                     out=out)
        g.row, g.score, _ = g.pre_move(g.row, g.score, move)
        val, i, j = (int(x) for x in rec["tiles"][t])
        g.row[i, j] = val
        time.sleep(speed_ms / 1000)
    render_board(rec["final_board"], rec["score"], rec["odometer"],
                 "GAME OVER", out=out)


def watch_agent(store: ArtifactStore, name: str, speed_ms: int = 200,
                depth: int = 0, width: int = 1, since_empty: int = 6,
                max_moves: Optional[int] = None, out=sys.stdout) -> None:
    acfg, weights, _ = ckpt.load_agent_dense(store, name, "cpu")
    ts = ntuple.get_tuple_set(acfg.n)
    try:
        from .. import native as native_mod

        ne = (native_mod.NativeEngine(ts, np.asarray(weights),
                                      seed=random.getrandbits(32))
              if native_mod.available() else None)
    except Exception:  # pragma: no cover - toolchain-less hosts
        ne = None
    if ne is not None:
        # C++ fast path: ms-latency stepping even at search depth 3+
        board = np.zeros((4, 4), np.int8)
        board, _, _ = ne.spawn(board)
        board, _, _ = ne.spawn(board)
        score, odo, moves = 0, 0, 0
        while True:
            d, aft, delta = ne.best_move(board, depth=depth, width=width,
                                         since_empty=since_empty)
            if d < 0:
                break
            render_board(board, score, odo,
                         f"next = {ParityGame.actions[d]}", out=out)
            time.sleep(speed_ms / 1000)
            score += delta
            odo += 1
            board, _, _ = ne.spawn(aft)
            moves += 1
            if max_moves is not None and moves >= max_moves:
                return
        render_board(board, score, odo, "GAME OVER", out=out)
        return
    est = np_estimator(ts, np.asarray(weights))
    game = ParityGame(rng=random.Random())
    moves = 0
    for state, move in game.generate_run(est, depth=depth, width=width,
                                         since_empty=since_empty):
        render_board(state.row, state.score, state.odometer,
                     f"next = {ParityGame.actions[move]}", out=out)
        time.sleep(speed_ms / 1000)
        moves += 1
        if max_moves is not None and moves >= max_moves:
            return
    render_board(game.row, game.score, game.odometer, "GAME OVER", out=out)


def trial_and_replay(store: ArtifactStore, name: str, num: int = 100,
                     speed_ms: int = 200, out=sys.stdout,
                     device=None) -> None:
    """Play ``num`` games of agent ``name`` on ``device`` (the CUDA
    card by default) and replay the best."""
    from ..obs.logging import Logger
    from ..train import card_device
    from ..train.trial import trial

    acfg, weights, _ = ckpt.load_agent_dense(
        store, name, card_device(device, "trial_and_replay"))
    ts = ntuple.get_tuple_set(acfg.n)
    res = trial(ts, weights, num=num, logger=Logger(console=True))
    rec = res.best_game
    ckpt.save_game(store, f"best_trial_{name}", rec)
    out.write(f"\nreplaying best game (score {rec['score']})...\n")
    replay_game(store, f"best_trial_{name}", speed_ms, out=out)


def _pick(store: ArtifactStore, what: str) -> Optional[str]:
    prefix = "a/" if what == "agent" else "g/"
    suffix = ".json" if what == "agent" else ".npz"
    items = [k[len(prefix):-len(suffix)]
             for k in store.list_keys(prefix)]
    if not items:
        print(f"no {what}s in store")
        return None
    for i, v in enumerate(items):
        print(f"  {i}: {v}")
    while True:
        try:
            idx = int(input(f"enter index of {what}: "))
            if 0 <= idx < len(items):
                return items[idx]
        except (ValueError, EOFError):
            return None


def _speed() -> int:
    try:
        s = int(input("speed in ms per move (10-2000, default 200): ") or 200)
        return min(max(s, 10), 2000)
    except (ValueError, EOFError):
        return 200


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="tpu2048 terminal client")
    p.add_argument("--store", default="~/.tpu2048")
    p.add_argument("--backend", default="local")
    p.add_argument("--option", type=int, default=None,
                   help="0 play, 1 replay, 2 trial+replay, 3 watch")
    p.add_argument("--device", default=None,
                   help="device of the trial (default: the CUDA card)")
    args = p.parse_args(argv)
    store = open_store(args.backend, args.store)
    print("option 0 = play yourself")
    print("option 1 = replay a game from storage")
    print("option 2 = trial a trained agent over 100 games, replay best")
    print("option 3 = watch a trained agent play live")
    option = args.option
    if option is None:
        try:
            option = int(input("> "))
        except (ValueError, EOFError):
            return
    if option == 0:
        play_yourself()
    elif option == 1:
        name = _pick(store, "game")
        if name:
            replay_game(store, name, _speed())
    elif option == 2:
        name = _pick(store, "agent")
        if name:
            trial_and_replay(store, name, speed_ms=_speed(),
                             device=args.device)
    elif option == 3:
        name = _pick(store, "agent")
        if name:
            watch_agent(store, name, _speed())


if __name__ == "__main__":
    main()
