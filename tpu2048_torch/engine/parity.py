"""Sequential CPU parity engine (``tpu2048/engine/parity.py``).

A verbatim copy (numpy only), kept here because importing it from the
JAX package would load jax through ``tpu2048/engine/__init__.py``;
``tests/test_torch_shared.py`` holds the two equal.  A single-board
engine that reproduces the observable behaviour of abachurin/2048
*exactly* under a fixed seed — same Mersenne Twister RNG call order
(``random.randrange(10)`` for the tile value, then ``random.choice``
over empty cells enumerated in row-major ``np.where`` order; see
``game2048/game_logic.py:96-121`` there), same move semantics, same
scoring, same recorded ``moves``/``tiles`` logs.  This is the
trajectory oracle for the vectorized engines and stays out of the
device paths.

The move itself is resolved through the same row LUT as the vectorized
engine (``lut.py``), which the LUT unit tests pin to the rules.
"""

from __future__ import annotations

import pickle
import random
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from .lut import build_row_tables

_T = build_row_tables()

Estimator = Callable[[np.ndarray, int], float]


def random_eval(row: np.ndarray, score: int) -> float:
    """Random-policy baseline estimator (reference ``game_logic.py:5-6``)."""
    return float(np.random.random())


def score_eval(row: np.ndarray, score: int) -> float:
    """Greedy-score baseline estimator (reference ``game_logic.py:9-10``)."""
    return float(score)


class ParityGame:
    """Sequential 2048 game with reference-identical RNG consumption.

    Pass ``rng=random.Random(seed)`` for an isolated stream, or leave
    ``None`` to consume the global ``random`` module exactly like the
    reference does (required for fixed-seed parity runs).
    """

    actions = {0: "left", 1: "up", 2: "right", 3: "down"}

    def __init__(
        self,
        score: int = 0,
        row: Optional[np.ndarray] = None,
        rng: Optional[random.Random] = None,
    ):
        self.rng = rng if rng is not None else random
        self.score = score
        self.odometer = 0
        self.moves: List[int] = []
        self.tiles: List[Tuple[int, Tuple[int, int]]] = []
        self.history: Dict[int, Tuple[np.ndarray, int, int]] = {}
        if row is None:
            self.row = np.zeros((4, 4), dtype=np.int32)
            self.new_tile()
            self.new_tile()
            self.tiles = []
            self.starting_position = self.row.copy()
        else:
            self.row = np.array(row, dtype=np.int32)
            self.starting_position = self.row.copy()

    # -- board queries ----------------------------------------------------

    @staticmethod
    def empty(row: np.ndarray) -> List[Tuple[int, int]]:
        zeros = np.where(row == 0)
        return list(zip(zeros[0], zeros[1]))

    @staticmethod
    def empty_count(row: np.ndarray) -> int:
        return 16 - int(np.count_nonzero(row))

    @staticmethod
    def adjacent_pair_count(row: np.ndarray) -> int:
        return (
            24
            - int(np.count_nonzero(row[:, :3] - row[:, 1:]))
            - int(np.count_nonzero(row[:3, :] - row[1:, :]))
        )

    def game_over(self, row: np.ndarray) -> bool:
        return not self.empty_count(row) and not self.adjacent_pair_count(row)

    # -- stochastic spawn (reference RNG call order) ----------------------

    def create_new_tile(self, row: np.ndarray) -> Tuple[int, Tuple[int, int]]:
        em = self.empty(row)
        tile = 1 if self.rng.randrange(10) else 2
        position = self.rng.choice(em)
        return tile, position

    def new_tile(self) -> None:
        tile, position = self.create_new_tile(self.row)
        self.row[position] = tile
        self.tiles.append((tile, position))

    # -- moves via the shared row LUT -------------------------------------

    def pre_move(
        self, row: np.ndarray, score: int, direction: int
    ) -> Tuple[np.ndarray, int, bool]:
        ob = np.rot90(row, direction) if direction else row
        codes = (
            (ob[:, 0].astype(np.int64) << 12)
            | (ob[:, 1].astype(np.int64) << 8)
            | (ob[:, 2].astype(np.int64) << 4)
            | ob[:, 3].astype(np.int64)
        )
        cells = _T.cells[codes].astype(np.int32)
        new_score = score + int(_T.score[codes].sum())
        changed = bool(_T.changed[codes].any())
        nb = np.rot90(cells, 4 - direction) if direction else cells
        return nb, new_score, changed

    def make_move(self, direction: int) -> bool:
        self.row, self.score, changed = self.pre_move(
            self.row, self.score, direction
        )
        self.odometer += 1
        self.moves.append(direction)
        return changed

    # -- greedy policy / episode runners ----------------------------------

    def _find_best_move(
        self,
        estimator: Estimator,
        depth: int = 0,
        width: int = 1,
        since_empty: int = 0,
    ) -> Tuple[int, Optional[np.ndarray], Optional[int]]:
        best_dir, best_value = 0, -np.inf
        best_row, best_score = None, None
        for direction in range(4):
            new_row, new_score, changed = self.pre_move(
                self.row, self.score, direction
            )
            if changed:
                value = self.look_forward(
                    estimator, new_row, new_score, depth, width, since_empty
                )
                if value > best_value:
                    best_dir, best_value = direction, value
                    best_row, best_score = new_row, new_score
        return best_dir, best_row, best_score

    def _move_on(
        self, best_dir: int, best_row: np.ndarray, best_score: int
    ) -> None:
        self.moves.append(best_dir)
        self.odometer += 1
        self.row, self.score = best_row, best_score
        self.new_tile()

    def trial_run(
        self,
        estimator: Estimator,
        limit_tile: int = 0,
        step_limit: int = 100000,
        depth: int = 0,
        width: int = 1,
        since_empty: int = 0,
        record_history: bool = False,
    ) -> None:
        """Play one full episode greedily (reference ``trial_run``)."""
        while self.odometer < step_limit:
            if self.game_over(self.row):
                if record_history:
                    self.history[self.odometer] = (
                        self.row.copy(),
                        self.score,
                        -1,
                    )
                self.moves.append(-1)
                return
            if limit_tile and int(np.max(self.row)) >= limit_tile:
                break
            best_dir, best_row, best_score = self._find_best_move(
                estimator, depth, width, since_empty
            )
            if record_history:
                self.history[self.odometer] = (
                    self.row.copy(),
                    self.score,
                    best_dir,
                )
            self._move_on(best_dir, best_row, best_score)

    def generate_run(
        self,
        estimator: Estimator,
        limit_tile: int = 0,
        depth: int = 0,
        width: int = 1,
        since_empty: int = 16,
    ):
        """Yield (game, move) pairs for live watching (ref ``generate_run``)."""
        while True:
            if self.game_over(self.row):
                return
            if limit_tile and int(np.max(self.row)) >= limit_tile:
                break
            best_dir, best_row, best_score = self._find_best_move(
                estimator, depth, width, since_empty
            )
            yield self, best_dir
            self._move_on(best_dir, best_row, best_score)

    # -- sampled expectimax (reference ``look_forward``) -------------------

    def look_forward(
        self,
        estimator: Estimator,
        row: np.ndarray,
        score: int,
        depth: int,
        width: int,
        since_empty: int,
    ) -> float:
        if depth == 0:
            return estimator(row, score)
        empty = self.empty_count(row)
        if empty >= since_empty:
            return estimator(row, score)
        num_tiles = min(width, empty)
        empty_cells = self.empty(row)
        tile_positions = self.rng.sample(empty_cells, num_tiles)
        average = 0.0
        for position in tile_positions:
            new_tile = 1 if self.rng.randrange(10) else 2
            new_row = row.copy()
            new_row[position] = new_tile
            if self.game_over(new_row):
                best_value = -100.0
            else:
                best_value = -np.inf
                for direction in range(4):
                    test_row, test_score, changed = self.pre_move(
                        new_row, score, direction
                    )
                    if changed:
                        value = self.look_forward(
                            estimator,
                            test_row,
                            test_score,
                            depth - 1,
                            width,
                            since_empty,
                        )
                        best_value = max(best_value, value)
            average += max(best_value, 0.0)
        return average / num_tiles

    # -- replay & persistence ---------------------------------------------

    def replay_chain(self) -> Dict[int, Tuple[Optional[np.ndarray], Optional[int], int]]:
        """Re-simulate from the recorded moves+tiles logs.

        Deterministic replay oracle (reference ``replay``,
        ``game_logic.py:246-269``) — without the reference's
        out-of-range read when no terminal sentinel was recorded.
        """
        chain: Dict[int, Tuple[Optional[np.ndarray], Optional[int], int]] = {}
        g = ParityGame(row=self.starting_position)
        for i in range(self.odometer):
            chain[i] = (g.row.copy(), g.score, self.moves[i])
            g.row, g.score, _ = g.pre_move(g.row, g.score, self.moves[i])
            g.odometer += 1
            tile, position = self.tiles[i]
            g.row[tuple(position)] = tile
        final_move = (
            self.moves[self.odometer] if len(self.moves) > self.odometer else -1
        )
        chain[self.odometer] = (g.row.copy(), g.score, final_move)
        chain[self.odometer + 1] = (None, None, -1)
        return chain

    def to_record(self) -> dict:
        """Portable game record (JSON/npz-friendly, no pickled classes)."""
        return {
            "starting_position": np.asarray(self.starting_position, np.int8),
            "moves": np.asarray(self.moves, np.int8),
            "tiles": np.asarray(
                [(t, p[0], p[1]) for t, p in self.tiles], np.int8
            ).reshape(-1, 3),
            "score": int(self.score),
            "odometer": int(self.odometer),
            "final_board": np.asarray(self.row, np.int8),
        }

    @staticmethod
    def from_record(rec: dict) -> "ParityGame":
        g = ParityGame(row=np.array(rec["starting_position"], np.int32))
        g.moves = [int(m) for m in rec["moves"]]
        g.tiles = [
            (int(t), (int(i), int(j))) for t, i, j in np.asarray(rec["tiles"])
        ]
        g.score = int(rec["score"])
        g.odometer = int(rec["odometer"])
        g.row = np.array(rec["final_board"], np.int32)
        return g

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self.to_record(), f, -1)

    @staticmethod
    def load(path: str) -> "ParityGame":
        with open(path, "rb") as f:
            return ParityGame.from_record(pickle.load(f))

    def __str__(self) -> str:
        lines = []
        for j in range(4):
            lines.append(
                "".join(
                    f"{(1 << int(v)) if v else 0}".ljust(8)
                    for v in self.row[j]
                )
            )
        lines.append(
            f"score = {self.score} moves = {self.odometer} "
            f"reached {1 << int(np.max(self.row))}"
        )
        return "\n".join(lines)
