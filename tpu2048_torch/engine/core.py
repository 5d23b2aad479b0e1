"""Host-side numpy single-board helpers of ``tpu2048/engine/core.py``.

Only the replay helpers that ``train/trial._game_record`` needs: the
batched cells engine of the reference is not part of the port's
serving path (the packed row-code engine, ``fast.py``, is).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .lut import build_row_tables

_T = build_row_tables()


def np_move(board: np.ndarray, direction: int) -> Tuple[np.ndarray, int, bool]:
    """Host-side single-board move: 0 left, 1 up, 2 right, 3 down."""
    ob = np.rot90(board, direction) if direction else board
    codes = pack_row_np_board(ob)
    cells = _T.cells[codes]
    delta = int(_T.score[codes].sum())
    changed = bool(_T.changed[codes].any())
    nb = np.rot90(cells, 4 - direction) if direction else cells
    return nb.astype(board.dtype), delta, changed


def pack_row_np_board(board: np.ndarray) -> np.ndarray:
    b = board.astype(np.int64)
    return (b[:, 0] << 12) | (b[:, 1] << 8) | (b[:, 2] << 4) | b[:, 3]
