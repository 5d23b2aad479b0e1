"""The cells engine on torch tensors (``tpu2048/engine/core.py``).

Boards are (N, 4, 4) int8 tensors of tile exponents.  Each row packs
into a 16-bit code whose slide-left result comes from the row tables
(``lut.py``); a move in direction d is rot90^d, slide left, rot90^-d.
Directions: 0 left, 1 up, 2 right, 3 down.  Random draws come from a
draw source (``..draws``), through the same sites as the codes engine
(``fast.py``), so the same draws give the same boards in both engines
and in the reference.

The packed row-code engine (``fast.py``) carries trial and training;
this one is the reference's board-shaped engine, used by the search's
``engine_mode="cells"`` and by the host-side replay helpers below.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..draws import Draws
from .lut import build_row_tables

_T = build_row_tables()


class EnvState(NamedTuple):
    """Lockstep environment batch state."""

    boards: torch.Tensor  # (N, 4, 4) int8 tile exponents
    score: torch.Tensor  # (N,) int32 current score
    odometer: torch.Tensor  # (N,) int32 moves made this episode


@lru_cache(maxsize=None)
def _luts(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(cells (65536, 4) int8, score (65536,) int32, changed (65536,)
    bool) on ``device``, moved there once."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in (_T.cells, _T.score, _T.changed))


def pack_rows(boards: torch.Tensor) -> torch.Tensor:
    """Pack (..., 4, 4) boards into (..., 4) int32 row codes."""
    b = boards.to(torch.int32)
    return (b[..., 0] << 12) | (b[..., 1] << 8) | (b[..., 2] << 4) | b[..., 3]


def _slide_left(boards: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slide every row of every board left through the row tables.

    Returns (new_boards, score_delta (...,), changed (...,)).  A row
    holding an exponent above 15 (two 15s merged) packs past 0xFFFF
    and reads row 0xFFFF, as JAX's clamped gather does."""
    cells, score, changed = _luts(boards.device)
    codes = pack_rows(boards).clamp(max=0xFFFF).long()  # (..., 4)
    return (cells[codes], score[codes].sum(dim=-1, dtype=torch.int32),
            changed[codes].any(dim=-1))


def move(boards: torch.Tensor, direction: int
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Apply one move direction (a Python int) to a (N, 4, 4) batch.

    Returns (new_boards, score_delta, changed)."""
    ob = torch.rot90(boards, direction, dims=(-2, -1)) if direction \
        else boards
    nb, score_delta, changed = _slide_left(ob)
    if direction:
        nb = torch.rot90(nb, 4 - direction, dims=(-2, -1))
    return nb, score_delta, changed


def afterstates(boards: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All 4 afterstates of a (N, 4, 4) batch: aft (4, N, 4, 4) int8,
    delta (4, N) int32, legal (4, N) bool."""
    outs = [move(boards, d) for d in range(4)]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(3))


def is_terminal(boards: torch.Tensor) -> torch.Tensor:
    """(N,) bool: no empty cell and no equal adjacent pair (equals "no
    legal move")."""
    full = (boards != 0).flatten(-2).all(dim=-1)
    no_h = (boards[..., :, :3] != boards[..., :, 1:]).flatten(-2).all(dim=-1)
    no_v = (boards[..., :3, :] != boards[..., 1:, :]).flatten(-2).all(dim=-1)
    return full & no_h & no_v


def spawn(boards: torch.Tensor, draws: Draws
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One random tile on each board: position uniform over the empty
    cells, exponent 1 with p = 0.9 else 2.  A full board is returned
    unchanged, with value 0.

    Returns (new_boards, pos (N,) int32 flat cell index, val (N,)
    int32); the draws are ``fast.spawn_codes``'s."""
    n = boards.shape[0]
    flat = boards.reshape(n, 16)
    empty = flat == 0
    cnt = empty.sum(dim=1, dtype=torch.int32)
    u, v = draws.spawn(n)
    # an f32 product truncated toward zero, as in the reference
    tgt = torch.minimum((u * cnt).to(torch.int32), (cnt - 1).clamp(min=0))
    cum = empty.cumsum(dim=1, dtype=torch.int32)
    hit = (cum == tgt[:, None] + 1) & empty
    pos = hit.to(torch.int32).argmax(dim=1).to(torch.int32)
    val = torch.where(v < 0.9, 1, 2).to(torch.int32)
    has = cnt > 0
    rows = torch.arange(n, device=boards.device)
    newflat = flat.clone()
    newflat[rows, pos.long()] = torch.where(has, val.to(boards.dtype),
                                            flat[rows, pos.long()])
    return newflat.reshape(boards.shape), pos, torch.where(has, val, 0)


def _boards_from_draws(p1, u1, p2r, u2) -> torch.Tensor:
    """(n, 4, 4) int8 boards from the four draws of ``Draws.new`` /
    ``Draws.reset``: the law and draws of ``fast.new_codes``."""
    v1 = torch.where(u1 < 0.9, 1, 2)
    v2 = torch.where(u2 < 0.9, 1, 2)
    p2 = p2r + (p2r >= p1).to(p2r.dtype)
    cells = torch.arange(16, device=p1.device)[None, :]
    flat = (torch.where(cells == p1[:, None], v1[:, None], 0)
            + torch.where(cells == p2[:, None], v2[:, None], 0))
    return flat.to(torch.int8).reshape(-1, 4, 4)


def new_boards(n: int, draws: Draws) -> torch.Tensor:
    """Fresh starting boards: two random tiles each, placed directly
    (the first uniform over 16 cells, the second over the 15 left)."""
    return _boards_from_draws(*draws.new(n))


def reset_where(state: EnvState, done: torch.Tensor, draws: Draws
                ) -> EnvState:
    """Fresh boards for the ``done`` envs (lockstep auto-reset).  The
    draws cover the whole batch, as in ``fast.reset_where_codes``."""
    fresh = _boards_from_draws(*draws.reset(state.boards.shape[0]))
    return EnvState(
        boards=torch.where(done[:, None, None], fresh, state.boards),
        score=torch.where(done, 0, state.score),
        odometer=torch.where(done, 0, state.odometer),
    )


def init_env(n: int, draws: Draws) -> EnvState:
    """Fresh batch of n environments."""
    boards = new_boards(n, draws)
    zeros = torch.zeros(n, dtype=torch.int32, device=boards.device)
    return EnvState(boards=boards, score=zeros, odometer=zeros.clone())


def max_tile(boards: torch.Tensor) -> torch.Tensor:
    """(N,) int32 maximum tile exponent per board."""
    return boards.flatten(-2).amax(dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# Numpy single-board helpers (host-side replay, UIs, tests).
# ---------------------------------------------------------------------------


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
