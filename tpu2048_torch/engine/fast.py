"""Packed row-code engine on torch tensors (``tpu2048/engine/fast.py``).

Boards are (N, 4) int32 tensors of 16-bit row codes
``r0<<12 | r1<<8 | r2<<4 | r3`` of tile exponents.  Left/right moves
are gathers from precomposed row tables; up/down are the same moves on
the transposed codes, and their afterstates stay TRANSPOSED until the
one chosen afterstate is turned back (``canonicalize_chosen``).

Direction encoding matches the reference: 0 left, 1 up, 2 right,
3 down.  Random draws come from a draw source (``..draws``), so the
same draws give bitwise the same boards as the JAX engine.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..draws import Draws
from .lut import RowTables, build_row_tables, pack_row_np


class CodeTables(NamedTuple):
    left_nc: np.ndarray  # (65536,) int32: newcode | changed << 16
    left_sc: np.ndarray  # (65536,) int32: score
    right_nc: np.ndarray
    right_sc: np.ndarray
    dir_sc: np.ndarray  # (131072,) int32: [left_sc; right_sc] concatenated
    quad: np.ndarray  # (65536, 4) int32: [l_nc, r_nc, l_sc, r_sc] rows


@lru_cache(maxsize=None)
def build_code_tables() -> CodeTables:
    # verbatim copy of tpu2048/engine/fast.py::build_code_tables
    t: RowTables = build_row_tables()
    codes = np.arange(65536, dtype=np.int64)
    nibbles = np.stack([(codes >> s) & 0xF for s in (12, 8, 4, 0)], axis=1)
    rev = pack_row_np(nibbles[:, ::-1]).astype(np.int64)
    left_nc = (t.codes.astype(np.int64) | (t.changed.astype(np.int64) << 16)
               ).astype(np.int32)
    left_sc = t.score.astype(np.int32)
    # right = rev . left . rev, fully precomposed
    r_cells = t.cells[rev][:, ::-1]
    r_codes = pack_row_np(r_cells.astype(np.int64))
    right_nc = (r_codes | (t.changed[rev].astype(np.int64) << 16)
                ).astype(np.int32)
    right_sc = t.score[rev].astype(np.int32)
    dir_sc = np.concatenate([left_sc, right_sc])
    quad = np.stack([left_nc, right_nc, left_sc, right_sc], axis=1)
    return CodeTables(left_nc, left_sc, right_nc, right_sc, dir_sc, quad)


@lru_cache(maxsize=None)
def _quad(device: torch.device) -> torch.Tensor:
    """The (65536, 4) quad table on ``device``, moved there once."""
    return torch.from_numpy(build_code_tables().quad).to(device)


@lru_cache(maxsize=None)
def _shifts(device: torch.device) -> torch.Tensor:
    """Nibble shifts (12, 8, 4, 0) of a row code, on ``device``."""
    return torch.tensor([12, 8, 4, 0], dtype=torch.int32, device=device)


def _nibbles(codes: torch.Tensor) -> torch.Tensor:
    """(..., 4) row codes -> (..., 4, 4) int32 exponents [row, col]."""
    return (codes[..., None] >> _shifts(codes.device)) & 0xF


def _pack(nibbles: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) exponents -> (..., 4) row codes (disjoint bits, so
    the sum is the bitwise or)."""
    return (nibbles << _shifts(nibbles.device)).sum(dim=-1,
                                                   dtype=torch.int32)


# -- representation conversions ---------------------------------------------
#
# Whole-nibble tensor ops instead of the reference's per-nibble
# expressions: the same integers from a few launches, not dozens — the
# serve step is bound by the host's launch rate.


def codes_from_boards(boards: torch.Tensor) -> torch.Tensor:
    return _pack(boards.to(torch.int32))


def boards_from_codes(codes: torch.Tensor) -> torch.Tensor:
    return _nibbles(codes).to(torch.int8)


def cells_from_codes(codes: torch.Tensor) -> torch.Tensor:
    """(..., 4) codes -> (..., 16) int32 cell exponents (row-major)."""
    return _nibbles(codes).reshape(codes.shape[:-1] + (16,))


def transpose_codes(codes: torch.Tensor) -> torch.Tensor:
    """Board transpose in code space."""
    return _pack(_nibbles(codes).transpose(-1, -2))


# -- move resolution --------------------------------------------------------


def afterstates_full(
    codes: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """All 4 afterstates of a (N, 4) code batch: (aft, delta, legal,
    tcodes).

        aft    (4, N, 4) int32 — directions 1 and 3 TRANSPOSED
        delta  (4, N) int32 score gained by each move
        legal  (4, N) bool, whether each move changes the board
        tcodes (N, 4) the transposed input

    One gather of a 16-byte quad row per row code, over the codes and
    their transpose together, resolves both direction families and
    both scores."""
    n = codes.shape[0]
    tcodes = transpose_codes(codes)
    # q[o, b, row] = [l_nc, r_nc, l_sc, r_sc] of orientation o
    # (0 = as is, 1 = transposed); direction d = 2 * family + o
    q = _quad(codes.device)[torch.stack([codes, tcodes])]  # (2, N, 4, 4)
    nc = q[..., :2]  # (2, N, 4 rows, 2 families)
    aft = (nc & 0xFFFF).permute(3, 0, 1, 2).reshape(4, n, 4)
    legal = (nc >> 16).any(dim=2).permute(2, 0, 1).reshape(4, n)
    delta = q[..., 2:].sum(dim=2, dtype=torch.int32
                           ).permute(2, 0, 1).reshape(4, n)
    return aft, delta, legal, tcodes


def afterstates_codes(
    codes: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All 4 afterstates of a (N, 4) code batch: (aft (4, N, 4) int32,
    delta (4, N) int32, legal (4, N) bool), directions 1 and 3
    TRANSPOSED; ``afterstates_full`` without the transposed codes."""
    aft, delta, legal, _t = afterstates_full(codes)
    return aft, delta, legal


@lru_cache(maxsize=None)
def _nc_pair(device: torch.device) -> torch.Tensor:
    """The (65536, 2) [left_nc, right_nc] table on ``device``."""
    t = build_code_tables()
    return torch.from_numpy(np.stack([t.left_nc, t.right_nc], axis=1)
                            ).to(device)


def afterstates_nc(
    codes: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All 4 afterstates of a (N, 4) code batch, without scores:
    (aft (4, N, 4) int32, legal (4, N) bool, tcodes (N, 4)); directions
    1 and 3 TRANSPOSED, as in ``afterstates_full``.

    One gather of an 8-byte [left_nc, right_nc] row per row code of the
    codes and their transpose: the 16 lookups per board of the
    reference.  A code above 0xFFFF (a search child whose masked spawn
    slot carried out of its row, ``search/expectimax.py``) reads row
    0xFFFF, as JAX's clamped gather does."""
    n = codes.shape[0]
    tcodes = transpose_codes(codes)
    both = torch.stack([codes.clamp(max=0xFFFF), tcodes])
    nc = _nc_pair(codes.device)[both]  # (2 orientations, N, 4 rows, 2)
    aft = (nc & 0xFFFF).permute(3, 0, 1, 2).reshape(4, n, 4)
    legal = (nc >> 16).any(dim=2).permute(2, 0, 1).reshape(4, n)
    return aft, legal, tcodes


@lru_cache(maxsize=None)
def _dir_sc(device: torch.device) -> torch.Tensor:
    """The (131072,) [left_sc; right_sc] score table on ``device``."""
    return torch.from_numpy(build_code_tables().dir_sc).to(device)


def chosen_delta(codes: torch.Tensor, tcodes: torch.Tensor,
                 best_dir: torch.Tensor) -> torch.Tensor:
    """Score gained by the chosen direction only, (N,) int32: four
    gathers from ``dir_sc``.  Directions 0 and 2 score the codes, 1 and
    3 the transposed codes ``tcodes``; the left/right family picks the
    table's half."""
    cot = torch.where((best_dir % 2 == 1)[:, None], tcodes, codes)
    fam = (best_dir >= 2).to(torch.int32)[:, None] << 16
    return _dir_sc(codes.device)[cot | fam].sum(dim=-1, dtype=torch.int32)


def canonicalize_chosen(aft_codes: torch.Tensor, best_dir: torch.Tensor
                        ) -> torch.Tensor:
    """Transpose the chosen afterstate back when it came from up/down."""
    need_t = ((best_dir % 2) == 1)[:, None]
    return torch.where(need_t, transpose_codes(aft_codes), aft_codes)


# -- stochastic spawn / reset ----------------------------------------------


def _tile_values(u: torch.Tensor) -> torch.Tensor:
    # exponent 1 (tile 2) with p = 0.9, else 2; the comparison runs in
    # f32 (torch casts the scalar to the tensor's dtype), as in JAX
    return torch.where(u < 0.9, 1, 2).to(torch.int32)


def spawn_codes(
    codes: torch.Tensor, draws: Draws
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One random tile on each board: position uniform over the empty
    cells, value 2 or 4 at 0.9 / 0.1.  Returns (codes, pos, val), with
    val 0 for a full board (left unchanged)."""
    n = codes.shape[0]
    flat = cells_from_codes(codes)  # (N, 16)
    empty = flat == 0
    cnt = empty.sum(dim=1, dtype=torch.int32)
    u, v = draws.spawn(n)
    # u * cnt is an f32 product truncated toward zero, as in the
    # reference (fast.py:263): keep f32 here
    tgt = torch.minimum((u * cnt).to(torch.int32), (cnt - 1).clamp(min=0))
    cum = empty.cumsum(dim=1, dtype=torch.int32)
    hit = (cum == tgt[:, None] + 1) & empty
    # argmax takes no bool; on ints it returns the first maximal index
    pos = hit.to(torch.int32).argmax(dim=1).to(torch.int32)
    val = _tile_values(v)
    has = cnt > 0
    row, col = pos // 4, pos % 4
    add = torch.where(has, val << ((3 - col) * 4), 0)
    one_hot_row = row[:, None] == torch.arange(4, device=codes.device)
    codes_out = codes + torch.where(one_hot_row, add[:, None], 0)
    return codes_out, pos, torch.where(has, val, 0)


def new_codes(n: int, draws: Draws) -> torch.Tensor:
    """Fresh starting boards: two random tiles each, placed directly
    (first uniform over 16 cells, second uniform over the 15 left)."""
    return _two_tile_codes(*draws.new(n))


def _two_tile_codes(p1, u1, p2r, u2) -> torch.Tensor:
    """Boards from the four draws of ``Draws.new`` / ``Draws.reset``."""
    v1, v2 = _tile_values(u1), _tile_values(u2)
    p2 = p2r + (p2r >= p1).to(torch.int32)
    rows = torch.arange(4, device=p1.device)[None, :]
    add1 = torch.where(rows == (p1 // 4)[:, None],
                       (v1 << ((3 - p1 % 4) * 4))[:, None], 0)
    add2 = torch.where(rows == (p2 // 4)[:, None],
                       (v2 << ((3 - p2 % 4) * 4))[:, None], 0)
    return (add1 + add2).to(torch.int32)


class EnvStateC(NamedTuple):
    """Batched env state of the codes engine (``fast.EnvStateC``)."""

    codes: torch.Tensor  # (N, 4) int32 packed row codes
    score: torch.Tensor  # (N,) int32
    odometer: torch.Tensor  # (N,) int32


def reset_where_codes(state: EnvStateC, done: torch.Tensor, draws: Draws
                      ) -> EnvStateC:
    """Fresh boards for the ``done`` envs.  The draws cover the whole
    batch every call, as in the reference, so the draw stream does not
    depend on how many envs finished."""
    fresh = _two_tile_codes(*draws.reset(state.codes.shape[0]))
    return EnvStateC(
        codes=torch.where(done[:, None], fresh, state.codes),
        score=torch.where(done, 0, state.score),
        odometer=torch.where(done, 0, state.odometer),
    )


def init_env_codes(n: int, draws: Draws) -> EnvStateC:
    codes = new_codes(n, draws)
    zeros = torch.zeros(n, dtype=torch.int32, device=codes.device)
    return EnvStateC(codes=codes, score=zeros, odometer=zeros.clone())


def max_tile_codes(codes: torch.Tensor) -> torch.Tensor:
    return cells_from_codes(codes).amax(dim=-1).to(torch.int32)
