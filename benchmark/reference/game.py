"""The 2048 game in plain PyTorch: moves, spawns and fresh boards.

Written from the rules, not from the program: a board is a (..., 16)
int64 tensor of tile exponents in row-major order (0 = empty, k = the
tile 2**k).  A move slides every tile toward one side; two equal
neighbours merge once, the pair nearest that side first, and score the
new tile's value.  Directions: 0 left, 1 up, 2 right, 3 down.

Randomness is an input.  A spawn takes two uniforms (u, v) in [0, 1)
per board: the tile lands on the ``min(floor(u * empty), empty - 1)``-th
empty cell in row-major order (the product in float32), and is a 2
(exponent 1) when ``v < 0.9``, else a 4.  A fresh board takes four
draws (p1, u1, p2r, u2): the first tile on cell p1 of 16, the second on
cell p2r of the 15 left (p2r, plus one when p2r >= p1), values from u1
and u2 by the same law.
"""

from __future__ import annotations

from functools import lru_cache

import torch


@lru_cache(maxsize=None)
def _left_table() -> tuple:
    """Every 4-cell row (16 ** 4 of them, cell 0 first) slid left:
    (rows (65536, 4) int64, score (65536,) int64)."""
    rows = []
    scores = []
    for code in range(16 ** 4):
        cells = [(code >> (12 - 4 * i)) & 0xF for i in range(4)]
        tiles = [c for c in cells if c]
        out, score, i = [], 0, 0
        while i < len(tiles):
            if i + 1 < len(tiles) and tiles[i] == tiles[i + 1]:
                out.append(tiles[i] + 1)
                score += 1 << (tiles[i] + 1)
                i += 2
            else:
                out.append(tiles[i])
                i += 1
        rows.append(out + [0] * (4 - len(out)))
        scores.append(score)
    return (torch.tensor(rows, dtype=torch.int64),
            torch.tensor(scores, dtype=torch.int64))


def _tables(device):
    rows, score = _left_table()
    return rows.to(device), score.to(device)


def _slide_left(grid: torch.Tensor):
    """(B, 4, 4) grids -> (slid grids, score (B,))."""
    rows, score = _tables(grid.device)
    code = (grid[..., 0] << 12) | (grid[..., 1] << 8) | (grid[..., 2] << 4) \
        | grid[..., 3]
    return rows[code], score[code].sum(dim=-1)


def move(boards: torch.Tensor, direction: int):
    """(B, 16) boards -> (afterstates (B, 16), score (B,), legal (B,))."""
    grid = boards.reshape(-1, 4, 4)
    turned = torch.rot90(grid, direction, dims=(1, 2))
    slid, score = _slide_left(turned)
    back = torch.rot90(slid, -direction, dims=(1, 2)).reshape(-1, 16)
    return back, score, (back != boards).any(dim=-1)


def afterstates(boards: torch.Tensor):
    """(B, 16) -> (aft (4, B, 16), score (4, B), legal (4, B))."""
    outs = [move(boards, d) for d in range(4)]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(3))


def _tile(u: torch.Tensor) -> torch.Tensor:
    return torch.where(u < 0.9, 1, 2).to(torch.int64)


def spawn(boards: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """One tile on each board with empty cells: (boards, pos, val)."""
    empty = boards == 0
    cnt = empty.sum(dim=-1)
    k = torch.minimum((u.float() * cnt.float()).to(torch.int64),
                      (cnt - 1).clamp(min=0))
    rank = empty.cumsum(dim=-1) - 1
    hit = empty & (rank == k[:, None])
    pos = hit.to(torch.int64).argmax(dim=-1)
    val = torch.where(cnt > 0, _tile(v), 0)
    out = boards.clone()
    ar = torch.arange(boards.shape[0], device=boards.device)
    out[ar, pos] = torch.where(cnt > 0, val, boards[ar, pos])
    return out, pos, val


def fresh(p1, u1, p2r, u2) -> torch.Tensor:
    """Fresh boards from the four draws of a start."""
    b = p1.shape[0]
    p1, p2r = p1.long(), p2r.long()
    p2 = p2r + (p2r >= p1).long()
    out = torch.zeros((b, 16), dtype=torch.int64, device=p1.device)
    ar = torch.arange(b, device=p1.device)
    out[ar, p1] = _tile(u1)
    out[ar, p2] = _tile(u2)
    return out


def from_codes(codes: torch.Tensor) -> torch.Tensor:
    """(..., 4) 16-bit row codes ``r0 << 12 | r1 << 8 | r2 << 4 | r3`` ->
    (..., 16) exponents: how the program hands its boards over."""
    shifts = torch.tensor([12, 8, 4, 0], device=codes.device)
    cells = (codes.long()[..., None] >> shifts) & 0xF
    return cells.reshape(codes.shape[:-1] + (16,))


def to_codes(boards: torch.Tensor) -> torch.Tensor:
    shifts = torch.tensor([12, 8, 4, 0], device=boards.device)
    return (boards.reshape(boards.shape[:-1] + (4, 4)) << shifts).sum(
        dim=-1).to(torch.int32)


def empties(boards: torch.Tensor) -> torch.Tensor:
    return (boards == 0).sum(dim=-1)
