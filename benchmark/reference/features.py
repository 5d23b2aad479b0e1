"""N-tuple features in plain PyTorch, from a configuration's tuple list.

A tuple is an ordered list of cells and a base.  Its table has
``base ** len(cells)`` entries; a board's entry is
``sum_j d_j * base ** (k - 1 - j)`` over the tuple's cells in order,
with ``d_j`` the cell's exponent, clipped at ``base - 1`` where the base
is below 16.  The tables lie one after another in one flat table, in
the configuration's order.

Symmetry.  The eight symmetries of the square map a tuple's cells onto
another tuple's (the configurations hold whole orbits of tuples).  An
entry is a pattern "these cells hold these exponents", and its images
are the same pattern on the mapped cells.  Tuples of at most 16 ** 4
entries are stored whole and learn on all eight images of the board
(the 8-image update).  The larger ones are stored at one entry per
orbit, the orbit's smallest flat index: a board reads, and updates,
that canonical entry.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

WHOLE_MAX = 16 ** 4  # tables up to this size are stored whole


class Tuples(NamedTuple):
    cells: Tuple[Tuple[int, ...], ...]  # flat cell numbers, in order
    bases: Tuple[int, ...]
    offsets: Tuple[int, ...]
    total: int
    whole: Tuple[int, ...]  # tuples stored whole
    canon: Tuple[int, ...]  # tuples stored at one entry per orbit


def tuples_from_config(spec: List[dict]) -> Tuples:
    cells, bases, offsets, at = [], [], [], 0
    for t in spec:
        cs = tuple(4 * int(i) + int(j) for i, j in t["cells"])
        cells.append(cs)
        bases.append(int(t["base"]))
        offsets.append(at)
        at += int(t["base"]) ** len(cs)
    whole = tuple(f for f in range(len(cells))
                  if bases[f] ** len(cells[f]) <= WHOLE_MAX)
    canon = tuple(f for f in range(len(cells)) if f not in whole)
    return Tuples(tuple(cells), tuple(bases), tuple(offsets), at, whole,
                  canon)


def symmetries() -> np.ndarray:
    """(8, 16): p[s] maps a cell of the image board to the cell of the
    original board it shows, ``image[c] = board[p[s][c]]``."""
    grid = np.arange(16).reshape(4, 4)
    out = []
    for k in range(4):
        r = np.rot90(grid, k)
        out.append(r.reshape(16))
        out.append(r.T.reshape(16))
    return np.stack(out)


def _weights(base: int, k: int) -> np.ndarray:
    return np.array([base ** (k - 1 - j) for j in range(k)], np.int64)


@lru_cache(maxsize=None)
def _orbit_plan(ts: Tuples) -> Tuple[np.ndarray, ...]:
    """For each symmetry s and canonical tuple f: the tuple g whose
    cells are the image of f's, and the cells of the original board that
    g reads on the image board, in g's order."""
    perms = symmetries()
    by_set = {frozenset(c): g for g, c in enumerate(ts.cells)}
    plans = []
    for p in perms:
        rows = []
        for f in ts.canon:
            src = {c for c in range(16) if p[c] in ts.cells[f]}
            g = by_set[frozenset(src)]
            rows.append((g, [int(p[c]) for c in ts.cells[g]]))
        plans.append(rows)
    return plans


def _digits(boards: torch.Tensor, base: int) -> torch.Tensor:
    return boards.clamp(max=base - 1) if base < 16 else boards


def indices(ts: Tuples, boards: torch.Tensor,
            feats: Tuple[int, ...]) -> torch.Tensor:
    """(B, 16) boards -> (B, len(feats)) flat-table indices, int64."""
    cols = []
    for f in feats:
        d = _digits(boards[:, list(ts.cells[f])], ts.bases[f])
        w = torch.from_numpy(_weights(ts.bases[f], len(ts.cells[f]))).to(
            boards.device)
        cols.append((d * w).sum(dim=-1) + ts.offsets[f])
    return torch.stack(cols, dim=-1)


def image_indices(ts: Tuples, boards: torch.Tensor) -> torch.Tensor:
    """(B, 16) -> (B, 8, len(ts.whole)): the whole tuples' indices on all
    eight images of each board."""
    perms = torch.from_numpy(symmetries()).to(boards.device)
    return torch.stack([indices(ts, boards[:, perms[s]], ts.whole)
                        for s in range(8)], dim=1)


def canonical_indices(ts: Tuples, boards: torch.Tensor) -> torch.Tensor:
    """(B, 16) -> (B, len(ts.canon)): each canonical tuple's entry as the
    smallest flat index over its orbit."""
    best = None
    for rows in _orbit_plan(ts):
        cols = []
        for g, src in rows:
            d = _digits(boards[:, src], ts.bases[g])
            w = torch.from_numpy(_weights(ts.bases[g], len(src))).to(
                boards.device)
            cols.append((d * w).sum(dim=-1) + ts.offsets[g])
        idx = torch.stack(cols, dim=-1)
        best = idx if best is None else torch.minimum(best, idx)
    return best
