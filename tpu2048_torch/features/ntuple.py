"""N-tuple feature indices on torch tensors (``tpu2048/features/ntuple.py``).

The tuple geometry (``_cell_tuples``, ``_d4_perms``, ``get_tuple_set``)
is a verbatim numpy copy of the reference's: importing it from there
would load jax through ``tpu2048/features/__init__.py``.
``tests/test_torch_features.py`` holds the copies equal.

Indices are computed with int32 multiply-adds over the 32-column
(raw, min(x, 13)) cell vector, not with a float matmul as the
reference does: on the card a float32 matmul may run in TF32, which
keeps 10 mantissa bits and would corrupt the base-14 coefficients.
Integer arithmetic is exact in every mode.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

Cell = Tuple[int, int]


class TupleSet(NamedTuple):
    n: int
    num_feat: int  # number of tuples
    matrix: np.ndarray  # (num_feat, 32) float32; cols 0-15 raw, 16-31 clipped@13
    offsets: np.ndarray  # (num_feat,) int32 offsets into the flat table
    sizes: np.ndarray  # (num_feat,) int32 table size per tuple
    total: int  # flat weight-table length
    sym_perms: np.ndarray  # (8, 16) int32 D4 cell permutations


def _cell_tuples(n: int) -> List[Tuple[List[Cell], int]]:
    """Tuple definitions as (ordered cells, base).

    Cell order encodes the packing: index = sum cell_value * base^(k-1-j).
    """
    t: List[Tuple[List[Cell], int]] = []
    if n == 2:
        # vertical pairs then horizontal pairs (row-major ravel order)
        for i in range(3):
            for j in range(4):
                t.append(([(i, j), (i + 1, j)], 16))
        for i in range(4):
            for j in range(3):
                t.append(([(i, j), (i, j + 1)], 16))
    elif n == 3:
        for i in range(2):
            for j in range(4):
                t.append(([(i, j), (i + 1, j), (i + 2, j)], 16))
        for i in range(4):
            for j in range(2):
                t.append(([(i, j), (i, j + 1), (i, j + 2)], 16))
        # bent triples per 2x2 square, excluding one corner each
        for i in range(3):
            for j in range(3):
                t.append(([(i + 1, j), (i + 1, j + 1), (i, j + 1)], 16))
        for i in range(3):
            for j in range(3):
                t.append(([(i, j), (i + 1, j), (i + 1, j + 1)], 16))
        for i in range(3):
            for j in range(3):
                t.append(([(i, j), (i, j + 1), (i + 1, j + 1)], 16))
        for i in range(3):
            for j in range(3):
                t.append(([(i, j), (i + 1, j), (i, j + 1)], 16))
    elif n in (4, 5, 6, 7):
        for j in range(4):  # columns
            t.append(([(0, j), (1, j), (2, j), (3, j)], 16))
        for i in range(4):  # rows
            t.append(([(i, 0), (i, 1), (i, 2), (i, 3)], 16))
        for i in range(3):  # 2x2 squares
            for j in range(3):
                t.append(
                    ([(i, j), (i + 1, j), (i, j + 1), (i + 1, j + 1)], 16)
                )
        if n >= 5:
            # 4 five-cell crosses around the middle cells
            for a in range(2):
                for b in range(2):
                    t.append(
                        (
                            [
                                (1 + a, 1 + b),
                                (a, 1 + b),
                                (1 + a, b),
                                (2 + a, 1 + b),
                                (1 + a, 2 + b),
                            ],
                            16,
                        )
                    )
        if n >= 6:
            # six-cell blocks: n=6 packs base 14 with exponents clipped
            # at 13; n=7 packs the same blocks base 16, unclipped
            base6 = 14 if n == 6 else 16
            # 3x2 vertical blocks
            for a in range(2):
                for b in range(3):
                    t.append(
                        (
                            [
                                (a, b),
                                (a + 1, b),
                                (a + 2, b),
                                (a, b + 1),
                                (a + 1, b + 1),
                                (a + 2, b + 1),
                            ],
                            base6,
                        )
                    )
            # 2x3 horizontal blocks
            for a in range(3):
                for b in range(2):
                    t.append(
                        (
                            [
                                (a, b),
                                (a, b + 1),
                                (a, b + 2),
                                (a + 1, b),
                                (a + 1, b + 1),
                                (a + 1, b + 2),
                            ],
                            base6,
                        )
                    )
    else:
        raise ValueError(f"unsupported tuple order n={n}")
    return t


def _d4_perms() -> np.ndarray:
    """8 cell permutations p with T(b).ravel()[c] == b.ravel()[p[c]]."""
    grid = np.arange(16).reshape(4, 4)
    perms = []
    g = grid
    for _ in range(4):
        perms.append(g.ravel())
        perms.append(g.T.ravel())
        g = np.rot90(g)
    return np.stack(perms).astype(np.int32)


@lru_cache(maxsize=None)
def get_tuple_set(n: int) -> TupleSet:
    tuples = _cell_tuples(n)
    num_feat = len(tuples)
    matrix = np.zeros((num_feat, 32), dtype=np.float32)
    sizes = np.zeros(num_feat, dtype=np.int64)
    for f, (cells, base) in enumerate(tuples):
        k = len(cells)
        col0 = 0 if base == 16 else 16  # clipped values live in cols 16-31
        for j, (i, jj) in enumerate(cells):
            matrix[f, col0 + i * 4 + jj] += float(base ** (k - 1 - j))
        sizes[f] = base**k
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    total = int(sizes.sum())
    assert total < 2**31, "flat table must be int32-indexable"
    assert int(sizes.max()) - 1 <= 2**24 - 1, (
        f"per-class packed index max {int(sizes.max()) - 1} exceeds the "
        "f32 exact-integer range; the index matmul would corrupt indices"
    )
    return TupleSet(
        n=n,
        num_feat=num_feat,
        matrix=matrix,
        offsets=offsets.astype(np.int32),
        sizes=sizes.astype(np.int32),
        total=total,
        sym_perms=_d4_perms(),
    )


@lru_cache(maxsize=None)
def _index_plan(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(cols, coef), both (num_feat, K) with K the largest arity: the
    columns of the 32-wide cell vector each tuple reads and their
    integer place values, padded with coefficient 0."""
    m = get_tuple_set(n).matrix
    k = int((m != 0).sum(axis=1).max())
    cols = np.zeros((m.shape[0], k), np.int64)
    coef = np.zeros((m.shape[0], k), np.int32)
    for f in range(m.shape[0]):
        nz = np.flatnonzero(m[f])
        cols[f, : len(nz)] = nz
        coef[f, : len(nz)] = np.rint(m[f, nz]).astype(np.int32)
    return cols, coef


@lru_cache(maxsize=None)
def _index_tensors(n: int, device: torch.device):
    cols, coef = _index_plan(n)
    ts = get_tuple_set(n)
    return (torch.from_numpy(cols).to(device),
            torch.from_numpy(coef).to(device),
            torch.from_numpy(ts.offsets).to(device))


def cell_vector(flat_boards: torch.Tensor) -> torch.Tensor:
    """(..., 16) exponents -> (..., 32) int32 [raw, min(raw, 13)]."""
    x = flat_boards.to(torch.int32)
    return torch.cat([x, x.clamp(max=13)], dim=-1)


def feature_indices(ts: TupleSet, flat_boards: torch.Tensor) -> torch.Tensor:
    """(..., 16) exponent vectors -> (..., num_feat) int32 flat-table
    indices, exact in int32 (every packed index is < 2^24)."""
    cols, coef, offsets = _index_tensors(ts.n, flat_boards.device)
    v = cell_vector(flat_boards)
    local = (v[..., cols] * coef).sum(dim=-1, dtype=torch.int32)
    return local + offsets


def init_weights(ts: TupleSet, generator: torch.Generator) -> torch.Tensor:
    """U[0, 0.01) init, on the generator's device."""
    return torch.rand(ts.total, generator=generator,
                      device=generator.device) * 0.01
