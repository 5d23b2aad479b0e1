"""Row-move lookup tables for the 2048 slide/merge rule.

A verbatim copy of ``tpu2048/engine/lut.py`` (numpy only), kept here
because importing it from the JAX package would load jax through
``tpu2048/engine/__init__.py``; ``tests/test_torch_engine.py`` holds
the two equal.  Capability parity with the move table of abachurin/2048
(``game2048/game_logic.py:18-39``), but built as flat, device-ready
arrays by a vectorized numpy derivation of the game rules instead of a
Python dict of tuples.

A board row is 4 tile *exponents* (0 = empty, k = tile ``2**k``), packed
into a 16-bit code ``r0<<12 | r1<<8 | r2<<4 | r3``.  For each of the
65,536 codes the tables give the result of sliding the row LEFT:

    cells   (65536, 4) int8   resulting row as exponents
    codes   (65536,)   int32  resulting row re-packed (see caveat below)
    score   (65536,)   int32  score gained: sum of values of tiles created
    changed (65536,)   bool   whether the move changes the row

2048 merge semantics implemented here (re-derived from the rules):
tiles slide toward the move direction; equal adjacent tiles (after the
slide) merge pairwise, leftmost pair first; a tile created by a merge
does not merge again in the same move; each merge of two ``2**x`` tiles
scores ``2**(x+1)``.

Caveat: merging two exponent-15 tiles produces exponent 16, which does
not fit a nibble.  ``cells`` stores it faithfully (int8); ``codes`` for
those rows is not a valid nibble-packing.  The engine only consumes
``cells``/``score``/``changed``; 65,536-tiles are unreachable in
practice (the reference table has the same blind spot).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np


class RowTables(NamedTuple):
    cells: np.ndarray  # (65536, 4) int8
    codes: np.ndarray  # (65536,) int32
    score: np.ndarray  # (65536,) int32
    changed: np.ndarray  # (65536,) bool


def pack_row_np(rows: np.ndarray) -> np.ndarray:
    """Pack (..., 4) exponent rows into 16-bit codes."""
    r = rows.astype(np.int64)
    return (r[..., 0] << 12) | (r[..., 1] << 8) | (r[..., 2] << 4) | r[..., 3]


@lru_cache(maxsize=None)
def build_row_tables() -> RowTables:
    codes = np.arange(65536, dtype=np.int64)
    rows = np.stack([(codes >> s) & 0xF for s in (12, 8, 4, 0)], axis=1)
    rows = rows.astype(np.int32)

    # 1) slide: compact non-zero tiles to the left, preserving order.
    order = np.argsort(rows == 0, axis=1, kind="stable")
    out = np.take_along_axis(rows, order, axis=1)

    # 2) merge pairwise left-to-right.  Zeroing the right member of a
    # merged pair prevents chain merges ([1,1,2] -> [2,2], not [3]).
    score = np.zeros(65536, dtype=np.int32)
    for i in range(3):
        m = (out[:, i] != 0) & (out[:, i] == out[:, i + 1])
        out[m, i] += 1
        out[m, i + 1] = 0
        score[m] += (1 << out[m, i]).astype(np.int32)

    # 3) compact again to close the merge gaps.
    order = np.argsort(out == 0, axis=1, kind="stable")
    out = np.take_along_axis(out, order, axis=1)

    changed = (out != rows).any(axis=1)
    new_codes = pack_row_np(out).astype(np.int32)
    return RowTables(
        cells=out.astype(np.int8),
        codes=new_codes,
        score=score,
        changed=changed,
    )
