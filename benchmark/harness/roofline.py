"""The yardstick of the per-layer shares: the card's published peak and
the bytes each piece of work needs, counted from its shapes.

Every count is of bytes moved through device memory, each input read
once and each output written once; the card's peak is NVIDIA's data
sheet figure for the H100 SXM at its full 700 W: 3.35 TB/s of HBM.  All
the work counted here is bound by bytes, not by operations.
"""

from __future__ import annotations

from typing import Iterable

HBM_BYTES_PER_S = 3.35e12


def share(nbytes: float, seconds: float) -> float:
    """The least time of ``nbytes`` over ``seconds``, in %."""
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds


def grad_class_bytes(calls: Iterable[tuple], valid_rows: float) -> float:
    """``grad_class(hi (B, G), lo, dw, valid, H, L)`` calls: each valid
    row's G indices (hi and lo, 4 bytes each) and its dw, the B-byte
    mask, and the whole (2, G, H, L) f32 pair written once.
    ``valid_rows`` is the calls' valid rows all told."""
    calls = list(calls)
    total = 0.0
    for args in calls:
        (b, g), h, l = args[0], args[4], args[5]
        total += b + 2 * g * h * l * 4
    if calls:
        g = calls[0][0][1]
        total += valid_rows * (2 * g * 4 + 4)
    return total


def eval_class_bytes(calls: Iterable[tuple]) -> float:
    """``eval_class(tables, hi (B, G), lo, precision)`` calls: hi and lo
    read (4 bytes each) and the (B,) f32 values written.  The table
    entries the indices touch are left out (their count needs the
    indices), so this is a lower bound and the share too."""
    total = 0.0
    for args in calls:
        b, g = args[1]
        total += 2 * b * g * 4 + b * 4
    return total


def train_step_bytes(envs: int, whole: int, canon: int) -> float:
    """One lockstep train step's bytes, all envs: per env its board
    (16-byte row codes), score and odometer read and written; the four
    afterstates' F = whole + canon table entries read for the choice
    and the chosen one's again for the bootstrap; every updated entry
    (8 images of each whole tuple, one of each canonical tuple) read and
    written in the three f32 tables w, E and A; and the two log bytes.
    Entries that two envs share are counted for each."""
    f = whole + canon
    per_env = (2 * (16 + 4 + 4) + 4 * f * 4 + f * 4
               + (8 * whole + canon) * 3 * 2 * 4 + 2)
    return float(envs * per_env)


def search_bytes(boards_valued: float, tuples: int) -> float:
    """Search: each valued board's F table entries read, the board as an
    8-byte code read and its f32 value written."""
    return boards_valued * (tuples * 4 + 8 + 4)
