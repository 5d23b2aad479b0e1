"""D4 symmetry as a permutation of the flat weight table
(``tpu2048/features/symmetry.py``).

The D4 action on boards induces a fixed permutation of the flat table
that splits, per tuple, into a relabeling of tuples within the
geometry and a base-B digit permutation of the tuple's sub-table —
a transpose of the sub-table viewed as a (B,)*k array.
``build_sym_transforms`` and ``_table_geometry`` are verbatim copies of
the reference's numpy code.  On the card a digit permutation is one
``reshape -> permute -> reshape`` per tuple; the reference's streaming
planner (``ops/digit_perm.py``) is a TPU lowering workaround and is
not ported.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import torch

from .ntuple import TupleSet, _cell_tuples, get_tuple_set

# (f_target, f_source, digit axes perm) per sym s=1..7
SymMaps = List[List[Tuple[int, int, Tuple[int, ...]]]]


@lru_cache(maxsize=None)
def build_sym_transforms(n: int) -> SymMaps:
    ts = get_tuple_set(n)
    cells_list = []
    bases = []
    for cells, base in _cell_tuples(n):
        cells_list.append([i * 4 + j for i, j in cells])
        bases.append(base)
    out: SymMaps = []
    for s in range(1, 8):
        perm_cells = ts.sym_perms[s]
        maps = []
        for ft, cells_t in enumerate(cells_list):
            target_cells = [int(perm_cells[c]) for c in cells_t]
            fs = next(
                f2
                for f2, cells_s in enumerate(cells_list)
                if bases[f2] == bases[ft]
                and set(cells_s) == set(target_cells)
            )
            cells_s = cells_list[fs]
            digit_perm = tuple(cells_s.index(tc) for tc in target_cells)
            maps.append((ft, fs, digit_perm))
        out.append(maps)
    return out


def _table_geometry(ts: TupleSet):
    offsets = [int(o) for o in ts.offsets]
    sizes = [int(z) for z in ts.sizes]
    bases = [
        16 if z in (16**2, 16**3, 16**4, 16**5, 16**6) else 14
        for z in sizes
    ]
    ks = []
    for z, b in zip(sizes, bases):
        k = 0
        v = 1
        while v < z:
            v *= b
            k += 1
        ks.append(k)
    # contiguous same-size classes (ascending offsets by construction)
    classes = []  # (f0, g, size)
    f = 0
    while f < len(sizes):
        g = 1
        while f + g < len(sizes) and sizes[f + g] == sizes[f]:
            g += 1
        classes.append((f, g, sizes[f]))
        f += g
    return offsets, sizes, bases, ks, classes


def _digit_transpose(x: torch.Tensor, base: int, k: int,
                     perm: Tuple[int, ...]) -> torch.Tensor:
    """``x`` (..., base**k) viewed as (..., (base,)*k), digit axes
    permuted by ``perm``, flattened back."""
    lead = x.shape[:-1]
    nl = len(lead)
    axes = tuple(range(nl)) + tuple(nl + p for p in perm)
    return x.reshape(lead + (base,) * k).permute(axes).reshape(x.shape)


def _apply_transform(ts: TupleSet, delta: torch.Tensor, maps) -> torch.Tensor:
    """One D4 table transform T_s of the full flat table (..., total):
    table ft of the output is the digit-permuted table fs of the
    input."""
    offsets, sizes, bases, ks, _classes = _table_geometry(ts)
    pieces = [None] * len(sizes)
    for ft, fs, perm in maps:
        src = delta[..., offsets[fs]: offsets[fs] + sizes[fs]]
        pieces[ft] = _digit_transpose(src, bases[fs], ks[fs], perm)
    return torch.cat(pieces, dim=-1)


def symmetrize_sum(ts: TupleSet, delta: torch.Tensor) -> torch.Tensor:
    """Sum over all 8 D4 transforms of ``delta`` (identity included),
    in the reference's three doubling passes

        y1 = x + T_m(x);  y2 = y1 + T_r2(y1);  y3 = y2 + T_r(y2)

    The additions are elementwise and in the same order, so the result
    is bitwise the reference's.  ``delta`` may carry leading batch
    dimensions ``(..., total)``."""
    transforms = build_sym_transforms(ts.n)
    # sym_perms rows (ntuple._d4_perms): s=1 transpose (m), s=2 rot90
    # (r), s=4 rot180 (r^2); transforms[s-1] is T_s
    y = delta + _apply_transform(ts, delta, transforms[0])  # m
    y = y + _apply_transform(ts, y, transforms[3])  # r^2
    y = y + _apply_transform(ts, y, transforms[1])  # r
    return y


def fold_other_symmetries(ts: TupleSet, delta: torch.Tensor) -> torch.Tensor:
    """Sum over the 7 non-identity D4 transforms of ``delta``:
    ``symmetrize_sum(ts, delta) - delta``, as in the reference."""
    return symmetrize_sum(ts, delta) - delta


def symmetrize_table(ts: TupleSet, w: torch.Tensor) -> torch.Tensor:
    """Average of a table over its full D4 orbit (the symmetric
    projection): ``symmetrize_sum / 8``."""
    return symmetrize_sum(ts, w) / 8.0


def _apply_class_transform(ts: TupleSet, block: torch.Tensor, maps,
                           feat0: int, g: int) -> torch.Tensor:
    """T_s restricted to one size class: ``block`` is (..., g, size),
    the class's g per-tuple tables.  D4 maps the tables of one size
    among themselves, so the restriction is closed."""
    _offsets, _sizes, bases, ks, _classes = _table_geometry(ts)
    base, k = bases[feat0], ks[feat0]
    pieces = [None] * g
    for ft, fs, perm in maps:
        if feat0 <= ft < feat0 + g:
            if not feat0 <= fs < feat0 + g:
                raise ValueError("class not closed under D4")
            pieces[ft - feat0] = _digit_transpose(
                block[..., fs - feat0, :], base, k, perm)
    return torch.stack(pieces, dim=-2)


def symmetrize_class_sum(ts: TupleSet, feat0: int, g: int,
                         block: torch.Tensor) -> torch.Tensor:
    """``symmetrize_sum`` restricted to one size class's (..., g, size)
    block, in the same three doubling passes and addition order, so
    bitwise the reference's.  The plain version of the ``fold_class``
    kernel (``ops/kernels.py``)."""
    transforms = build_sym_transforms(ts.n)
    y = block + _apply_class_transform(ts, block, transforms[0], feat0, g)
    y = y + _apply_class_transform(ts, y, transforms[3], feat0, g)
    y = y + _apply_class_transform(ts, y, transforms[1], feat0, g)
    return y
