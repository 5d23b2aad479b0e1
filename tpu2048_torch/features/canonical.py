"""Canonical-orbit form of the weight table
(``tpu2048/features/canonical.py``).

An agent trained with ``sym_impl="canonical"`` stores one
representative entry per D4 orbit of its large gather-path classes
(the orbit-minimal index).  Serving reads either the canonical table
through canonical indices (``canonical_gather_indices``) or its dense,
orbit-constant expansion (``to_dense_table``).  The numpy table
builders are verbatim copies of the reference's.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from .ntuple import TupleSet, cell_vector, get_tuple_set
from .symmetry import _table_geometry, build_sym_transforms, symmetrize_sum


def is_canonical(acfg) -> bool:
    """True when the agent trains/evaluates in canonical-index form."""
    return acfg.sym_mode == "scatter" and acfg.sym_impl == "canonical"


@lru_cache(maxsize=None)
def feature_perm_table(n: int) -> np.ndarray:
    """(8, F) int32: fp[s, f] = feature holding the T_s-image of an
    entry of feature f (fp[0] = identity)."""
    ts = get_tuple_set(n)
    fp = np.zeros((8, ts.num_feat), np.int32)
    fp[0] = np.arange(ts.num_feat)
    for s in range(1, 8):
        for ft, fs, _perm in build_sym_transforms(n)[s - 1]:
            fp[s, fs] = ft
    return fp


@lru_cache(maxsize=None)
def _gather_feat_ids(n: int) -> np.ndarray:
    from ..ops.onehot import build_table_classes

    return build_table_classes(get_tuple_set(n)).gather_feats


@lru_cache(maxsize=None)
def _orbit_index_plan(n: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(cols, coef, off) for the gather-class orbit indices: for image
    s and gather feature k, the local index of the T_s-image of the
    identity entry is ``sum_j v[cols[s,k,j]] * coef[s,k,j]`` over the
    32-wide cell vector ``v`` of the identity board, and ``off[s, k]``
    its table offset.  The D4 cell permutations are composed into
    ``cols``: image s reads cell ``c`` of the permuted board, which is
    cell ``perm_s[c]`` of the identity board (clipped half likewise)."""
    ts = get_tuple_set(n)
    gf = _gather_feat_ids(n)
    fp = feature_perm_table(n)
    k = len(gf)
    ar = max(int((ts.matrix != 0).sum(axis=1).max()), 1)
    cols = np.zeros((8, k, ar), np.int64)
    coef = np.zeros((8, k, ar), np.int32)
    off = np.zeros((8, k), np.int32)
    for s in range(8):
        perm = np.concatenate([ts.sym_perms[s], 16 + ts.sym_perms[s]])
        for i, f in enumerate(fp[s, gf]):
            nz = np.flatnonzero(ts.matrix[f])
            cols[s, i, : len(nz)] = perm[nz]
            coef[s, i, : len(nz)] = np.rint(ts.matrix[f, nz]).astype(np.int32)
        off[s] = ts.offsets[fp[s, gf]]
    return cols, coef, off


@lru_cache(maxsize=None)
def _orbit_tensors(n: int, device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in _orbit_index_plan(n))


def canonical_gather_indices(
    ts: TupleSet, flat_boards: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., 16) boards -> (canonical indices, orbit multiplicities)
    for the gather-class features only, both int32 (..., K).

    ``mult[b, k] = |stab|`` of the entry (# of symmetries fixing it).
    Exact int32 arithmetic, for the reason ``ntuple.feature_indices``
    gives.
    """
    cols, coef, off = _orbit_tensors(ts.n, flat_boards.device)
    if off.shape[1] == 0:
        shape = flat_boards.shape[:-1] + (0,)
        z = torch.zeros(shape, dtype=torch.int32, device=flat_boards.device)
        return z, z
    v = cell_vector(flat_boards)
    vals = (v[..., cols] * coef).sum(dim=-1, dtype=torch.int32) + off
    canon = vals.amin(dim=-2)  # (..., K)
    mult = (vals == canon.unsqueeze(-2)).sum(dim=-2, dtype=torch.int32)
    return canon, mult


def canonical_mask(ts: TupleSet) -> np.ndarray:
    """(total,) bool host-side mask of entries that are canonical (the
    min of their orbit).  O(total * 8) numpy; for conversions only."""
    offsets, sizes, bases, ks, _classes = _table_geometry(ts)
    transforms = build_sym_transforms(ts.n)
    mask = np.ones(ts.total, bool)
    for f in range(ts.num_feat):
        size, base, kk = sizes[f], bases[f], ks[f]
        idx = np.arange(size, dtype=np.int64)
        digits = [(idx // base ** (kk - 1 - j)) % base for j in range(kk)]
        best = offsets[f] + idx  # identity image
        for s in range(1, 8):
            ft, _fs, perm = next(
                m for m in transforms[s - 1] if m[1] == f
            )
            # T_s maps source entry (f, i) to (ft, j) where digit d of
            # j at position p equals digit perm[p] of i
            j = np.zeros_like(idx)
            for p in range(kk):
                j += digits[perm[p]] * base ** (kk - 1 - p)
            best = np.minimum(best, offsets[ft] + j)
        mask[offsets[f]: offsets[f] + size] &= (
            best == offsets[f] + np.arange(size, dtype=np.int64)
        )
    return mask


@lru_cache(maxsize=None)
def _gather_region(n: int) -> np.ndarray:
    """(total,) bool: True on entries of the gather-path classes (the
    only classes the canonical representation transforms)."""
    ts = get_tuple_set(n)
    gf = _gather_feat_ids(n)
    region = np.zeros(ts.total, bool)
    for f in gf:
        region[ts.offsets[f]: ts.offsets[f] + ts.sizes[f]] = True
    return region


def to_dense_table(ts: TupleSet, w_canonical: torch.Tensor) -> torch.Tensor:
    """Expand a canonical-form table to the orbit-constant dense table
    that identity-index evaluators read, on the table's device.

    On the gather classes dense[e] = w[canon(e)]: the D4 orbit sum of
    the canonical-masked ``w`` places ``|stab(e)| * w[canon(e)]`` at
    every entry e, the same sum over the canonical indicator yields
    ``|stab(e)|``, and one elementwise divide recovers the values.  The
    same operations in the same order as the reference, so the result
    is bitwise its.  The matmul classes pass through unchanged.
    """
    if not len(_gather_feat_ids(ts.n)):
        return w_canonical
    device = w_canonical.device
    region = torch.from_numpy(_gather_region(ts.n)).to(device)
    ind = torch.from_numpy(canonical_mask(ts)).to(device) & region
    ind = ind.to(torch.float32)
    num = symmetrize_sum(ts, w_canonical * ind)
    den = symmetrize_sum(ts, ind)
    dense_g = num / den.clamp(min=1.0)
    return torch.where(region, dense_g, w_canonical)
