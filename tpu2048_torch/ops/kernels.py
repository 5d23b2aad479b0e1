"""Wrappers of the port's CUDA kernels (``tpu2048/ops/pallas_kernels.py``,
``tpu2048/ops/fold_kernel.py``).

Each wrapper checks what it is given, launches its kernel on torch's
current stream for CUDA tensors, and takes its plain PyTorch version
only for CPU tensors.  Each counts its launches in a plain integer
attribute (``eval_class.launches``, ``grad_class.launches``,
``fold_class.launches``), so a run can show that its path went
through the kernel.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..features.ntuple import TupleSet, get_tuple_set
from ..features.symmetry import (_digit_transpose, _table_geometry,
                                 build_sym_transforms, symmetrize_class_sum)

PRECISIONS = ("bf16x2", "bf16", "f32")


def _check_device(name: str, *tensors: torch.Tensor) -> str:
    """The one device type of ``tensors``: "cpu" (plain version) or
    "cuda" (kernel, contiguous tensors only)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on different devices: "
                         f"{sorted(map(str, devices))}")
    kind = tensors[0].device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not {kind}")
    if kind == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: CUDA inputs must be contiguous")
    return kind


def _launch(name: str, device: torch.device, *args) -> None:
    """Call a kernel's C entry point on torch's current stream of
    ``device``; raise if the launch was refused."""
    from .build import load_library

    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, f"{name}_launch")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + lib.cuda_error_string(rc).decode())


def _check_index_pair(name: str, hi: torch.Tensor, lo: torch.Tensor,
                      g: int = -1) -> None:
    for label, t in (("hi", hi), ("lo", lo)):
        if t.dtype != torch.int32 or t.dim() != 2 or \
                (g >= 0 and t.shape[1] != g):
            want = f"(B, {g})" if g >= 0 else "(B, G)"
            raise TypeError(f"{name}: {label} must be {want} int32, got "
                            f"{tuple(t.shape)} {t.dtype}")
    if hi.shape != lo.shape:
        raise ValueError(f"{name}: hi {tuple(hi.shape)} and lo "
                         f"{tuple(lo.shape)} differ in shape")


# -- eval_class (K1/K2: pallas_kernels.py::eval_class) ----------------------


def eval_class_reference(tables: torch.Tensor, hi: torch.Tensor,
                         lo: torch.Tensor,
                         precision: str = "bf16x2") -> torch.Tensor:
    """Plain version of ``eval_class``: sum_g T[g, hi[b, g], lo[b, g]]
    in f32, over a round-to-nearest-even bf16 copy of T for "bf16"."""
    if precision == "bf16":
        tables = tables.to(torch.bfloat16).to(torch.float32)
    g = torch.arange(tables.shape[0], device=tables.device)
    return tables[g, hi.long(), lo.long()].sum(dim=-1)


def eval_class_ordered(tables: torch.Tensor, hi: torch.Tensor,
                       lo: torch.Tensor,
                       precision: str = "bf16x2") -> torch.Tensor:
    """The kernel's exact arithmetic in plain PyTorch: ``acc = acc +
    term_g`` over g = 0 .. G-1 from zeros, each term the f32 entry, or
    for "bf16" its round-to-nearest-even bf16 value.  The card's
    ``eval_class`` equals it bitwise."""
    if precision == "bf16":
        tables = tables.to(torch.bfloat16).to(torch.float32)
    acc = torch.zeros(hi.shape[0], dtype=torch.float32, device=hi.device)
    for g in range(tables.shape[0]):
        acc = acc + tables[g][hi[:, g].long(), lo[:, g].long()]
    return acc


def eval_class(tables: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
               precision: str = "bf16x2") -> torch.Tensor:
    """V[b] = sum_g tables[g, hi[b, g], lo[b, g]], (B,) f32.

    ``tables`` (G, H, L) f32, ``hi`` and ``lo`` (B, G) int32, any B.
    "f32" and "bf16x2" sum the exact f32 entries (bf16x2's ~2^-18
    contract is met with room); "bf16" sums each entry rounded to bf16
    (to nearest even), in f32.  On the card the sum runs in the fixed
    order g = 0 .. G-1 (``eval_class_ordered``), and out-of-range
    indices give NaN.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; "
                         f"expected one of {PRECISIONS}")
    if tables.dtype != torch.float32 or tables.dim() != 3:
        raise TypeError(f"tables must be (G, H, L) float32, got "
                        f"{tuple(tables.shape)} {tables.dtype}")
    _check_index_pair("eval_class", hi, lo, tables.shape[0])
    if _check_device("eval_class", tables, hi, lo) == "cpu":
        return eval_class_reference(tables, hi, lo, precision)
    b, g = hi.shape
    _, h, l = tables.shape
    if tables.numel() >= 2**31:
        raise ValueError(f"eval_class: a class block of {tables.numel()} "
                         "entries is past int32 indexing")
    out = torch.empty(b, dtype=torch.float32, device=hi.device)
    _launch("eval_class", hi.device, tables.data_ptr(),
            int(precision == "bf16"), hi.data_ptr(), lo.data_ptr(),
            out.data_ptr(), b, g, h, l)
    eval_class.launches += 1
    return out


eval_class.launches = 0


# -- grad_class (K3: pallas_kernels.py::grad_for) ---------------------------


def grad_class_reference(hi: torch.Tensor, lo: torch.Tensor,
                         dw: torch.Tensor, valid: torch.Tensor, h: int,
                         l: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``grad_class``: ``index_add_`` of the valid
    rows' dw (and of their count) into zeroed (G, H, L) blocks.  An
    out-of-range index of a valid row makes ``dsum[g, 0, 0]`` NaN."""
    b, g = hi.shape
    ok = (hi >= 0) & (hi < h) & (lo >= 0) & (lo < l)
    take = valid[:, None] & ok
    gi = torch.arange(g, device=hi.device)
    flat = ((gi * h + hi.clamp(0, h - 1)) * l + lo.clamp(0, l - 1))
    flat = flat.reshape(-1).long()
    zero = torch.zeros((), dtype=torch.float32, device=hi.device)
    dsum = torch.zeros(g * h * l, dtype=torch.float32, device=hi.device)
    hits = torch.zeros_like(dsum)
    dsum.index_add_(0, flat, torch.where(take, dw[:, None], zero).reshape(-1))
    hits.index_add_(0, flat, take.to(torch.float32).reshape(-1))
    dsum, hits = dsum.view(g, h, l), hits.view(g, h, l)
    bad = (valid[:, None] & ~ok).any(dim=0)
    dsum[:, 0, 0] = torch.where(bad, float("nan"), dsum[:, 0, 0])
    return dsum, hits


def grad_class(hi: torch.Tensor, lo: torch.Tensor, dw: torch.Tensor,
               valid: torch.Tensor, h: int, l: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dsum, hits), each (G, H, L) f32: ``dsum[g, hi, lo]`` sums dw
    over the valid rows hitting that entry, ``hits`` counts them.

    ``hi`` and ``lo`` (B, G) int32, ``dw`` (B,) f32, ``valid`` (B,)
    bool, any B.  hits are exact; dsum is an f32 sum whose order the
    card's atomics change from run to run.  Invalid rows are never
    read; a valid row's out-of-range index makes ``dsum[g, 0, 0]``
    NaN.
    """
    _check_index_pair("grad_class", hi, lo)
    b, g = hi.shape
    if dw.dtype != torch.float32 or dw.shape != (b,):
        raise TypeError(f"grad_class: dw must be ({b},) float32, got "
                        f"{tuple(dw.shape)} {dw.dtype}")
    if valid.dtype != torch.bool or valid.shape != (b,):
        raise TypeError(f"grad_class: valid must be ({b},) bool, got "
                        f"{tuple(valid.shape)} {valid.dtype}")
    if h < 1 or l < 1:
        raise ValueError(f"grad_class: bad block shape H={h}, L={l}")
    if _check_device("grad_class", hi, lo, dw, valid) == "cpu":
        return grad_class_reference(hi, lo, dw, valid, h, l)
    dsum = torch.zeros((g, h, l), dtype=torch.float32, device=hi.device)
    hits = torch.zeros_like(dsum)
    _launch("grad_class", hi.device, hi.data_ptr(), lo.data_ptr(),
            dw.data_ptr(), valid.data_ptr(), dsum.data_ptr(),
            hits.data_ptr(), b, g, h, l)
    grad_class.launches += 1
    return dsum, hits


grad_class.launches = 0


# -- fold_class (K4: fold_kernel.py::fold_class_pair) -----------------------

# the three doubling rounds of symmetrize_class_sum: T_m, T_r2, T_r
_ROUND_SYMS = (0, 3, 1)


@lru_cache(maxsize=None)
def fold_plan(n: int, feat0: int, g: int) -> np.ndarray:
    """(3, g, 5) int32 plan of the three doubling rounds for one
    base-16 class of 16^k tables, k <= 4, from which ``_fold_words``
    (and through it ``fold_orbit_plan``) is derived: row r, tuple t holds
    ``[src, c_0, .., c_{k-1}]`` such that round r's transform reads
    tuple ``src`` at ``sum_d digit_d(e) * c_d`` for local index e
    (digit 0 the most significant).  Derived numerically by applying
    each round's plain digit transpose to an index range, and checked
    against it over the whole range."""
    ts = get_tuple_set(n)
    _offsets, _sizes, bases, ks, _classes = _table_geometry(ts)
    base, k = bases[feat0], ks[feat0]
    if base != 16 or not 1 <= k <= 4:
        raise ValueError(f"fold_class takes base-16 classes of 16^1.."
                         f"16^4 tables, not {base}^{k}")
    size = base**k
    e = np.arange(size)
    digits = [(e >> (4 * (k - 1 - d))) & 15 for d in range(k)]
    transforms = build_sym_transforms(n)
    plan = np.zeros((3, g, 5), np.int32)
    seen = np.zeros((3, g), bool)
    for r, s in enumerate(_ROUND_SYMS):
        for ft, fs, perm in transforms[s]:
            if not feat0 <= ft < feat0 + g:
                continue
            src = _digit_transpose(torch.arange(size), base, k, perm).numpy()
            coef = [int(src[16 ** (k - 1 - d)]) for d in range(k)]
            if not (sum(c * dg for c, dg in zip(coef, digits)) == src).all():
                raise AssertionError(f"transform {s} of tuple {ft} is "
                                     "not a digit permutation")
            plan[r, ft - feat0, : 1 + k] = [fs - feat0, *coef]
            seen[r, ft - feat0] = True
    if not seen.all():
        raise ValueError(f"tuples {feat0}..{feat0 + g - 1} are not a "
                         "class closed under D4")
    return plan


def _fold_k(n: int, feat0: int) -> int:
    """k of the class at ``feat0``: its tables are 16^k."""
    return _table_geometry(get_tuple_set(n))[3][feat0]


def _fold_words(n: int, feat0: int, g: int) -> np.ndarray:
    """(8, g * 16^k) int64: ``W[j][a]``, the class-local index that word
    ``j = b0 + 2 b1 + 4 b2`` (round 0 applied b0 times after round 1 b1
    times after round 2 b2 times) reads for output ``a``.  Output a's
    orbit sum adds ``x[W[0][a]] .. x[W[7][a]]`` as
    ``((l0 + l1) + (l2 + l3)) + ((l4 + l5) + (l6 + l7))``, the
    reference's association order."""
    plan = fold_plan(n, feat0, g)
    k = _fold_k(n, feat0)
    size = 16**k
    a = np.arange(g * size, dtype=np.int64)

    def image(r, idx):
        p = plan[r, idx // size]
        e = idx % size
        j = sum(((e >> (4 * (k - 1 - d))) & 15) * p[:, 1 + d]
                for d in range(k))
        return p[:, 0].astype(np.int64) * size + j

    words = []
    for j in range(8):
        x = a
        for r in (2, 1, 0):  # innermost round first
            if (j >> r) & 1:
                x = image(r, x)
        words.append(x)
    return np.stack(words)


# FOLD_CAYLEY[m][j] = i: word j after word m is word i (D4's table in
# the basis of the words), so orbit member W[m][a] reads leaf j at
# W[FOLD_CAYLEY[m][j]][a].  The same for every class; fold_orbit_plan
# checks it over the whole index range, and csrc/fold_class.cu spells
# it out in its FOLD_MEMBER lines.
FOLD_CAYLEY = (
    (0, 1, 2, 3, 4, 5, 6, 7),
    (1, 0, 3, 2, 7, 6, 5, 4),
    (2, 3, 0, 1, 6, 7, 4, 5),
    (3, 2, 1, 0, 5, 4, 7, 6),
    (4, 5, 6, 7, 2, 3, 0, 1),
    (5, 4, 7, 6, 1, 0, 3, 2),
    (6, 7, 4, 5, 0, 1, 2, 3),
    (7, 6, 5, 4, 3, 2, 1, 0),
)
FOLD_MAX_SLOTS = 8  # tiles of one tile orbit: at most |D4|
FOLD_ORBIT_WORDS = 4 + FOLD_MAX_SLOTS  # [slots, rep_begin, rep_end, 0, bases]


def fold_swizzle(p: np.ndarray, k: int) -> np.ndarray:
    """Shared-memory position of the kernel's orbit entry ``p`` (slot
    ``p >> 2k``, tile entry ``p & (4^k - 1)``): the entry's 16-byte run
    index has its low bits XORed with the slot and the entry's bits
    5..7, which spreads an entry orbit's leaves over more banks.  An
    involution; ``csrc/fold_class.cu::swizzle`` is the same map."""
    s, l = p >> (2 * k), p & (4**k - 1)
    x = ((l >> 5) ^ s) & 7 & ((4**k >> 2) - 1)
    return (s << (2 * k)) | (l ^ (x << 2))


def _tile_spread(l: np.ndarray, k: int) -> np.ndarray:
    """Offset in a 16^k table of tile-local index ``l``: its k 2-bit
    digits are the low halves of the table index's k 4-bit digits."""
    return sum(((l >> (2 * (k - 1 - d))) & 3) << (4 * (k - 1 - d))
               for d in range(k))


@lru_cache(maxsize=None)
def fold_orbit_plan(n: int, feat0: int, g: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """The ``fold_class`` kernel's plan for one base-16 class of 16^k
    tables, k <= 4: ``(orbits, reps)``.

    A *tile* is one tuple's 4^k entries that share the high two bits of
    every digit; a word permutes digits and relabels tuples, so it maps
    whole tiles onto tiles, and the class splits into *tile orbits* of
    at most 8 tiles, closed under D4.  One block of the kernel stages a
    tile orbit in shared memory, slot by slot, and writes it back.

    ``orbits`` (T, 12) int32: per tile orbit ``[slots, rep_begin,
    rep_end, 0, base_0 .. base_7]``, ``base_s`` the class-local index
    of slot s's first entry (entry l of the slot lies at ``base_s +
    spread(l)``).  ``reps`` (E, 8) int16: one row per entry orbit (its
    least index is the representative), ``reps[rep_begin:rep_end]``
    those of one tile orbit; word j's image of the representative sits
    at slot ``q >> 2k``, entry ``q & (4^k - 1)`` for ``q =
    fold_swizzle(reps[e, j], k)``, and at shared-memory position
    ``reps[e, j]``.
    Member j then sums the leaves ``x[p_{FOLD_CAYLEY[j][i]}]``.

    Derived numerically from ``fold_plan``, and checked over the whole
    index range: the Cayley table, words mapping tiles to tiles, and
    every entry in a representative's orbit."""
    words = _fold_words(n, feat0, g)
    k = _fold_k(n, feat0)
    size, tile = 16**k, 4**k
    for m in range(8):
        for j in range(8):
            if not np.array_equal(words[j][words[m]],
                                  words[FOLD_CAYLEY[m][j]]):
                raise AssertionError(f"word {j} after word {m} is not word "
                                     f"{FOLD_CAYLEY[m][j]}")
    a = words[0]
    e = a % size
    hi_half = sum(((e >> (4 * (k - 1 - d) + 2)) & 3) << (2 * (k - 1 - d))
                  for d in range(k))
    low = sum(((e >> (4 * (k - 1 - d))) & 3) << (2 * (k - 1 - d))
              for d in range(k))
    tile_of = (a // size) * tile + hi_half  # tile id of every entry
    n_tiles = g * tile
    # each tile's first entry: its tuple's base plus the high halves
    first = (np.arange(n_tiles) // tile) * size + (
        _tile_spread(np.arange(n_tiles) % tile, k) << 2)
    tile_img = tile_of[words]  # (8, entries): tile of each image
    if not np.array_equal(tile_img, tile_img[:, first][:, tile_of]):
        raise AssertionError("a word splits a tile")
    orbit_key = tile_img[:, first].min(axis=0)  # least tile of the orbit
    keys, orbit_of_tile = np.unique(orbit_key, return_inverse=True)
    slot_of_tile = np.zeros(n_tiles, np.int64)
    orbits = np.zeros((len(keys), FOLD_ORBIT_WORDS), np.int32)
    for o in range(len(keys)):
        members = np.flatnonzero(orbit_of_tile == o)
        if len(members) > FOLD_MAX_SLOTS:
            raise AssertionError("a tile orbit of more than 8 tiles")
        slot_of_tile[members] = np.arange(len(members))
        orbits[o, 0] = len(members)
        orbits[o, 4: 4 + len(members)] = first[members]
    rep = words.min(axis=0) == a
    pos = slot_of_tile[tile_img] * tile + low[words]  # (8, entries)
    rep_idx = np.flatnonzero(rep)
    order = np.argsort(orbit_of_tile[tile_of[rep_idx]], kind="stable")
    rep_idx = rep_idx[order]
    counts = np.bincount(orbit_of_tile[tile_of[rep_idx]],
                         minlength=len(keys))
    ends = np.cumsum(counts)
    orbits[:, 1], orbits[:, 2] = ends - counts, ends
    reps = fold_swizzle(pos[:, rep_idx].T, k).astype(np.int16)
    covered = np.zeros(g * size, bool)
    covered[words[:, rep_idx]] = True
    if not covered.all():
        raise AssertionError("representatives do not cover the class")
    return orbits, np.ascontiguousarray(reps)


@lru_cache(maxsize=None)
def _fold_plan_on(n: int, feat0: int, g: int, device: torch.device
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    # moved to the device once (a per-call host copy would synchronise)
    orbits, reps = fold_orbit_plan(n, feat0, g)
    return (torch.from_numpy(orbits).to(device),
            torch.from_numpy(reps).to(device))


def fold_class(ts: TupleSet, feat0: int, g: int, pair: torch.Tensor
               ) -> torch.Tensor:
    """D4 orbit sum of the class ``feat0 .. feat0 + g - 1``'s
    standard-packed (..., g, 16^k) block, k <= 4; a new tensor,
    bitwise equal to its plain version
    ``features.symmetry.symmetrize_class_sum``."""
    _offsets, sizes, _bases, ks, _classes = _table_geometry(ts)
    size = sizes[feat0]
    if pair.dtype != torch.float32 or pair.dim() < 2 or \
            tuple(pair.shape[-2:]) != (g, size):
        raise TypeError(f"fold_class: pair must be (..., {g}, {size}) "
                        f"float32, got {tuple(pair.shape)} {pair.dtype}")
    if _check_device("fold_class", pair) == "cpu":
        return symmetrize_class_sum(ts, feat0, g, pair)
    if pair.data_ptr() % 16:
        raise ValueError("fold_class: the kernel moves 16-byte runs; pair "
                         "must start 16-byte aligned")
    orbits, reps = _fold_plan_on(ts.n, feat0, g, pair.device)
    out = torch.empty_like(pair)
    rows = pair.numel() // (g * size)
    _launch("fold_class", pair.device, pair.data_ptr(), out.data_ptr(),
            orbits.data_ptr(), reps.data_ptr(), orbits.shape[0], rows, g,
            ks[feat0])
    fold_class.launches += 1
    return out


fold_class.launches = 0
