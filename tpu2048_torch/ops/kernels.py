"""Wrappers of the port's CUDA kernels (``tpu2048/ops/pallas_kernels.py``,
``tpu2048/ops/fold_kernel.py``, the canonical learner's stacked
scatter, ``tpu2048/agent/td.py:669``, and the train actor's feature
indices, which the reference builds with XLA ops).

Each wrapper checks what it is given, launches its kernel on torch's
current stream for CUDA tensors, and takes its plain PyTorch version
only for CPU tensors.  Each counts its launches in a plain integer
attribute (``eval_class.launches``, ``grad_class.launches``,
``fold_class.launches``, ``cross_apply.launches``,
``feature_index.launches``), so a run can show that its path went
through the kernel.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from ..engine.fast import cells_from_codes
from ..features.canonical import (_gather_feat_ids, _orbit_index_plan,
                                  canonical_gather_indices)
from ..features.ntuple import (TupleSet, _index_plan, feature_indices,
                               get_tuple_set)
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

# csrc/grad_class.cu's constants: rows of a count or place block (kTile),
# the most warps that reduce one bucket (kWarps), the most chunks of a
# bucket that one warp reduces alone (kSmallChunks), the largest H and L
GRAD_TILE = 1024
GRAD_WARPS = 32
GRAD_SMALL_CHUNKS = 4
GRAD_MAX_SIDE = 256


def scatter_add_ordered(table: torch.Tensor, flat: torch.Tensor,
                        upd: torch.Tensor) -> None:
    """``table[flat] += upd`` in place (1-D), each entry's terms added
    in an order fixed by the list, whatever the device.  On CUDA tensors
    ``index_add_`` adds colliding terms with atomics in no fixed order,
    and ``index_put_`` with ``accumulate`` sorts the list and adds each
    entry's run in a fixed order; on CPU tensors it is the other way
    round (``index_add_`` walks the list, ``index_put_`` spreads a long
    one over threads that add atomically).  So one list gives one result
    on either device (the two devices' results differ by f32 summation
    order), and replicas that apply one gathered list stay bitwise
    equal."""
    if table.device.type == "cuda":
        table.index_put_((flat,), upd, accumulate=True)
    else:
        table.index_add_(0, flat, upd)


def grad_class_reference(hi: torch.Tensor, lo: torch.Tensor,
                         dw: torch.Tensor, valid: torch.Tensor, h: int,
                         l: int) -> torch.Tensor:
    """Plain version of ``grad_class``: the valid rows' dw added in row
    order (``scatter_add_ordered``) and their count (``index_add_``)
    into the two rows of a zeroed (2, G, H, L) pair.  An out-of-range
    index of a valid row makes ``dsum[g, 0, 0]`` NaN."""
    b, g = hi.shape
    ok = (hi >= 0) & (hi < h) & (lo >= 0) & (lo < l)
    take = valid[:, None] & ok
    gi = torch.arange(g, device=hi.device)
    flat = ((gi * h + hi.clamp(0, h - 1)) * l + lo.clamp(0, l - 1))
    flat = flat.reshape(-1).long()
    zero = torch.zeros((), dtype=torch.float32, device=hi.device)
    pair = torch.zeros((2, g, h, l), dtype=torch.float32, device=hi.device)
    dsum, hits = pair
    scatter_add_ordered(dsum.view(-1), flat,
                        torch.where(take, dw[:, None], zero).reshape(-1))
    # 0/1 counts: exact in any order
    hits.view(-1).index_add_(0, flat, take.to(torch.float32).reshape(-1))
    bad = (valid[:, None] & ~ok).any(dim=0)
    dsum[:, 0, 0] = torch.where(bad, float("nan"), dsum[:, 0, 0])
    return pair


def grad_class_order(hi: torch.Tensor, lo: torch.Tensor, valid: torch.Tensor,
                     h: int, l: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's stable order by hi (its kernels 1-3) in plain
    PyTorch: ``(pos, offsets, totals)``.

    Each tile of GRAD_TILE rows counts its rows per (tuple, hi), bin h
    = H for a valid row with a bad index; one exclusive scan per tuple
    over (bin, tile) gives ``offsets`` (G, H + 1, tiles) and ``totals``
    (G,); a row's rank in its tile's bucket is the count of its bucket
    in the tile's earlier warps plus that of the earlier lanes of its
    warp.  ``pos`` (B, G) int64: each row's position in its tuple's
    sorted list, -1 for a row that takes no part."""
    b, g = hi.shape
    dev = hi.device
    tiles = -(-b // GRAD_TILE)
    ok = (hi >= 0) & (hi < h) & (lo >= 0) & (lo < l)
    live = valid[:, None] & ok
    # kernel 1: bins per row and tuple, counted per tile
    bins = torch.where(live, hi.long(), torch.where(valid[:, None], h, -1))
    tile = (torch.arange(b, device=dev) // GRAD_TILE)[:, None]
    gi = torch.arange(g, device=dev)[None, :]
    counted = bins >= 0
    cell = ((gi * (h + 1) + bins.clamp(min=0)) * tiles + tile)[counted]
    counts = torch.bincount(cell, minlength=g * (h + 1) * tiles)
    # kernel 2: exclusive offsets in (bin, tile) order per tuple
    counts = counts.view(g, (h + 1) * tiles)
    totals = counts.sum(dim=1)
    offsets = (counts.cumsum(dim=1) - counts).view(g, h + 1, tiles)
    # kernel 3: a row's rank among its tile's earlier rows of its bucket
    nw = GRAD_TILE // 32
    pb = torch.full((tiles * GRAD_TILE, g), -1, dtype=torch.long, device=dev)
    pb[:b] = torch.where(live, hi.long(), -1)
    lanes = pb.t().reshape(g, tiles, nw, 32)  # (tuple, tile, warp, lane)
    placed = lanes >= 0
    hb = lanes.clamp(min=0)
    below = torch.ones(32, 32, dtype=torch.bool, device=dev).tril(-1)
    rank = ((lanes[..., :, None] == lanes[..., None, :]) & below).sum(-1)
    g4 = torch.arange(g, device=dev)[:, None, None, None]
    t4 = torch.arange(tiles, device=dev)[None, :, None, None]
    w4 = torch.arange(nw, device=dev)[None, None, :, None]
    cell = (((g4 * tiles + t4) * nw + w4) * h + hb)[placed]
    wcount = torch.bincount(cell, minlength=g * tiles * nw * h).view(
        g, tiles, nw, h)
    earlier = wcount.cumsum(dim=2) - wcount
    pos = offsets[g4, hb, t4] + earlier[g4, t4, w4, hb] + rank
    pos = torch.where(placed, pos, -1).view(g, -1).t()[:b]
    return pos, offsets, totals


def grad_class_ordered(hi: torch.Tensor, lo: torch.Tensor, dw: torch.Tensor,
                       valid: torch.Tensor, h: int, l: int) -> torch.Tensor:
    """The kernel's exact arithmetic in plain PyTorch, the same (2, G,
    H, L) pair as ``grad_class``.  Rows in ``grad_class_order``'s order;
    bucket (g, hi)'s n rows cut into chunks of 32 positions, taken by W
    warps, warp w the chunks w, w + W, ... (W = 1 for at most
    GRAD_SMALL_CHUNKS chunks, else min(GRAD_WARPS, chunks));
    within a chunk each lo's dw summed in position order from 0.0, that
    sum added to warp w's accumulator of lo; then the W accumulators
    added in warp order from 0.0.  The card's ``grad_class`` equals it
    bitwise."""
    b, g = hi.shape
    dev = hi.device
    pos, offsets, totals = grad_class_order(hi, lo, valid, h, l)
    rows, tup = (pos >= 0).nonzero(as_tuple=True)
    # the sorted lists, tuple after tuple: (tuple, position) order
    order = torch.argsort(tup * max(b, 1) + pos[rows, tup])
    rows, tup = rows[order], tup[order]
    hh = hi[rows, tup].long()
    ll = lo[rows, tup].long()
    x = dw[rows]
    start = offsets[tup, hh, 0]
    size = offsets.view(g, -1)[tup, (hh + 1) * offsets.shape[2]] - start
    q = pos[rows, tup] - start
    chunk, lane = q // 32, q % 32
    chunks = (size + 31) // 32
    warps = torch.where(chunks <= GRAD_SMALL_CHUNKS, 1,
                        chunks.clamp(max=GRAD_WARPS))
    warp, turn = chunk % warps, chunk // warps
    # each lane's rank among its chunk's lanes of its lo, and its group's
    # lowest lane (the chunk's lanes sit contiguous in the lists)
    m = ll.shape[0]
    idx = torch.arange(m, device=dev)
    rank = torch.zeros(m, dtype=torch.long, device=dev)
    lead = idx.clone()
    for d in range(1, 32):
        k = (idx - d).clamp(min=0)
        same = (lane >= d) & (ll[k] == ll)
        rank += same.long()
        lead = torch.where(same, k, lead)
    gsum = torch.zeros(m, dtype=torch.float32, device=dev)
    for r in range(32):
        sel = rank == r
        gsum[lead[sel]] = gsum[lead[sel]] + x[sel]
    first = rank == 0
    entry = (tup * h + hh) * l + ll
    slot = (entry * GRAD_WARPS + warp)[first]
    slots, aid = torch.unique(slot, return_inverse=True)
    acc = torch.zeros(slots.shape[0], dtype=torch.float32, device=dev)
    fturn, fsum = turn[first], gsum[first]
    for t in range(int(fturn.max()) + 1 if fturn.numel() else 0):
        sel = fturn == t
        acc[aid[sel]] = acc[aid[sel]] + fsum[sel]
    pair = torch.zeros((2, g * h * l), dtype=torch.float32, device=dev)
    for w in range(GRAD_WARPS):
        sel = slots % GRAD_WARPS == w
        at = slots[sel] // GRAD_WARPS
        pair[0, at] = pair[0, at] + acc[sel]
    pair[1] = torch.bincount(entry, minlength=g * h * l).to(torch.float32)
    pair = pair.view(2, g, h, l)
    bad = totals > offsets[:, h, 0]
    pair[0, :, 0, 0] = torch.where(bad, float("nan"), pair[0, :, 0, 0])
    return pair


def grad_class(hi: torch.Tensor, lo: torch.Tensor, dw: torch.Tensor,
               valid: torch.Tensor, h: int, l: int) -> torch.Tensor:
    """The gradient pair, one contiguous (2, G, H, L) f32 tensor: row 0
    is dsum, where ``dsum[g, hi, lo]`` sums dw over the valid rows
    hitting that entry, row 1 is hits, their count (``dsum, hits =
    grad_class(...)`` unpacks it into two views).  The pair is
    ``fold_class``'s input as it stands, viewed as (2, G, H * L).

    ``hi`` and ``lo`` (B, G) int32, ``dw`` (B,) f32, ``valid`` (B,)
    bool, any B.  hits are exact; on the card dsum is an f32 sum in a
    fixed order (``grad_class_ordered``, H and L at most 256), so one
    input gives one result, within hits * 2^-23 * sum |dw| of the plain
    version's row order.  Invalid rows take no part; a valid row's
    out-of-range index makes ``dsum[g, 0, 0]`` NaN.
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
    if max(h, l) > GRAD_MAX_SIDE:
        raise ValueError(f"grad_class: the kernel takes H, L <= "
                         f"{GRAD_MAX_SIDE}, not H={h}, L={l}")
    from .build import load_library

    words = load_library().grad_class_scratch_words(b, g, h)
    # the launch writes every entry of the pair: no fill first
    pair = torch.empty((2, g, h, l), dtype=torch.float32, device=hi.device)
    scratch = torch.empty(words, dtype=torch.int32, device=hi.device)
    _launch("grad_class", hi.device, hi.data_ptr(), lo.data_ptr(),
            dw.data_ptr(), valid.data_ptr(), pair.data_ptr(),
            scratch.data_ptr(), words, b, g, h, l)
    grad_class.launches += 1
    return pair


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


# -- cross_apply (the crosses' stacked scatter: agent/td.py:669) ------------


def tc_rate(e: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The TC per-weight rate |E| / A (1 where A is still 0)."""
    return torch.where(a > 0.0, e.abs() / a.clamp(min=1e-30), 1.0)


def cross_apply_reference(weights: torch.Tensor, opt_e: torch.Tensor,
                          opt_a: torch.Tensor, alpha: torch.Tensor,
                          flat: torch.Tensor, per: torch.Tensor,
                          valid: torch.Tensor, mean: bool) -> None:
    """Plain version of ``cross_apply``: under ``mean`` each update
    divided by its entry's valid updates (at least 1); then under TC
    (``opt_e`` not empty) the rate |E| / A gathered before any update,
    and ``alpha * rate * p``, ``p`` and ``|p|`` added to the weights, E
    and A, each in a fixed order (``scatter_add_ordered``); under
    sgd ``p`` added to the weights.  In place."""
    if mean:
        # 0/1 counts: exact in any order
        hits = torch.zeros(weights.shape[0], dtype=torch.float32,
                           device=weights.device).index_add_(
            0, flat, valid.to(torch.float32))
        per = per / hits[flat].clamp(min=1.0)
    if not opt_e.numel():
        scatter_add_ordered(weights, flat, per)
        return
    # gather E/A before any of the three scatters
    rate = tc_rate(opt_e[flat], opt_a[flat])
    scatter_add_ordered(weights, flat, alpha * rate * per)
    scatter_add_ordered(opt_e, flat, per)
    scatter_add_ordered(opt_a, flat, per.abs())


def cross_apply_ordered(weights: torch.Tensor, opt_e: torch.Tensor,
                        opt_a: torch.Tensor, alpha: torch.Tensor,
                        flat: torch.Tensor, per: torch.Tensor,
                        valid: torch.Tensor, mean: bool) -> None:
    """The kernel's exact arithmetic in plain PyTorch, in place, as
    ``cross_apply`` on the card.  The list sorted stably by entry; in
    each window of 32 positions (aligned on multiples of 32) each
    entry's per and |per| summed in position order from 0.0 and its
    valid updates counted; then per entry its windows' sums added in
    window order from 0.0, P and Q, and its count n: under "mean" P and
    Q divided by max(n, 1); TC: ``w += alpha * rate * P``, ``E += P``,
    ``A += Q``, the rate from E and A before; sgd: ``w += P``.  The
    card's ``cross_apply`` equals it bitwise."""
    m = flat.shape[0]
    if m == 0:
        return
    dev = flat.device
    key, order = torch.sort(flat, stable=True)
    p_s, v_s = per[order], valid[order]
    pos = torch.arange(m, device=dev)
    start = torch.ones(m, dtype=torch.bool, device=dev)
    start[1:] = key[1:] != key[:-1]
    run_start = torch.where(start, pos, 0).cummax(dim=0).values
    lead = torch.maximum(run_start, pos // 32 * 32)  # the group's first
    rank = pos - lead
    gp = torch.zeros(m, dtype=torch.float32, device=dev)
    gq = torch.zeros(m, dtype=torch.float32, device=dev)
    for r in range(32):
        sel = rank == r
        gp[lead[sel]] = gp[lead[sel]] + p_s[sel]
        gq[lead[sel]] = gq[lead[sel]] + p_s[sel].abs()
    run = start.long().cumsum(dim=0) - 1
    first = rank == 0  # one group a window of each run
    turn = (pos // 32 - run_start // 32)[first]
    rp = torch.zeros(int(run[-1]) + 1, dtype=torch.float32, device=dev)
    rq = torch.zeros_like(rp)
    for t in range(int(turn.max()) + 1):
        sel = turn == t
        at = run[first][sel]
        rp[at] = rp[at] + gp[first][sel]
        rq[at] = rq[at] + gq[first][sel]
    k = key[start]
    if mean:
        d = torch.bincount(run[v_s], minlength=rp.shape[0])
        d = d.to(torch.float32).clamp(min=1.0)
        rp, rq = rp / d, rq / d
    if not opt_e.numel():
        weights[k] = weights[k] + rp
        return
    rate = tc_rate(opt_e[k], opt_a[k])
    weights[k] = weights[k] + alpha * rate * rp
    opt_e[k] = opt_e[k] + rp
    opt_a[k] = opt_a[k] + rq


def cross_apply(weights: torch.Tensor, opt_e: torch.Tensor,
                opt_a: torch.Tensor, alpha: torch.Tensor,
                flat: torch.Tensor, per: torch.Tensor, valid: torch.Tensor,
                mean: bool) -> None:
    """The canonical learner's sparse update of its gather classes, in
    place: ``flat`` (M,) int64 table entries, ``per`` (M,) f32 updates
    (0 where not ``valid``), ``valid`` (M,) bool; TC when ``opt_e`` and
    ``opt_a`` hold the table's sums, sgd when they are empty; ``alpha``
    the f32 meta-rate or rate.  On the card one stable sort of ``flat``
    serves all three tables, and each entry's terms are summed in a
    fixed order before one add to each table (``cross_apply_ordered``,
    bitwise), so one input gives one result; that differs from the plain
    version's term-by-term adds (``cross_apply_reference``, the CPU's)
    by f32 summation order only."""
    tc = bool(opt_e.numel())
    tables = (weights, opt_e, opt_a) if tc else (weights,)
    for t in tables:
        if t.dtype != torch.float32 or t.dim() != 1 or \
                t.shape != weights.shape:
            raise TypeError(f"cross_apply: tables must be ({weights.shape[0]},)"
                            f" float32, got {tuple(t.shape)} {t.dtype}")
    m = flat.shape[0]
    if flat.dtype != torch.int64 or flat.shape != (m,) or \
            per.dtype != torch.float32 or per.shape != (m,) or \
            valid.dtype != torch.bool or valid.shape != (m,):
        raise TypeError("cross_apply: flat (M,) int64, per (M,) float32 and "
                        "valid (M,) bool expected, got "
                        f"{flat.dtype} {tuple(flat.shape)}, {per.dtype} "
                        f"{tuple(per.shape)}, {valid.dtype} "
                        f"{tuple(valid.shape)}")
    if alpha.dtype != torch.float32 or alpha.numel() != 1:
        raise TypeError("cross_apply: alpha must be one float32")
    kind = _check_device("cross_apply", *tables, alpha, flat, per, valid)
    if kind == "cpu":
        cross_apply_reference(weights, opt_e, opt_a, alpha, flat, per, valid,
                              mean)
        return
    if m >= 2**31 or weights.shape[0] >= 2**31:
        raise ValueError(f"cross_apply: {m} updates of {weights.shape[0]} "
                         "entries are past int32 counting")
    # int32 keys: half the radix passes of int64 ones
    key, order = torch.sort(flat.to(torch.int32), stable=True)
    per, valid = per[order], valid[order]
    scratch = torch.empty(3 * m, dtype=torch.int32, device=flat.device)
    _launch("cross_apply", flat.device, key.data_ptr(), per.data_ptr(),
            valid.data_ptr(), scratch.data_ptr(), weights.data_ptr(),
            opt_e.data_ptr() if tc else None,
            opt_a.data_ptr() if tc else None, alpha.data_ptr(), m,
            int(mean), int(tc))
    cross_apply.launches += 1


cross_apply.launches = 0


# -- feature_index (the train actor's indices; no TPU kernel) ---------------

# csrc/feature_index.cu's limits: features, cells of a tuple, gather
# features; and its plan's layout, in int32 words (``struct Plan``)
FI_MAX_FEAT, FI_MAX_TERMS, FI_MAX_GATHER, FI_IMAGES = 64, 6, 16, 8
_FI_DHEAD, _FI_DTERM, _FI_GFEAT, _FI_GIMAGES, _FI_GOWN, _FI_GCELL, \
    _FI_GIMG, _FI_WORDS = 8, 136, 904, 920, 936, 952, 1048, 2072


@lru_cache(maxsize=None)
def _tperm(device: torch.device) -> torch.Tensor:
    """Transposed-cell -> canonical-cell permutation (cell (i, j) of
    the transposed board is cell (j, i) of the canonical one), moved
    to the device once: a per-step host copy would synchronise."""
    return torch.from_numpy(np.arange(16).reshape(4, 4).T.reshape(16)
                            ).to(device)


def _gathers_out(ts: TupleSet, canonical: bool) -> int:
    """The gather features whose canonical indices are written: Kc in
    canonical form, none otherwise."""
    return len(_gather_feat_ids(ts.n)) if canonical else 0


def feature_index_reference(ts: TupleSet, codes: torch.Tensor,
                            transposed=(1, 3), canonical: bool = True
                            ) -> tuple:
    """Plain version of ``feature_index``: the slots' cells from their
    codes, those of the ``transposed`` slots permuted back, then
    ``feature_indices`` and, in canonical form with gather features,
    ``canonical_gather_indices``."""
    cells4 = cells_from_codes(codes)  # (S, N, 16)
    # the transposed slots (up/down): permute their cells back
    tperm = _tperm(codes.device)
    cells4 = torch.stack([c[..., tperm] if d in transposed else c
                          for d, c in enumerate(cells4)])
    idx4 = feature_indices(ts, cells4)
    cidx4 = mult4 = None
    if _gathers_out(ts, canonical):
        cidx4, mult4 = canonical_gather_indices(ts, cells4)
    return idx4, cidx4, mult4


@lru_cache(maxsize=None)
def feature_index_plan(n: int, canonical: bool) -> np.ndarray:
    """The kernel's plan of tuple set ``n`` (``csrc/feature_index.cu``'s
    ``struct Plan``), (_FI_WORDS,) int32, from the tuple set's own
    plans: ``ntuple._index_plan``'s columns and place values with its
    offsets, and in canonical form ``canonical._orbit_index_plan``.

    There a gather feature's 8 images read the cells of its identity
    image in other orders, so the plan lists those cells once (its
    digits) and, per image, each digit's place value and the image's
    offset.  The images fall in features whose tables do not overlap,
    so the least index is among the images in the feature of least
    offset, and no image elsewhere can equal it: the plan lists image 0
    (the feature's own index) and then those images alone, with
    whether image 0 is one of them.  The other ("direct") features list
    their terms.  Raises ValueError for a tuple set beyond the kernel's
    limits."""
    ts = get_tuple_set(n)
    cols, coef = _index_plan(n)
    gf = _gather_feat_ids(n) if _gathers_out(ts, canonical) else []
    direct = [f for f in range(ts.num_feat) if f not in set(gf)]
    arity = (coef != 0).sum(axis=1)
    dterms = int(arity[direct].max()) if direct else 0
    gterms = int(arity[gf].max()) if len(gf) else 0
    if ts.num_feat > FI_MAX_FEAT or len(gf) > FI_MAX_GATHER or \
            max(dterms, gterms) > FI_MAX_TERMS:
        raise ValueError(
            f"feature_index: tuple set n={n} ({ts.num_feat} features of up "
            f"to {max(dterms, gterms)} cells, {len(gf)} gather features) is "
            f"beyond the kernel's {FI_MAX_FEAT}, {FI_MAX_TERMS} and "
            f"{FI_MAX_GATHER}")
    w = np.zeros(_FI_WORDS, np.int64)
    w[:5] = ts.num_feat, len(direct), dterms, len(gf), gterms
    for i, f in enumerate(direct):
        w[_FI_DHEAD + 2 * i: _FI_DHEAD + 2 * i + 2] = f, ts.offsets[f]
        nz = np.flatnonzero(coef[f])
        at = _FI_DTERM + 2 * FI_MAX_TERMS * i
        w[at: at + 2 * len(nz): 2] = cols[f, nz]
        w[at + 1: at + 2 * len(nz): 2] = coef[f, nz]
    if len(gf):
        ocols, ocoef, ooff = _orbit_index_plan(n)
        for k, f in enumerate(gf):
            w[_FI_GFEAT + k] = f
            digits = [int(c) for c, p in zip(ocols[0, k], ocoef[0, k]) if p]
            w[_FI_GCELL + FI_MAX_TERMS * k:][:len(digits)] = digits
            low = int(ooff[:, k].min())
            least = [s for s in range(FI_IMAGES) if ooff[s, k] == low]
            # the least feature's table ends before any other image's
            first = int(np.flatnonzero(ts.offsets == low)[0])
            if (ooff[:, k] != low).any() and \
                    ooff[ooff[:, k] != low, k].min() < low + ts.sizes[first]:
                raise ValueError(f"feature_index: n={n}: gather feature {f}'s "
                                 "images share a table")
            images = [0] + [s for s in least if s]
            w[_FI_GIMAGES + k] = len(images)
            w[_FI_GOWN + k] = int(least[0] == 0)
            for i, s in enumerate(images):
                place = {int(c): int(p) for c, p in zip(ocols[s, k],
                                                         ocoef[s, k]) if p}
                if set(place) != set(digits):
                    raise ValueError(f"feature_index: n={n}: image {s} of "
                                     f"gather feature {f} reads other cells")
                at = _FI_GIMG + (FI_IMAGES * k + i) * 8
                w[at: at + len(digits)] = [place[c] for c in digits]
                w[at + FI_MAX_TERMS] = ooff[s, k]
    return w.astype(np.int32)


@lru_cache(maxsize=None)
def _check_plan_layout() -> None:
    from .build import load_library

    if load_library().feature_index_plan_words() != _FI_WORDS:
        raise RuntimeError("feature_index: the kernel's plan layout and "
                           "the wrapper's differ")


def feature_index(ts: TupleSet, codes: torch.Tensor, transposed=(1, 3),
                  canonical: bool = True) -> tuple:
    """The train actor's indices of (S, N) boards from their (S, N, 4)
    int32 row codes, slots listed in ``transposed`` holding their
    boards transposed (the engine's up/down afterstates): ``(idx (S, N,
    F), cidx (S, N, Kc), mult (S, N, Kc))`` int32, ``idx`` the
    flat-table indices (``ntuple.feature_indices``) and, in canonical
    form with gather features, ``cidx`` and ``mult`` their
    canonical-orbit indices and multiplicities
    (``canonical.canonical_gather_indices``), else None for both.  On
    the card one kernel, given the tuple set's plan
    (``feature_index_plan``) as its parameters, reads the codes and
    writes the three, bitwise ``feature_index_reference``, the CPU's."""
    if codes.dtype != torch.int32 or codes.dim() != 3 or \
            codes.shape[-1] != 4:
        raise TypeError(f"feature_index: codes must be (S, N, 4) int32, got "
                        f"{tuple(codes.shape)} {codes.dtype}")
    slots, n = codes.shape[:2]
    if not all(0 <= d < slots for d in transposed):
        raise ValueError(f"feature_index: transposed slots {transposed} "
                         f"outside 0 .. {slots - 1}")
    if not codes.is_contiguous():
        raise ValueError("feature_index: codes must be contiguous")
    if _check_device("feature_index", codes) == "cpu":
        return feature_index_reference(ts, codes, transposed, canonical)
    _check_plan_layout()
    plan = feature_index_plan(ts.n, canonical)
    kc = _gathers_out(ts, canonical)
    rows = slots * n
    if rows * max(ts.num_feat, kc) >= 2**31 or slots > 31:
        raise ValueError(f"feature_index: {slots} x {n} boards are past "
                         "int32 indexing")
    if codes.data_ptr() % 16:
        raise ValueError("feature_index: codes must be 16-byte aligned")
    idx4 = torch.empty((slots, n, ts.num_feat), dtype=torch.int32,
                       device=codes.device)
    cidx4 = mult4 = None
    if kc:
        cidx4 = torch.empty((slots, n, kc), dtype=torch.int32,
                            device=codes.device)
        mult4 = torch.empty_like(cidx4)
    if rows:
        # the plan goes into the launch's parameters from host memory
        _launch("feature_index", codes.device, codes.data_ptr(), rows, n,
                sum(1 << d for d in set(transposed)), plan.ctypes.data,
                idx4.data_ptr(),
                cidx4.data_ptr() if kc else None,
                mult4.data_ptr() if kc else None)
        feature_index.launches += 1
    return idx4, cidx4, mult4


feature_index.launches = 0
