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


def eval_class(tables: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
               precision: str = "bf16x2") -> torch.Tensor:
    """V[b] = sum_g tables[g, hi[b, g], lo[b, g]], (B,) f32.

    ``tables`` (G, H, L) f32, ``hi`` and ``lo`` (B, G) int32, any B.
    "f32" and "bf16x2" sum the exact f32 entries (bf16x2's ~2^-18
    contract is met with room); "bf16" sums a round-to-nearest-even
    bf16 copy of the table, accumulated in f32.  Out-of-range indices
    give NaN on the card.
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
    if precision == "bf16":
        tables = tables.to(torch.bfloat16)
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
    """(3, g, 5) int32 gather plan of ``fold_class`` for one base-16
    class of 16^k tables, k <= 4: row r, tuple t holds
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


@lru_cache(maxsize=None)
def _fold_plan_on(n: int, feat0: int, g: int, device: torch.device
                  ) -> torch.Tensor:
    # moved to the device once (a per-call host copy would synchronise)
    return torch.from_numpy(fold_plan(n, feat0, g)).to(device)


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
    plan = _fold_plan_on(ts.n, feat0, g, pair.device)
    out = torch.empty_like(pair)
    rows = pair.numel() // (g * size)
    _launch("fold_class", pair.device, pair.data_ptr(), out.data_ptr(),
            plan.data_ptr(), rows, g, ks[feat0])
    fold_class.launches += 1
    return out


fold_class.launches = 0
