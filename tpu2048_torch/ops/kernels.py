"""Wrappers of the port's CUDA kernels (``tpu2048/ops/pallas_kernels.py``).

Each wrapper checks what it is given, launches its kernel on torch's
current stream for CUDA tensors, and takes its plain PyTorch version
only for CPU tensors.  Each counts its launches in a plain integer
attribute (``eval_class.launches``), so a run can show that its path
went through the kernel.
"""

from __future__ import annotations

import torch

PRECISIONS = ("bf16x2", "bf16", "f32")


def eval_class_reference(tables: torch.Tensor, hi: torch.Tensor,
                         lo: torch.Tensor,
                         precision: str = "bf16x2") -> torch.Tensor:
    """Plain version of ``eval_class``: sum_g T[g, hi[b, g], lo[b, g]]
    in f32, over a round-to-nearest-even bf16 copy of T for "bf16"."""
    if precision == "bf16":
        tables = tables.to(torch.bfloat16).to(torch.float32)
    g = torch.arange(tables.shape[0], device=tables.device)
    return tables[g, hi.long(), lo.long()].sum(dim=-1)


def _check(tables: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
           precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; "
                         f"expected one of {PRECISIONS}")
    if tables.dtype != torch.float32 or tables.dim() != 3:
        raise TypeError(f"tables must be (G, H, L) float32, got "
                        f"{tuple(tables.shape)} {tables.dtype}")
    g = tables.shape[0]
    for name, t in (("hi", hi), ("lo", lo)):
        if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != g:
            raise TypeError(f"{name} must be (B, {g}) int32, got "
                            f"{tuple(t.shape)} {t.dtype}")
    if hi.shape != lo.shape:
        raise ValueError(f"hi {tuple(hi.shape)} and lo {tuple(lo.shape)} "
                         "differ in shape")
    if not (tables.device == hi.device == lo.device):
        raise ValueError(f"tensors on different devices: {tables.device}, "
                         f"{hi.device}, {lo.device}")


def eval_class(tables: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor,
               precision: str = "bf16x2") -> torch.Tensor:
    """V[b] = sum_g tables[g, hi[b, g], lo[b, g]], (B,) f32.

    ``tables`` (G, H, L) f32, ``hi`` and ``lo`` (B, G) int32, any B.
    "f32" and "bf16x2" sum the exact f32 entries (bf16x2's ~2^-18
    contract is met with room); "bf16" sums a round-to-nearest-even
    bf16 copy of the table, accumulated in f32.  Out-of-range indices
    give NaN on the card.
    """
    _check(tables, hi, lo, precision)
    if tables.device.type == "cpu":
        return eval_class_reference(tables, hi, lo, precision)
    if tables.device.type != "cuda":
        raise ValueError(f"eval_class runs on CUDA or CPU tensors, not "
                         f"{tables.device}")
    for name, t in (("tables", tables), ("hi", hi), ("lo", lo)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    from .build import load_library

    lib = load_library()
    b, g = hi.shape
    _, h, l = tables.shape
    if precision == "bf16":
        tables = tables.to(torch.bfloat16)
    out = torch.empty(b, dtype=torch.float32, device=hi.device)
    with torch.cuda.device(hi.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.eval_class_launch(
            tables.data_ptr(), int(precision == "bf16"), hi.data_ptr(),
            lo.data_ptr(), out.data_ptr(), b, g, h, l, stream,
        )
    if rc != 0:
        raise RuntimeError("eval_class launch failed: "
                           + lib.eval_class_error_string(rc).decode())
    eval_class.launches += 1
    return out


eval_class.launches = 0
