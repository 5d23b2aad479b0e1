"""Table classes of the flat weight table, and the two-level one-hot
table ops (``tpu2048/ops/onehot.py``).

Tuples of one size sit contiguously in the flat table; the sizes in
``CLASS_DECOMP`` (16^2, 16^3, 16^4) are viewed as stacked (G, H, L)
class blocks, read with a two-level (hi, lo) index by the
``eval_class`` kernel ("pallas") or by one-hot matrix products
("onehot").  Larger sizes (16^5, 14^6, 16^6) are read by plain
gathers.  ``CLASS_DECOMP``, ``TableClass`` and ``build_table_classes``
are verbatim copies of the reference.

``table_ops="onehot"`` evaluates a class as the bilinear form

    T[g, hi, lo] = (onehot(hi) @ T[g])[lo]

one (B, H) x (H, L) product per tuple, and its gradient as the
transpose, ``dsum[g] = onehot(hi)^T (dw * onehot(lo))`` and ``hits``
the same with the valid mask.  Each product term is an exact f32
weight (or dw) or zero, as ``Precision.HIGHEST`` gives the reference,
only while the matrix products run in full f32: on the card TF32
would round every weight to a 10-bit mantissa, so the products refuse
to run when a caller has allowed it (``torch.backends.cuda.matmul``).
The port never sets that flag itself.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..features.ntuple import TupleSet, get_tuple_set

# size -> (H, L) two-level decomposition; sizes absent here (16^5, 14^6)
# are evaluated by plain gather.
CLASS_DECOMP = {
    256: (16, 16),
    4096: (64, 64),
    65536: (256, 256),
}


class TableClass(NamedTuple):
    """A run of same-size tuples, contiguous in the flat table."""

    start: int  # flat-table offset of the first tuple
    g: int  # number of tuples
    h: int
    l: int
    feat0: int  # first feature column in the (…, num_feat) index array


class TableClasses(NamedTuple):
    matmul: Tuple[TableClass, ...]  # classes read as (G, H, L) blocks
    gather_feats: np.ndarray  # (K,) int32 feature columns on the gather path


def build_table_classes(ts: TupleSet) -> TableClasses:
    """Group the tuple set's tables into contiguous same-size runs."""
    sizes = ts.sizes
    offsets = ts.offsets
    classes: List[TableClass] = []
    gather_feats: List[int] = []
    f = 0
    while f < ts.num_feat:
        size = int(sizes[f])
        g = 1
        while f + g < ts.num_feat and int(sizes[f + g]) == size:
            g += 1
        if size in CLASS_DECOMP:
            h, l = CLASS_DECOMP[size]
            classes.append(
                TableClass(start=int(offsets[f]), g=g, h=h, l=l, feat0=f)
            )
        else:
            gather_feats.extend(range(f, f + g))
        f += g
    return TableClasses(
        matmul=tuple(classes),
        gather_feats=np.asarray(gather_feats, np.int32),
    )


def _class_tables(weights: torch.Tensor, c: TableClass) -> torch.Tensor:
    """The class's (G, H, L) block: a view of ``weights``, not a copy."""
    return weights[c.start: c.start + c.g * c.h * c.l].view(c.g, c.h, c.l)


@lru_cache(maxsize=None)
def _class_offsets(n: int, feat0: int, g: int, device: torch.device
                   ) -> torch.Tensor:
    # moved to the device once: a copy from host memory on every call
    # would synchronise the stream on every step
    return torch.from_numpy(get_tuple_set(n).offsets[feat0: feat0 + g]
                            ).to(device)


def _hi_lo(ts: TupleSet, idx: torch.Tensor, c: TableClass, a: int = 0,
           b: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split this class's global indices into (hi, lo) int32 levels,
    each a new contiguous (..., G) tensor; of the class's tuples ``a ..
    b - 1`` only, a (..., b - a) pair, when given (a rank's tuples
    under a model axis)."""
    b = c.g if b < 0 else b
    off = _class_offsets(ts.n, c.feat0 + a, b - a, idx.device)
    local = idx[..., c.feat0 + a: c.feat0 + b] - off
    return local // c.l, local % c.l


# the one-hot products run over row blocks of at most this many f32
# entries in each (G, rows, H) or (G, rows, L) operand (256 MiB): the
# train step's 32,768 rows at n >= 4 take 3 blocks, a 2,000,000-row
# search chunk 130, where one block would need 34.8 GB.  Rows are
# independent, so the evaluator's values do not depend on the blocks
_BLOCK_ENTRIES = 1 << 26


def _tf32_allowed() -> bool:
    """True when a caller lets cuBLAS run f32 products in TF32."""
    m = torch.backends.cuda.matmul
    p = getattr(m, "fp32_precision", None)
    if p is None:  # torch before the fp32_precision settings
        return bool(m.allow_tf32)
    if p == "none":  # the backend follows the generic setting
        p = getattr(torch.backends, "fp32_precision", "ieee")
    return p == "tf32"


def _check_exact(device: torch.device) -> None:
    if device.type == "cuda" and _tf32_allowed():
        raise RuntimeError(
            'table_ops="onehot" needs exact f32 matrix products, but TF32 '
            "is allowed for CUDA matmuls, which would round every weight "
            "to a 10-bit mantissa; disallow it first "
            "(torch.backends.cuda.matmul.fp32_precision = \"ieee\", or "
            "torch.set_float32_matmul_precision(\"highest\") on an older "
            "torch)")


def _block_rows(g: int, width: int) -> int:
    return max(1, _BLOCK_ENTRIES // (g * width))


def _one_hot(idx: torch.Tensor, width: int) -> torch.Tensor:
    """(G, rows, width) f32 one-hot of the (rows, G) levels ``idx``; a
    level out of range gives a row of zeros, as ``jax.nn.one_hot`` (an
    invalid row of the train step may hold any index)."""
    r, g = idx.shape
    at = idx.t().long()[..., None]
    ok = ((at >= 0) & (at < width)).to(torch.float32)
    out = torch.zeros((g, r, width), dtype=torch.float32, device=idx.device)
    return out.scatter_(2, at.clamp(0, width - 1), ok)


def class_values(tables: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor
                 ) -> torch.Tensor:
    """``sum_g tables[g, hi[:, g], lo[:, g]]``, (B,) f32, through the
    one-hot product ``onehot(hi) @ tables[g]`` (G, B, L) and a gather of
    its column ``lo``: exact, every term a weight or zero.  The terms
    add in the order g = 0 .. G-1, the ``eval_class`` kernel's, so a
    row's value depends on its own indices alone."""
    _check_exact(tables.device)
    g, h, l = tables.shape
    b = hi.shape[0]
    out = torch.empty(b, dtype=torch.float32, device=tables.device)
    step = _block_rows(g, max(h, l))
    for at in range(0, b, step):
        m = torch.bmm(_one_hot(hi[at: at + step], h), tables)
        terms = m.gather(2, lo[at: at + step].t().long()[..., None])[..., 0]
        acc = out[at: at + step]
        acc.copy_(terms[0])
        for k in range(1, g):
            acc += terms[k]
    return out


def class_grads(hi: torch.Tensor, lo: torch.Tensor, dw: torch.Tensor,
                valid: torch.Tensor, h: int, l: int) -> torch.Tensor:
    """The class's gradient pair, one contiguous (2, G, H, L) f32
    tensor as ``kernels.grad_class`` gives it: ``dsum[g] =
    onehot(hi)^T (dw * onehot(lo))`` over the valid rows, and ``hits``
    the same with 1 per valid row (exact integers).  The rows' sums
    add in the products' order: dsum differs from the ordered
    ``index_add_`` in f32 summation order only."""
    _check_exact(hi.device)
    b, g = hi.shape
    dwv = torch.where(valid, dw, 0.0).to(torch.float32)
    cv = valid.to(torch.float32)
    pair = torch.zeros((2, g, h, l), dtype=torch.float32, device=hi.device)
    step = _block_rows(g, max(h, l))
    for at in range(0, b, step):
        rows = slice(at, at + step)
        oh_hi = _one_hot(hi[rows], h).transpose(1, 2)  # (G, H, rows)
        oh_lo = _one_hot(lo[rows], l)  # (G, rows, L)
        pair[0].baddbmm_(oh_hi, oh_lo * dwv[rows, None])
        pair[1].baddbmm_(oh_hi, oh_lo * cv[rows, None])
    return pair

