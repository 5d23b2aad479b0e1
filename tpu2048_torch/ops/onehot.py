"""Table classes of the flat weight table (``tpu2048/ops/onehot.py``).

Tuples of one size sit contiguously in the flat table; the sizes in
``CLASS_DECOMP`` (16^2, 16^3, 16^4) are viewed as stacked (G, H, L)
class blocks and read by the ``eval_class`` kernel with a two-level
(hi, lo) index.  Larger sizes (16^5, 14^6, 16^6) are read by plain
gathers.  ``CLASS_DECOMP``, ``TableClass`` and ``build_table_classes``
are verbatim copies of the reference; its one-hot matmul evaluation
is a TPU lowering workaround and is not ported.
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
