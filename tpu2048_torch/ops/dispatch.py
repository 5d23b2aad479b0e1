"""Table-op dispatch: the evaluator of a tuple set
(``tpu2048/ops/dispatch.py``).

  "gather": plain torch indexing of the flat table, on any device;
  "pallas": the ``eval_class`` CUDA kernel for the 16^2..16^4 classes
            (its plain version on CPU tensors) and plain gathers for
            the larger classes — the reference's name for its fused
            kernel path, kept so that configs carry over;
  "auto":   "pallas" for CUDA tensors, "gather" elsewhere, as the
            reference resolves it on and off the TPU.

Both paths give the same values up to f32 summation order.  The
reference's "search" mode is not ported yet; its "onehot" mode is a
TPU workaround and will not be.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable

import torch

from ..features.ntuple import TupleSet, feature_indices, get_tuple_set
from . import kernels
from . import onehot as oh

_NOT_PORTED = {
    "search": 'not ported yet: it waits for the ROADMAP item "Search + '
              'expectimax"',
    "onehot": 'not ported: the ROADMAP lists one-hot matmuls under "Not '
              'ported" (a TPU workaround); use "pallas"',
}


def resolve_mode(mode: str, device: torch.device) -> str:
    """"auto" -> "pallas" on CUDA tensors, "gather" elsewhere."""
    if mode in _NOT_PORTED:
        raise NotImplementedError(f"table_ops={mode!r} is {_NOT_PORTED[mode]}")
    if mode == "auto":
        return "pallas" if device.type == "cuda" else "gather"
    if mode not in ("gather", "pallas"):
        raise ValueError(f"unknown table op mode: {mode}")
    return mode


def _gather_class_values(ts, weights, flat_boards, idx2,
                         canonical: bool) -> torch.Tensor:
    """Sum of the gather-path features' weights, (B,): identity
    indices, or canonical-orbit indices when the table is in canonical
    form (features/canonical.py)."""
    if canonical:
        from ..features.canonical import canonical_gather_indices

        cidx, _mult = canonical_gather_indices(ts, flat_boards)
        return weights[cidx.reshape(idx2.shape[0], -1)].sum(dim=-1)
    gf = _gather_feats(ts.n, idx2.device)
    return weights[idx2[:, gf]].sum(dim=-1)


@lru_cache(maxsize=None)
def _gather_feats(n: int, device: torch.device) -> torch.Tensor:
    # moved to the device once (a per-step host copy would synchronise)
    return torch.from_numpy(
        oh.build_table_classes(get_tuple_set(n)).gather_feats).to(device)


def make_evaluator(ts: TupleSet, mode: str, canonical: bool = False
                   ) -> Callable:
    """Returns eval_fn(weights, flat_boards (..., 16)) -> (...,) f32.

    The mode resolves on each call from the device of ``weights``.
    ``canonical=True`` reads the gather-path classes at their
    canonical-orbit indices; the 16^2..16^4 classes use identity
    indices in either representation.
    """
    resolve_mode(mode, torch.device("cpu"))  # reject bad modes now
    classes = oh.build_table_classes(ts)

    def eval_fn(weights: torch.Tensor, flat_boards: torch.Tensor
                ) -> torch.Tensor:
        shape = flat_boards.shape[:-1]
        b = flat_boards[..., 0].numel()
        idx2 = feature_indices(ts, flat_boards).reshape(b, ts.num_feat)
        resolved = resolve_mode(mode, weights.device)
        if resolved == "gather" and not canonical:
            return weights[idx2].sum(dim=-1).reshape(shape)
        total = torch.zeros(b, dtype=torch.float32, device=weights.device)
        for c in classes.matmul:
            if resolved == "pallas":
                hi, lo = oh._hi_lo(ts, idx2, c)
                v = kernels.eval_class(oh._class_tables(weights, c), hi, lo)
            else:
                v = weights[idx2[:, c.feat0: c.feat0 + c.g]].sum(dim=-1)
            total = total + v
        if len(classes.gather_feats):
            total = total + _gather_class_values(
                ts, weights, flat_boards, idx2, canonical
            )
        return total.reshape(shape)

    return eval_fn
