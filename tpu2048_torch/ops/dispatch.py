"""Table-op dispatch: the evaluator of a tuple set
(``tpu2048/ops/dispatch.py``).

  "gather": plain torch indexing of the flat table, on any device;
  "pallas": the ``eval_class`` CUDA kernel for the 16^2..16^4 classes
            (its plain version on CPU tensors) and plain gathers for
            the larger classes — the reference's name for its fused
            kernel path, kept so that configs carry over;
  "search": the search tree's evaluator: the ``eval_class`` kernel in
            single-pass "bf16" for the 16^2..16^4 classes and exact f32
            gathers for the larger classes on CUDA tensors, "gather"
            elsewhere; the train-side functions take it as "pallas";
  "auto":   "pallas" for CUDA tensors, "gather" elsewhere, as the
            reference resolves it on and off the TPU.

"gather" and "pallas" give the same values up to f32 summation order;
"search" reads the small classes' weights rounded to bf16.  The
train step's table ops live here too: the evaluator that also returns
its indices (``make_train_evaluator``), the exact re-evaluation of the
chosen afterstate (``make_mxu_eval_idx``), the per-class gradient
blocks (``make_class_grads``) and the table-level accumulator and
updater of the learners off the canonical form
(``make_delta_accumulator``, ``make_updater``), the last three through
the ``grad_class`` kernel on "pallas".  The reference's "onehot" mode
is a TPU workaround and is not ported.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, List, Optional, Tuple

import torch

from ..features.ntuple import TupleSet, feature_indices, get_tuple_set
from . import kernels
from . import onehot as oh

_NOT_PORTED = {
    "onehot": 'not ported: the ROADMAP lists one-hot matmuls under "Not '
              'ported" (a TPU workaround); use "pallas"',
}


def resolve_mode(mode: str, device: torch.device) -> str:
    """"auto" -> "pallas" on CUDA tensors, "gather" elsewhere;
    "search" -> "search" on CUDA tensors, "gather" elsewhere."""
    if mode in _NOT_PORTED:
        raise NotImplementedError(f"table_ops={mode!r} is {_NOT_PORTED[mode]}")
    if mode == "auto":
        return "pallas" if device.type == "cuda" else "gather"
    if mode == "search":
        return "search" if device.type == "cuda" else "gather"
    if mode not in ("gather", "pallas"):
        raise ValueError(f"unknown table op mode: {mode}")
    return mode


def uses_kernels(mode: str, device: torch.device) -> bool:
    """True when ``mode`` takes the kernels' wrappers on ``device``
    ("search" is "pallas" to the train-side functions)."""
    return resolve_mode(mode, device) in ("pallas", "search")


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


def _matmul_class_values(ts: TupleSet, classes: oh.TableClasses,
                         weights: torch.Tensor, idx2: torch.Tensor,
                         resolved: str, precision: str = "bf16x2"
                         ) -> torch.Tensor:
    """Sum of the 16^2..16^4 classes' weights at the (B, F) feature
    indices ``idx2``, (B,) f32: the ``eval_class`` kernel at
    ``precision`` on "pallas" and "search", plain f32 gathers on
    "gather" (where the reference, too, ignores the precision)."""
    total = torch.zeros(idx2.shape[0], dtype=torch.float32,
                        device=weights.device)
    for c in classes.matmul:
        if resolved in ("pallas", "search"):
            hi, lo = oh._hi_lo(ts, idx2, c)
            v = kernels.eval_class(oh._class_tables(weights, c), hi, lo,
                                   precision)
        else:
            v = weights[idx2[:, c.feat0: c.feat0 + c.g]].sum(dim=-1)
        total = total + v
    return total


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
        total = _matmul_class_values(
            ts, classes, weights, idx2, resolved,
            "bf16" if resolved == "search" else "bf16x2")
        if len(classes.gather_feats):
            total = total + _gather_class_values(
                ts, weights, flat_boards, idx2, canonical
            )
        return total.reshape(shape)

    return eval_fn


def make_train_evaluator(ts: TupleSet, mode: str, canonical: bool = False,
                         precision: Optional[str] = None) -> Callable:
    """Evaluator that also returns the indices it computed, so the
    train step selects the chosen afterstate's features instead of
    recomputing them; the reference's ``split=True`` form.

    Returns fn(weights, flat_boards (..., 16)) ->
        (mxu (...,), gth (...,), idx (..., F), cidx (..., K) | None,
         mult (..., K) | None):
    ``mxu`` is the 16^2..16^4 classes' part, at ``precision`` (default
    "bf16x2", "bf16" under "search"; "bf16" for the selection pass of
    ``AgentConfig.actor_precision="bf16"``), and ``gth`` the larger
    classes' part, exact f32 gathers at canonical-orbit indices when
    ``canonical``.
    """
    resolve_mode(mode, torch.device("cpu"))  # reject bad modes now
    classes = oh.build_table_classes(ts)
    if precision is None:
        precision = "bf16" if mode == "search" else "bf16x2"
    if canonical:
        from ..features.canonical import canonical_gather_indices

    def ev(weights: torch.Tensor, flat_boards: torch.Tensor):
        shape = flat_boards.shape[:-1]
        b = flat_boards[..., 0].numel()
        idx = feature_indices(ts, flat_boards)
        idx2 = idx.reshape(b, ts.num_feat)
        mxu = _matmul_class_values(ts, classes, weights, idx2,
                                   resolve_mode(mode, weights.device),
                                   precision)
        cidx = mult = None
        gth = torch.zeros(b, dtype=torch.float32, device=weights.device)
        if len(classes.gather_feats):
            if canonical:
                cidx, mult = canonical_gather_indices(ts, flat_boards)
                gth = weights[cidx.reshape(b, -1)].sum(dim=-1)
            else:
                gf = _gather_feats(ts.n, idx2.device)
                gth = weights[idx2[:, gf]].sum(dim=-1)
        return mxu.reshape(shape), gth.reshape(shape), idx, cidx, mult

    return ev


def make_mxu_eval_idx(ts: TupleSet, mode: str) -> Callable:
    """Exact-grade value of the 16^2..16^4 classes from precomputed
    feature indices: fn(weights, idx2 (B, F)) -> (B,) f32.  The bf16
    actor's exact TD bootstrap: an N-row "bf16x2" (exact f32) pass
    over the chosen afterstates, after the 4N-row bf16 selection."""
    resolve_mode(mode, torch.device("cpu"))
    classes = oh.build_table_classes(ts)

    def ev(weights: torch.Tensor, idx2: torch.Tensor) -> torch.Tensor:
        return _matmul_class_values(ts, classes, weights, idx2,
                                    resolve_mode(mode, weights.device))

    return ev


def make_class_grads(ts: TupleSet, mode: str
                     ) -> Tuple[oh.TableClasses, Callable]:
    """Per-class gradient pairs of the 16^2..16^4 classes only, in
    standard digit order.

    Returns ``(classes, fn)`` with ``fn(idx (B, F), dw (B,), valid
    (B,)) -> [pair (2, g, h, l), ...]`` aligned with
    ``classes.matmul``, each pair [dsum; hits] in one contiguous tensor
    (``dsum, hits = pair`` unpacks it): the ``grad_class`` kernel on
    "pallas" (its plain version on CPU tensors), the plain
    ``index_add_`` on "gather".  hits are exact; dsum differs between
    the two only in f32 summation order.
    """
    resolve_mode(mode, torch.device("cpu"))
    classes = oh.build_table_classes(ts)

    def fn(idx: torch.Tensor, dw: torch.Tensor, valid: torch.Tensor
           ) -> List[torch.Tensor]:
        grads = (kernels.grad_class if uses_kernels(mode, idx.device)
                 else kernels.grad_class_reference)
        out = []
        for c in classes.matmul:
            hi, lo = oh._hi_lo(ts, idx, c)
            out.append(grads(hi, lo, dw, valid, c.h, c.l))
        return out

    return classes, fn


def _flat_updates(idx: torch.Tensor, dw: torch.Tensor, valid: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(flat indices, dw per index, 1 per valid index), each (B * F,)
    in row-major (b, f) order: the valid rows' updates of ``idx``."""
    dwv = torch.where(valid, dw, 0.0)
    upd = dwv[:, None].expand(idx.shape).reshape(-1)
    contrib = valid[:, None].expand(idx.shape).to(torch.float32).reshape(-1)
    return idx.reshape(-1).long(), upd, contrib


def make_delta_accumulator(ts: TupleSet, mode: str) -> Callable:
    """Returns acc_fn(weights_like, idx (B, F), dw (B,), valid (B,)) ->
    pair (2, total) f32: row 0 the per-entry sum of the valid rows' dw,
    row 1 their hit count (``dsum, hits = pair`` unpacks it).  The
    table-level optimizers' gradient (temporal coherence off the
    canonical form, and the "fold" learners).

    "gather": two ``index_add_`` into a zeroed pair.  "pallas": one
    ``grad_class`` pair per 16^2..16^4 class, copied into its columns,
    and the ``index_add_`` pair over the larger classes' columns only.
    Both add each entry's terms in row order on the CPU, so there they
    agree bit for bit."""
    resolve_mode(mode, torch.device("cpu"))
    classes = oh.build_table_classes(ts)

    def acc(weights: torch.Tensor, idx: torch.Tensor, dw: torch.Tensor,
            valid: torch.Tensor) -> torch.Tensor:
        pair = torch.zeros((2,) + weights.shape, dtype=torch.float32,
                           device=weights.device)
        if not uses_kernels(mode, weights.device):
            flat, upd, contrib = _flat_updates(idx, dw, valid)
            pair[0].index_add_(0, flat, upd)
            pair[1].index_add_(0, flat, contrib)
            return pair
        for c in classes.matmul:
            hi, lo = oh._hi_lo(ts, idx, c)
            size = c.g * c.h * c.l
            pair[:, c.start: c.start + size] = kernels.grad_class(
                hi, lo, dw, valid, c.h, c.l).view(2, size)
        if len(classes.gather_feats):
            gidx = idx[:, _gather_feats(ts.n, idx.device)]
            flat, upd, contrib = _flat_updates(gidx, dw, valid)
            pair[0].index_add_(0, flat, upd)
            pair[1].index_add_(0, flat, contrib)
        return pair

    return acc


def scatter_add_ordered(table: torch.Tensor, flat: torch.Tensor,
                        upd: torch.Tensor) -> None:
    """``table[flat] += upd`` in place (1-D), an entry's terms added in
    the order of the list, whatever the device.  On CUDA tensors
    ``index_add_`` adds colliding terms with atomics in no fixed order,
    and ``index_put_`` with ``accumulate`` sorts the list stably and adds
    each entry's run in turn; on CPU tensors it is the other way round
    (``index_add_`` walks the list, ``index_put_`` spreads a long one
    over threads that add atomically).  Replicas that apply one
    gathered list this way stay bitwise equal."""
    if table.device.type == "cuda":
        table.index_put_((flat,), upd, accumulate=True)
    else:
        table.index_add_(0, flat, upd)


def make_updater(ts: TupleSet, mode: str, mean: bool, mesh=None) -> Callable:
    """Returns update_fn(weights, idx (B, F), dw (B,), valid (B,)) ->
    weights, updated IN PLACE.

    ``idx`` holds global flat-table indices, ``dw`` the per-row update
    already scaled by alpha / num_feat, and ``valid`` masks rows out.
    A scatter-add, with each entry's updates divided by its hit count
    this step when ``mean`` (``AgentConfig.update_mode="mean"``).

    "gather": one ``index_add_`` of the rows' (divided) updates.
    "pallas": per 16^2..16^4 class one ``grad_class`` pair, whose dsum
    (over hits under ``mean``) is added to the class block; the larger
    classes as "gather", their hits counted over their own columns.
    Under ``mean`` the two paths round differently, as in the
    reference: "gather" divides each update, "pallas" each sum.

    Under a ``mesh`` (``parallel/mesh.py``) the rows are this rank's
    and the update is the global batch's: each class pair is
    all-reduced, and the scattered rows are all-gathered in rank order
    and added in the list's order (``scatter_add_ordered``), so the
    hits are global and every rank's table takes the same bits."""
    resolve_mode(mode, torch.device("cpu"))
    classes = oh.build_table_classes(ts)

    def scatter(weights, idx, dw, valid):
        if mesh is not None:
            idx, dw, valid = mesh.all_gather_rows(idx, dw, valid)
        flat, upd, contrib = _flat_updates(idx, dw, valid)
        if mean:
            hits = torch.zeros_like(weights).index_add_(0, flat, contrib)
            upd = upd / hits[flat].clamp(min=1.0)
        if mesh is not None:
            scatter_add_ordered(weights, flat, upd)
        else:
            weights.index_add_(0, flat, upd)

    def update(weights: torch.Tensor, idx: torch.Tensor, dw: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
        if not uses_kernels(mode, weights.device):
            scatter(weights, idx, dw, valid)
            return weights
        for c in classes.matmul:
            hi, lo = oh._hi_lo(ts, idx, c)
            pair = kernels.grad_class(hi, lo, dw, valid, c.h, c.l)
            if mesh is not None:
                mesh.all_reduce(pair)
            dsum, hits = pair
            if mean:
                dsum = dsum / hits.clamp(min=1.0)
            size = c.g * c.h * c.l
            weights[c.start: c.start + size] += dsum.reshape(size)
        if len(classes.gather_feats):
            scatter(weights, idx[:, _gather_feats(ts.n, idx.device)], dw,
                    valid)
        return weights

    return update
