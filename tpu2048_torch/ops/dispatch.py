"""Table-op dispatch: the evaluator of a tuple set
(``tpu2048/ops/dispatch.py``).

  "gather": plain torch indexing of the flat table, on any device;
  "onehot": the 16^2..16^4 classes through exact f32 one-hot matrix
            products (``onehot.py``), on any device, and plain gathers
            for the larger classes; refused on the card while TF32 is
            allowed;
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

"gather", "onehot" and "pallas" give the same values up to f32
summation order; "search" reads the small classes' weights rounded to
bf16.  The train step's table ops live here too: the evaluator that
also returns its indices (``make_train_evaluator``), the exact
re-evaluation of the chosen afterstate (``make_mxu_eval_idx``), the
per-class gradient blocks (``make_class_grads``) and the table-level
accumulator and updater of the learners off the canonical form
(``make_delta_accumulator``, ``make_updater``), the last three through
the ``grad_class`` kernel on "pallas".  Under "onehot" these follow
the reference's branches: the class gradients and the updater take
the one-hot products, and the train evaluator, the exact
re-evaluation and the accumulator are "gather"'s.

Under a mesh with a model axis (``mesh=``, ``parallel/mesh.py``) the
weights these functions take are this rank's shard
(``Mesh.table_shard``), and each evaluates the pieces it holds only:
a 16^2..16^4 class's value over its tuples there (``eval_class`` on a
tuple range: the shard's tables of those tuples are a contiguous
block, and their (hi, lo) columns are computed for the range alone,
so the kernel takes them as it stands), and each gather-path feature's
entry where the shard holds it, 0 elsewhere.  One all-reduce over the
model group then sums the pieces, and the values are put together as
the unsharded evaluator does: the classes in their order, the gather
features in one sum.  A piece held by one rank comes back exact (the
other ranks add 0), so the values are bitwise the unsharded ones
wherever no class is split (n >= 5); a class split by tuples (n <=
4) adds its owners' partial sums in the all-reduce's order, which
stays within 2^-23 * (g - 1) * sum |terms| of the unsharded ordered
sum (g the class's tuples; both orders' f32 rounding to first order).  The gradients and updates apply only the entries the
shard holds (the rest land as exact zeros on its first entry); the
data group's sums and gathered lists are as without a model axis.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Callable, List, Optional, Tuple

import torch

from ..features.ntuple import TupleSet, feature_indices, get_tuple_set
from ..obs.profiler import count
from . import kernels
from . import onehot as oh
from .kernels import scatter_add_ordered


def resolve_mode(mode: str, device: torch.device) -> str:
    """"auto" -> "pallas" on CUDA tensors, "gather" elsewhere;
    "search" -> "search" on CUDA tensors, "gather" elsewhere; "gather",
    "onehot" and "pallas" as they are, on any device."""
    if mode == "auto":
        return "pallas" if device.type == "cuda" else "gather"
    if mode == "search":
        return "search" if device.type == "cuda" else "gather"
    if mode not in ("gather", "onehot", "pallas"):
        raise ValueError(f"unknown table op mode: {mode}")
    return mode


def uses_kernels(mode: str, device: torch.device) -> bool:
    """True when ``mode`` takes the kernels' wrappers on ``device``
    ("search" is "pallas" to the train-side functions)."""
    return resolve_mode(mode, device) in ("pallas", "search")


def _shard_of(ts: TupleSet, mesh):
    """This rank's shard of ``ts``'s table under ``mesh``'s model axis
    (``parallel.mesh.TableShard``), or None: the table is whole."""
    return None if mesh is None else mesh.table_shard(ts)


def _gather_index(ts, flat_boards, idx2, canonical: bool) -> torch.Tensor:
    """(B, K) flat indices of the gather-path features: identity
    indices, or canonical-orbit indices when the table is in canonical
    form (features/canonical.py)."""
    if canonical:
        from ..features.canonical import canonical_gather_indices

        cidx, _mult = canonical_gather_indices(ts, flat_boards)
        return cidx.reshape(idx2.shape[0], -1)
    return idx2[:, _gather_feats(ts.n, idx2.device)]


@lru_cache(maxsize=None)
def _gather_feats(n: int, device: torch.device) -> torch.Tensor:
    # moved to the device once (a per-step host copy would synchronise)
    return torch.from_numpy(
        oh.build_table_classes(get_tuple_set(n)).gather_feats).to(device)


def _train_side(resolved: str) -> str:
    """The train evaluator's and the exact re-evaluation's mode:
    "onehot" reads the classes by gathers there, as the reference's
    (``dispatch.py:269``, ``:326``)."""
    return "gather" if resolved == "onehot" else resolved


def _class_value(ts: TupleSet, c: oh.TableClass, weights: torch.Tensor,
                 idx2: torch.Tensor, resolved: str, precision: str,
                 a: int = 0, b: int = -1, lo: int = 0) -> torch.Tensor:
    """The sum over the class's tuples ``a .. b - 1`` (all by default)
    of their weights at the (B, F) feature indices ``idx2``, (B,) f32;
    ``weights`` starts at flat entry ``lo`` (a shard)."""
    b = c.g if b < 0 else b
    if resolved in ("pallas", "search", "onehot"):
        hl = c.h * c.l
        at = c.start + a * hl - lo
        tables = weights[at: at + (b - a) * hl].view(b - a, c.h, c.l)
        hi, low = oh._hi_lo(ts, idx2, c, a, b)
        if resolved == "onehot":
            return oh.class_values(tables, hi, low)
        return kernels.eval_class(tables, hi, low, precision)
    cols = idx2[:, c.feat0 + a: c.feat0 + b]
    return weights[cols - lo if lo else cols].sum(dim=-1)


def _matmul_class_values(ts: TupleSet, classes: oh.TableClasses,
                         weights: torch.Tensor, idx2: torch.Tensor,
                         resolved: str, precision: str = "bf16x2"
                         ) -> torch.Tensor:
    """Sum of the 16^2..16^4 classes' weights at the (B, F) feature
    indices ``idx2``, (B,) f32: the ``eval_class`` kernel at
    ``precision`` on "pallas" and "search", the one-hot products on
    "onehot", plain f32 gathers on "gather" (where the reference, too,
    ignores the precision)."""
    total = torch.zeros(idx2.shape[0], dtype=torch.float32,
                        device=weights.device)
    for c in classes.matmul:
        total = total + _class_value(ts, c, weights, idx2, resolved,
                                     precision)
    return total


def _class_parts(ts: TupleSet, classes: oh.TableClasses, weights, idx2,
                 resolved: str, precision: str, shard) -> torch.Tensor:
    """(C, B): row i the value of class i's tuples that ``shard`` holds
    (0 where it holds none)."""
    parts = torch.zeros((len(classes.matmul), idx2.shape[0]),
                        dtype=torch.float32, device=weights.device)
    for i, c in enumerate(classes.matmul):
        a, b = shard.tuples(c.feat0, c.g)
        if a < b:
            parts[i] = _class_value(ts, c, weights, idx2, resolved,
                                    precision, a, b, shard.lo)
    return parts


def _sum_classes(parts: torch.Tensor) -> torch.Tensor:
    """The classes' values added in the unsharded evaluator's order."""
    total = torch.zeros(parts.shape[1], dtype=torch.float32,
                        device=parts.device)
    for v in parts:
        total = total + v
    return total


def _owned(shard, flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(held, local): which of the flat indices ``flat`` the shard
    holds, and their shard-local index (0 for the others)."""
    held = (flat >= shard.lo) & (flat < shard.hi)
    return held, torch.where(held, flat - shard.lo, 0)


def _owned_values(weights: torch.Tensor, idx: torch.Tensor, shard
                  ) -> torch.Tensor:
    """The shard's entries at the flat indices ``idx``, 0 where another
    rank holds the entry."""
    held, local = _owned(shard, idx)
    return torch.where(held, weights[local], 0.0)


def _model_sum(mesh, *parts: torch.Tensor) -> List[torch.Tensor]:
    """Each of ``parts`` (f32) summed over the model group, in one
    all-reduce."""
    flat = torch.cat([p.reshape(-1) for p in parts])
    mesh.all_reduce(flat, axis="model")
    out, at = [], 0
    for p in parts:
        out.append(flat[at: at + p.numel()].view(p.shape))
        at += p.numel()
    return out


def make_evaluator(ts: TupleSet, mode: str, canonical: bool = False,
                   mesh=None) -> Callable:
    """Returns eval_fn(weights, flat_boards (..., 16)) -> (...,) f32.

    The mode resolves on each call from the device of ``weights``.
    ``canonical=True`` reads the gather-path classes at their
    canonical-orbit indices; the 16^2..16^4 classes use identity
    indices in either representation.  Under a ``mesh`` with a model
    axis ``weights`` is this rank's shard (see the module doc).
    """
    resolve_mode(mode, torch.device("cpu"))  # reject bad modes now
    classes = oh.build_table_classes(ts)
    shard = _shard_of(ts, mesh)

    def eval_fn(weights: torch.Tensor, flat_boards: torch.Tensor
                ) -> torch.Tensor:
        shape = flat_boards.shape[:-1]
        b = flat_boards[..., 0].numel()
        idx2 = feature_indices(ts, flat_boards).reshape(b, ts.num_feat)
        resolved = resolve_mode(mode, weights.device)
        precision = "bf16" if resolved == "search" else "bf16x2"
        if shard is not None:
            if resolved == "gather" and not canonical:
                [vals] = _model_sum(mesh, _owned_values(weights, idx2, shard))
                return vals.sum(dim=-1).reshape(shape)
            parts = _class_parts(ts, classes, weights, idx2, resolved,
                                 precision, shard)
            gv = _owned_values(weights, _gather_index(
                ts, flat_boards, idx2, canonical), shard)
            parts, gv = _model_sum(mesh, parts, gv)
            total = _sum_classes(parts)
            if len(classes.gather_feats):
                total = total + gv.sum(dim=-1)
            return total.reshape(shape)
        if resolved == "gather" and not canonical:
            return weights[idx2].sum(dim=-1).reshape(shape)
        total = _matmul_class_values(ts, classes, weights, idx2, resolved,
                                     precision)
        if len(classes.gather_feats):
            total = total + weights[_gather_index(
                ts, flat_boards, idx2, canonical)].sum(dim=-1)
        return total.reshape(shape)

    return eval_fn


def make_train_evaluator(ts: TupleSet, mode: str, canonical: bool = False,
                         precision: Optional[str] = None,
                         mesh=None, codes: bool = False) -> Callable:
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
    ``canonical``.  Under a ``mesh`` with a model axis ``weights`` is
    this rank's shard, and one all-reduce over the model group sums
    the pieces (see the module doc).

    With ``codes``, the codes form: fn(weights, codes (S, N, 4),
    transposed) -> the same, of the (S, N) boards whose packed row
    codes are given, the slots in ``transposed`` holding their boards
    transposed (the engine's up/down afterstates).  Its indices come
    from ``kernels.feature_index`` (one kernel on the card) where the
    mode takes the kernels, else from its plain version; the rows it
    gives the kernel's wrapper add to the ``td.index_rows`` counter.
    """
    resolve_mode(mode, torch.device("cpu"))  # reject bad modes now
    classes = oh.build_table_classes(ts)
    shard = _shard_of(ts, mesh)
    if precision is None:
        precision = "bf16" if mode == "search" else "bf16x2"
    if canonical:
        from ..features.canonical import canonical_gather_indices

    def values(weights: torch.Tensor, idx: torch.Tensor,
               cidx: Optional[torch.Tensor]):
        """(mxu, gth) of the (..., F) indices and, in canonical form,
        the (..., K) canonical ones."""
        shape = idx.shape[:-1]
        b = idx[..., 0].numel()
        idx2 = idx.reshape(b, ts.num_feat)
        resolved = _train_side(resolve_mode(mode, weights.device))
        gidx = None
        if len(classes.gather_feats):
            if canonical:
                gidx = cidx.reshape(b, -1)
            else:
                gidx = idx2[:, _gather_feats(ts.n, idx2.device)]
        gth = torch.zeros(b, dtype=torch.float32, device=weights.device)
        if shard is not None:
            parts = _class_parts(ts, classes, weights, idx2, resolved,
                                 precision, shard)
            if gidx is None:
                [parts] = _model_sum(mesh, parts)
            else:
                parts, gv = _model_sum(
                    mesh, parts, _owned_values(weights, gidx, shard))
                gth = gv.sum(dim=-1)
            mxu = _sum_classes(parts)
        else:
            mxu = _matmul_class_values(ts, classes, weights, idx2, resolved,
                                       precision)
            if gidx is not None:
                gth = weights[gidx].sum(dim=-1)
        return mxu.reshape(shape), gth.reshape(shape)

    def ev(weights: torch.Tensor, flat_boards: torch.Tensor):
        idx = feature_indices(ts, flat_boards)
        cidx = mult = None
        if canonical and len(classes.gather_feats):
            cidx, mult = canonical_gather_indices(ts, flat_boards)
        return (*values(weights, idx, cidx), idx, cidx, mult)

    def ev_codes(weights: torch.Tensor, row_codes: torch.Tensor,
                 transposed):
        if uses_kernels(mode, row_codes.device):
            count("td.index_rows", row_codes.shape[0] * row_codes.shape[1])
            build = kernels.feature_index
        else:
            build = kernels.feature_index_reference
        idx, cidx, mult = build(ts, row_codes, transposed, canonical)
        return (*values(weights, idx, cidx), idx, cidx, mult)

    return ev_codes if codes else ev


def make_mxu_eval_idx(ts: TupleSet, mode: str, mesh=None) -> Callable:
    """Exact-grade value of the 16^2..16^4 classes from precomputed
    feature indices: fn(weights, idx2 (B, F)) -> (B,) f32.  The bf16
    actor's exact TD bootstrap: an N-row "bf16x2" (exact f32) pass
    over the chosen afterstates, after the 4N-row bf16 selection.
    Under a ``mesh`` with a model axis, the classes' pieces of this
    rank's shard summed over the model group."""
    resolve_mode(mode, torch.device("cpu"))
    classes = oh.build_table_classes(ts)
    shard = _shard_of(ts, mesh)

    def ev(weights: torch.Tensor, idx2: torch.Tensor) -> torch.Tensor:
        resolved = _train_side(resolve_mode(mode, weights.device))
        if shard is None:
            return _matmul_class_values(ts, classes, weights, idx2, resolved)
        [parts] = _model_sum(mesh, _class_parts(
            ts, classes, weights, idx2, resolved, "bf16x2", shard))
        return _sum_classes(parts)

    return ev


def make_class_grads(ts: TupleSet, mode: str, mesh=None
                     ) -> Tuple[oh.TableClasses, Callable]:
    """Per-class gradient pairs of the 16^2..16^4 classes only, in
    standard digit order.

    Returns ``(classes, fn)`` with ``fn(idx (B, F), dw (B,), valid
    (B,)) -> [pair (2, g, h, l), ...]`` aligned with
    ``classes.matmul``, each pair [dsum; hits] in one contiguous tensor
    (``dsum, hits = pair`` unpacks it): the ``grad_class`` kernel on
    "pallas" (its plain version on CPU tensors), the one-hot products
    on "onehot", the plain version (``kernels.grad_class_reference``,
    rows added in their order) on "gather".  hits are exact; dsum
    differs between them only in f32 summation order, and each gives
    one result per input on the card.  Under a ``mesh`` with a model
    axis each pair covers the class's tuples ``a .. b - 1`` that this
    rank holds, (2, b - a, h, l) (``TableShard.tuples``), and is None
    for a class it holds none of.
    """
    resolve_mode(mode, torch.device("cpu"))
    classes = oh.build_table_classes(ts)
    shard = _shard_of(ts, mesh)

    def fn(idx: torch.Tensor, dw: torch.Tensor, valid: torch.Tensor
           ) -> List[Optional[torch.Tensor]]:
        grads = _class_grads_fn(resolve_mode(mode, idx.device))
        out = []
        for c in classes.matmul:
            a, b = (0, c.g) if shard is None else shard.tuples(c.feat0, c.g)
            if a == b:
                out.append(None)
                continue
            hi, lo = oh._hi_lo(ts, idx, c, a, b)
            out.append(grads(hi, lo, dw, valid, c.h, c.l))
        return out

    return classes, fn


def _class_grads_fn(resolved: str) -> Callable:
    """The class gradient of a resolved mode: the ``grad_class`` kernel's
    wrapper, the one-hot products, or its plain version."""
    if resolved in ("pallas", "search"):
        return kernels.grad_class
    if resolved == "onehot":
        return oh.class_grads
    return kernels.grad_class_reference


def _flat_updates(idx: torch.Tensor, dw: torch.Tensor, valid: torch.Tensor,
                  shard=None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(flat indices, dw per index, 1 per valid index), each (B * F,)
    in row-major (b, f) order: the valid rows' updates of ``idx``.
    With a ``shard`` the indices are shard-local, and an entry the
    shard does not hold takes a 0 update and a 0 count at its entry 0."""
    dwv = torch.where(valid, dw, 0.0)
    upd = dwv[:, None].expand(idx.shape).reshape(-1)
    contrib = valid[:, None].expand(idx.shape).to(torch.float32).reshape(-1)
    flat = idx.reshape(-1).long()
    if shard is not None:
        held, flat = _owned(shard, flat)
        upd = torch.where(held, upd, 0.0)
        contrib = torch.where(held, contrib, 0.0)
    return flat, upd, contrib


def make_delta_accumulator(ts: TupleSet, mode: str, mesh=None) -> Callable:
    """Returns acc_fn(weights_like, idx (B, F), dw (B,), valid (B,)) ->
    pair (2, total) f32: row 0 the per-entry sum of the valid rows' dw,
    row 1 their hit count (``dsum, hits = pair`` unpacks it).  The
    table-level optimizers' gradient (temporal coherence off the
    canonical form, and the "fold" learners).

    "gather" (and "onehot", as in the reference): the rows' dw added
    into a zeroed pair in a fixed order (``scatter_add_ordered``),
    and their counts.  "pallas": one ``grad_class`` pair per
    16^2..16^4 class, copied into its columns, and the same ordered
    pair over the larger classes' columns only.
    Both add each entry's terms in row order on the CPU, so there they
    agree bit for bit; on the card each gives one result per input.
    Under a ``mesh`` with a model axis ``weights_like`` is this rank's
    shard and the pair is shard-sized: the entries the shard holds
    only."""
    resolve_mode(mode, torch.device("cpu"))
    classes = oh.build_table_classes(ts)
    shard = _shard_of(ts, mesh)
    lo = 0 if shard is None else shard.lo

    def acc(weights: torch.Tensor, idx: torch.Tensor, dw: torch.Tensor,
            valid: torch.Tensor) -> torch.Tensor:
        pair = torch.zeros((2,) + weights.shape, dtype=torch.float32,
                           device=weights.device)
        if not uses_kernels(mode, weights.device):
            flat, upd, contrib = _flat_updates(idx, dw, valid, shard)
            scatter_add_ordered(pair[0], flat, upd)
            pair[1].index_add_(0, flat, contrib)  # 0/1: exact in any order
            return pair
        for c in classes.matmul:
            a, b = (0, c.g) if shard is None else shard.tuples(c.feat0, c.g)
            if a == b:
                continue
            hi, low = oh._hi_lo(ts, idx, c, a, b)
            hl = c.h * c.l
            at = c.start + a * hl - lo
            pair[:, at: at + (b - a) * hl] = kernels.grad_class(
                hi, low, dw, valid, c.h, c.l).view(2, (b - a) * hl)
        if len(classes.gather_feats):
            gidx = idx[:, _gather_feats(ts.n, idx.device)]
            flat, upd, contrib = _flat_updates(gidx, dw, valid, shard)
            scatter_add_ordered(pair[0], flat, upd)
            pair[1].index_add_(0, flat, contrib)  # 0/1: exact in any order
        return pair

    return acc


def make_updater(ts: TupleSet, mode: str, mean: bool, mesh=None) -> Callable:
    """Returns update_fn(weights, idx (B, F), dw (B,), valid (B,)) ->
    weights, updated IN PLACE.

    ``idx`` holds global flat-table indices, ``dw`` the per-row update
    already scaled by alpha / num_feat, and ``valid`` masks rows out.
    A scatter-add, with each entry's updates divided by its hit count
    this step when ``mean`` (``AgentConfig.update_mode="mean"``).

    "gather": the rows' (divided) updates added in a fixed order
    (``scatter_add_ordered``), so one input gives one table on the
    card as on the CPU.
    "pallas": per 16^2..16^4 class one ``grad_class`` pair, whose dsum
    (over hits under ``mean``) is added to the class block; the larger
    classes as "gather", their hits counted over their own columns.
    "onehot": the same, each class pair from the one-hot products
    (the reference's ``onehot_update``).  Under ``mean`` the paths
    round differently, as in the reference: "gather" divides each
    update, "pallas" and "onehot" each sum.

    Under a ``mesh`` (``parallel/mesh.py``) the rows are this rank's
    and the update is the global batch's: each class pair is
    all-reduced over the data group, and the scattered rows are
    all-gathered in rank order and added in a fixed order, so the
    hits are global and every rank's table takes the same bits.  Under
    a model axis ``weights`` is this rank's shard, and only the entries
    it holds are updated."""
    resolve_mode(mode, torch.device("cpu"))
    classes = oh.build_table_classes(ts)
    shard = _shard_of(ts, mesh)
    lo = 0 if shard is None else shard.lo

    def scatter(weights, idx, dw, valid):
        if mesh is not None:
            idx, dw, valid = mesh.all_gather_rows(idx, dw, valid)
        flat, upd, contrib = _flat_updates(idx, dw, valid, shard)
        if mean:
            # 0/1 counts: exact in any order
            hits = torch.zeros_like(weights).index_add_(0, flat, contrib)
            upd = upd / hits[flat].clamp(min=1.0)
        scatter_add_ordered(weights, flat, upd)

    def update(weights: torch.Tensor, idx: torch.Tensor, dw: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
        resolved = resolve_mode(mode, weights.device)
        if resolved not in ("pallas", "search", "onehot"):
            scatter(weights, idx, dw, valid)
            return weights
        grads = _class_grads_fn(resolved)
        for c in classes.matmul:
            a, b = (0, c.g) if shard is None else shard.tuples(c.feat0, c.g)
            if a == b:
                continue
            hi, low = oh._hi_lo(ts, idx, c, a, b)
            pair = grads(hi, low, dw, valid, c.h, c.l)
            if mesh is not None:
                mesh.all_reduce(pair)
            dsum, hits = pair
            if mean:
                dsum = dsum / hits.clamp(min=1.0)
            size = (b - a) * c.h * c.l
            at = c.start + a * c.h * c.l - lo
            weights[at: at + size] += dsum.reshape(size)
        if len(classes.gather_feats):
            scatter(weights, idx[:, _gather_feats(ts.n, idx.device)],
                    dw, valid)
        return weights

    return update
