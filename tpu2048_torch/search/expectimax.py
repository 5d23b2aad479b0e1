"""Batched sampled expectimax (``tpu2048/search/expectimax.py``).

The tree for a batch of afterstate boards expands level by level over
the whole batch at once:

  * each chance node samples ``min(width, empty)`` distinct empty
    cells (Gumbel top-k over the empty mask) and draws each spawned
    tile 2/4 with the 0.9/0.1 law;
  * depth-0 nodes and comfortable nodes (``empty >= since_empty``)
    take the value function's estimate;
  * dead children score -100 and each child's best value is clipped
    at 0 before the node averages its valid children.

The reference unrolls the recursion at trace time and picks the tier
of a root-compacted batch with ``lax.cond``; here the recursion is a
Python call per level over tensors, the root chunks are a Python loop,
and the tier is picked on the host from one read of ``need.sum()``
(one device sync per search step).  Every draw comes from a search key
of the draw seam (``draws.SearchKey``), in the reference's key
schedule and shapes, so the same draws give the same trees.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..draws import SearchKey
from ..engine import core as engine
from ..engine import fast as engf
from ..obs.profiler import count, span

ValueFn = Callable[[torch.Tensor], torch.Tensor]  # (B,4,4) -> (B,) f32


def _top_k_cells(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` highest of (B, 16) scores' cell indices, int32, as
    ``lax.top_k`` orders them: descending, ties to the lower index (a
    stable sort; ``torch.topk`` does not promise an order for ties)."""
    order = torch.sort(scores, dim=1, descending=True, stable=True).indices
    return order[:, :k].to(torch.int32)


def _spawn_plan(cells: torch.Tensor, width: int, noise: torch.Tensor):
    """Cells (B, 16) -> (pos (B, width) int32, valid (B, width) bool):
    up to ``width`` distinct empty cells, a uniform sample without
    replacement.  Slots past the board's empty count are invalid and
    point at occupied cells."""
    empty = cells == 0
    cnt = empty.sum(dim=1)
    pos = _top_k_cells(torch.where(empty, noise, -1.0), width)
    slot = torch.arange(width, device=cells.device)
    valid = slot[None, :] < cnt.clamp(max=width)[:, None]
    return pos, valid


def _tile_values(u: torch.Tensor) -> torch.Tensor:
    return torch.where(u < 0.9, 1, 2).to(torch.int32)


def _sample_spawns(boards: torch.Tensor, width: int, noise: torch.Tensor,
                   u: torch.Tensor):
    """Up to ``width`` distinct spawns per board from one level's draws.

    Returns (children (B, width, 4, 4), valid (B, width)); an invalid
    slot overwrites an occupied cell, and its child is masked out of
    the node's average."""
    b = boards.shape[0]
    flat = boards.reshape(b, 16)
    pos, valid = _spawn_plan(flat, width, noise)
    val = _tile_values(u).to(boards.dtype)
    children = flat[:, None, :].repeat(1, width, 1)  # (B, width, 16)
    children.scatter_(2, pos.long()[..., None], val[..., None])
    return children.reshape(b, width, 4, 4), valid


def _node_values(base, empty, child_vals, legal, dead, valid,
                 since_empty: int) -> torch.Tensor:
    """One level's values from its children's: the best legal move of
    each chance child (-100 if dead, clipped at 0), averaged over the
    valid children; comfortable boards keep their estimate."""
    b, width = valid.shape
    best = torch.where(legal, child_vals, float("-inf")).amax(dim=0)
    best = torch.where(dead, -100.0, best)
    best = best.clamp(min=0.0).reshape(b, width)
    num = valid.sum(dim=1).clamp(min=1)
    avg = torch.where(valid, best, 0.0).sum(dim=1) / num
    return torch.where(empty >= since_empty, base, avg)


def expectimax_value(
    value_fn: ValueFn,
    boards: torch.Tensor,
    key: SearchKey,
    depth: int,
    width: int,
    since_empty: int,
) -> torch.Tensor:
    """Expectimax value of a batch of AFTERSTATE boards (B, 4, 4),
    expanded with the cells engine."""
    with span("search.value"):
        base = value_fn(boards)
    if depth == 0:
        return base
    b = boards.shape[0]
    with span("search.expand"):
        empty = (boards.reshape(b, 16) == 0).sum(dim=1)
        noise, u, k_rec = key.level(depth, b, width)
        children, valid = _sample_spawns(boards, width, noise, u)
        flat_children = children.reshape(b * width, 4, 4)
        dead = engine.is_terminal(flat_children)
        aft, _, legal = engine.afterstates(flat_children)  # (4, B*W, ...)
    child_vals = expectimax_value(
        value_fn, aft.reshape(4 * b * width, 4, 4), k_rec, depth - 1,
        width, since_empty,
    ).reshape(4, b * width)
    with span("search.backup"):
        return _node_values(base, empty, child_vals, legal, dead, valid,
                            since_empty)


def _sample_spawns_codes(codes: torch.Tensor, width: int,
                         noise: torch.Tensor, u: torch.Tensor):
    """Codes twin of ``_sample_spawns``: the same draws give the same
    positions and values; children are built by code arithmetic.

    An invalid slot ADDS its tile to an occupied cell, which may carry
    into the next nibble (or out of the row's 16 bits); the child is
    masked out of the average all the same, and every reader of codes
    masks nibbles or clamps, as the reference's gathers do."""
    cells = engf.cells_from_codes(codes)  # (B, 16)
    pos, valid = _spawn_plan(cells, width, noise)
    val = _tile_values(u)
    row, col = pos // 4, pos % 4
    add = val << ((3 - col) * 4)  # (B, width)
    rows4 = torch.arange(4, device=codes.device, dtype=torch.int32)
    children = codes[:, None, :] + torch.where(
        rows4[None, None, :] == row[..., None], add[..., None], 0
    )  # (B, width, 4)
    return children, valid


def expectimax_value_codes(
    value_fn: ValueFn,
    codes: torch.Tensor,
    key: SearchKey,
    depth: int,
    width: int,
    since_empty: int,
) -> torch.Tensor:
    """Codes-engine expectimax: the values of ``expectimax_value`` on
    (B, 4) row codes.  Each level resolves all 4 moves of every chance
    child with ``afterstates_nc``; deadness is "no legal move"."""
    with span("search.value"):
        cells = engf.cells_from_codes(codes)
        base = value_fn(cells.reshape(cells.shape[:-1] + (4, 4)))
    if depth == 0:
        return base
    b = codes.shape[0]
    with span("search.expand"):
        empty = (cells == 0).sum(dim=1)
        noise, u, k_rec = key.level(depth, b, width)
        children, valid = _sample_spawns_codes(codes, width, noise, u)
        aft, legal, _t = engf.afterstates_nc(children.reshape(b * width, 4))
        dead = ~legal.any(dim=0)  # == is_terminal(children)
        # up/down come back transposed: turn them back so the recursion
        # and the feature indices see the boards of the cells engine
        aft = torch.stack([aft[0], engf.transpose_codes(aft[1]),
                           aft[2], engf.transpose_codes(aft[3])])
    child_vals = expectimax_value_codes(
        value_fn, aft.reshape(4 * b * width, 4), k_rec, depth - 1, width,
        since_empty,
    ).reshape(4, b * width)
    with span("search.backup"):
        return _node_values(base, empty, child_vals, legal, dead, valid,
                            since_empty)


def make_expectimax_estimator(
    value_fn: ValueFn, depth: int, width: int, since_empty: int,
    max_leaves: int = 2_000_000, engine_mode: str = "codes",
    input_rep: str = "cells",
):
    """Wrap a value function into an expectimax estimator
    ``estimator(roots, key) -> (B,) f32``.

    ``input_rep`` is the roots' form: "cells" (B, 4, 4) boards or
    "codes" (B, 4) row codes.  ``engine_mode`` expands the tree with
    the "codes" or the "cells" engine (cells takes cell roots only).

    The tree of B roots holds B * (4 * width)^depth leaf boards; the
    root batch runs in chunks of at most ``max_leaves`` leaves, padded
    with empty boards to a whole number of chunks, each chunk with its
    own key (``key.chunks``).  ``estimator.chunks`` counts the chunks
    run.
    """
    if engine_mode not in ("codes", "cells"):
        raise ValueError(f"unknown engine_mode: {engine_mode}")
    if input_rep not in ("codes", "cells"):
        raise ValueError(f"unknown input_rep: {input_rep}")
    codes_in = input_rep == "codes"
    if codes_in and engine_mode == "cells":
        raise ValueError("the cells engine cannot take code roots")
    tail = (4,) if codes_in else (4, 4)

    def tree(roots: torch.Tensor, key: SearchKey) -> torch.Tensor:
        if engine_mode == "codes":
            codes = roots if codes_in else engf.codes_from_boards(roots)
            return expectimax_value_codes(value_fn, codes, key, depth,
                                          width, since_empty)
        return expectimax_value(value_fn, roots, key, depth, width,
                                since_empty)

    def estimator(roots: torch.Tensor, key: SearchKey) -> torch.Tensor:
        if depth == 0:
            return _base_value(value_fn, roots, codes_in)
        b = roots.shape[0]
        per_chunk = max(1, max_leaves // (4 * width) ** depth)
        if b <= per_chunk:
            estimator.chunks += 1
            count("search.roots_expanded", b)
            return tree(roots, key)
        chunks = -(-b // per_chunk)
        padded = chunks * per_chunk
        count("search.roots_expanded", padded)
        if padded != b:
            roots = torch.cat([roots, roots.new_zeros((padded - b,) + tail)])
        vals = [tree(roots[i * per_chunk: (i + 1) * per_chunk], k)
                for i, k in enumerate(key.chunks(chunks))]
        estimator.chunks += chunks
        return torch.cat(vals)[:b]

    estimator.chunks = 0
    return estimator


def _base_value(value_fn: ValueFn, roots: torch.Tensor,
                codes_in: bool) -> torch.Tensor:
    if codes_in:
        cells = engf.cells_from_codes(roots)
        return value_fn(cells.reshape(cells.shape[:-1] + (4, 4)))
    return value_fn(roots)


def default_tiers(batch: int) -> tuple:
    """Geometric compaction ladder for a root batch: 64, 256, 1024, ...
    below ``batch``."""
    tiers = []
    t = 64
    while t < batch:
        tiers.append(t)
        t *= 4
    return tuple(tiers)


def make_compacted_estimator(
    value_fn: ValueFn, depth: int, width: int, since_empty: int,
    batch: int, tiers=None, input_rep: str = "cells", **kwargs,
):
    """Root-compacted expectimax: only the roots that the caller marks
    as needing search enter the tree.

    ``estimator(roots, key, need (B,) bool) -> (B,) f32``: the base
    estimate for every root, and for the needy roots the values of
    ``make_expectimax_estimator`` run with ``key`` on the smallest tier
    of ``sizes`` (the ``tiers`` below ``batch``, then ``batch``) that
    holds them, compacted needy-first in index order as
    ``lax.top_k(need, k)`` orders them.  The full batch runs uncompacted.
    A step with no needy root runs no tree: its values are the base
    estimates, as the reference's would be.

    ``estimator.tier_counts`` counts the steps per tier (0 for no
    tree); ``estimator.tree`` is the inner estimator, whose ``chunks``
    counts its chunks.
    """
    codes_in = input_rep == "codes"

    if depth == 0:
        def est0(roots, key, need):
            del key, need
            return _base_value(value_fn, roots, codes_in)

        return est0

    est = make_expectimax_estimator(value_fn, depth, width, since_empty,
                                    input_rep=input_rep, **kwargs)
    if tiers is None:
        tiers = default_tiers(batch)
    sizes = sorted({t for t in tiers if t < batch}) + [batch]

    def estimator(roots: torch.Tensor, key: SearchKey,
                  need: torch.Tensor) -> torch.Tensor:
        with span("search.base"):
            base = _base_value(value_fn, roots, codes_in)
        with span("search.need_read"):
            c = int(need.sum())  # the host's one read of the step
            count("host_reads")
        count("search.roots_needy", c)
        if c == 0:
            estimator.tier_counts[0] += 1
            return base
        k = next(s for s in sizes if c <= s)
        estimator.tier_counts[k] += 1
        if k == batch:
            with span("search.tree"):
                tv = est(roots, key)
            return torch.where(need, tv, base)
        with span("search.compact"):
            idx = _top_k_rows(need, k)
            sub = roots[idx]
        with span("search.tree"):
            tv = est(sub, key)
        out = base.clone()
        out[idx] = torch.where(need[idx], tv, base[idx])
        return out

    estimator.tier_counts = dict.fromkeys([0] + sizes, 0)
    estimator.tree = est
    return estimator


def _top_k_rows(need: torch.Tensor, k: int) -> torch.Tensor:
    """``lax.top_k(need.astype(int32), k)``'s indices: the needy rows
    first, each group in index order."""
    order = torch.sort(need.to(torch.int32), descending=True,
                       stable=True).indices
    return order[:k]
