"""The TD(0) n-tuple learner with temporal-coherence rates, in plain
PyTorch: N games played in lockstep, each move greedy on the table,
each previous afterstate updated toward the reward plus the value of
the next one.

One step, for every game (the configuration's recipe: "tc" optimiser
with alpha 1, "mean" updates, the 8-image symmetry, a bf16 actor):

1. The four afterstates, their scores and legality.
2. Selection: each afterstate's value with the whole tuples' entries
   rounded to bf16, the canonical tuples' entries in float32, summed in
   float32 in the tuples' order.  The first of the best legal moves.
3. The bootstrap: the chosen afterstate's value in float32.  The TD
   error is ``score + V(chosen) - V(previous)``, or ``-V(previous)``
   where no move is legal (the game ends).
4. The update of the previous afterstate, with ``delta = td / F`` (F
   tuples): every whole tuple's entry on each of the board's eight
   images, and every canonical tuple's canonical entry, takes delta.
   An entry's step is the mean of the deltas it took (``dbar``).  Its
   rate is ``|E| / A`` (1 while A is 0); ``w += alpha * rate * dbar``,
   ``E += dbar``.  A whole tuple's entry takes ``A += |dbar|``; a
   canonical entry takes the absolute value of each row's share,
   ``A += sum_i |delta_i / hits|``, as the reference's sparse scatter
   adds them one by one.
5. The move, a spawn, and a fresh board for every game that ended.

The tables can be held in a lower precision (``dtype``): that is the
control that the benchmark's check has to refuse.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import features, game


class State(NamedTuple):
    w: torch.Tensor
    e: torch.Tensor
    a: torch.Tensor
    boards: torch.Tensor  # (N, 16) int64
    score: torch.Tensor  # (N,) int64
    odo: torch.Tensor  # (N,) int64
    prev: torch.Tensor  # (N, 16) previous afterstate
    prev_value: torch.Tensor  # (N,) f32
    prev_valid: torch.Tensor  # (N,) bool


def start(init_w: torch.Tensor, boards: torch.Tensor,
          dtype=torch.float32) -> State:
    n = boards.shape[0]
    dev = boards.device
    w = init_w.to(dtype).clone()
    return State(w=w, e=torch.zeros_like(w), a=torch.zeros_like(w),
                 boards=boards.long(),
                 score=torch.zeros(n, dtype=torch.int64, device=dev),
                 odo=torch.zeros(n, dtype=torch.int64, device=dev),
                 prev=torch.zeros_like(boards.long()),
                 prev_value=torch.zeros(n, dtype=torch.float32, device=dev),
                 prev_valid=torch.zeros(n, dtype=torch.bool, device=dev))


def _ordered_sum(cols: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros(cols.shape[0], dtype=torch.float32, device=cols.device)
    for j in range(cols.shape[1]):
        acc = acc + cols[:, j]
    return acc


def _values(ts, w, boards, bf16_whole: bool):
    """(whole part, canonical part) of the boards' values, f32."""
    whole = w[features.indices(ts, boards, ts.whole)].float()
    if bf16_whole:
        whole = whole.to(torch.bfloat16).float()
    canon = w[features.canonical_indices(ts, boards)].float()
    return _ordered_sum(whole), _ordered_sum(canon)


def _apply(st: State, idx: torch.Tensor, d: torch.Tensor, alpha: float,
           abs_terms: bool) -> None:
    """The mean and the TC rule over the (rows, k) entries ``idx``, each
    row's term ``d``.  ``abs_terms``: A takes each term's |term / hits|
    (the canonical tuples' sparse rule), else the entry's |dbar|."""
    vals = d[:, None].expand(idx.shape).reshape(-1)
    uniq, inv = torch.unique(idx.reshape(-1), return_inverse=True)
    hits = torch.bincount(inv, minlength=uniq.shape[0]).float()
    terms = vals / hits[inv]
    dbar = torch.zeros_like(hits).index_add_(0, inv, terms)
    if abs_terms:
        dabs = torch.zeros_like(hits).index_add_(0, inv, terms.abs())
    else:
        dabs = dbar.abs()
    e, a = st.e[uniq].float(), st.a[uniq].float()
    rate = torch.where(a > 0, e.abs() / a.clamp(min=1e-30), 1.0)
    st.w[uniq] = (st.w[uniq].float() + alpha * rate * dbar).to(st.w.dtype)
    st.e[uniq] = (e + dbar).to(st.e.dtype)
    st.a[uniq] = (a + dabs).to(st.a.dtype)


def _update(ts, st: State, delta: torch.Tensor, alpha: float) -> None:
    rows = st.prev[st.prev_valid]
    d = delta[st.prev_valid]
    _apply(st, features.image_indices(ts, rows).reshape(rows.shape[0], -1),
           d, alpha, abs_terms=False)
    if ts.canon:
        _apply(st, features.canonical_indices(ts, rows), d, alpha,
               abs_terms=True)


def step(ts, st: State, spawn_draws, reset_draws, moves=None,
         alpha: float = 1.0):
    """One lockstep step: (state, gap, chosen).  ``moves`` (N,) are the
    moves to follow (-1: choose by the table); ``gap`` (N,) is how far
    below the best legal value the followed move's value lies, as a
    share of the best's size (0 where the table chose; inf for an
    illegal move); ``chosen`` the moves made (-1 where the game ended).
    """
    n = st.boards.shape[0]
    ar = torch.arange(n, device=st.boards.device)
    aft, sc, legal = game.afterstates(st.boards)
    flat = aft.reshape(4 * n, 16)
    mxu, gth = _values(ts, st.w, flat, bf16_whole=True)
    masked = torch.where(legal, (mxu + gth).reshape(4, n), float("-inf"))
    best = masked.argmax(dim=0)
    done = ~legal.any(dim=0)
    gap = torch.zeros(n, dtype=torch.float32, device=st.boards.device)
    if moves is not None:
        follow = (moves >= 0) & ~done
        m = moves.clamp(min=0).long()
        top = masked.max(dim=0).values
        got = masked[m, ar]
        size = top.abs().clamp(min=float(top[~done].abs().median())
                               if bool((~done).any()) else 1.0)
        gap = torch.where(follow, (top - got) / size, 0.0)
        best = torch.where(follow, m, best)
    chosen = aft[best, ar]
    exact, _ = _values(ts, st.w, chosen, bf16_whole=False)
    best_val = exact + gth.reshape(4, n)[best, ar]
    gain = sc[best, ar]
    td = torch.where(done, -st.prev_value,
                     gain.float() + best_val - st.prev_value)
    delta = torch.where(st.prev_valid, td, 0.0) / float(len(ts.cells))
    if bool(st.prev_valid.any()):
        _update(ts, st, delta, alpha)
    moved = torch.where(done[:, None], st.boards, chosen)
    spawned, _, _ = game.spawn(moved, *spawn_draws)
    boards = torch.where(done[:, None], st.boards, spawned)
    fresh = game.fresh(*reset_draws)
    out = st._replace(
        boards=torch.where(done[:, None], fresh, boards),
        score=torch.where(done, 0, st.score + gain),
        odo=torch.where(done, 0, st.odo + 1),
        prev=torch.where(done[:, None], st.prev, chosen),
        prev_value=torch.where(done, 0.0, best_val),
        prev_valid=~done)
    return out, gap, torch.where(done, -1, best)
