"""Sampled expectimax in plain PyTorch, on the same draws as the
program's search.

A move's value is the expectimax value of its afterstate (the
reference's ``look_forward`` with depth, width and ``since_empty``):

* at depth 0, and for a board with at least ``since_empty`` empty
  cells, the table's value of the board;
* else a chance node: up to ``width`` distinct empty cells, those with
  the largest of 16 noise draws (ties to the lower cell), each taking a
  2 or a 4 by a uniform draw (``< 0.9``: a 2).  Each such child's value
  is its best legal afterstate's value one level down, -100 where it
  has no legal move, and at least 0; the node takes the mean over its
  valid children.

Which draws a node takes follows the program's key schedule: a level
of ``b`` boards draws (b, 16) noise and (b, width) tile uniforms from
its key, row i for board i, and hands a key of its own to the level
below, whose boards are the (4 moves, b boards, width children)
afterstates in that order.  A step's roots are its games' four
afterstates, move-major; the roots that need the tree (a legal move of
a live game, fewer than ``since_empty`` empty cells) are searched in
tiers of 64, 256, 1024, ... roots below the whole batch, needy roots
first, in chunks of at most ``max_leaves`` leaves padded with empty
boards, each chunk with a key of its own once there is more than one.

Values: the whole tuples' entries rounded to bf16 and the larger
tuples' in float32, at the dense table's identity indices (``lower``
rounds them further, for the control).
"""

from __future__ import annotations

import torch

from . import features, game

MAX_LEAVES = 2_000_000


def table_value(ts, w: torch.Tensor, boards: torch.Tensor,
                lower: bool = False) -> torch.Tensor:
    """(B, 16) boards -> (B,) f32 values of a dense table: the whole
    tuples in bf16 (fp8 e4m3 when ``lower``), the others in f32 (bf16
    when ``lower``), each part summed in the tuples' order."""
    out = torch.zeros(boards.shape[0], dtype=torch.float32,
                      device=boards.device)
    parts = []
    for feats, (hi, lo) in ((ts.whole, (torch.bfloat16, torch.float8_e4m3fn)),
                            (ts.canon, (torch.float32, torch.bfloat16))):
        if not feats:
            continue
        v = w[features.indices(ts, boards, feats)]
        v = v.to(lo if lower else hi).float()
        acc = torch.zeros_like(out)
        for j in range(v.shape[1]):
            acc = acc + v[:, j]
        parts.append(acc)
    for p in parts:
        out = out + p
    return out


def _children(boards, width, noise, u):
    b = boards.shape[0]
    empty = boards == 0
    cnt = empty.sum(dim=1)
    scores = torch.where(empty, noise, -1.0)
    pos = torch.sort(scores, dim=1, descending=True, stable=True
                     ).indices[:, :width]
    valid = torch.arange(width, device=boards.device)[None, :] < \
        cnt.clamp(max=width)[:, None]
    val = torch.where(u < 0.9, 1, 2).to(boards.dtype)
    kids = boards[:, None, :].repeat(1, width, 1)
    kids.scatter_(2, pos[..., None], val[..., None])
    return kids.reshape(b * width, 16), valid


def value(ts, w, boards, src, path, depth, width, since_empty,
          lower=False) -> torch.Tensor:
    base = table_value(ts, w, boards, lower)
    if depth == 0:
        return base
    b = boards.shape[0]
    empty = game.empties(boards)
    noise, u = src.level(path + ("level", depth), b, width)
    kids, valid = _children(boards, width, noise, u)
    aft, _, legal = game.afterstates(kids)  # (4, b * width, 16)
    dead = ~legal.any(dim=0)
    vals = value(ts, w, aft.reshape(-1, 16), src, path + ("below", depth),
                 depth - 1, width, since_empty, lower).reshape(4, b * width)
    best = torch.where(legal, vals, float("-inf")).amax(dim=0)
    best = torch.where(dead, -100.0, best).clamp(min=0.0).reshape(b, width)
    avg = torch.where(valid, best, 0.0).sum(dim=1) / \
        valid.sum(dim=1).clamp(min=1)
    return torch.where(empty >= since_empty, base, avg)


def tiers(batch: int) -> list:
    sizes, t = [], 64
    while t < batch:
        sizes.append(t)
        t *= 4
    return sizes + [batch]


def root_values(ts, w, roots, need, src, path, depth, width, since_empty,
                lower=False) -> torch.Tensor:
    """(R, 16) roots, (R,) need -> (R,) values, the tree's for the needy
    roots and the table's for the rest."""
    base = table_value(ts, w, roots, lower)
    c = int(need.sum())
    if c == 0:
        return base
    r = roots.shape[0]
    k = next(s for s in tiers(r) if c <= s)
    if k == r:
        order = torch.arange(r, device=roots.device)
    else:
        order = torch.sort(need.to(torch.int32), descending=True,
                           stable=True).indices[:k]
    sub = roots[order]
    per = max(1, MAX_LEAVES // (4 * width) ** depth)
    if k <= per:
        tv = value(ts, w, sub, src, path, depth, width, since_empty, lower)
    else:
        chunks = -(-k // per)
        pad = chunks * per - k
        sub = torch.cat([sub, sub.new_zeros((pad, 16))])
        tv = torch.cat([
            value(ts, w, sub[i * per: (i + 1) * per], src,
                  path + ("chunk", i), depth, width, since_empty, lower)
            for i in range(chunks)])[:k]
    out = base.clone()
    out[order] = torch.where(need[order], tv, base[order])
    return out
