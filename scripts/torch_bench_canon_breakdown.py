#!/usr/bin/env python3
"""The canonical-index train step's pieces, one by one, on the card (the
twin of ``scripts/bench_canon_breakdown.py``).

Times each piece of the ``sym_impl="canonical"`` TD step in isolation:
the engine's expansion, the canonical orbit indices, the evaluator in
three modes, the class gradients, the class chain (gradients, D4
fold, TC block update), the sparse gather-class TC update and the
sorted-dedup form of it, then the ``scan:`` rows, the staged recorder
merge per step, one train step, and the per-step cost over a segment.

  * Plain rows: ms per call, ``REPS`` calls between two
    synchronisations after one untimed call.
  * ``scan:`` rows: a body run ``SCAN_ITERS`` times in a Python loop
    between two synchronisations (JAX's ``lax.scan`` has no eager twin),
    three times after one untimed run, divided by ``SCAN_ITERS``.
  * Beside each row a comment line of its launches and device µs per
    call (per iteration for a ``scan:`` row, per step for the last
    two), read with ``torch.profiler`` over one more run (not measured
    on the CPU).

The evaluator's "pallas" is the port's kernel mode (``eval_class`` on
the card, its plain version on CPU tensors); a mode that raises is
reported as skipped, as the reference reports it.  ``class chain FUSED
fold`` runs the chain through ``kernels.fold_class``, the fold the
train step takes on the card (the reference's repacked fold kernel is a
TPU layout the port does not have); the unfused rows fold with the
plain ``symmetrize_class_sum``.  So on the card this script launches
``eval_class``, ``grad_class`` and ``fold_class``.  The TC updates run
in place on their own copies of the tables (XLA updates a scan's carry
in place too); ``torch.sort(stable=True)`` stands in for ``lax.sort``,
``cummax``/``cummin`` of the flipped array for ``lax.cummax``/``cummin``,
and ``index_add_`` for ``.at[].add``.  The reference keeps the actor's
values live with ``w + masked.sum() * 0``; eager PyTorch computes
every output it is asked for, so the twin leaves that add out.

Usage:
  python3 scripts/torch_bench_canon_breakdown.py [n] [num_envs] [--device D]

n defaults to 5 and num_envs to 8192; ``--device`` to the CUDA card
(without one the run raises).  The first line is the card's name and
power limit.  Imports no jax.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import torch_bench  # noqa: E402
from tpu2048_torch.agent import td  # noqa: E402
from tpu2048_torch.config import AgentConfig, TrainConfig  # noqa: E402
from tpu2048_torch.draws import TorchDraws  # noqa: E402
from tpu2048_torch.engine import fast as engf  # noqa: E402
from tpu2048_torch.features import canonical as canon  # noqa: E402
from tpu2048_torch.features import ntuple  # noqa: E402
from tpu2048_torch.features.symmetry import symmetrize_class_sum  # noqa: E402
from tpu2048_torch.ops import dispatch, kernels  # noqa: E402

REPS = 10
SCAN_ITERS = 64
SCAN_REPS = 3
STEP_REPS = 10
SEGMENT_REPS = 3
MERGE_REPS = 5
# the reference stacks the three tables into one scatter up to here
STACK_MAX = 32_000_000
EVAL_MODES = (("pallas", True), ("pallas", False), ("gather", True))


def tc_update(w, e, a, alpha, start: int, dbar):
    """The TC rule on the block of ``w``, ``e``, ``a`` that starts at
    ``start`` and is ``dbar`` long, in place: the rate from ``e`` and
    ``a`` before they take ``dbar``.  Returns (w, e, a)."""
    blk = slice(start, start + dbar.numel())
    w_blk, e_blk, a_blk = w[blk], e[blk], a[blk]
    lr = torch.where(a_blk > 0, e_blk.abs() / a_blk.clamp(min=1e-30), 1.0)
    w_blk.add_(alpha * lr * dbar)
    e_blk.add_(dbar)
    a_blk.add_(dbar.abs())
    return w, e, a


def _class_chain(ts, classes, grads, fold, w, e, a, alpha, i, d, v):
    """Class gradients, ``fold`` of each class's (2, g, h * l) pair,
    then the TC rule on the class's block, in place."""
    for c, pair in zip(classes.matmul, grads(i, d, v)):
        size1 = c.h * c.l
        pair = fold(ts, c.feat0, c.g, pair.view(2, c.g, size1))
        nsz = c.g * size1
        dbar = pair[0].reshape(nsz) / pair[1].reshape(nsz).clamp(min=1.0)
        tc_update(w, e, a, alpha, c.start, dbar)
    return w, e, a


def blocks_fold_tc(ts, classes, grads, w, e, a, alpha, i, d, v):
    """The class chain with the plain fold (``symmetrize_class_sum``)."""
    return _class_chain(ts, classes, grads, symmetrize_class_sum, w, e, a,
                        alpha, i, d, v)


def blocks_fused_tc(ts, classes, grads, w, e, a, alpha, i, d, v):
    """The class chain through ``kernels.fold_class`` (the card's kernel,
    its plain version on CPU tensors)."""
    return _class_chain(ts, classes, grads, kernels.fold_class, w, e, a,
                        alpha, i, d, v)


def sparse_tc(w, e, a, alpha, ci, d, v):
    """The gather classes' sparse TC update, in place: hits, the
    collision mean, the rate's gathers and three scatters."""
    flat = ci.reshape(-1).long()
    per = d[:, None].expand(ci.shape)
    per = torch.where(v[:, None], per, 0.0)
    contrib = v[:, None].expand(ci.shape).to(torch.float32)
    hits = torch.zeros_like(w).index_add_(0, flat, contrib.reshape(-1))
    per = per / hits[flat].view(ci.shape).clamp(min=1.0)
    e_g, a_g = e[flat].view(ci.shape), a[flat].view(ci.shape)
    lr = torch.where(a_g > 0, e_g.abs() / a_g.clamp(min=1e-30), 1.0)
    w.index_add_(0, flat, (alpha * lr * per).reshape(-1))
    e.index_add_(0, flat, per.reshape(-1))
    a.index_add_(0, flat, per.abs().reshape(-1))
    return w, e, a


def _entry_reduce(keys, vals, drop_key: int):
    """Sort (key, value) pairs by key and reduce each key's run: (the
    run's key at its first position and ``drop_key`` elsewhere or for a
    key at or above it, the run's value sum and sum of |value| and its
    length at every position, the sorted keys)."""
    m = keys.shape[0]
    ks, order = torch.sort(keys, stable=True)
    vs = vals[order]
    ar = torch.arange(m, dtype=torch.int32, device=keys.device)
    neq = ks[1:] != ks[:-1]
    one = torch.ones(1, dtype=torch.bool, device=keys.device)
    is_first = torch.cat([one, neq])
    is_last = torch.cat([neq, one])
    first_pos = torch.where(is_first, ar, -1).cummax(dim=0).values
    last_pos = torch.where(is_last, ar, m).flip(0).cummin(dim=0).values.flip(0)
    cs = vs.cumsum(dim=0)
    ca = vs.abs().cumsum(dim=0)
    prev = torch.where(first_pos > 0, first_pos - 1, 0).long()
    last = last_pos.long()
    seg_sum = cs[last] - torch.where(first_pos > 0, cs[prev], 0.0)
    seg_abs = ca[last] - torch.where(first_pos > 0, ca[prev], 0.0)
    count = (last_pos - first_pos + 1).to(torch.float32)
    tgt = torch.where(is_first & (ks < drop_key), ks, drop_key)
    return tgt, seg_sum, seg_abs, count, ks


def dedup_tc(total: int, w, e, a, alpha, ci, d, v):
    """The sparse TC update with each entry's terms reduced first
    (``_entry_reduce``) and one scatter per table to unique indices
    (one stacked scatter into a new (3, total) copy while the table has
    at most ``STACK_MAX`` entries, else in place).  Returns (w, e, a)."""
    per = d[:, None].expand(ci.shape)
    keys = torch.where(v[:, None], ci, total).reshape(-1)
    tgt, seg_sum, seg_abs, cnt, ks = _entry_reduce(keys, per.reshape(-1),
                                                   total)
    add = seg_sum / cnt
    add_abs = seg_abs / cnt
    # a dropped key reads the last entry, as JAX's clamped gather does
    at = ks.clamp(max=total - 1).long()
    e_g, a_g = e[at], a[at]
    lr = torch.where(a_g > 0, e_g.abs() / a_g.clamp(min=1e-30), 1.0)
    # mode="drop": a dropped position adds 0 to entry 0
    keep = tgt < total
    tgt = torch.where(keep, tgt, 0).long()
    upd = [torch.where(keep, u, 0.0) for u in (alpha * lr * add, add,
                                                add_abs)]
    if total <= STACK_MAX:
        wea = torch.stack([w, e, a])
        wea.index_add_(1, tgt, torch.stack(upd))
        return wea[0], wea[1], wea[2]
    for table, u in zip((w, e, a), upd):
        table.index_add_(0, tgt, u)
    return w, e, a


def actor(ev, w, cd):
    """The actor's move: every afterstate valued by ``ev`` (directions 1
    and 3 transposed back), the best legal one taken and turned back;
    a board with no legal move stays.  Returns the new codes."""
    aft, _delta, legal, _t = engf.afterstates_full(cd)
    vals = ev(w, torch_bench.afterstate_cells(aft))
    masked = torch.where(legal, vals, float("-inf"))
    bd = masked.argmax(dim=0).to(torch.int32)
    ar = torch.arange(cd.shape[0], device=cd.device)
    nc = engf.canonicalize_chosen(aft[bd.long(), ar], bd)
    return torch.where(legal.any(dim=0)[:, None], nc, cd)


def staged_rows(k: int, envs: int, device) -> td.RecStep:
    """``k`` stacked recorder rows of ``envs`` envs: each step writes
    its own column, an eighth of the envs finish at step k // 2."""
    col = torch.arange(k, dtype=torch.int32, device=device)[:, None]
    done = torch.zeros((k, envs), dtype=torch.bool, device=device)
    done[k // 2, : envs // 8] = True
    return td.RecStep(
        mv=torch.zeros((k, envs), dtype=torch.int8, device=device),
        sp=torch.zeros((k, envs), dtype=torch.int8, device=device),
        wslot=col.expand(k, envs).contiguous(),
        done=done,
        cand=torch.full((k, envs), -1, dtype=torch.int32, device=device),
        odo=col.expand(k, envs).contiguous(),
        sb=torch.zeros((k, envs, 16), dtype=torch.int8, device=device),
    )


def empty_recorder(envs: int, s_max: int, device) -> td.Recorder:
    """A recorder of ``envs`` logs of ``s_max`` steps (and the spill
    column), all zero."""
    def z(*shape, dtype=torch.int8):
        return torch.zeros(shape, dtype=dtype, device=device)
    return td.Recorder(
        moves=z(envs, s_max + 1), spawns=z(envs, s_max + 1),
        starts=z(envs, 4, 4), overflow=z(envs, dtype=torch.bool),
        best_moves=z(s_max), best_spawns=z(s_max), best_start=z(4, 4),
        best_len=z(dtype=torch.int32), best_score=z(dtype=torch.int32))


class Rows:
    """Prints each row's line and its cost line on ``device``."""

    def __init__(self, device):
        self.device = device

    def cost(self, label: str, fn, calls: int = 1, per: str = "call"):
        print(torch_bench.cost_line(label, torch_bench.device_cost(
            fn, self.device, calls), per=per), flush=True)

    def plain(self, label: str, fn, *args, reps: int = REPS) -> float:
        """``label`` padded as the reference pads it, then ms per call."""
        dt = torch_bench.timeit(fn, *args, device=self.device, reps=reps)
        print(f"{label + ':':28s}{dt*1e3:8.2f} ms", flush=True)
        self.cost(label, lambda: fn(*args))
        return dt

    def scanned(self, label: str, body, carry, width: int = 28) -> float:
        """``body`` run SCAN_ITERS times from ``carry`` per call: ms per
        iteration."""
        def f(c):
            for _ in range(SCAN_ITERS):
                c = body(c)
            return c
        dt = torch_bench.timeit(f, carry, device=self.device,
                                reps=SCAN_REPS) / SCAN_ITERS
        print(f"{label + ':':{width}s}{dt*1e3:8.2f} ms", flush=True)
        self.cost(label, lambda: f(carry), calls=SCAN_ITERS, per="iteration")
        return dt


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("n", type=int, nargs="?", default=5)
    p.add_argument("num_envs", type=int, nargs="?", default=8192)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    device = torch_bench.start(args.device, "bench_canon_breakdown")
    n, envs = args.n, args.num_envs
    ts = ntuple.get_tuple_set(n)
    weights = ntuple.init_weights(ts, torch_bench.seeded_generator(device, 0))
    acfg = AgentConfig(n=n, sym_impl="canonical")
    tcfg = TrainConfig(num_envs=envs, steps_per_call=64)
    print(f"device={device} n={n} envs={envs}", flush=True)
    rows = Rows(device)

    codes = torch_bench.rolled_codes(envs, TorchDraws(
        torch_bench.seeded_generator(device, 0)))
    cells = engf.cells_from_codes(codes).to(torch.int8)
    cells4 = cells[None].expand((4,) + cells.shape).reshape(4 * envs, 16)
    dw = torch.randn(envs, generator=torch_bench.seeded_generator(device, 1),
                     device=device) * 1e-3
    valid = torch.ones(envs, dtype=torch.bool, device=device)

    # (a) engine expansion only
    rows.plain("afterstates_full", engf.afterstates_full, codes)

    # (b) canonical orbit indices, actor batch (4N) and prev batch (N)
    def f4(c):
        return canon.canonical_gather_indices(ts, c)
    rows.plain("canon idx (4N boards)", f4, cells4)
    rows.plain("canon idx (N boards)", f4, cells)

    # (c) evaluator variants on the 4N actor batch
    for mode, canonical in EVAL_MODES:
        label = f"eval[{mode} canon={int(canonical)}] 4N"
        try:
            ev = dispatch.make_evaluator(ts, mode, canonical=canonical)
            dt = torch_bench.timeit(lambda w, c, _ev=ev: _ev(w, c).sum(),
                                    weights, cells4, device=device, reps=REPS)
        except Exception as e:  # reported as the reference reports it
            print(f"eval[{mode} canon={canonical}]: skipped "
                  f"({type(e).__name__})", flush=True)
            continue
        print(f"{label}: {dt*1e3:8.2f} ms", flush=True)
        rows.cost(label, lambda _ev=ev: _ev(weights, cells4).sum())

    # (d) class grads + class fold + block TC
    classes, grads = dispatch.make_class_grads(ts, "auto")
    idx = ntuple.feature_indices(ts, cells)

    def blocks_only(i, d, v):
        return grads(i, d, v)[0][0].sum()

    rows.plain("class grads (pallas)", blocks_only, idx, dw, valid)
    z = torch.zeros_like(weights)
    alpha = torch.tensor(1.0, device=device)

    def fresh():
        """Own copies of the tables for an in-place TC row."""
        return weights.clone(), z.clone(), z.clone()

    rows.plain("class grads+fold+TC blocks",
               lambda t: blocks_fold_tc(ts, classes, grads, *t, alpha, idx,
                                        dw, valid), fresh())

    # (e) sparse gather-class TC (hits + lr gathers + 3 scatters)
    cidx, _mult = f4(cells)
    if cidx.shape[1]:
        rows.plain("sparse gather-class TC",
                   lambda t: sparse_tc(*t, alpha, cidx, dw, valid), fresh())
        # (e3) the sorted-dedup chain of round 4, kept as the
        # measurement that decided against it on the TPU
        rows.plain("sorted-dedup TC (r4)",
                   lambda t: dedup_tc(ts.total, *t, alpha, cidx, dw, valid),
                   fresh())

    # (e2) per-piece costs inside a loop of SCAN_ITERS bodies
    ev_p = dispatch.make_evaluator(ts, "auto", canonical=True)
    rows.scanned("scan: engine expand", torch_bench.first_move, codes)
    rows.scanned("scan: actor (exp+eval+sel)",
                 lambda cd: actor(ev_p, weights, cd), codes)
    rows.scanned("scan: class grads+fold+TC",
                 lambda t: blocks_fold_tc(ts, classes, grads, *t, alpha, idx,
                                          dw, valid), fresh())
    rows.scanned("scan: class chain FUSED fold",
                  lambda t: blocks_fused_tc(ts, classes, grads, *t, alpha,
                                            idx, dw, valid), fresh(),
                  width=30)
    if cidx.shape[1]:
        rows.scanned("scan: sparse gather-TC",
                     lambda t: sparse_tc(*t, alpha, cidx, dw, valid), fresh())
        rows.scanned("scan: sorted-dedup TC (r4)",
                     lambda t: dedup_tc(ts.total, *t, alpha, cidx, dw,
                                        valid), fresh())
        rows.scanned("scan: canon idx (N)",
                     lambda c: c + f4(cells)[0].sum() * 0,
                     torch.zeros((), dtype=torch.int32, device=device))

    # (e4) staged recorder merge, amortized per step: the once-per-
    # segment fold of K stacked RecStep rows into the (R, S) logs
    k, s_max = tcfg.steps_per_call, tcfg.max_record_steps
    recs = staged_rows(k, envs, device)
    rec0 = empty_recorder(envs, s_max, device)

    def merge(r, s, rs):
        return td._merge_staged_recorder(r, s, rs, s_max)

    dt = torch_bench.timeit(merge, rec0, rec0.starts, recs, device=device,
                            reps=MERGE_REPS)
    print(f"staged merge (per step):    {dt/k*1e3:8.2f} ms", flush=True)
    rows.cost("staged merge (per step)",
              lambda: merge(rec0, rec0.starts, recs), calls=k, per="step")

    # (f) one full train step, the reference's unstaged one
    draws = TorchDraws(torch_bench.seeded_generator(device, 0))
    st = td.init_td_state(ts, acfg, tcfg, draws, device)
    step = td.make_train_step(ts, acfg, tcfg, draws, staged=False)
    dt = torch_bench.time_reps(step, st, STEP_REPS, device) / STEP_REPS
    print(f"full train step (1x):       {dt*1e3:8.2f} ms", flush=True)
    rows.cost("full train step (1x)", lambda: step(st), per="step")

    # (g) the per-step cost over a segment (the real number)
    st = td.init_td_state(ts, acfg, tcfg, draws, device)
    seg = td.make_train_segment(ts, acfg, tcfg, draws)
    st = seg(st)
    torch_bench.sync(device)
    t0 = time.time()
    for _ in range(SEGMENT_REPS):
        st = seg(st)
    torch_bench.sync(device)
    dt = (time.time() - t0) / SEGMENT_REPS / k
    print(f"scan-amortized step:        {dt*1e3:8.2f} ms "
          f"({envs/dt/1e3:.0f}k env-steps/s)", flush=True)
    rows.cost("scan-amortized step", lambda: seg(st), calls=k, per="step")


if __name__ == "__main__":
    main()
