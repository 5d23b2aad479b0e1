#!/usr/bin/env python3
"""Where the TD train step's time goes, piece by piece, on the card (the
twin of ``scripts/bench_train_breakdown.py``).

Times the step's components in isolation for one geometry: a dense
pass over the table (its GB/s), the actor's afterstate expansion and
evaluation, the identity accumulate, the D4 fold (``symmetrize_sum``),
the dense TC update, the explicit 8-image accumulate and the
gather-class share of the accumulate.  Under "auto" on the card the
actor takes the ``eval_class`` kernel and both accumulates take
``grad_class``.  Each row gives ms per call (``REPS`` calls between two
synchronisations, after one untimed call), as the reference does,
then a comment line of its launches and device µs per call, read with
``torch.profiler`` over one more call (not measured on the CPU).  The
reference's ``.at[].add(mode="drop")`` is ``index_add_`` here (every
index is in range).

Usage:
  python3 scripts/torch_bench_train_breakdown.py [n] [num_envs] [--device D]

n defaults to 6 and num_envs to 8192; ``--device`` to the CUDA card
(without one the run raises).  The first line is the card's name and
power limit.  Imports no jax.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import torch_bench  # noqa: E402
from tpu2048_torch.draws import TorchDraws  # noqa: E402
from tpu2048_torch.engine import fast as engf  # noqa: E402
from tpu2048_torch.features import ntuple  # noqa: E402
from tpu2048_torch.features.symmetry import symmetrize_sum  # noqa: E402
from tpu2048_torch.ops import dispatch  # noqa: E402
from tpu2048_torch.ops import onehot as oh  # noqa: E402

REPS = 5


def make_actor(ev):
    """The actor side: all four afterstates (directions 1 and 3
    transposed back) valued by ``ev``."""
    def actor(w, cd):
        aft, delta, _legal, _t = engf.afterstates_full(cd)
        return ev(w, torch_bench.afterstate_cells(aft)).sum() + delta.sum()
    return actor


def tc_update(w, e, a, dsum, hits):
    """The dense TC update: rate, apply, accumulator update."""
    dbar = dsum / hits.clamp(min=1.0)
    lr = torch.where(a > 0.0, e.abs() / a.clamp(min=1e-30), 1.0)
    return w + lr * dbar, e + dbar, a + dbar.abs()


def make_acc_gather_only(gf: torch.Tensor):
    """The accumulate's scatter into the gather classes only."""
    def acc_gather_only(w, i, d, v):
        gi = i[:, gf].reshape(-1).long()
        upd = d[:, None].expand(-1, gf.shape[0]).reshape(-1)
        cv = v[:, None].expand(-1, gf.shape[0]).to(torch.float32).reshape(-1)
        zz = torch.zeros_like(w)
        return (zz.index_add(0, gi, upd), zz.index_add(0, gi, cv))
    return acc_gather_only


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("n", type=int, nargs="?", default=6)
    p.add_argument("num_envs", type=int, nargs="?", default=8192)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    device = torch_bench.start(args.device, "bench_train_breakdown")
    n, envs = args.n, args.num_envs
    ts = ntuple.get_tuple_set(n)
    weights = ntuple.init_weights(ts, torch_bench.seeded_generator(device, 0))
    print(f"device={device} n={n} envs={envs} "
          f"table={ts.total/1e6:.1f}M entries", flush=True)

    # mid-game-ish boards, as in the reference
    codes = torch_bench.rolled_codes(envs, TorchDraws(
        torch_bench.seeded_generator(device, 0)))
    boards = engf.cells_from_codes(codes).to(torch.int8)
    idx1 = ntuple.feature_indices(ts, boards)  # (N, F)
    dw = torch.randn(envs, generator=torch_bench.seeded_generator(device, 1),
                     device=device) * 1e-3
    valid = torch.ones(envs, dtype=torch.bool, device=device)

    def row(label, fn, *a):
        dt = torch_bench.timeit(fn, *a, device=device, reps=REPS)
        print(f"{label} {dt*1e3:8.2f} ms", flush=True)
        cost = torch_bench.device_cost(lambda: fn(*a), device)
        print(torch_bench.cost_line(label.rstrip(": "), cost), flush=True)
        return dt

    # (0) achievable dense-pass rate on this table size (roofline)
    def f_axpy(a, b):
        return a + 0.5 * b
    dt = torch_bench.timeit(f_axpy, weights, weights, device=device,
                            reps=REPS)
    gb = weights.numel() * weights.element_size() * 3 / 1e9
    print(f"dense axpy (1 pass, {gb:.2f} GB): {dt*1e3:8.2f} ms "
          f"({gb/dt:6.1f} GB/s)", flush=True)
    print(torch_bench.cost_line(
        f"dense axpy (1 pass, {gb:.2f} GB)",
        torch_bench.device_cost(lambda: f_axpy(weights, weights), device)),
        flush=True)

    # (a) full 4-afterstate expansion + evaluation (the actor side)
    actor = make_actor(dispatch.make_evaluator(ts, "auto"))
    row("actor (expand+eval x4):     ", actor, weights, codes)

    # (b) identity accumulate -> (dsum, hits)
    acc = dispatch.make_delta_accumulator(ts, "auto")
    row("accumulate (identity):      ", acc, weights, idx1, dw, valid)

    # (c) D4 fold of the stacked [dsum; hits] pair (sym_impl="fold")
    pair = torch.stack([weights, weights * 0.5])
    row("fold (symmetrize_sum x2):   ", lambda q: symmetrize_sum(ts, q), pair)

    # (d) dense TC update (lr compute + apply + accumulator update)
    z = torch.zeros_like(weights)
    row("tc dense update:            ", tc_update, weights, z, z, z, z)

    # (e) explicit 8-image accumulate (sym_impl="index")
    idx8 = ntuple.all_symmetry_indices(ts, boards).reshape(
        envs * 8, ts.num_feat)
    dw8 = dw[:, None].expand(envs, 8).reshape(-1)
    v8 = torch.ones(envs * 8, dtype=torch.bool, device=device)
    row("accumulate (8-image index): ", acc, weights, idx8, dw8, v8)

    # (f) gather-path share of (b): scatter into ONLY the gather classes
    classes = oh.build_table_classes(ts)
    if len(classes.gather_feats):
        gf = torch.from_numpy(classes.gather_feats).to(device)
        row("accumulate (gather classes only):",
            make_acc_gather_only(gf), weights, idx1, dw, valid)


if __name__ == "__main__":
    main()
