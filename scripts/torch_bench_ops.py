#!/usr/bin/env python3
"""The table-op modes of the PyTorch port on the card (the twin of
``scripts/bench_ops.py``).

Times the three table-op paths ("gather", "onehot", "pallas") at the
eval and update shapes of a tuple set, each with its max|err| against
the first mode, and the raw gather rate against table size.  A mode
that fails raises.  TF32 is left as the port's defaults set it (off):
"onehot" refuses to run while it is allowed.

Usage:
  python3 scripts/torch_bench_ops.py [n] [n_envs] [--device cuda|cpu]

n defaults to 4 and n_envs to 8192.  ``--device`` defaults to the CUDA
card (without one the run raises).  The first line is the card's name
and power limit.  Imports no jax.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import torch_bench  # noqa: E402
from tpu2048_torch.features import ntuple  # noqa: E402
from tpu2048_torch.ops import dispatch  # noqa: E402

MODES = ("gather", "onehot", "pallas")
REPS = 20
GATHERS = 1 << 20
TABLE_SIZES = (1 << 12, 1 << 16, 1 << 20, 1 << 24)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("n", type=int, nargs="?", default=4)
    p.add_argument("n_envs", type=int, nargs="?", default=8192)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    device = torch_bench.start(args.device, "bench_ops")
    n, n_envs = args.n, args.n_envs
    ts = ntuple.get_tuple_set(n)
    gen = torch_bench.seeded_generator(device, 0)
    weights = ntuple.init_weights(ts, gen)
    b_eval = 4 * n_envs
    boards = torch.randint(0, 12, (b_eval, 16), generator=gen, device=device,
                           dtype=torch.int8)
    print(f"n={n} num_feat={ts.num_feat} total={ts.total} "
          f"b_eval={b_eval} b_upd={n_envs}", flush=True)

    ref = None
    for mode in MODES:
        ev = dispatch.make_evaluator(ts, mode)
        dt = torch_bench.timeit(ev, weights, boards, device=device, reps=REPS)
        v = ev(weights, boards)
        if ref is None:
            ref = v
        err = float((v - ref).abs().max())
        lookups = b_eval * ts.num_feat
        print(f"eval {mode:7s} {dt*1e3:8.3f} ms  "
              f"{lookups/dt/1e6:8.1f} M lookups/s  max|err|={err:.2e}",
              flush=True)

    idx_u = ntuple.feature_indices(ts, boards[:n_envs])
    dw = torch.randn(n_envs, generator=gen, device=device) * 1e-3
    valid = torch.rand(n_envs, generator=gen, device=device) < 0.95
    ref = None
    for mode in MODES:
        up = dispatch.make_updater(ts, mode, mean=True)
        # the updater adds in place: time it on a copy, and take the
        # error from one update of a fresh copy
        dt = torch_bench.timeit(up, weights.clone(), idx_u, dw, valid,
                                device=device, reps=REPS)
        w = up(weights.clone(), idx_u, dw, valid)
        if ref is None:
            ref = w
        err = float((w - ref).abs().max())
        scatters = n_envs * ts.num_feat
        print(f"upd  {mode:7s} {dt*1e3:8.3f} ms  "
              f"{scatters/dt/1e6:8.1f} M scatters/s  max|err|={err:.2e}",
              flush=True)

    # raw gather rate vs table size
    for tsize in TABLE_SIZES:
        table = torch.randn(tsize, generator=gen, device=device)
        idx = torch.randint(0, tsize, (GATHERS,), generator=gen,
                            device=device)
        dt = torch_bench.timeit(lambda t, i: t[i].sum(), table, idx,
                                device=device, reps=REPS)
        print(f"raw gather table={tsize:>9}  "
              f"{GATHERS / dt / 1e6:8.1f} M gathers/s", flush=True)


if __name__ == "__main__":
    main()
