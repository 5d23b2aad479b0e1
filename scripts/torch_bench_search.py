#!/usr/bin/env python3
"""Where does the port's expectimax time go? (the twin of
``scripts/bench_search.py``).

Times the depth-d tree (``tpu2048_torch/search/expectimax.py``) and its
parts at eval-shaped batches on the card: the leaf evaluation at the
tree's leaf batch under "gather" and "search", ``afterstates_nc`` at
the inner-node batch, and the whole tree at depths 1-3 under each mode
(reference protocol: depth=3, width=4, since_empty=6).

Usage:
  python3 scripts/torch_bench_search.py [n] [games] [--device cuda|cpu]

n defaults to 5 and games to 100.  ``--device`` defaults to the CUDA
card (without one the run raises).  The first line is the card's name
and power limit.  Imports no jax.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_bench  # noqa: E402
from tpu2048_torch.draws import TorchDraws  # noqa: E402
from tpu2048_torch.engine import fast as engf  # noqa: E402
from tpu2048_torch.features import ntuple  # noqa: E402
from tpu2048_torch.ops import dispatch  # noqa: E402
from tpu2048_torch.search.expectimax import make_expectimax_estimator  # noqa: E402

WIDTH = 4
SINCE_EMPTY = 6


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("n", type=int, nargs="?", default=5)
    p.add_argument("games", type=int, nargs="?", default=100)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    device = torch_bench.start(args.device, "bench_search")
    n, games = args.n, args.games
    ts = ntuple.get_tuple_set(n)
    weights = ntuple.init_weights(ts, torch_bench.seeded_generator(device, 0))
    rng = np.random.default_rng(0)

    print(f"device={device} n={n} games={games}", flush=True)

    # mid-game-looking boards (some empties, mixed tiles)
    roots = rng.integers(0, 11, (4 * games, 16)).astype(np.int8)
    roots[roots > 8] = 0  # ~20% empties
    boards = torch.from_numpy(roots.reshape(4 * games, 4, 4)).to(device)

    # raw leaf-eval rate at the tree's leaf batch, per evaluator mode
    b_leaf = 4 * games * (4 * WIDTH) ** 2
    lb = torch.from_numpy(
        rng.integers(0, 11, (b_leaf, 16)).astype(np.int8)).to(device)
    for emode in ("gather", "search"):
        evm = dispatch.make_evaluator(ts, emode)
        dt = torch_bench.timeit(evm, weights, lb, device=device)
        lookups = b_leaf * ts.num_feat
        print(f"leaf eval [{emode:6s}] b={b_leaf}: {dt*1e3:8.1f} ms  "
              f"{lookups/dt/1e6:8.1f} M lookups/s", flush=True)

    # engine expansion rate at the inner-node batch
    b_mid = 4 * games * 4 * WIDTH
    codes = engf.codes_from_boards(boards[: min(len(roots), b_mid)])
    codes = codes.repeat(max(1, b_mid // codes.shape[0]), 1)[:b_mid]
    dt = torch_bench.timeit(engf.afterstates_nc, codes, device=device)
    print(f"afterstates_nc b={b_mid}: {dt*1e3:8.1f} ms", flush=True)

    # the whole tree at depths 1..3, per evaluator mode
    for emode in ("gather", "search"):
        evm = dispatch.make_evaluator(ts, emode)
        for depth in (1, 2, 3):
            def vf(b, e=evm):
                return e(weights, b.reshape(b.shape[:-2] + (16,)))

            est = make_expectimax_estimator(vf, depth, WIDTH, SINCE_EMPTY)
            key = TorchDraws(torch_bench.seeded_generator(device, 2)).search()
            dt = torch_bench.timeit(est, boards, key, device=device, reps=3)
            leaves = 4 * games * (4 * WIDTH) ** depth
            print(f"tree [{emode:6s}] depth={depth}: {dt*1e3:8.1f} ms  "
                  f"({leaves/1e6:.2f}M leaves, "
                  f"{dt*1e3/games:.2f} ms/game-move)", flush=True)


if __name__ == "__main__":
    main()
