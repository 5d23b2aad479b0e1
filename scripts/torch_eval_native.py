#!/usr/bin/env python3
"""Evaluate a stored agent with the NATIVE C++ expectimax engine of the
PyTorch port (the twin of ``scripts/eval_native.py``).

The reference's headline search result (README.md:131-145) is 100
games at depth=3 width=4 since_empty=6, ~1 s/move on its CPU.  For a
100-game statistics run the host C++ engine (tpu2048_torch/native) is
the right tool: whole games in seconds, threads scale across cores
(ctypes releases the GIL during the C call).  A host tool: the agent's
dense table is made on the CPU, and no card is touched.

Usage:
  python3 scripts/torch_eval_native.py <agent> [--num 100] [--depth 3]
          [--width 4] [--since-empty 6] [--seed 0] [--threads N]

The agent is read from ``~/.tpu2048``.  Imports no jax.
"""

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from tpu2048_torch import native  # noqa: E402
from tpu2048_torch.features import ntuple  # noqa: E402
from tpu2048_torch.store import checkpoint as ckpt  # noqa: E402
from tpu2048_torch.store.artifacts import open_store  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("agent")
    p.add_argument("--num", type=int, default=100)
    p.add_argument("--depth", type=int, default=3)
    p.add_argument("--width", type=int, default=4)
    p.add_argument("--since-empty", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--threads", type=int, default=0)
    args = p.parse_args()

    assert native.available(), "native engine failed to build"
    store = open_store("local", root="~/.tpu2048")
    acfg, weights, meta = ckpt.load_agent_dense(store, args.agent, "cpu")
    ts = ntuple.get_tuple_set(acfg.n)
    w = np.ascontiguousarray(weights.numpy(), np.float32)
    print(f"agent {args.agent}: n={acfg.n}, episodes={meta.get('episodes')}, "
          f"depth={args.depth} width={args.width} "
          f"since_empty={args.since_empty} num={args.num}", flush=True)

    nthreads = args.threads or min(8, os.cpu_count() or 1)

    def play(i):
        eng = native.NativeEngine(ts=ts, weights=w,
                                  seed=args.seed * 100003 + i)
        t0 = time.time()
        score, moves, final = eng.play_game(
            depth=args.depth, width=args.width,
            since_empty=args.since_empty)
        return score, moves, final, time.time() - t0

    t0 = time.time()
    results = []
    with ThreadPoolExecutor(max_workers=nthreads) as ex:
        for r in ex.map(play, range(args.num)):
            results.append(r)
            n = len(results)
            if n % 10 == 0:
                print(f"  {n}/{args.num} games, last score "
                      f"{r[0]} ({r[1]} moves, {r[3]:.0f}s)", flush=True)
    elapsed = time.time() - t0

    scores = np.array([r[0] for r in results])
    moves = np.array([r[1] for r in results])
    tiles = np.array([int(r[2].max()) for r in results])
    order = np.argsort(-scores)
    print("\nBest games:")
    for i in order[:3]:
        for row in results[i][2]:
            print("".join(f"{(1 << int(v)) if v else 0}".ljust(7)
                          for v in row))
        print(f"score = {scores[i]} moves = {moves[i]} "
              f"reached {1 << int(tiles[i])}\n")
    mean = float(scores.mean())
    sem = float(scores.std(ddof=1) / np.sqrt(len(scores)))
    print(f"average score of {args.num} runs = {round(mean, 3)} "
          f"(95% CI ±{round(1.96 * sem, 1)})")
    for e in (15, 14, 13, 12, 11, 10):
        k = int((tiles >= e).sum())
        p = k / len(tiles)
        # Wilson 95% interval: honest at the tail rates search rows
        # live in (a 0/100 result still gets a meaningful upper bound)
        z = 1.96
        den = 1 + z * z / len(tiles)
        ctr = (p + z * z / (2 * len(tiles))) / den
        hw = (z * np.sqrt(p * (1 - p) / len(tiles)
                          + z * z / (4 * len(tiles) ** 2)) / den)
        print(f"{1 << e} reached in {round(p * 100, 2)}% "
              f"(95% CI {round(max(0.0, (ctr - hw)) * 100, 2)}"
              f"-{round(min(1.0, ctr + hw) * 100, 2)}%)")
    print(f"total time = {round(elapsed, 2)}s "
          f"({nthreads} threads)")
    print(f"average time per move = "
          f"{round(elapsed / max(int(moves.sum()), 1) * 1000, 3)} ms "
          f"(wall, all games)")


if __name__ == "__main__":
    main()
