#!/usr/bin/env python3
"""The course of one search call, step by step: where its largest tier
lies, and what a window of whole calls reads.

    python3 benchmark/tools/call_profile.py --workload search-n5 \\
        --seeds 1,2,3 --out results/profile.jsonl

For each seed: the cell's set-up, then its first call from the seed's
fresh boards, played to its end as the window plays it.  Each line of
``--out`` is one seed: per step (callback to callback) its time in ms,
the games live before it and its needy roots (a legal move of a live
game with fewer than ``since_empty`` empty cells after it, the roots
the tree searches); and the call's steps, moves and wall.  One process.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))


def profile(cell, seed: int, device) -> dict:
    from harness import runner

    d = runner.driver(cell, seed, device)
    d.setup()
    # stop once the second call has begun: its first step is dropped
    steps, times, _, _ = d._play(
        float("inf"), lambda st, el: len(st) > 1 and st[-1].start)
    steps, times = steps[:-1], times[:-1]
    needy = d._needy(steps)
    live = [int(s.active.sum()) for s in steps]
    moves = int(steps[-1].odo.sum())
    wall = sum(times)
    return {"workload": cell.name, "seed": seed, "steps": len(steps),
            "moves": moves, "wall_s": wall, "moves_per_s": moves / wall,
            "step_ms": [round(t * 1e3, 3) for t in times],
            "live_after": live, "needy": [0] + needy}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    from harness import spec

    cell = spec.load(args.workload)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as out:
        for seed in args.seeds.split(","):
            t = time.time()
            rec = profile(cell, int(seed), args.device)
            rec["seconds"] = time.time() - t
            out.write(json.dumps(rec) + "\n")
            out.flush()
            needy = rec["needy"]
            top = max(needy)
            wide = [i for i, v in enumerate(needy) if v >= 0.9 * top]
            print(json.dumps({k: rec[k] for k in (
                "workload", "seed", "steps", "moves", "wall_s",
                "moves_per_s")} | {"needy_max": top,
                                   "needy_90pct_steps": [wide[0], wide[-1]]
                                   if wide else None}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
