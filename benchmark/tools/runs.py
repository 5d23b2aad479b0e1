#!/usr/bin/env python3
"""Run cells several times on the card and keep every result line.

    python3 benchmark/tools/runs.py --out results/sets.jsonl \\
        --workload train-n6 --seeds 11,12,13 --seconds 30 --trace 0 \\
        [--root DIR]

Each run is its own process (``benchmark/run.py`` from ``--root``, the
checkout's root by default: a trial size is a copy of the checkout with
its configuration file changed), one after another; each line of ``--out``
is one run: its arguments, exit code, seconds, last result line and the
end of its standard error.  A summary per workload follows on standard
output: each metric's median and quartile spread as a share of the
median (``statistics.quantiles(values, n=4)``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def spread(values):
    if len(values) < 2:
        return None
    q = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q[2] - q[0]) / abs(med) if med else None


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--workload", action="append", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--root", default=".")
    p.add_argument("--timeout", type=float, default=1200)
    args = p.parse_args()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    summary = {}
    with open(args.out, "a") as out:
        for w in args.workload:
            for seed in seeds:
                cmd = [sys.executable, "benchmark/run.py", "--workload", w,
                       "--seed", str(seed), "--seconds", str(args.seconds),
                       "--trace", str(args.trace)]
                t = time.time()
                try:
                    r = subprocess.run(cmd, cwd=args.root, capture_output=True,
                                       text=True, timeout=args.timeout)
                    rc, so, se = r.returncode, r.stdout, r.stderr
                except subprocess.TimeoutExpired as e:
                    rc, so, se = 124, e.stdout or "", e.stderr or ""
                    so = so if isinstance(so, str) else so.decode()
                    se = se if isinstance(se, str) else se.decode()
                lines = so.strip().splitlines()
                try:
                    res = json.loads(lines[-1]) if lines else None
                except json.JSONDecodeError:
                    res = None
                rec = {"workload": w, "seed": seed, "trace": args.trace,
                       "rc": rc,
                       "seconds": time.time() - t, "result": res,
                       "stderr": se[-3000:]}
                out.write(json.dumps(rec) + "\n")
                out.flush()
                brief = {k: v["value"] for k, v in (res or {}).get(
                    "metrics", {}).items()}
                print(w, seed, rc, round(rec["seconds"], 1),
                      (res or {}).get("correct"), brief,
                      {k: v["value"] for k, v in (res or {}).get(
                          "checks", {}).items()}, flush=True)
                if rc != 0:
                    print(se[-2000:], flush=True)
                for k, v in brief.items():
                    summary.setdefault(w, {}).setdefault(k, []).append(v)
    for w, ms in summary.items():
        for k, vals in ms.items():
            print("SUMMARY", w, k, "median", statistics.median(vals),
                  "spread", spread(vals), "n", len(vals))
    return 0


if __name__ == "__main__":
    sys.exit(main())
