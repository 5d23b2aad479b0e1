#!/usr/bin/env python3
"""Where the port's greedy-play serve step spends its time on a CUDA card.

    python3 scripts/torch_serve_profile.py [--out FILE]

1. Plays 8192 n=5 games four times, gather / kernel / kernel /
   gather (``table_ops`` "gather" and "auto"), and prints each run's
   moves per second, so the two paths are compared on one card in
   turns.
2. Plays them once more through the kernel path under
   ``torch.profiler`` and prints the device time by kernel name, the
   number of kernel launches per step, and the device's busy and idle
   share of the profiled wall time.

Weights are dyadic (integers in [0, 40] x 2^-12, from a seeded numpy
generator), so both paths play the same games.  The full result is
written as JSON to ``--out``.  Needs one CUDA card; imports no jax.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu2048_torch.features.ntuple import get_tuple_set  # noqa: E402
from tpu2048_torch.ops import kernels  # noqa: E402
from tpu2048_torch.train.trial import trial  # noqa: E402

GAMES = 8192


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    raise AttributeError("profiler event has no device time")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/serve_profile.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    ts = get_tuple_set(5)
    rng = np.random.default_rng(0)
    w = torch.from_numpy(
        (rng.integers(0, 41, ts.total) * 2.0**-12).astype(np.float32)).to(dev)
    kw = dict(num=GAMES, seed=0)
    trial(ts, w, table_ops="auto", **kw)  # warm-up: build, caches

    runs = []
    for mode in ("gather", "auto", "auto", "gather"):
        r = trial(ts, w, table_ops=mode, **kw)
        moves = int(r.odometers.sum())
        runs.append({"table_ops": mode, "elapsed_s": r.elapsed,
                     "moves": moves, "moves_per_s": moves / r.elapsed,
                     "avg_score": float(r.scores.mean())})
        print(f"abba: {json.dumps(runs[-1])}", flush=True)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    launches0 = kernels.eval_class.launches
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        r = trial(ts, w, table_ops="auto", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = kernels.eval_class.launches - launches0
    table = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            table.append({"name": evt.key, "count": evt.count,
                          "device_us": us})
    table.sort(key=lambda e: -e["device_us"])
    busy_us = sum(e["device_us"] for e in table)
    n_kernels = sum(e["count"] for e in table)
    summary = {
        "card": card, "games": GAMES, "steps": steps,
        "profiled_wall_s": wall, "profiled_trial_elapsed_s": r.elapsed,
        "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / wall,
        "device_idle_share": 1 - busy_us / 1e6 / wall,
        "kernels_per_step": n_kernels / max(steps, 1),
        "device_us_per_step": busy_us / max(steps, 1),
        "wall_us_per_step": wall * 1e6 / max(steps, 1),
    }
    print(f"profile: {json.dumps(summary)}", flush=True)
    ours = [e for e in table[15:] if "eval_class" in e["name"]]
    for e in table[:15] + ours:
        print(f"kernel: {json.dumps(e)}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"abba": runs, "profile": summary, "kernels": table}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
