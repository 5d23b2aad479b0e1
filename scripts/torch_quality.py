#!/usr/bin/env python3
"""The quality gate of the PyTorch port on one CUDA card.

    python3 scripts/torch_quality.py [--out FILE]

The protocol of ``QUALITY.md:36-41``, through the port:

1. ``Trainer`` at the shipped defaults (``AgentConfig()``,
   ``TrainConfig()``: n=5, 8192 envs, K=64) with train seed 1, to
   20,000 completed episodes;
2. greedy play of the trained agent (its dense table), ``trial(num=1000,
   seed=7)``;
3. the same agent with depth-3 / width-4 / since_empty=6 expectimax,
   ``trial(num=100, seed=7)``; one 32-step segment in the middle of it
   runs under ``torch.profiler``, which gives the search step's kernel
   launches, host syncs, device-busy share and ``eval_class``'s share
   of device time.

Prints one line per phase and writes the whole result as JSON to
``--out`` (default ``chiprun_out/quality.json``): average scores, the
2048-, 4096- and 8192-rates with Wilson 95% intervals, the training
wall time and rate, and ms per move of both evaluations, beside the
card's name and power limit.  Needs one CUDA card; imports no jax.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu2048_torch.config import (AgentConfig, SearchConfig,  # noqa: E402
                                  TrainConfig)
from tpu2048_torch.obs.logging import Logger  # noqa: E402
from tpu2048_torch.features.canonical import to_dense_table  # noqa: E402
from tpu2048_torch.features.ntuple import get_tuple_set  # noqa: E402
from tpu2048_torch.ops import kernels  # noqa: E402
from tpu2048_torch.train.loop import Trainer  # noqa: E402
from tpu2048_torch.train.trial import trial  # noqa: E402

# the protocol (QUALITY.md:36-41, :361): training episodes, greedy
# games, search games
EPISODES = 20000
GAMES = 1000
SEARCH_GAMES = 100
SEARCH = SearchConfig(depth=3, width=4, since_empty=6)
SEARCH_STEPS_PER_CALL = 32
PROFILE_SEGMENT = 40  # the profiled search segment: steps 1280-1311


def wilson(k: int, n: int, z: float = 1.96) -> list:
    """Wilson score interval of k successes in n trials, in percent."""
    p = k / n
    den = 1 + z * z / n
    mid = (p + z * z / (2 * n)) / den
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / den
    return [100 * (mid - half), 100 * (mid + half)]


def summary(r) -> dict:
    n = len(r.scores)
    moves = int(r.odometers.sum())
    out = {"games": n, "avg_score": float(r.scores.mean()),
           "max_score": int(r.scores.max()), "total_moves": moves,
           "elapsed_s": r.elapsed, "ms_per_move": 1e3 * r.elapsed / moves}
    for exp in (11, 12, 13):
        k = int((r.tiles >= exp).sum())
        out[f"rate_{1 << exp}"] = {"pct": 100 * k / n, "wilson95": wilson(k, n)}
    return out


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    raise AttributeError("profiler event has no device time")


class ProfileWindow:
    """A ``trial`` progress callback that profiles the segment after
    its ``at``-th one (steps ``at * k`` to ``(at + 1) * k - 1``)."""

    def __init__(self, at: int, steps: int):
        self.at, self.steps, self.seen = at, steps, 0
        self.prof = None
        self.result = None

    def __call__(self, _state) -> None:
        self.seen += 1
        if self.seen == self.at:
            torch.cuda.synchronize()
            self.launches0 = kernels.eval_class.launches
            self.prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            self.prof.start()
            self.t0 = time.perf_counter()
        elif self.seen == self.at + 1:
            torch.cuda.synchronize()
            wall = time.perf_counter() - self.t0
            self.prof.stop()
            self.result = self._summarize(
                wall, kernels.eval_class.launches - self.launches0)
            self.prof = None

    def close(self) -> None:
        """Stop a profiler that the run outlived (no result then)."""
        if self.prof is not None:
            self.prof.stop()
            self.prof = None

    def _summarize(self, wall: float, eval_launches: int) -> dict:
        steps = self.steps
        dev_us, dev_n, eval_us = 0.0, 0, 0.0
        host = {}
        top = []
        for evt in self.prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                us = _device_us(evt)
                if us <= 0:
                    continue
                dev_us += us
                dev_n += evt.count
                if "eval_class" in evt.key:
                    eval_us += us
                top.append({"name": evt.key[:90], "count": evt.count,
                            "device_us": us})
            elif ("Synchronize" in evt.key or "_local_scalar_dense" in evt.key
                  or "cudaMemcpy" in evt.key):
                host[evt.key] = evt.count
        top.sort(key=lambda e: -e["device_us"])
        return {
            "steps": steps, "profiled_wall_s": wall,
            "wall_ms_per_step": 1e3 * wall / steps,
            "device_launches_per_step": dev_n / steps,
            "eval_class_launches_per_step": eval_launches / steps,
            "device_us_per_step": dev_us / steps,
            "device_busy_share": dev_us / 1e6 / wall,
            "eval_class_share_of_device": eval_us / dev_us if dev_us else 0.0,
            "host_sync_events_per_step": {k: v / steps
                                          for k, v in host.items()},
            "top_kernels": top[:15],
        }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/quality.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    result = {"card": card, "torch": torch.__version__,
              "protocol": "QUALITY.md:36-41"}

    acfg = AgentConfig()
    tcfg = TrainConfig(seed=1, episodes=EPISODES)
    tr = Trainer("quality", acfg, tcfg, logger=Logger(console=False),
                 device="cuda")
    t0 = time.perf_counter()
    out = tr.run()
    torch.cuda.synchronize()
    hist = out["train_history"]
    result["train"] = {
        "episodes": out["episodes"], "wall_s": time.perf_counter() - t0,
        "env_steps_per_s": out["env_steps_per_sec"],
        "top_score": out["top_score"], "ma100_last": hist[-1] if hist else None,
        "ma100_every_2000": hist[19::20]}
    print(f"train: {json.dumps(result['train'])}", flush=True)

    ts = get_tuple_set(acfg.n)
    w = to_dense_table(ts, tr.state.weights)
    del tr
    r = trial(ts, w, num=GAMES, seed=7)
    result["greedy"] = summary(r)
    print(f"greedy: {json.dumps(result['greedy'])}", flush=True)

    window = ProfileWindow(PROFILE_SEGMENT, SEARCH_STEPS_PER_CALL)
    try:
        r = trial(ts, w, num=SEARCH_GAMES, seed=7, search=SEARCH,
                  steps_per_call=SEARCH_STEPS_PER_CALL, progress_cb=window)
    finally:
        window.close()
    result["search"] = {**summary(r), "depth": SEARCH.depth,
                        "width": SEARCH.width,
                        "since_empty": SEARCH.since_empty,
                        "stats": r.search_stats}
    print(f"search: {json.dumps(result['search'])}", flush=True)
    result["search_profile"] = window.result
    print(f"search_profile: {json.dumps(window.result)}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
