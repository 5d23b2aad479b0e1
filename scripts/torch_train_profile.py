#!/usr/bin/env python3
"""Where the port's default train step spends its time on a CUDA card.

    python3 scripts/torch_train_profile.py [--out FILE]

1. Trains the shipped configuration (n=5, 8192 envs, K=64 steps per
   segment) from a fresh state in ``ROUNDS`` rounds of four runs,
   plain / kernel / kernel / plain (``table_ops`` "gather" and
   "auto"), each for a warm-up segment and then ``SEGMENTS`` timed
   segments, after one untimed run of each path that takes the
   process's first-use costs; prints each run's env-steps per second,
   so the two paths are compared on one card in turns.
2. Runs one more kernel-path segment under ``torch.profiler`` and
   prints the device time per step by kernel name and by kind of
   kernel, the kernel launches per step, the share of the device time
   taken by the ported kernels, and the device's busy and idle share
   of the profiled wall time.

Draws come from a ``torch.Generator`` seeded with 0.  The full result
is written as JSON to ``--out`` (default
``chiprun_out/train_profile.json``).  Needs one CUDA card; imports no jax.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu2048_torch.config import AgentConfig, TrainConfig  # noqa: E402
from tpu2048_torch.agent import td  # noqa: E402
from tpu2048_torch.draws import TorchDraws  # noqa: E402
from tpu2048_torch.features.ntuple import get_tuple_set  # noqa: E402

SEGMENTS = 4  # timed segments of each ABBA run
ROUNDS = 2  # ABBA rounds

# kind of a CUDA kernel, by the first pattern its name contains
KINDS = [
    ("eval_class", "eval_class (K1/K2)"),
    ("grad_class", "grad_class (K3)"),
    ("fold_class", "fold_class (K4)"),
    ("index_add", "scatter-add (index_add_)"),
    ("indexFuncLargeIndex", "scatter-add (index_add_)"),
    ("index_put", "index_put (rings, logs)"),
    ("scatter", "scatter"),
    ("index_elementwise", "advanced-index gather"),
    ("gather", "gather"),
    ("reduce", "reduction"),
    ("scan", "cumsum"),
    ("CatArray", "cat/stack"),
    ("copy", "copy/convert"),
    ("fill", "fill/zero"),
    ("Memset", "fill/zero"),
    ("where", "where"),
    ("elementwise", "elementwise"),
]


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    raise AttributeError("profiler event has no device time")


def _kind(name: str) -> str:
    for pat, kind in KINDS:
        if pat in name:
            return kind
    return "other"


def _fresh(ts, tcfg, mode):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    draws = TorchDraws(gen)
    cfg = AgentConfig(table_ops=mode)
    st = td.init_td_state(ts, cfg, tcfg, draws, "cuda")
    return st, td.make_train_segment(ts, cfg, tcfg, draws)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/train_profile.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    tcfg = TrainConfig()
    ts = get_tuple_set(AgentConfig().n)
    steps = tcfg.steps_per_call

    for mode in ("gather", "auto"):  # first use: kernel build, caches
        st, seg = _fresh(ts, tcfg, mode)
        seg(st)
    runs = []
    for mode in ("gather", "auto", "auto", "gather") * ROUNDS:
        st, seg = _fresh(ts, tcfg, mode)
        st = seg(st)  # warm-up segment: the first episodes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SEGMENTS):
            st = seg(st)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_steps = SEGMENTS * steps
        runs.append({"table_ops": mode, "wall_s": wall,
                     "env_steps_per_s": n_steps * tcfg.num_envs / wall,
                     "wall_ms_per_step": wall * 1e3 / n_steps,
                     "episodes": int(st.metrics.episodes)})
        print(f"abba: {json.dumps(runs[-1])}", flush=True)

    st, seg = _fresh(ts, tcfg, "auto")
    for _ in range(2):
        st = seg(st)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        st = seg(st)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    table, kinds = [], {}
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            table.append({"name": evt.key, "count": evt.count,
                          "device_us": us, "kind": _kind(evt.key)})
            k = kinds.setdefault(_kind(evt.key), {"launches": 0, "us": 0.0})
            k["launches"] += evt.count
            k["us"] += us
    table.sort(key=lambda e: -e["device_us"])
    busy_us = sum(e["device_us"] for e in table)
    # each ported kernel's share of the device time
    ported = {k: v["us"] / busy_us for k, v in kinds.items() if "(K" in k}
    summary = {
        "card": card, "envs": tcfg.num_envs, "steps": steps,
        "profiled_wall_s": wall,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1 - busy_us / 1e6 / wall,
        "kernels_per_step": sum(e["count"] for e in table) / steps,
        "device_us_per_step": busy_us / steps,
        "wall_us_per_step": wall * 1e6 / steps,
        "ported_kernel_share_of_device": ported,
    }
    print(f"profile: {json.dumps(summary)}", flush=True)
    for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]["us"]):
        row = {"kind": k, "launches_per_step": v["launches"] / steps,
               "device_us_per_step": v["us"] / steps}
        print(f"kind: {json.dumps(row)}", flush=True)
    for e in table[:20]:
        print(f"kernel: {json.dumps(e)}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"abba": runs, "profile": summary, "kinds": kinds,
                   "kernels": table}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
