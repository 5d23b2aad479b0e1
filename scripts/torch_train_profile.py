#!/usr/bin/env python3
"""Where the port's default train step spends its time on a CUDA card.

    python3 scripts/torch_train_profile.py [--out FILE] [--root DIR]

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
3. From the same trace, the class-gradient stretch of each step: the
   fills just before ``grad_class``'s kernels (torch's fill kernels,
   or a fill of the kernel's own), its kernels (consecutive events
   named ``grad_class*``, taken as one), whatever runs between them
   and ``fold_class``, and the fold; device µs per step of each part,
   and the span from the first fill's start to the fold's end.  Then
   ``CALLS`` ``grad_class`` calls at (17, 256, 256), B = 8192, half
   the rows valid, with random indices and with every row on one
   entry, queued behind a sleep kernel so that they run back to back:
   per call the fills, the kernels (and their part after the fills
   have ended: a kernel launched as a programmatic dependent starts
   early and waits), the card's idle time and overlap inside the
   call, and the period from one call's end to the next.

``--root`` names the checkout whose ``tpu2048_torch`` is profiled (by
default the one this script lies in), so one copy of the script
measures two checkouts alike.  Draws come from a ``torch.Generator``
seeded with 0.  The full result is written as JSON to ``--out``
(default ``chiprun_out/train_profile.json``).  Needs one CUDA card;
imports no jax.

The traces are read with the profiled checkout's
``obs.profiler.device_events``, so ``--root`` must name a checkout
that has it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEGMENTS = 4  # timed segments of each ABBA run
ROUNDS = 2  # ABBA rounds
CALLS = 20  # grad_class calls profiled back to back, per case

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
    ("FillFunctor", "fill/zero"),
    ("zero_pair", "fill/zero"),  # a grad_class fill of its own pair
    ("fill", "fill/zero"),
    ("Memset", "fill/zero"),
    ("where", "where"),
    ("elementwise", "elementwise"),
]
FILL = "fill/zero"
ACTIVITIES = [torch.profiler.ProfilerActivity.CPU,
              torch.profiler.ProfilerActivity.CUDA]


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


def _grad_parts(events: list) -> list:
    """For each ``grad_class`` call in ``events`` (its consecutive
    kernels, merged into one event from the first's start to the last's
    end): the fills right before it, the call, and, where a
    ``fold_class`` follows before the next call, what runs between them
    and the fold."""
    merged = []
    for e in events:
        if "grad_class" in e[0] and merged and "grad_class" in merged[-1][0]:
            start = merged[-1][1]
            merged[-1] = ("grad_class", start,
                          max(merged[-1][2], e[1] + e[2] - start))
        else:
            merged.append(e)
    events = merged
    parts = []
    at = [i for i, e in enumerate(events) if "grad_class" in e[0]]
    for j, i in enumerate(at):
        f = i
        while f > 0 and _kind(events[f - 1][0]) == FILL:
            f -= 1
        end = at[j + 1] if j + 1 < len(at) else len(events)
        fold = next((k for k in range(i + 1, end)
                     if "fold_class" in events[k][0]), None)
        parts.append({"fills": events[f:i], "grad": events[i],
                      "between": events[i + 1: fold] if fold else [],
                      "fold": events[fold] if fold else None})
    return parts


def _stretch_summary(parts: list) -> dict:
    """Per-step means of the class-gradient stretch's parts."""
    def mean(xs):
        return statistics.fmean(xs) if xs else 0.0

    spans = [p["fold"][1] + p["fold"][2] - (p["fills"] or [p["grad"]])[0][1]
             for p in parts if p["fold"]]
    return {
        "steps": len(parts),
        "fills_per_step": mean([len(p["fills"]) for p in parts]),
        "fill_us": mean([sum(e[2] for e in p["fills"]) for p in parts]),
        "grad_class_us": mean([p["grad"][2] for p in parts]),
        "between_launches_per_step": mean([len(p["between"]) for p in parts]),
        "between_us": mean([sum(e[2] for e in p["between"]) for p in parts]),
        "between_kernels": sorted({e[0][:80] for p in parts
                                   for e in p["between"]}),
        "fold_class_us": mean([p["fold"][2] for p in parts if p["fold"]]),
        "span_fill_to_fold_end_us": mean(spans),
    }


def _grad_inputs(g, h, l, b, seed, collide):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, h, (b, g)).astype(np.int32)
    lo = rng.integers(0, l, (b, g)).astype(np.int32)
    if collide:  # a fresh start: every row on one entry of each table
        hi[:] = lo[:] = 0
    dw = rng.standard_normal(b).astype(np.float32)
    valid = rng.random(b) < 0.5
    return [torch.from_numpy(a).cuda() for a in (hi, lo, dw, valid)]


def _grad_call_profile(kernels, device_events, collide: bool) -> dict:
    """``CALLS`` grad_class calls queued behind a sleep kernel, traced:
    per call the fills, the scatter, the idle gaps inside the call,
    and the period from one call's end to the next."""
    g, h, l = 17, 256, 256
    args = _grad_inputs(g, h, l, 8192, 11, collide)
    kernels.grad_class(*args, h, l)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
        torch.cuda._sleep(20_000_000)
        for _ in range(CALLS):
            kernels.grad_class(*args, h, l)
        torch.cuda.synchronize()
    parts = _grad_parts(device_events(prof))
    calls = []
    for p in parts:
        spans = sorted((e[1], e[1] + e[2]) for e in p["fills"] + [p["grad"]])
        covered, reach = 0.0, spans[0][0]
        for a, b in spans:  # the union of the call's kernels on the card
            covered += max(0.0, b - max(a, reach))
            reach = max(reach, b)
        fill_end = max((e[1] + e[2] for e in p["fills"]), default=0.0)
        end = p["grad"][1] + p["grad"][2]
        calls.append({
            "fills": len(p["fills"]),
            "fill_us": sum(e[2] for e in p["fills"]),
            "scatter_us": p["grad"][2],
            # the scatter after the last fill has ended: with a
            # programmatic dependent launch the kernel starts earlier
            # and waits for the fill
            "scatter_after_fill_us": end - max(p["grad"][1], fill_end),
            "idle_us": reach - spans[0][0] - covered,
            "overlap_us": sum(b - a for a, b in spans) - covered,
            "span_us": reach - spans[0][0], "end_us": end})
    periods = [b["end_us"] - a["end_us"] for a, b in zip(calls, calls[1:])]
    out = {"case": "collide" if collide else "random", "shape": [g, h, l],
           "batch": 8192, "calls": len(calls),
           "fills_per_call": statistics.fmean(c["fills"] for c in calls),
           "period_us_median": statistics.median(periods)}
    for key in ("fill_us", "scatter_us", "scatter_after_fill_us", "idle_us",
                "overlap_us", "span_us"):
        out[key + "_median"] = statistics.median(c[key] for c in calls)
    return out


def _fresh(td, TorchDraws, AgentConfig, ts, tcfg, mode):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    draws = TorchDraws(gen)
    cfg = AgentConfig(table_ops=mode)
    st = td.init_td_state(ts, cfg, tcfg, draws, "cuda")
    return st, td.make_train_segment(ts, cfg, tcfg, draws)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/train_profile.json")
    ap.add_argument("--root", default=REPO,
                    help="checkout whose tpu2048_torch is profiled")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.root))
    from tpu2048_torch.agent import td
    from tpu2048_torch.config import AgentConfig, TrainConfig
    from tpu2048_torch.draws import TorchDraws
    from tpu2048_torch.features.ntuple import get_tuple_set
    from tpu2048_torch.obs.profiler import device_events
    from tpu2048_torch.ops import kernels

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    print(f"root: {os.path.abspath(args.root)} (package at "
          f"{os.path.dirname(kernels.__file__)})", flush=True)
    tcfg = TrainConfig()
    ts = get_tuple_set(AgentConfig().n)
    steps = tcfg.steps_per_call

    def fresh(mode):
        return _fresh(td, TorchDraws, AgentConfig, ts, tcfg, mode)

    for mode in ("gather", "auto"):  # first use: kernel build, caches
        st, seg = fresh(mode)
        seg(st)
    runs = []
    for mode in ("gather", "auto", "auto", "gather") * ROUNDS:
        st, seg = fresh(mode)
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

    st, seg = fresh("auto")
    for _ in range(2):
        st = seg(st)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=ACTIVITIES) as prof:
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
    stretch = _stretch_summary(_grad_parts(device_events(prof)))
    print(f"grad_stretch: {json.dumps(stretch)}", flush=True)
    del prof

    calls = [_grad_call_profile(kernels, device_events, collide)
             for collide in (False, True)]
    for c in calls:
        print(f"grad_call: {json.dumps(c)}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"root": os.path.abspath(args.root), "abba": runs,
                   "profile": summary, "kinds": kinds, "kernels": table,
                   "grad_stretch": stretch, "grad_calls": calls}, f,
                  indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
