#!/usr/bin/env python3
"""Does a seed give one training run on a CUDA card, and what does it cost?

    python3 scripts/torch_train_repeat.py [--root DIR] [--out FILE]

For the checkout at ``--root`` (by default the one this script lies
in), on one card:

1. ``grad_class`` on the train step's distributions at (17, 256, 256):
   random rows (B = 8192, half valid), every row on one entry, the
   train step's own rows one step after a fresh start and after
   ``MID_SEGMENTS`` segments of the shipped defaults (8192 rows each),
   and the "index" learner's 8 x 8192 rows after two warm steps; per
   case the device time of one call (CUDA events, ``REPS`` x ``INNER``
   back-to-back calls behind a sleep kernel) and the host's time to
   enqueue one, the kernels one call
   launches on the card (a ``torch.profiler`` trace), and whether two
   launches on one input with non-dyadic dw give the same bits;
2. the shipped defaults (n=5, 8192 envs, K=64): env-steps/s over
   ``SEGMENTS`` segments after a warm one, and the launches, device µs
   and the host's busiest ops per step of one more segment under
   ``torch.profiler``;
3. two runs from one seed of each of ``REPEAT`` (the defaults and the
   sgd "index" learner for ``REPEAT_SEGMENTS`` segments at 8192 envs,
   one n=6 step): how many games and which state leaves differ.

Run it once per checkout in one call, parent, change, change, parent,
to hold two checkouts against each other on one card.  Prints one
``#`` line with the card's name and power limit, then one JSON line per
reading; writes them all to ``--out`` (default
``chiprun_out/train_repeat.json``).  Needs one CUDA card; imports no
jax.
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
B = 8192  # envs, the shipped TrainConfig's
SHAPE = (17, 256, 256)  # n=5's 16^4 class
MID_SEGMENTS = 12
SEGMENTS = 4  # timed segments of the defaults
REPEAT_SEGMENTS = 4
REPS, INNER = 7, 20
# the runs held against a second run from one seed: (settings, n,
# segments; 0 for one step)
# kernels of the step by kind: the first kind whose text is in a name
KINDS = [("grad_class", "grad_class"), ("grad_class", "zero_pair"),
         ("eval_class", "eval_class"), ("fold_class", "fold_class"),
         ("cross_apply", "cross_apply"),
         ("index_add_", "indexFuncLargeIndex"),
         ("index_put_ accumulate", "indexing_backward"),
         ("sort", "Radix"), ("sort", "radix"), ("sort", "sort"),
         ("index_put_", "index_put")]
REPEAT = {"defaults": ({}, 5, REPEAT_SEGMENTS),
          "sgd_index": (dict(optimizer="sgd", alpha=0.25, sym_impl="index"),
                        5, REPEAT_SEGMENTS),
          "n6_step": ({}, 6, 0)}


def _device_ms(fn) -> tuple:
    """(median, min and max device ms of one ``fn()``; the host's median
    µs to enqueue one, behind a sleep kernel that keeps the card busy)."""
    fn()
    torch.cuda.synchronize()
    times, host = [], []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        t0 = time.perf_counter()
        for _ in range(INNER):
            fn()
        host.append((time.perf_counter() - t0) * 1e6 / INNER)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / INNER)
    return ([statistics.median(times), min(times), max(times)],
            statistics.median(host))


def _traced(fn, device_events, prof_out=None) -> list:
    """The device events (name, start µs, µs) of one ``fn()``; the
    profile itself appended to ``prof_out`` when given."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    if prof_out is not None:
        prof_out.append(prof)
    return device_events(prof)


def _host_ops(prof, per: int, top: int = 15) -> list:
    """The ``top`` host ops by self CPU µs per ``per``: [name, calls,
    µs]."""
    rows = [[e.key, e.count / per, e.self_cpu_time_total / per]
            for e in prof.key_averages()]
    return sorted(rows, key=lambda r: -r[2])[:top]


def _short(name: str) -> str:
    """A kernel's name without its namespace and arguments."""
    return name.split("(")[0].split("::")[-1] if "::" in name.split("(")[0] \
        else name[:60]


def _by_kind(events: list, per: int) -> dict:
    """{kind: [launches, device µs]} per ``per`` of the events."""
    kinds = {}
    for name, _start, us in events:
        kind = next((k for k, text in KINDS if text in name), "other")
        row = kinds.setdefault(kind, [0.0, 0.0])
        row[0] += 1 / per
        row[1] += us / per
    return kinds


def _leaves(state, prefix: str = "") -> dict:
    """A (nested) named tuple of tensors as {"env.codes": tensor, ...}."""
    out = {}
    for f, x in zip(state._fields, state):
        if hasattr(x, "_fields"):
            out.update(_leaves(x, f"{prefix}{f}."))
        elif isinstance(x, torch.Tensor):
            out[prefix + f] = x
    return out


def _differ(a, b) -> dict:
    la, lb = _leaves(a), _leaves(b)
    envs = a.env.score.shape[0]
    games = int(((a.env.codes != b.env.codes).reshape(envs, -1).any(dim=1)
                 | (a.env.score != b.env.score)).sum())
    return {"games_differing": games,
            "leaves": len(la),
            "leaves_differing": sorted(k for k in la
                                       if not torch.equal(la[k], lb[k]))}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO,
                    help="checkout whose tpu2048_torch is measured")
    ap.add_argument("--out", default="chiprun_out/train_repeat.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from tpu2048_torch.agent import td
    from tpu2048_torch.config import AgentConfig, TrainConfig
    from tpu2048_torch.draws import TorchDraws
    from tpu2048_torch.features.ntuple import get_tuple_set
    from tpu2048_torch.obs.profiler import device_events
    from tpu2048_torch.ops import kernels
    from tpu2048_torch.ops import onehot as oh

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"# {card}", flush=True)
    out = {"card": card, "root": root,
           "package": os.path.dirname(kernels.__file__)}
    dev = torch.device("cuda")
    tcfg = TrainConfig(num_envs=B)

    def draws(seed):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return TorchDraws(gen)

    def start(acfg, seed=0):
        ts = get_tuple_set(acfg.n)
        d = draws(seed)
        return ts, td.init_td_state(ts, acfg, tcfg, d, "cuda"), d

    def rows(ts, st, seed):
        c = oh.build_table_classes(ts).matmul[0]
        hi, lo = oh._hi_lo(ts, st.prev_idx.reshape(-1, ts.num_feat), c)
        b = hi.shape[0]
        dw = torch.from_numpy(np.random.default_rng(seed).standard_normal(
            b).astype(np.float32)).to(dev)
        valid = st.prev_valid[:, None].expand(-1, st.prev_idx.shape[1])
        return [hi, lo, dw, valid.reshape(-1).clone()]

    # 1. grad_class on the step's distributions
    rng = np.random.default_rng(11)
    g, h, l = SHAPE
    hi = rng.integers(0, h, (B, g)).astype(np.int32)
    lo = rng.integers(0, l, (B, g)).astype(np.int32)
    dw = rng.standard_normal(B).astype(np.float32)
    valid = rng.random(B) < 0.5
    random = [torch.from_numpy(a).to(dev) for a in (hi, lo, dw, valid)]
    collide = [torch.zeros_like(random[0]), torch.zeros_like(random[1]),
               *random[2:]]
    ts, st, d = start(AgentConfig())
    step = td.make_train_step(ts, AgentConfig(), tcfg, d)
    fresh = rows(ts, step(st)[0], 1)
    seg = td.make_train_segment(ts, AgentConfig(), tcfg, d)
    for _ in range(MID_SEGMENTS):
        st = seg(st)
    mid = rows(ts, st, 2)
    acfg = AgentConfig(sym_impl="index")
    ts, st, d = start(acfg)
    step = td.make_train_step(ts, acfg, tcfg, d)
    for _ in range(3):
        st = step(st)[0]
    index = rows(ts, st, 3)
    del st, step, seg
    cases = {"random": random, "collide": collide, "train_fresh": fresh,
             "train_mid": mid, "train_index": index}
    out["grad_class"] = {}
    for case, a in cases.items():
        first = kernels.grad_class(*a, h, l)
        again = kernels.grad_class(*a, h, l)
        events = _traced(lambda: kernels.grad_class(*a, h, l),
                         device_events)
        ms, host_us = _device_ms(lambda: kernels.grad_class(*a, h, l))
        row = {"case": case, "batch": int(a[0].shape[0]),
               "valid_rows": int(a[3].sum()),
               "ms_median_min_max": ms, "host_us_per_call": host_us,
               "kernels_per_call": len(events),
               "kernel_us": {_short(e[0]): e[2] for e in events},
               "repeats_bitwise": bool(torch.equal(first, again))}
        if hasattr(kernels, "grad_class_ordered"):
            row["equals_ordered"] = bool(torch.equal(
                first, kernels.grad_class_ordered(*a, h, l)))
        out["grad_class"][case] = row
        print(f"grad_class: {json.dumps(row)}", flush=True)

    # 2. the defaults' rate, launches and device µs per step
    acfg = AgentConfig()
    ts, st, d = start(acfg)
    seg = td.make_train_segment(ts, acfg, tcfg, d)
    st = seg(st)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SEGMENTS):
        st = seg(st)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k = tcfg.steps_per_call
    t0 = time.perf_counter()
    profs = []
    events = _traced(lambda: seg(st), device_events, profs)
    traced_s = time.perf_counter() - t0
    out["train"] = {"envs": B, "steps_per_call": k, "segments": SEGMENTS,
                    "env_steps_per_s": SEGMENTS * k * B / wall,
                    "wall_ms_per_step": wall * 1e3 / (SEGMENTS * k),
                    "launches_per_step": len(events) / k,
                    "device_us_per_step": sum(e[2] for e in events) / k,
                    "by_kind": _by_kind(events, k),
                    "traced_wall_s": traced_s,
                    "host_ops_per_step": _host_ops(profs[0], k)}
    print(f"train: {json.dumps(out['train'])}", flush=True)
    del st, seg, profs

    # 3. two runs from one seed
    out["repeat"] = {}
    for name, (kw, n, segments) in REPEAT.items():
        acfg = AgentConfig(n=n, **kw)
        ends = []
        t0 = time.perf_counter()
        for _ in range(2):
            ts, st, d = start(acfg, seed=1)
            if segments:
                seg = td.make_train_segment(ts, acfg, tcfg, d)
                for _ in range(segments):
                    st = seg(st)
            else:
                st = td.make_train_step(ts, acfg, tcfg, d)(st)[0]
            torch.cuda.synchronize()
            ends.append(st)
        row = {"run": name, "n": n, "envs": B, "segments": segments,
               "steps": segments * tcfg.steps_per_call if segments else 1,
               **_differ(*ends), "seconds": time.perf_counter() - t0}
        out["repeat"][name] = row
        print(f"repeat: {json.dumps(row)}", flush=True)
        del ends, st
        torch.cuda.empty_cache()

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
