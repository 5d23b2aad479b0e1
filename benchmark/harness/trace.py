"""The traced window: a ``torch.profiler`` trace of the card and the
host, read into what the per-layer metrics and the breakdown need.

Only a run with ``--trace 1`` traces, and only its traced stretch: the
profiler slows the host's side of a step (by some 1.8x on the train
step), so no end-to-end metric is taken from a traced stretch.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple

import torch

DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Event(NamedTuple):
    name: str
    start: float  # µs
    dur: float  # µs


class Trace(NamedTuple):
    device: List[Event]  # the card's kernels, memsets and copies
    host: List[Event]  # the host's operators (cpu_op)
    start: float  # µs, the traced window's bounds on the trace's clock
    end: float
    wall_s: float  # the window's length on the host clock


class Traced:
    """``with Traced(device) as t: ...`` traces the block; ``t.trace`` is
    the result.  ``start()`` and ``stop()`` trace a stretch that begins
    and ends inside other code (each synchronises the card first)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.trace = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        sync(self.device)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        sync(self.device)
        wall = time.perf_counter() - self.t0
        self.prof.stop()
        self.trace = _read(self.prof, wall)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.stop()
        else:
            self.prof.stop()
        return False


def _read(prof, wall: float) -> Trace:
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        ev = Event(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
        if e.get("cat") in DEVICE_CATS:
            dev.append(ev)
        elif e.get("cat") == "cpu_op":
            host.append(ev)
    dev.sort(key=lambda e: e.start)
    host.sort(key=lambda e: e.start)
    if host or dev:
        start = min([e.start for e in host[:1] + dev[:1]])
        end = max([e.start + e.dur for e in host + dev])
    else:
        start = end = 0.0
    return Trace(dev, host, start, end, wall)


def busy_us(trace: Trace) -> float:
    """The time in which at least one device operation ran."""
    total, cur_s, cur_e = 0.0, None, None
    for e in trace.device:
        s, t = e.start, e.start + e.dur
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, t
        else:
            cur_e = max(cur_e, t)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_by_name(trace: Trace, top: int = 10) -> List[list]:
    tot: Dict[str, float] = defaultdict(float)
    for e in trace.device:
        tot[e.name[:64]] += e.dur * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            ][:top]


def idle_gaps(trace: Trace, top: int = 10) -> List[list]:
    """The card's idle gaps, each put down to the innermost host operator
    running at its middle (``host_outside_any_op`` where none ran),
    summed by that operator's name."""
    host = trace.host
    starts = [h.start for h in host]
    tot: Dict[str, float] = defaultdict(float)
    last = trace.start

    def owner(t: float) -> str:
        i = bisect.bisect_right(starts, t)
        best = None
        # the innermost open operator: the latest start that still covers t
        for h in reversed(host[max(0, i - 256): i]):
            if h.start + h.dur >= t:
                best = h
                break
        return best.name if best is not None else "host_outside_any_op"

    for e in trace.device + [Event("end", trace.end, 0.0)]:
        if e.start > last:
            tot[owner((last + e.start) / 2)] += (e.start - last) * 1e-6
        last = max(last, e.start + e.dur)
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            ][:top]


def kernel_us(trace: Trace, name: str) -> float:
    """Device µs of the operations whose name holds ``name``."""
    return sum(e.dur for e in trace.device if name in e.name)
