"""Profiling hooks of the port (``tpu2048/obs/profiler.py``): a timing
context for the host loop (``Timer``, copied), and ``device_trace``,
the reference's ``jax.profiler`` capture done with ``torch.profiler``:
a trace that TensorBoard's profiler plugin and Perfetto read.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Dict, Iterator, Optional


class Timer:
    """Accumulating named wall-clock sections."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            t = self.totals[name]
            lines.append(f"{name:24s} {t:9.3f}s  x{n}  ({t / n * 1e3:8.2f} ms/call)")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: Optional[str]) -> Iterator[None]:
    """``torch.profiler`` trace of the block (no-op when logdir is
    None): host activity, and the CUDA card's kernels and copies when a
    card is present, written under ``logdir`` as one Chrome trace,
    ``<host>_<pid>.<ms>.pt.trace.json`` (the name TensorBoard's
    ``tensorboard_trace_handler`` gives).

    With a card the trace must see it: a PyTorch without CUDA tracing
    raises before the block runs, and a trace that recorded no device
    activity (not even the one small kernel launched at its start to
    check just that) raises after it."""
    if not logdir:
        yield
        return
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, supported_activities

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        if ProfilerActivity.CUDA not in supported_activities():
            raise RuntimeError("device_trace: this PyTorch cannot trace the "
                               "CUDA card (no CUPTI)")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        if cuda:
            torch.ones(1, device="cuda").add_(1)  # the card's activity probe
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"{socket.gethostname()}_{os.getpid()}."
            f"{int(time.time() * 1e3)}.pt.trace.json"))
    # the profiler's raw events: its parsed ``events()`` would take
    # seconds on a long session's trace
    if cuda and not any(e.device_type() == DeviceType.CUDA
                        for e in prof.profiler.kineto_results.events()):
        raise RuntimeError("device_trace: the trace recorded no activity on "
                           "the CUDA card")
