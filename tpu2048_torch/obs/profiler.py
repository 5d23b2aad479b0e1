"""Profiling hooks of the port (``tpu2048/obs/profiler.py``): a timing
context for the host loop (``Timer``, copied, its sections also spans),
and ``device_trace``, the reference's ``jax.profiler`` capture done
with ``torch.profiler``: a trace that TensorBoard's profiler plugin and
Perfetto read; ``device_events`` lists the card's work in a
``torch.profiler`` trace.

The program marks its stages with ``span(name)`` and counts what it
decides with ``count(name, n)``.  Both act only while a
``torch.profiler`` session records (``device_trace``, or any caller's
own): then a span is a ``record_function`` range, on the profiler's
clock in the same trace as the card's kernels (the card's side of it
is the trace's ``gpu_user_annotation`` range), and a count adds to
``counters``.  Otherwise each is one check and nothing else.

The spans, ``layer.stage``, nested as listed:

  * ``td.segment`` > ``td.step`` (K of them), ``td.merge``,
    ``td.symmetrize``; ``td.step`` > ``td.actor``, ``td.class_chain``,
    ``td.crosses``, ``td.env``, ``td.recorder``, ``td.episodes``,
    ``td.reset`` (``agent/td.py``);
  * ``trial.step`` > ``trial.engine``, ``search.base``,
    ``search.need_read``, ``search.compact``, ``search.tree``,
    ``trial.select``; ``search.tree`` > ``search.expand``,
    ``search.value``, ``search.backup`` at each level of the tree
    (``train/trial.py``, ``search/expectimax.py``); ``trial.read`` and
    ``trial.progress`` between segments;
  * ``Timer`` sections by their own names (``Trainer.run``'s
    ``train_segment``, ``metrics_read``, ``checkpoint``).

The counters: ``host_reads``, the search loop's reads that wait for
the card (the tier choice and the segment's read); ``search.steps``;
``search.roots_needy``, the roots that needed the tree;
``search.roots_expanded``, the roots the tree ran, padding included;
``td.index_rows``, the train actor's boards whose indices went through
``kernels.feature_index`` (``ops/dispatch.py``).
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import tempfile
import time
from typing import Dict, Iterator, Optional

import torch

# one shared context for every span while no profiler records
_OFF = contextlib.nullcontext()

# what ``count`` adds up while a profiler records; a reader takes it
# after its traced stretch
counters: Dict[str, int] = {}


def span(name: str):
    """A named stage of the program: a ``record_function`` range while
    a ``torch.profiler`` session records, else a shared no-op."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to ``counters[name]`` while a profiler records."""
    if torch.autograd._profiler_enabled():
        counters[name] = counters.get(name, 0) + n


class Timer:
    """Accumulating named wall-clock sections."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span(name):
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


def device_events(prof) -> list:
    """(name, start µs, duration µs) of every kernel, memset and copy
    the card ran under the finished ``torch.profiler`` run
    ``prof``, in start order, from its Chrome trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
              for e in trace["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy")]
    return sorted(events, key=lambda e: e[1])
