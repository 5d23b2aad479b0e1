"""Host timing of the port (``tpu2048/obs/profiler.py``, ``Timer``
copied).

The reference's ``device_trace`` wraps ``jax.profiler`` and is not
copied: the port's ``Trainer.run(trace_dir=...)`` raises until its
``torch.profiler`` counterpart lands (ROADMAP.md Queue 1 item 6).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator


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
