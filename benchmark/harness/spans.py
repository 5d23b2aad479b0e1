"""The program's own spans and counters in a traced stretch.

The port marks its stages with ``tpu2048_torch.obs.profiler.span``: a
``record_function`` range while a profiler records, so each is in the
profiler's trace twice, on the host (``user_annotation``) and as the
range of the card's work that it launched (``gpu_user_annotation``), on
the profiler's one clock.  ``counters`` of the same module count while
the stretch records.  A program without spans has neither range, and a
program without counters has none: the readers then report nothing.

The run's ``Trace`` (``harness/trace.py``) keeps neither kind of range,
so no per-layer metric reads the spans: ``read`` takes them from the
profiler's Chrome trace, and ``tools/stages.py`` tables them by stage.
The counters are read by ``metrics/search.host_reads_per_step.py`` and
``metrics/search.tree_root_use.py``.

- A device operation goes to the innermost device range that holds its
  middle.  The port runs one stream, so the card's ranges nest as their
  host spans do, and a range holds only operations its span launched.
- An idle gap of the card goes to the host spans open at its middle,
  the rule ``trace.idle_gaps`` uses for the host's operators.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

from .trace import Event, Trace

OUTSIDE = "outside_any_span"


class Spans(NamedTuple):
    host: List[Event]  # the spans on the host (user_annotation)
    device: List[Event]  # their ranges on the card (gpu_user_annotation)


def read(path: str) -> Spans:
    """The program's spans in a profiler's exported Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kept = {"user_annotation": [], "gpu_user_annotation": []}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in kept:
            kept[e["cat"]].append(
                Event(e["name"], float(e["ts"]), float(e.get("dur", 0.0))))
    host, device = (sorted(kept[c], key=lambda s: (s.start, -s.dur))
                    for c in ("user_annotation", "gpu_user_annotation"))
    return Spans(host, device)


def _chains(spans: Sequence[Event], points: Sequence[float]
            ) -> List[Tuple[str, ...]]:
    """For each of the ``points`` (µs), the names of the spans open at
    it, outermost first.  ``spans`` nest or are disjoint."""
    spans = sorted(spans, key=lambda s: (s.start, -s.dur))
    order = sorted(range(len(points)), key=lambda i: points[i])
    out: List[Tuple[str, ...]] = [()] * len(points)
    stack: List[Event] = []
    i = 0
    for j in order:
        t = points[j]
        while i < len(spans) and spans[i].start <= t:
            s = spans[i]
            # a span that ends where the next starts is closed
            while stack and stack[-1].start + stack[-1].dur <= s.start:
                stack.pop()
            stack.append(s)
            i += 1
        while stack and stack[-1].start + stack[-1].dur < t:
            stack.pop()
        out[j] = tuple(s.name for s in stack)
    return out


def device_owners(trace: Trace, spans: Spans) -> List[str]:
    """The innermost device range of each of ``trace.device``'s
    operations (``OUTSIDE`` where none holds it)."""
    chains = _chains(spans.device,
                     [e.start + e.dur / 2 for e in trace.device])
    return [c[-1] if c else OUTSIDE for c in chains]


def gaps(trace: Trace) -> List[Tuple[float, float]]:
    """The card's idle gaps in the stretch, (start, length) in µs, as
    ``trace.idle_gaps`` finds them."""
    out, last = [], trace.start
    for e in trace.device + [Event("end", trace.end, 0.0)]:
        if e.start > last:
            out.append((last, e.start - last))
        last = max(last, e.start + e.dur)
    return out


def gap_chains(trace: Trace, spans: Spans
               ) -> List[Tuple[Tuple[str, ...], float]]:
    """Each idle gap's open host spans at its middle, with its length."""
    gs = gaps(trace)
    chains = _chains(spans.host, [a + d / 2 for a, d in gs])
    return [(c, d) for c, (_, d) in zip(chains, gs)]


def stage_table(trace: Trace, spans: Spans) -> Dict[str, Dict[str, float]]:
    """Per innermost span: device µs and operations (by the card's
    ranges), and idle µs (by the host spans at each gap's middle);
    ``OUTSIDE`` holds what falls in no span."""
    tab: Dict[str, Dict[str, float]] = defaultdict(
        lambda: {"device_us": 0.0, "launches": 0, "idle_us": 0.0})
    for e, o in zip(trace.device, device_owners(trace, spans)):
        tab[o]["device_us"] += e.dur
        tab[o]["launches"] += 1
    for c, d in gap_chains(trace, spans):
        tab[c[-1] if c else OUTSIDE]["idle_us"] += d
    return dict(tab)


def program_counters() -> Optional[Dict[str, int]]:
    """The program's ``counters``; None for a program without them."""
    from tpu2048_torch.obs import profiler

    return getattr(profiler, "counters", None)
