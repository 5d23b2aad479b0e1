#!/usr/bin/env python3
"""Each stage of the program in a cell's traced stretch, on the card.

    python3 benchmark/tools/stages.py --out results/stages.jsonl \\
        --workload search-n5 --seeds 11,12,13

For each seed, in this one process: the cell's set-up and its traced
stretch, as a ``--trace 1`` run makes them (no check follows).  Each
line of ``--out`` is one stretch: per innermost program span
(``harness/spans.py::stage_table``) the card's µs and operations and
the idle µs whose gap middle falls in it, with ``outside_any_span``
for what falls in none, and each span's largest operations by name;
the stretch's steps, wall and busy seconds, the program's counters,
the device's name, and the per-layer metrics the cell reports.  A
program without spans puts everything outside.

The run's ``Trace`` keeps no span, so in this process the harness's
``trace._read`` is wrapped to read them from the trace it exports
(``keep_spans``); a run of ``run.py`` is left as it is.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, BENCH)
sys.path.insert(1, os.path.dirname(BENCH))


def keep_spans(kept: list) -> None:
    """Has each traced stretch of this process append its program spans
    to ``kept``: the profiler exports its trace once, so the harness's
    export is read here too (``harness/spans.py::read``)."""
    from harness import spans, trace

    orig = trace._read

    def _read(prof, wall):
        export = prof.export_chrome_trace

        def tee(path):
            export(path)
            kept.append(spans.read(path))

        prof.export_chrome_trace = tee
        return orig(prof, wall)

    trace._read = _read


def top_kernels(tr, owners, top: int = 5) -> dict:
    """Per innermost span, its operations' device µs by name (the first
    64 characters), the largest ``top``."""
    tot = defaultdict(lambda: defaultdict(float))
    for e, o in zip(tr.device, owners):
        tot[o][e.name[:64]] += e.dur
    return {o: sorted(k.items(), key=lambda kv: -kv[1])[:top]
            for o, k in tot.items()}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    import torch

    from harness import runner, spans, spec
    from harness.trace import busy_us

    torch.set_num_threads(1)
    cell = spec.load(args.workload)
    kept = []
    keep_spans(kept)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as out:
        for seed in (int(s) for s in args.seeds.split(",")):
            counters = spans.program_counters()
            if counters is not None:
                counters.clear()
            d = runner.driver(cell, seed, args.device)
            d.setup()
            ctx = d.traced(0.0)
            tr, sp = ctx["trace"], kept.pop()
            ctx["busy_s"] = busy_us(tr) * 1e-6
            ctx["window_s"] = tr.wall_s
            metrics = {}
            for m in cell.per_layer:
                v = spec.reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = v
            rec = {"workload": args.workload, "seed": seed,
                   "device": runner.device_info(args.device)["kind"],
                   "steps": ctx["steps"], "window_s": tr.wall_s,
                   "busy_s": ctx["busy_s"], "launches": len(tr.device),
                   "spans": len(sp.host), "device_spans": len(sp.device),
                   "counters": dict(counters or {}),
                   "stages": spans.stage_table(tr, sp),
                   "kernels": top_kernels(tr, spans.device_owners(tr, sp)),
                   "metrics": metrics}
            out.write(json.dumps(rec) + "\n")
            out.flush()
            print(json.dumps({k: rec[k] for k in (
                "workload", "seed", "steps", "window_s", "busy_s",
                "launches", "spans", "device_spans", "counters",
                "metrics")}), flush=True)
            d.free()
            del d
    return 0


if __name__ == "__main__":
    sys.exit(main())
