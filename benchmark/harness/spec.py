"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root lists the cells and metrics.
A cell names a configuration, ``configs/<config>.json``, and a traffic
mix, ``traffic/<traffic>.json``, which names its driver,
``harness/<driver>.py``; each per-layer metric has a reader,
``metrics/<metric>.py``; each cell's limits of ``correct`` are in
``limits/<cell>.json``.  Nothing here knows a cell, a mix or a metric by
name: a later one is a new file and a new entry.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List, NamedTuple

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]  # the cell's end-to-end metrics
    per_layer: List[dict]  # the cell's per-layer metrics
    limits: Dict[str, float]


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    # a per-layer metric without the key: every cell that reports the
    # end-to-end metric it moves
    return metric.get("moves", metric["name"]) in e2e_names


def load(workload: str, bench_file: str = None) -> Cell:
    bench = _json(bench_file or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise KeyError(f"workload {workload!r} names an unknown "
                       f"configuration {w['config']!r}")
    config = _json(os.path.join(ROOT, configs[w["config"]]["file"]))
    traffic_file = os.path.join(BENCH, "traffic", w["traffic"] + ".json")
    if not os.path.isfile(traffic_file):
        raise KeyError(f"no traffic mix {w['traffic']!r} "
                       f"(traffic/{w['traffic']}.json)")
    traffic = _json(traffic_file)
    driver_path(traffic.get("driver", ""))
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, names)]
    for m in per_layer:
        reader_path(m["name"])  # every reader exists before the run
    limits = _json(os.path.join(BENCH, "limits", workload + ".json"))
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer,
                limits["limits"])


def driver_path(name: str) -> str:
    """``harness/<name>.py``, the module whose ``Driver`` runs a mix."""
    path = os.path.join(BENCH, "harness", name + ".py")
    if not name.isidentifier() or not os.path.isfile(path):
        raise KeyError(f"no traffic driver {name!r} (harness/{name}.py)")
    return path


def reader_path(metric: str) -> str:
    path = os.path.join(BENCH, "metrics", metric + ".py")
    if not os.path.isfile(path):
        raise KeyError(f"no reader for per-layer metric {metric!r} "
                       f"(metrics/{metric}.py)")
    return path


def reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
        reader_path(metric))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

