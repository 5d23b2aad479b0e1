"""One run of one cell: set-up, the window (or the traced stretch), the
check, and the result line."""

from __future__ import annotations

import importlib
import math
import sys
import time

import torch

from . import checks, spec
from .trace import busy_us, device_by_name, idle_gaps, sync

# the JAX stack and the JAX package, by top-level module name
BANNED = ("jax", "jaxlib", "flax", "tpu2048")


def banned_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(BANNED))


def driver(cell: spec.Cell, seed: int, device):
    """The cell's driver: ``Driver`` of ``harness/<driver>.py``, the
    module its traffic mix names."""
    mod = importlib.import_module("." + cell.traffic["driver"], __package__)
    return mod.Driver(cell.config, cell.traffic, seed, device)


def device_info(device) -> dict:
    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """The result object of one run (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, maybe ``breakdown``, and last
    ``checks``: each compared number beside its limit)."""
    d = driver(cell, seed, device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    d.setup()
    sync(device)
    metrics = {}
    extra = {}
    if not trace:
        setup_s = time.perf_counter() - t_start
        out = d.window(seconds)
        info = device_info(device)
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else out.get(m["name"])
            if value is None:
                raise KeyError(f"the driver measured no {m['name']!r}")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        ctx = d.traced(seconds)
        info = device_info(device)
        tr = ctx["trace"]
        ctx["busy_s"] = busy_us(tr) * 1e-6
        ctx["window_s"] = tr.wall_s
        for m in cell.per_layer:
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        info["busy_s"] = ctx["busy_s"]
        info["window_s"] = ctx["window_s"]
        extra["breakdown"] = {"device_ops": device_by_name(tr),
                              "idle_gaps": idle_gaps(tr)}
        out = ctx
    d.free()
    numbers = d.check()
    judged = checks.verdict(numbers, cell.limits)
    for v in metrics.values():
        if not math.isfinite(v["value"]):
            judged["correct"] = False
    result = {"correct": judged["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": info}
    result.update(extra)
    result["checks"] = judged["compared"]
    return result
