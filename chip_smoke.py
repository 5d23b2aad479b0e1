#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tpu2048_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one line of output each (the kernel phase one per precision):

  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: the CUDA kernels, compiled by nvcc from ``tpu2048_torch/ops/csrc``;
  3. kernel: ``eval_class`` in all three precisions against its plain
     PyTorch version at the three class shapes, at the serve batch
     B = 32768 (4 x 8192 afterstates) and a ragged B = 1001, within
     2^-20 of sum |terms|; then kernel and plain times at B = 32768,
     (17, 256, 256), timed with CUDA events;
  4. slice: a canonical-form n=5 agent with dyadic weights is saved in
     the reference's checkpoint format, loaded by the port onto the
     card, and plays 8192 games with ``table_ops="auto"`` (the kernel)
     and again with ``"gather"``; every value is exact in f32, so the
     two runs must agree exactly.

Then a JSON line of the kernels of the path (name, route, source, the
TPU kernel it replaces, its launches in the slice run, its largest
error against the plain version, and its and the plain version's time
in ms), and last ``{"ok": true, "device": {...}}``.  Any failure raises
and exits non-zero; without a CUDA card the script exits 1 before any
phase.  It imports no jax.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SERVE_GAMES = 8192
SERVE_B = 4 * SERVE_GAMES
RAGGED_B = 1001
SHAPES = [(17, 256, 256), (52, 64, 64), (24, 16, 16)]
PRECISIONS = ["bf16x2", "f32", "bf16"]
REL_TOL = 2.0**-20  # of sum |terms|: f32 summation order only


def _line(phase: str, **kw) -> None:
    print(f"{phase}: " + json.dumps(kw), flush=True)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script runs on a CUDA card only")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name}", flush=True)
    print(smi, flush=True)  # name and power limit, as nvidia-smi gives them
    _line("device_detail", torch=torch.__version__, cuda=torch.version.cuda,
          count=torch.cuda.device_count())
    return name


def phase_build() -> None:
    from tpu2048_torch.ops import build

    t0 = time.perf_counter()
    path = build.build_library()
    build.load_library()
    seconds = time.perf_counter() - t0
    log = path.with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    _line("build", seconds=round(seconds, 3), library=path.name,
          ptxas=ptxas)


def _inputs(g, h, l, b, seed, dev):
    rng = np.random.default_rng(seed)
    tables = rng.standard_normal((g, h, l)).astype(np.float32)
    hi = rng.integers(0, h, (b, g)).astype(np.int32)
    lo = rng.integers(0, l, (b, g)).astype(np.int32)
    return (torch.from_numpy(tables).to(dev), torch.from_numpy(hi).to(dev),
            torch.from_numpy(lo).to(dev))


def _device_ms(fn, reps: int = 7, inner: int = 20):
    """Median, min and max device time of one ``fn()`` in ms.  A sleep
    kernel holds the stream while the host enqueues ``inner`` calls, so
    the events time the calls back to back on the card, not the host's
    launch rate."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times), min(times), max(times)


def phase_kernel() -> dict:
    from tpu2048_torch.ops import kernels

    dev = torch.device("cuda")
    worst = {}
    for precision in PRECISIONS:
        max_abs, max_ratio = 0.0, 0.0
        for g, h, l in SHAPES:
            for b in (SERVE_B, RAGGED_B):
                tables, hi, lo = _inputs(g, h, l, b, seed=b + g, dev=dev)
                got = kernels.eval_class(tables, hi, lo, precision)
                torch.cuda.synchronize()
                ref_t = (tables.to(torch.bfloat16).float()
                         if precision == "bf16" else tables)
                want = kernels.eval_class_reference(ref_t, hi, lo, "f32")
                gi = torch.arange(g, device=dev)
                scale = ref_t[gi, hi.long(), lo.long()].abs().sum(dim=-1)
                err = (got - want).abs()
                if not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"{precision} {g,h,l} B={b}: "
                                         "non-finite kernel output")
                max_abs = max(max_abs, float(err.max()))
                max_ratio = max(max_ratio, float((err / scale).max()))
        if max_ratio > REL_TOL:
            raise AssertionError(
                f"eval_class {precision}: error {max_ratio:.3g} of "
                f"sum|terms| exceeds {REL_TOL:.3g}")
        worst[precision] = max_abs
        _line("kernel_check", precision=precision, max_abs_err=max_abs,
              max_err_over_sum_abs=max_ratio, bound=REL_TOL,
              shapes=SHAPES, batches=[SERVE_B, RAGGED_B])

    g, h, l = SHAPES[0]
    tables, hi, lo = _inputs(g, h, l, SERVE_B, seed=7, dev=dev)
    times = {}
    for precision in PRECISIONS:
        k = _device_ms(lambda: kernels.eval_class(tables, hi, lo, precision))
        p = _device_ms(
            lambda: kernels.eval_class_reference(tables, hi, lo, precision))
        times[precision] = (k, p)
        _line("kernel_time", precision=precision, shape=[g, h, l],
              batch=SERVE_B, kernel_ms_median_min_max=list(k),
              plain_ms_median_min_max=list(p))
    return {"max_abs_err": worst["bf16x2"], "ms": times["bf16x2"][0][0],
            "plain_ms": times["bf16x2"][1][0]}


def phase_slice() -> int:
    from tpu2048.config import AgentConfig
    from tpu2048.store.artifacts import LocalStore
    from tpu2048.store.checkpoint import save_agent
    from tpu2048_torch.features.canonical import is_canonical
    from tpu2048_torch.features.ntuple import get_tuple_set
    from tpu2048_torch.ops import kernels
    from tpu2048_torch.store.checkpoint import load_agent_dense
    from tpu2048_torch.train.trial import trial

    acfg = AgentConfig()  # n=5, canonical-orbit form
    assert acfg.n == 5 and is_canonical(acfg)
    ts = get_tuple_set(acfg.n)
    # integers in [0, 40] x 2^-12, about the reference's U[0, 0.01)
    # init; every sum of 21 of them is exact in f32 in any order
    rng = np.random.default_rng(0)
    w_np = (rng.integers(0, 41, ts.total) * 2.0**-12).astype(np.float32)
    with tempfile.TemporaryDirectory() as root:
        store = LocalStore(root)
        save_agent(store, "smoke", acfg, w_np)
        _, w, _ = load_agent_dense(store, "smoke", device="cuda")
    assert w.device.type == "cuda" and w.shape == (ts.total,)

    kernels.eval_class.launches = 0
    t0 = time.perf_counter()
    r_kernel = trial(ts, w, num=SERVE_GAMES, seed=0, table_ops="auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.eval_class.launches
    if launches == 0:
        raise AssertionError("the slice never launched eval_class")

    r_gather = trial(ts, w, num=SERVE_GAMES, seed=0, table_ops="gather")
    if kernels.eval_class.launches != launches:
        raise AssertionError("the gather run launched eval_class")
    for name in ("scores", "odometers", "final_boards", "tiles"):
        a, b = getattr(r_kernel, name), getattr(r_gather, name)
        if not np.array_equal(a, b):
            raise AssertionError(f"kernel and gather runs differ in {name}")
    odos = r_kernel.odometers
    if odos.min() <= 0 or odos.max() >= 32768:
        raise AssertionError("not every game was played to its end")
    best = int(np.argmax(r_kernel.scores))
    bg = r_kernel.best_game
    if bg is None or bg["score"] != r_kernel.scores[best] or not \
            np.array_equal(bg["final_board"], r_kernel.final_boards[best]):
        raise AssertionError("the best game's replay does not reproduce it")
    total_moves = int(odos.sum())
    _line("slice", games=SERVE_GAMES, n=acfg.n, weights=int(ts.total),
          avg_score=float(r_kernel.scores.mean()), total_moves=total_moves,
          max_moves=int(odos.max()), elapsed_s=r_kernel.elapsed,
          wall_s=wall, moves_per_s=total_moves / r_kernel.elapsed,
          gather_elapsed_s=r_gather.elapsed,
          gather_moves_per_s=total_moves / r_gather.elapsed,
          eval_class_launches=launches, kernel_equals_gather=True)
    return launches


def main() -> int:
    name = phase_device()
    phase_build()
    kstats = phase_kernel()
    launches = phase_slice()
    if "jax" in sys.modules:
        raise AssertionError("the port loaded jax")
    print(json.dumps({"kernels": [{
        "name": "eval_class",
        "route": "cuda",
        "source": "tpu2048_torch/ops/csrc/eval_class.cu",
        "replaces": "tpu2048/ops/pallas_kernels.py:131",
        "launches": launches,
        **kstats,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
