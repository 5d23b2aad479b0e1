#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tpu2048_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, one line of output each (the kernel phases one per check):

  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: the CUDA kernels, compiled by nvcc from ``tpu2048_torch/ops/csrc``
     (one nvcc per source, all at once);
  3. kernel: ``eval_class`` in all three precisions against its plain
     PyTorch version at the three class shapes, at the serve batch
     B = 32768 (4 x 8192 afterstates) and a ragged B = 1001, within
     2^-20 of sum |terms|, and bitwise against the ordered f32
     accumulation of its terms (``eval_class_ordered``; RNE bf16 terms
     for "bf16"); then at (17, 256, 256) the kernel's, the plain
     version's and one library call's time (``embedding_bag``, sum),
     timed with CUDA events, at B = 32768 and at the bootstrap's
     B = 8192, each beside its bound and its earlier reading;
  4. slice: a canonical-form n=5 agent with dyadic weights is saved
     through the port's ``store.checkpoint.save_agent`` (the
     reference's format), loaded onto the card, and plays 8192 games
     with ``table_ops="auto"`` (the kernel) and again with
     ``"gather"``; every value is exact in f32, so the two runs must
     agree exactly;
  5. grad_class: the class-gradient kernel against its plain version
     at the three class shapes, B = 8192 and a ragged B = 1001, half
     the rows invalid, with random indices and with every row on one
     entry (a fresh start's collision), and on the train step's own
     rows (``prev_idx`` split into hi and lo, with ``prev_valid``) one
     step after a fresh start at n=5, 3 and 2 (the three shapes): one
     contiguous (2, G, H, L) pair, hits bitwise, dsum within hits *
     2^-23 * (sum of |dw| at the entry), the bound between two f32
     summation orders, and the whole pair bitwise with dyadic dw on
     the same rows; a valid row's bad index shows as NaN; then kernel,
     plain and library (``index_add_`` pair) times beside the bound,
     the earlier reading and each case's collision profile (distinct
     entries per tuple, the most rows on one entry) for the random,
     colliding and fresh-start rows, and, after phase 8, the same
     check and times on the rows of the trainer's last step
     (mid-training);
  6. fold_class: the D4 class-fold kernel bitwise against the plain
     ``symmetrize_class_sum`` on random pairs (the 16^4 class at n=4
     and n=5, the 16^3 class at n=3, the 16^2 class at n=2); then
     kernel and plain times beside the bound and the earlier reading (no
     library call computes a D4 orbit sum);
  7. train_step: one n=5 train step of 8192 envs through the kernels
     on the card and through their plain versions on the CPU, from one
     state (two warm steps on the card) with dyadic weights and the
     same numpy draws: every integer of the state and the staged
     recorder rows bitwise, the weights and TC sums within 2^-17 of the
     table's largest entry;
  8. train: ``Trainer.run`` at the shipped defaults (n=5, 8192 envs,
     K=64) for 12 segments: every step launched each kernel, the
     weights are finite, episodes completed, the saved best game
     replays to its score, and the checkpoint loads through the port's
     ``load_agent`` and plays 256 games; env-steps/s, wall per
     segment, and the ma-100 of the first and last windows (the
     learning signal);
  9. search: ``eval_class`` "bf16" at the search tree's largest chunk,
     B = 2,000,000 rows of the (17, 256, 256) class, against its plain
     version within 2^-20 of sum |terms| and bitwise against the
     ordered accumulation, timed with the plain version and the
     library call beside its bound and its earlier reading; then the
     phase-4 agent plays 256 games with depth-3 / width-4 /
     since_empty=6 expectimax through ``trial`` with
     ``table_ops="auto"`` (the tree's values through the kernel in
     bf16) and again with ``"gather"``, from one seed: dyadic weights
     are exact in bf16, so the games must agree exactly; both paths
     are warmed first on crowded boards, and each plays twice, timed
     in the order kernel, gather, gather, kernel; the kernel's
     launches on this path (its first run), the compaction-tier
     histogram, tree chunks per step, ms per move of all four runs,
     and the best game's replay;
 10. train_variant_check: the learner settings off the defaults
     (``VARIANTS``: sgd with "fold", TC with "index" (``grad_class`` at
     8 x 8192 rows), sgd "index" "sum" (the updater), canonical sgd,
     canonical TC "sum", the "bf16x2" actor, the cells engine, and one
     K=2 "periodic" segment from a fresh state), each checked as in
     phase 7 at n=5 and 8192 envs, with the kernels each launched,
     except that each table entry may also differ by its f32
     summation-order bound (``_order_slack``); then ``grad_class``
     checked and timed as in phase 5 on the "index" step's 65,536 rows;
 11. train_variant: ``Trainer.run`` of the reference's own rule
     (``optimizer="sgd", alpha=0.25, sym_impl="index"``) at n=5, 8192
     envs, K=64 for 6 segments: ``eval_class`` twice a step,
     ``grad_class`` once, ``fold_class`` never; the weights finite,
     the best game replays; the checkpoint resumes on the card (its
     generator's stream continued) and on the CPU (a fresh stream,
     logged); env-steps/s and the first and last ma-100;
 12. flagship: at n=6 (95.7 M entries) and n=7 (206.6 M) one train
     step of 8192 envs on the card against the CPU, checked as in phase
     10; then ``Trainer.run`` of ``AgentConfig(n=6)`` at the shipped
     ``TrainConfig()`` width (8192 envs, all recorded, K=64) for 8
     segments: every kernel launched on every step, the ma-100 rises,
     the best game replays, the checkpoint loads and plays 256 games;
     and 2 segments at n=7; env-steps/s, the card's peak allocated
     memory and the launches per step of each;
 13. mesh: ``distributed.initialize`` with a coordinator on localhost
     (NCCL, one rank) and ``Trainer(mesh=global_mesh(MeshConfig(1, 1)))``.
     One n=5 step of 8192 envs through the mesh on the card against
     the unmeshed CPU step, checked as in phase 10; one segment of the
     defaults at full width through the mesh and one without it, from
     one seed: launches per step, collectives per step and their bytes
     (counted by ``Mesh``, held against the step's shapes), env-steps/s
     of both as a reading, and how many games differ after the segment
     between the two and between two unmeshed runs (the card's atomics
     add in no fixed order and temporal coherence amplifies the
     difference, so whole runs are not held bitwise: steps are);
 14. fixed_order: ``scatter_add_ordered``, the sparse apply of the mesh
     path, twice on the card from one non-dyadic, heavily colliding
     list: bitwise the same table, and within the summation-order bound
     of ``index_add_``; and one mesh step twice from one mid-training
     state: the gather classes' entries of the weights and both TC sums
     bitwise the same (replicas that apply one gathered list stay
     equal);
 15. two_ranks: two gloo ranks on this machine's CPU, started by this
     script (one card cannot hold two NCCL ranks), train one n=5
     segment of 64 envs; boards, scores, odometers, rings, logs and the
     best game equal the one-rank CPU run's bitwise, the tables within
     2^-17, and the two replicas are bitwise equal; with two or more
     cards the same on two NCCL ranks against the one-card run's tables
     (with one card the line says that this was not run);
 16. apps: the port's HTTP server (``apps/server.py``) over an
     ``AppService`` with no device argument, so on the card, driven over
     HTTP with ``urllib``: a train job of a new n=5 agent at the shipped
     width (8192 envs, K=64) to APP_EPISODES episodes (a checkpoint and
     ma-100 lines in its log, the chart and the agent listed), launching
     every kernel on every step; a long job then stopped ("training
     cancelled"); a 1000-game greedy test job through ``eval_class``
     whose best game replays to its logged score; a device watch at
     depth 1 / width 2 through ``eval_class`` (legal moves, scores that
     never fall); ``/api/stats`` reading the card's memory and name; the
     phase's seconds, the train job's env-steps/s, the test job's
     moves/s and each job's launches;
 17. trace: ``Trainer.run(trace_dir=...)`` of the defaults at the shipped
     width for TRACE_SEGMENTS segments: the ``torch.profiler`` trace holds
     one kernel event per launch of each wrapper (and ``grad_class``'s
     fill) among the step's other kernels; its bytes, events, kernel
     events per step and the kernels' histogram by device time, and
     env-steps/s beside an untraced run's, as a reading;
 18. model_axis: the mesh's model axis.  First the tuple-range launches
     of n=4's split class (tuples 0-8 and 9-16 of a (17, 256, 256)
     table): ``eval_class`` bitwise against its ordered sum and
     ``grad_class`` checked as in phase 5, both timed.  Then two ranks of
     this script (``--model-rank``) on the one card, over gloo
     (``distributed.initialize(backend="gloo")``), on a
     ``MeshConfig(data=1, model=2)`` mesh: (a) one step of 8192 envs at
     n=6 (the 16^4 class whole on rank 0) and at n=4 (the class split
     9/8 by tuples), from one CPU-made state with dyadic weights and the
     same draws, the tables reassembled by ``host_full`` and held
     against the unmeshed CPU step as in phase 10; (b) ``Trainer.run``
     of ``AgentConfig(n=6)`` at the shipped width for
     MODEL_AXIS_SEGMENTS segments: every kernel launched on every step
     by the rank that holds the class, none by the other; the ranks'
     replicated leaves bitwise equal; each rank's shard, peak allocated
     memory and collectives (held against the step's shapes and the
     save's reads); env-steps/s as a reading; the checkpoint (the whole
     tables) loads on the card, plays 256 games, and its best game
     replays.  With two or more cards the same on two NCCL ranks; with
     one the line says that this was not run.

Then a JSON line of the kernels of the paths (name, route,
source, the TPU kernel it replaces, its launches in the serve, train,
search, train_variant, flagship, n7, mesh, apps and model_axis runs (the
last the two ranks' sum), its largest error
against the plain
version, its, the plain version's and the library call's time in ms,
and its bound:
the bytes it must move, each input read once and each output written
once, over 3.35 TB/s; every timed shape under ``instances``), and last
``{"ok": true, "device": {...}}``.
Any failure raises and exits non-zero; without a CUDA card the script
exits 1 before any phase.  It imports nothing of jax or ``tpu2048``.

``python3 chip_smoke.py --rank <rendezvous> <ranks> <rank> <device>
<out>`` is one rank of phase 15, and ``python3 chip_smoke.py
--model-rank <rendezvous> <rank> <backend> <out>`` one of phase 18,
started by the script itself.
"""

from __future__ import annotations

import json
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SERVE_GAMES = 8192
SERVE_B = 4 * SERVE_GAMES
TRAIN_B = 8192  # envs of the shipped TrainConfig
TRAIN_SEGMENTS = 12
VARIANT_SEGMENTS = 6
FLAGSHIP_SEGMENTS = 8  # n=6 at the shipped width
N7_SEGMENTS = 2
RANKS_ENVS = 64  # phase 15's width: small enough that no argmax flips
RANKS_TIMEOUT = 300  # seconds for phase 15's ranks, then they are killed
MODEL_AXIS_SEGMENTS = 4  # phase 18's n=6 run on two ranks
MODEL_AXIS_TIMEOUT = 300  # seconds for phase 18's ranks, then they are killed
APP_EPISODES = 2000  # phase 16's train job: a few segments at 8192 envs
APP_TEST_GAMES = 1000
APP_WATCH_FRAMES = 10
APP_WAIT_S = 300  # the longest phase 16 waits for one job
TRACE_SEGMENTS = 2  # phase 17's traced run
TRACE_TOP = 12  # kernels of the traced step's histogram printed by name
# the traced step's kernels by kind: the first kind whose text is in a
# kernel's name takes it
KERNEL_KINDS = [("eval_class", "eval_class_kernel"),
                ("grad_class", "grad_class_kernel"),
                ("grad_class fill", "zero_pair"),
                ("fold_class", "fold_class_kernel"),
                ("advanced-index gather", "index_elementwise_kernel"),
                ("engine gather", "vectorized_gather_kernel"),
                ("index_add_", "indexFuncLargeIndex"),
                ("index_put_", "index_put"),
                ("reduction", "reduce_kernel"),
                ("copy/convert", "direct_copy_kernel"),
                ("fill/zero", "FillFunctor"),
                ("cat/stack", "CatArrayBatchedCopy"),
                ("scan", "scan"),
                ("sort", "sort"),
                ("elementwise", "elementwise_kernel")]
# the learner settings off the defaults (phase 10), at n=5 through
# table_ops="pallas"; "sum" at a small alpha, where 8192 envs' summed
# updates stay small
VARIANTS = {
    "sgd_fold": dict(optimizer="sgd", alpha=0.25, sym_impl="fold"),
    "tc_index": dict(sym_impl="index"),
    "sgd_index_sum": dict(optimizer="sgd", alpha=2.0**-10, sym_impl="index",
                          update_mode="sum"),
    "sgd_canonical": dict(optimizer="sgd", alpha=0.25),
    "tc_canonical_sum": dict(alpha=2.0**-4, update_mode="sum"),
    "bf16x2_actor": dict(actor_precision="bf16x2"),
    "cells": dict(engine_mode="cells"),
    "tc_periodic_segment": dict(sym_mode="periodic"),
}
RAGGED_B = 1001
SEARCH_GAMES = 256
SEARCH_B = 2_000_000  # leaf rows of one chunk of the search tree
SHAPES = [(17, 256, 256), (52, 64, 64), (24, 16, 16)]
PRECISIONS = ["bf16x2", "f32", "bf16"]
REL_TOL = 2.0**-20  # of sum |terms|: f32 summation order only
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published, at 700 W
# the kernels' earlier readings at the same shapes, before each one's
# redesign for the H100 (PERF.md section 6, NVIDIA H100
# 80GB HBM3, 700.00 W), printed on the *_time lines beside this run's
# (not in the kernels line, whose numbers are all of this run)
EARLIER_MS = {("eval_class", "bf16", 32768): 0.010267,
              ("eval_class", "bf16x2", 32768): 0.007419,
              ("eval_class", "f32", 32768): 0.007429,
              ("eval_class", "bf16", SEARCH_B): 0.4040,
              ("grad_class", "random", TRAIN_B): 0.01020,
              ("grad_class", "collide", TRAIN_B): 0.02140,
              ("fold_class", "n=5", 17): 0.062832}


def _bound_ms(nbytes: float) -> float:
    """The least time of moving ``nbytes`` through device memory."""
    return 1e3 * nbytes / HBM_BYTES_PER_S


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


def _grad_inputs(g, h, l, b, seed, dev, collide=False):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, h, (b, g)).astype(np.int32)
    lo = rng.integers(0, l, (b, g)).astype(np.int32)
    if collide:  # a fresh start: every row on one entry of each table
        hi[:] = lo[:] = 0
    dw = rng.standard_normal(b).astype(np.float32)
    valid = rng.random(b) < 0.5
    return [torch.from_numpy(a).to(dev) for a in (hi, lo, dw, valid)]


def _dyadic(total: int, seed: int) -> np.ndarray:
    """Integers in [0, 40] x 2^-12, about the reference's U[0, 0.01)
    init: every sum of up to 2^12 of them is exact in f32 in any order,
    and each is exact in bf16."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 41, total) * 2.0**-12).astype(np.float32)


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


def _eval_library(tables, hi, lo, precision):
    """(one-call library function, its flat indices) for
    ``eval_class``: ``embedding_bag`` (sum) of the flat indices
    ``g*H*L + hi*L + lo`` into the (G*H*L, 1) table, RNE-rounded for
    "bf16"; indices and table are made here, outside any timing."""
    g, h, l = tables.shape
    gi = torch.arange(g, device=tables.device)
    flat = (gi * h * l + hi.long() * l + lo.long()).contiguous()
    table = (tables.to(torch.bfloat16).float() if precision == "bf16"
             else tables).reshape(-1, 1).contiguous()

    def call():
        return torch.nn.functional.embedding_bag(flat, table, mode="sum")

    return call, flat


def _eval_bytes(tables, hi, flat) -> int:
    """Bytes ``eval_class`` must move on these inputs: the table
    entries the indices touch, hi and lo, and the output."""
    touched = int(torch.unique(flat).numel())
    return 4 * touched + 2 * hi.numel() * 4 + hi.shape[0] * 4


def _eval_time(tables, hi, lo, precision, inner=20) -> dict:
    """Kernel, plain and library times of ``eval_class`` on these
    inputs, the library call checked, and the bound."""
    from tpu2048_torch.ops import kernels

    lib, flat = _eval_library(tables, hi, lo, precision)
    want = kernels.eval_class_ordered(tables, hi, lo, precision)
    got_lib = lib()[:, 0]
    scale = kernels.eval_class_reference(tables.abs(), hi, lo, precision)
    if not bool(((got_lib - want).abs() <= REL_TOL * scale).all()):
        raise AssertionError("embedding_bag disagrees with eval_class")
    k = _device_ms(lambda: kernels.eval_class(tables, hi, lo, precision),
                   inner=inner)
    p = _device_ms(lambda: kernels.eval_class_reference(tables, hi, lo,
                                                        precision),
                   inner=inner)
    q = _device_ms(lib, inner=inner)
    nbytes = _eval_bytes(tables, hi, flat)
    b = hi.shape[0]
    row = {"precision": precision, "shape": list(tables.shape), "batch": b,
           "ms": k[0], "plain_ms": p[0], "library_ms": q[0],
           "bound_ms": _bound_ms(nbytes), "bytes": nbytes,
           "bound_share": _bound_ms(nbytes) / k[0]}
    _line("kernel_time", kernel="eval_class", **row,
          earlier_ms=EARLIER_MS.get(("eval_class", precision, b))
          if tuple(tables.shape) == SHAPES[0] else None,
          kernel_ms_median_min_max=list(k), plain_ms_median_min_max=list(p),
          library="embedding_bag(mode='sum')",
          library_ms_median_min_max=list(q))
    return row


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
                if not torch.equal(got, kernels.eval_class_ordered(
                        tables, hi, lo, precision)):
                    raise AssertionError(
                        f"{precision} {g,h,l} B={b}: not bitwise the ordered "
                        "f32 accumulation of its terms")
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
              bitwise_ordered=True, shapes=SHAPES,
              batches=[SERVE_B, RAGGED_B])

    g, h, l = SHAPES[0]
    rows = []
    for b in (SERVE_B, TRAIN_B):
        tables, hi, lo = _inputs(g, h, l, b, seed=7, dev=dev)
        for precision in PRECISIONS:
            rows.append(_eval_time(tables, hi, lo, precision))
    # the entry's headline: the selection pass's "bf16" at 4 x 8192 rows
    head = next(r for r in rows if r["precision"] == "bf16"
                and r["batch"] == SERVE_B)
    return {"max_abs_err": max(worst.values()), "ms": head["ms"],
            "plain_ms": head["plain_ms"], "library_ms": head["library_ms"],
            "bound_ms": head["bound_ms"], "instances": rows}


def _served_agent():
    """(tuple set, dense weights on the card) of a canonical-form n=5
    agent with dyadic weights, saved in the reference's checkpoint
    format and loaded by the port."""
    from tpu2048_torch.config import AgentConfig
    from tpu2048_torch.features.canonical import is_canonical
    from tpu2048_torch.features.ntuple import get_tuple_set
    from tpu2048_torch.store.artifacts import LocalStore
    from tpu2048_torch.store.checkpoint import load_agent_dense, save_agent

    acfg = AgentConfig()  # n=5, canonical-orbit form
    assert acfg.n == 5 and is_canonical(acfg)
    ts = get_tuple_set(acfg.n)
    w_np = _dyadic(ts.total, 0)
    with tempfile.TemporaryDirectory() as root:
        store = LocalStore(root)
        save_agent(store, "smoke", acfg, w_np)
        _, w, _ = load_agent_dense(store, "smoke", device="cuda")
    assert w.device.type == "cuda" and w.shape == (ts.total,)
    return ts, w


def _check_replay(r, what: str) -> None:
    """The best game's record replays to its score and final board."""
    best = int(np.argmax(r.scores))
    bg = r.best_game
    if bg is None or bg["score"] != r.scores[best] or not \
            np.array_equal(bg["final_board"], r.final_boards[best]):
        raise AssertionError(f"{what}: the best game's replay does not "
                             "reproduce it")


def _check_same_games(a, b, what: str) -> None:
    for name in ("scores", "odometers", "final_boards", "tiles"):
        if not np.array_equal(getattr(a, name), getattr(b, name)):
            raise AssertionError(f"{what}: kernel and gather runs differ "
                                 f"in {name}")


def phase_slice() -> int:
    from tpu2048_torch.ops import kernels
    from tpu2048_torch.train.trial import trial

    ts, w = _served_agent()

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
    _check_same_games(r_kernel, r_gather, "slice")
    odos = r_kernel.odometers
    if odos.min() <= 0 or odos.max() >= 32768:
        raise AssertionError("not every game was played to its end")
    _check_replay(r_kernel, "slice")
    total_moves = int(odos.sum())
    _line("slice", games=SERVE_GAMES, n=ts.n, weights=int(ts.total),
          avg_score=float(r_kernel.scores.mean()), total_moves=total_moves,
          max_moves=int(odos.max()), elapsed_s=r_kernel.elapsed,
          wall_s=wall, moves_per_s=total_moves / r_kernel.elapsed,
          gather_elapsed_s=r_gather.elapsed,
          gather_moves_per_s=total_moves / r_gather.elapsed,
          eval_class_launches=launches, kernel_equals_gather=True)
    return launches


def _grad_check(hi, lo, dw, valid, h, l, what: str) -> tuple:
    """``grad_class`` on these rows against its plain version: one
    contiguous (2, G, H, L) pair, hits bitwise, dsum within hits *
    2^-23 * (sum of |dw| at the entry), and with dyadic dw on the same
    rows (every sum exact in any order) the whole pair bitwise.
    Returns (largest |dsum error|, largest error over its bound)."""
    from tpu2048_torch.ops import kernels

    b, g = hi.shape
    pair = kernels.grad_class(hi, lo, dw, valid, h, l)
    torch.cuda.synchronize()
    if pair.shape != (2, g, h, l) or not pair.is_contiguous():
        raise AssertionError(f"grad_class {what}: not one contiguous "
                             f"(2, {g}, {h}, {l}) pair")
    want = kernels.grad_class_reference(hi, lo, dw, valid, h, l)
    if not torch.equal(pair[1], want[1]):
        raise AssertionError(f"grad_class {what}: hits differ from the "
                             "plain version")
    mass = kernels.grad_class_reference(hi, lo, dw.abs(), valid, h, l)[0]
    err = (pair[0] - want[0]).abs()
    bound = 2.0**-23 * want[1] * mass
    if not bool((err <= bound).all()):
        raise AssertionError(f"grad_class {what}: dsum outside hits * 2^-23 "
                             "* sum|dw|")
    dy = torch.from_numpy(_dyadic(b, b + g)).to(hi.device)
    if not torch.equal(kernels.grad_class(hi, lo, dy, valid, h, l),
                       kernels.grad_class_reference(hi, lo, dy, valid, h, l)):
        raise AssertionError(f"grad_class {what}: not bitwise the plain "
                             "version with dyadic dw")
    return float(err.max()), float((err / bound.clamp(min=1e-38)).max())


def _collisions(hi, lo, valid, l) -> dict:
    """The rows' collision profile: distinct entries per tuple (least,
    median, most) among the valid rows, and the most rows on one entry."""
    flat = (hi.long() * l + lo.long())[valid]
    distinct, most = [], 0
    for t in range(hi.shape[1]):
        _, counts = torch.unique(flat[:, t], return_counts=True)
        distinct.append(int(counts.numel()))
        most = max(most, int(counts.max()) if counts.numel() else 0)
    return {"valid_rows": int(valid.sum()),
            "distinct_per_tuple": [min(distinct), int(np.median(distinct)),
                                   max(distinct)],
            "most_rows_on_one_entry": most}


def _train_rows(n: int, state=None) -> tuple:
    """(hi, lo, dw, valid, h, l) of the train step's own rows for its
    16^2..16^4 class: ``prev_idx`` split into hi and lo, with
    ``prev_valid``, from ``state``, or else from one step of TRAIN_B
    envs after a fresh start; dw random from a seed."""
    from tpu2048_torch.agent import td
    from tpu2048_torch.config import AgentConfig, TrainConfig
    from tpu2048_torch.draws import TorchDraws
    from tpu2048_torch.features.ntuple import get_tuple_set
    from tpu2048_torch.ops import onehot as oh

    ts = get_tuple_set(n)
    if state is None:
        acfg, tcfg = AgentConfig(n=n), TrainConfig(num_envs=TRAIN_B)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(n)
        draws = TorchDraws(gen)
        state = td.init_td_state(ts, acfg, tcfg, draws, "cuda")
        state, _ = td.make_train_step(ts, acfg, tcfg, draws)(state)
    c = oh.build_table_classes(ts).matmul[0]
    hi, lo = oh._hi_lo(ts, state.prev_idx.reshape(-1, ts.num_feat), c)
    b = hi.shape[0]
    dw = torch.from_numpy(np.random.default_rng(b).standard_normal(b)
                          .astype(np.float32)).to(hi.device)
    # one row per image: 8 of each env under sym_impl="index"
    valid = state.prev_valid[:, None].expand(-1, state.prev_idx.shape[1])
    return hi, lo, dw, valid.reshape(-1).clone(), c.h, c.l


def _grad_time(case: str, args: list, h: int, l: int) -> dict:
    """Kernel, plain and library times of ``grad_class`` on these rows,
    the library call checked, and the bound."""
    from tpu2048_torch.ops import kernels

    hi, _lo, _dw, valid = args
    b, g = hi.shape
    k = _device_ms(lambda: kernels.grad_class(*args, h, l))
    pl = _device_ms(lambda: kernels.grad_class_reference(*args, h, l))
    lib = _grad_library(*args, h, l)
    if not torch.equal(lib()[1], kernels.grad_class_reference(*args, h, l)[1]):
        raise AssertionError("the index_add_ pair's hits differ")
    q = _device_ms(lib)
    nvalid = int(valid.sum())
    # valid rows' indices and dw, the mask, and the (2, G, H, L) pair
    nbytes = 2 * nvalid * g * 4 + nvalid * 4 + b + 2 * g * h * l * 4
    row = {"case": case, "shape": [g, h, l], "batch": b, "ms": k[0],
           "plain_ms": pl[0], "library_ms": q[0],
           "bound_ms": _bound_ms(nbytes), "bytes": nbytes,
           "bound_share": _bound_ms(nbytes) / k[0]}
    _line("grad_class_time", **row, **_collisions(*args[:2], valid, l),
          earlier_ms=EARLIER_MS.get(("grad_class", case, b)),
          kernel_ms_median_min_max=list(k),
          plain_ms_median_min_max=list(pl),
          library="two index_add_ into one zeroed pair, flat indices made "
                  "outside the call",
          library_ms_median_min_max=list(q))
    return row


def phase_grad_class() -> dict:
    from tpu2048_torch.ops import kernels

    dev = torch.device("cuda")
    worst, worst_ratio = 0.0, 0.0
    for g, h, l in SHAPES:
        for b in (TRAIN_B, RAGGED_B):
            for collide in (False, True):
                e, r = _grad_check(*_grad_inputs(g, h, l, b, b + g, dev,
                                                 collide), h, l,
                                   f"{g,h,l} B={b} collide={collide}")
                worst, worst_ratio = max(worst, e), max(worst_ratio, r)
    train_fresh = {n: _train_rows(n) for n in (5, 3, 2)}  # the three shapes
    for n, (*args, h, l) in train_fresh.items():
        e, r = _grad_check(*args, h, l, f"n={n} train rows, fresh start")
        worst, worst_ratio = max(worst, e), max(worst_ratio, r)
    hi, lo, dw, valid = _grad_inputs(3, 64, 64, 300, 5, dev)
    valid[:2] = torch.tensor([False, True])
    hi[0] = -7  # an invalid row's indices are never used
    lo[1, 2] = 64
    dsum = kernels.grad_class(hi, lo, dw, valid, 64, 64)[0]
    if not bool(dsum[2, 0, 0].isnan()) or int(dsum.isnan().sum()) != 1:
        raise AssertionError("grad_class: a valid row's bad index does not "
                             "show as NaN at dsum[g, 0, 0] alone")
    _line("grad_class_check", max_abs_err=worst,
          max_err_over_bound=worst_ratio, bound="hits*2^-23*sum|dw|",
          shapes=SHAPES, batches=[TRAIN_B, RAGGED_B],
          cases=["random", "all rows on one entry",
                 "train rows one step after a fresh start (n=5, 3, 2)"],
          hits="bitwise", dyadic_dw="bitwise", layout="(2, G, H, L)",
          bad_index="NaN")
    g, h, l = SHAPES[0]
    rows = [_grad_time(case, _grad_inputs(g, h, l, TRAIN_B, 11, dev, collide),
                       h, l)
            for case, collide in (("random", False), ("collide", True))]
    *args, h, l = train_fresh[5]
    rows.append(_grad_time("train_fresh", args, h, l))
    return {"max_abs_err": worst, "ms": rows[0]["ms"],
            "plain_ms": rows[0]["plain_ms"],
            "library_ms": rows[0]["library_ms"],
            "bound_ms": rows[0]["bound_ms"], "instances": rows}


def phase_grad_trained(state, kstat: dict) -> None:
    """Phase 5 on the rows of the phase-8 trainer's last step: checked
    and timed like the others, its row added to ``kstat``."""
    *args, h, l = _train_rows(5, state)
    e, r = _grad_check(*args, h, l, "n=5 train rows mid-training")
    kstat["max_abs_err"] = max(kstat["max_abs_err"], e)
    _line("grad_class_check", case="train_mid", max_abs_err=e,
          max_err_over_bound=r, hits="bitwise", dyadic_dw="bitwise")
    kstat["instances"].append(_grad_time("train_mid", args, h, l))


def _grad_library(hi, lo, dw, valid, h, l):
    """The one-call library form of ``grad_class``: two ``index_add_``
    calls into the halves of one zeroed pair, on flat indices made
    here; the pair and the invalid rows' zeroed dw are made inside the
    call."""
    g = hi.shape[1]
    gi = torch.arange(g, device=hi.device)
    flat = ((gi * h + hi.long()) * l + lo.long()).reshape(-1)
    count = valid.to(torch.float32)[:, None].expand(-1, g).reshape(-1)

    def call():
        pair = torch.zeros((2, g * h * l), dtype=torch.float32,
                           device=hi.device)
        w = torch.where(valid, dw, 0.0)[:, None].expand(-1, g).reshape(-1)
        pair[0].index_add_(0, flat, w)
        pair[1].index_add_(0, flat, count)
        return pair.view(2, g, h, l)

    return call


def phase_fold_class() -> dict:
    from tpu2048_torch.features.ntuple import get_tuple_set
    from tpu2048_torch.features.symmetry import symmetrize_class_sum
    from tpu2048_torch.ops import kernels

    dev = torch.device("cuda")
    worst = 0.0
    for n, g, size in ((4, 17, 65536), (5, 17, 65536), (3, 52, 4096),
                       (2, 24, 256)):
        ts = get_tuple_set(n)
        pair = torch.from_numpy(np.random.default_rng(n).standard_normal(
            (2, g, size)).astype(np.float32)).to(dev)
        got = kernels.fold_class(ts, 0, g, pair)
        torch.cuda.synchronize()
        want = symmetrize_class_sum(ts, 0, g, pair)
        worst = max(worst, float((got - want).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"fold_class n={n}: not bitwise equal to "
                                 "symmetrize_class_sum")
    _line("fold_class_check", classes=["n=4 17x16^4", "n=5 17x16^4",
                                       "n=3 52x16^3", "n=2 24x16^2"],
          bitwise=True, max_abs_err=worst)
    ts = get_tuple_set(5)
    pair = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 17, 65536)).astype(np.float32)).to(dev)
    k = _device_ms(lambda: kernels.fold_class(ts, 0, 17, pair))
    pl = _device_ms(lambda: symmetrize_class_sum(ts, 0, 17, pair))
    # the function's bytes: the pair read once and written once; the
    # kernel's own plan is not part of the function and is printed apart
    nbytes = 2 * pair.numel() * 4
    orbits, reps = kernels.fold_orbit_plan(5, 0, 17)
    row = {"shape": [2, 17, 65536], "ms": k[0], "plain_ms": pl[0],
           "library_ms": None, "bound_ms": _bound_ms(nbytes),
           "bytes": nbytes, "bound_share": _bound_ms(nbytes) / k[0]}
    _line("fold_class_time", **row, plan_bytes=orbits.nbytes + reps.nbytes,
          earlier_ms=EARLIER_MS[("fold_class", "n=5", 17)],
          kernel_ms_median_min_max=list(k),
          plain_ms_median_min_max=list(pl),
          library="none: no one call computes a D4 orbit sum")
    return {"max_abs_err": worst, "ms": k[0], "plain_ms": pl[0],
            "library_ms": None, "bound_ms": row["bound_ms"],
            "instances": [row]}


def _to(x, dev):
    """A copy of a (nested) tuple of tensors on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, copy=True)
    return type(x)(*(_to(v, dev) for v in x))


def _order_slack(acfg, ts, before, after) -> torch.Tensor:
    """Per table entry, the f32 summation-order bound of one step's
    update: the card's atomics and the CPU add an entry's terms in
    other orders, and phase 5's bound for a gradient sum, hits * 2^-23
    * (sum of |dw| at the entry), carried through the learner's rule.
    ``before`` is the CPU state the step started from, ``after`` the
    CPU state it left (its TD errors are read back from the two).

    Where the rule divides each sum by its hits (TC, and "mean"), the
    bound is 2^-23 * sum |dw|; where it adds the sum as it is (sgd
    "sum", and the canonical crosses under "sum"), hits times that.
    The D4 fold of "fold" and of the canonical class blocks folds the
    bound with the sums."""
    from tpu2048_torch.features.canonical import is_canonical
    from tpu2048_torch.features.symmetry import (symmetrize_class_sum,
                                                 symmetrize_sum)
    from tpu2048_torch.ops import onehot as oh

    done = ~after.prev_valid
    reward = (after.env.score - before.env.score).to(torch.float32)
    td = torch.where(done, -before.prev_value,
                     reward + after.prev_value - before.prev_value)
    # |dw| of each env; TC moves w by alpha * rate * dbar, rate <= 1
    alpha = float(before.alpha)
    scale = alpha if acfg.optimizer == "sgd" else max(alpha, 1.0)
    dw = torch.where(before.prev_valid, td.abs(), 0.0) * (scale / ts.num_feat)

    def mass_hits(idx, per):
        """[sum of per; count] of the valid envs' rows at ``idx``."""
        flat = idx.reshape(idx.shape[0], -1)
        per = per.expand(flat.shape) if per.dim() == 2 else \
            per[:, None].expand(flat.shape)
        keep = before.prev_valid[:, None].expand(flat.shape)
        pair = torch.zeros((2, ts.total), dtype=torch.float32)
        pair[0].index_add_(0, flat[keep].long(), per[keep])
        pair[1].index_add_(0, flat[keep].long(), torch.ones_like(per[keep]))
        return pair

    sgd_sum = acfg.optimizer == "sgd" and acfg.update_mode == "sum"
    pair = mass_hits(before.prev_idx, dw)
    if is_canonical(acfg):
        classes = oh.build_table_classes(ts).matmul
        end = max(c.start + c.g * c.h * c.l for c in classes)
        pair[:, end:] = 0.0  # the gather classes learn at their crosses
        for c in classes:  # the class-local fold, as the step's
            blk = slice(c.start, c.start + c.g * c.h * c.l)
            pair[:, blk] = symmetrize_class_sum(
                ts, c.feat0, c.g, pair[:, blk].reshape(2, c.g, c.h * c.l)
            ).reshape(2, -1)
        slack = pair[0] * (pair[1] if sgd_sum else 1.0)
        if before.prev_cidx.shape[1]:
            per = dw[:, None].expand(before.prev_cidx.shape)
            if acfg.update_mode == "sum":
                per = per * before.prev_cmult.to(torch.float32)
            cross = mass_hits(before.prev_cidx, per)
            undivided = acfg.update_mode == "sum"
            slack[end:] = (cross[0] * (cross[1] if undivided else 1.0))[end:]
    else:
        if acfg.sym_mode == "scatter" and acfg.sym_impl == "fold":
            pair = symmetrize_sum(ts, pair)
        slack = pair[0] * (pair[1] if sgd_sum else 1.0)
    return 2.0**-23 * slack


def _hold_states(card, plain, what: str, slack=0.0) -> dict:
    """The card's train state against the CPU's: every integer bitwise
    (the rings' trash slot and the logs' spill column aside: they take
    the writes of lanes that do not record, in no set order), each
    table within 2^-17 of its largest entry plus ``slack`` (per entry,
    see ``_order_slack``).  Returns the tables' largest errors and
    their largest share of the bound."""
    def cut(x, f):
        x = x.cpu()
        if f in ("score_ring", "tile_ring"):
            return x[:-1]
        return x[..., :-1] if f in ("moves", "spawns") else x

    same = {f"env.{f}": torch.equal(a.cpu(), b)
            for f, a, b in zip(card.env._fields, card.env, plain.env)}
    same.update({f: torch.equal(getattr(card, f).cpu(), getattr(plain, f))
                 for f in ("prev_idx", "prev_cidx", "prev_cmult", "prev_valid",
                           "prev_value", "top_tile", "alpha", "next_decay")})
    for group in ("metrics", "recorder"):
        a, b = getattr(card, group), getattr(plain, group)
        same.update({f"{group}.{f}": torch.equal(cut(x, f), cut(y, f))
                     for f, x, y in zip(a._fields, a, b)})
    differ = [f for f, ok in same.items() if not ok]
    if differ:
        raise AssertionError(f"{what}: the card's integer state differs from "
                             f"the plain CPU's in {differ}")
    errs = {}
    for f in ("weights", "opt_e", "opt_a"):
        a, b = getattr(card, f).cpu(), getattr(plain, f)
        if not b.numel():  # the sgd rule keeps no TC sums
            continue
        err = (a - b).abs()
        bound = 2.0**-17 * float(b.abs().max()) + slack
        errs[f] = float(err.max())
        share = float((err / bound).max())
        errs[f + "_share_of_bound"] = share
        if not share <= 1.0:
            raise AssertionError(f"{what}: {f} differs by {errs[f]}, "
                                 f"{share:.3g} of its bound")
    return errs


def _launch_counts() -> dict:
    from tpu2048_torch.ops import kernels

    return {k.__name__: k.launches for k in (
        kernels.eval_class, kernels.grad_class, kernels.fold_class)}


def _as_tensors(x):
    """A (nested) tuple of numpy arrays as one of CPU tensors."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    return type(x)(*(_as_tensors(v) for v in x))


def _card_step_against_cpu(acfg, tcfg, segment: bool = False,
                           mesh=None) -> tuple:
    """One train step (or one segment) of ``acfg`` through the kernels on
    the card (under ``mesh``, if given: its collectives too) and through
    their plain versions, unmeshed, on the CPU, from one
    state with dyadic weights and the same numpy draws: after two warm
    steps on the card, or for a segment from a fresh state, whose first
    step updates nothing, so that every value the actor reads is exact
    in f32 on both sides; the staged recorder rows bitwise.  Returns
    (the card's state, the CPU's, the summation-order bound of each
    table entry (``_order_slack``), the card's launches per kernel).

    Under a mesh's model axis the start state is cut to this rank's
    shard (``shard_td_state``) and the card's state read back whole
    (``host_full_state``, a collective); every rank of the mesh calls,
    and only rank 0 steps on the CPU: the others get (the card's state,
    None, None, their launches).  There the warm steps run on the CPU,
    so that every rank starts from the same bits."""
    from tpu2048_torch.agent import td
    from tpu2048_torch.draws import NumpyDraws
    from tpu2048_torch.features.ntuple import get_tuple_set
    from tpu2048_torch.features.symmetry import symmetrize_table
    from tpu2048_torch.parallel import mesh as pmesh

    ts = get_tuple_set(acfg.n)
    sharded = mesh is not None and mesh.model > 1
    warm_on = "cpu" if sharded else "cuda"
    st = td.init_td_state(ts, acfg, tcfg, NumpyDraws(0, warm_on), warm_on)
    if not segment:
        warm = td.make_train_step(ts, acfg, tcfg, NumpyDraws(1, warm_on))
        st, _ = warm(warm(st)[0])  # two steps: valid rows and TC sums
    st = _to(st, "cpu")._replace(weights=torch.from_numpy(_dyadic(ts.total,
                                                                   2)))
    make = td.make_train_segment if segment else td.make_train_step
    before = _launch_counts()
    card = make(ts, acfg, tcfg, NumpyDraws(3, "cuda"), mesh=mesh)(
        pmesh.shard_td_state(st, mesh, ts) if sharded else _to(st, "cuda"))
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in _launch_counts().items()}
    if sharded:
        whole = _as_tensors(pmesh.host_full_state(
            card if segment else card[0], mesh))
        card = whole if segment else (whole, card[1])
        if mesh.rank != 0:
            return whole, None, None, launches
    if segment:
        # the segment's first step (which updates nothing) alone, for
        # the rows its second step learns from
        first, _ = td.make_train_step(ts, acfg, tcfg, NumpyDraws(3, "cpu"))(
            _to(st, "cpu"))
        plain = make(ts, acfg, tcfg, NumpyDraws(3, "cpu"))(st)
        slack = _order_slack(acfg, ts, first, plain)
        if acfg.sym_mode == "periodic":
            slack = symmetrize_table(ts, slack)
    else:
        (card, rec_card) = card
        plain, rec_plain = make(ts, acfg, tcfg, NumpyDraws(3, "cpu"))(
            _to(st, "cpu"))
        if not all(torch.equal(a.cpu(), b)
                   for a, b in zip(rec_card, rec_plain)):
            raise AssertionError(f"{acfg}: the staged recorder rows differ")
        slack = _order_slack(acfg, ts, st, plain)
    return card, plain, slack, launches


def phase_train_step() -> None:
    from tpu2048_torch.config import AgentConfig, TrainConfig

    acfg = AgentConfig(table_ops="pallas")  # kernels on the card, plain on CPU
    tcfg = TrainConfig(num_envs=TRAIN_B)
    t0 = time.perf_counter()
    card, plain, _, _ = _card_step_against_cpu(acfg, tcfg)
    errs = _hold_states(card, plain, "train step")
    _line("train_step_check", n=acfg.n, envs=TRAIN_B, integers="bitwise",
          max_abs_err=errs, tolerance="2^-17 * max|table|",
          episodes_done=int(card.metrics.episodes),
          seconds=time.perf_counter() - t0)


def phase_train_variants(kstat: dict) -> None:
    """Phase 10: the learner settings off the defaults, each one step
    (one K=2 segment for "periodic") on the card against the CPU; then
    phase 5's check and times of ``grad_class`` on the 8 x 8192 rows of
    the "index" learner's step, its row added to ``kstat``."""
    import dataclasses

    from tpu2048_torch.config import AgentConfig, TrainConfig

    tcfg = TrainConfig(num_envs=TRAIN_B)
    for name, kw in VARIANTS.items():
        acfg = AgentConfig(table_ops="pallas", **kw)
        segment = acfg.sym_mode == "periodic"
        t0 = time.perf_counter()
        card, plain, slack, launches = _card_step_against_cpu(
            acfg, dataclasses.replace(tcfg, steps_per_call=2) if segment
            else tcfg, segment)
        errs = _hold_states(card, plain, f"train variant {name}", slack)
        steps = 2 if segment else 1
        bootstrap = (acfg.actor_precision == "bf16"
                     and acfg.engine_mode == "codes")
        want = {"eval_class": steps * (1 + bootstrap), "grad_class": steps,
                "fold_class": steps * (acfg.sym_impl == "canonical"
                                       and acfg.sym_mode == "scatter")}
        if launches != want:
            raise AssertionError(f"{name}: the card launched {launches}, "
                                 f"expected {want}")
        _line("train_variant_check", variant=name, config=kw, n=acfg.n,
              envs=TRAIN_B, steps=steps, integers="bitwise",
              max_abs_err=errs, tolerance="2^-17 * max|table| + the entry's "
              "summation-order bound",
              launches=launches, alpha_after=float(card.alpha),
              seconds=time.perf_counter() - t0)
        if name == "tc_index":
            *args, h, l = _train_rows(acfg.n, card)
            e, r = _grad_check(*args, h, l, "n=5 index learner's rows")
            kstat["max_abs_err"] = max(kstat["max_abs_err"], e)
            _line("grad_class_check", case="train_index", max_abs_err=e,
                  max_err_over_bound=r, hits="bitwise", dyadic_dw="bitwise")
            kstat["instances"].append(_grad_time("train_index", args, h, l))


class _StopAfter:
    """A job that asks the trainer to stop after ``n`` segments."""

    def __init__(self, n: int):
        self.left = n

    def should_stop(self) -> bool:
        self.left -= 1
        return self.left < 0


def phase_train(name: str) -> tuple:
    from tpu2048_torch.config import AgentConfig, TrainConfig
    from tpu2048_torch.features.ntuple import get_tuple_set
    from tpu2048_torch.obs.logging import Logger
    from tpu2048_torch.ops import kernels
    from tpu2048_torch.store.artifacts import LocalStore
    from tpu2048_torch.store.checkpoint import load_agent, load_agent_dense
    from tpu2048_torch.train.loop import Trainer
    from tpu2048_torch.train.trial import trial

    acfg = AgentConfig()
    # the shipped defaults; checkpoints only at the end of the run
    tcfg = TrainConfig(num_envs=TRAIN_B, steps_per_call=64,
                       episodes=10**9, checkpoint_every=10**9)
    with tempfile.TemporaryDirectory() as root:
        store = LocalStore(root)
        tr = Trainer(name, acfg, tcfg, store=store,
                     logger=Logger(console=False), device="cuda")
        for k in (kernels.eval_class, kernels.grad_class, kernels.fold_class):
            k.launches = 0
        out = tr.run(job=_StopAfter(TRAIN_SEGMENTS))
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in (
            kernels.eval_class, kernels.grad_class, kernels.fold_class)}
        steps = TRAIN_SEGMENTS * tcfg.steps_per_call
        want = {"eval_class": 2 * steps, "grad_class": steps,
                "fold_class": steps}
        if launches != want:
            raise AssertionError(f"train run launched {launches}, expected "
                                 f"{want} (every kernel on every step)")
        st = tr.state
        if not bool(torch.isfinite(st.weights).all()):
            raise AssertionError("non-finite weights after training")
        if out["episodes"] <= 0:
            raise AssertionError("no episode completed")
        _replays(store, f"best_of_{name}", out["top_score"])
        acfg2, w_np, meta = load_agent(store, name)
        if (acfg2 != acfg or w_np.shape != st.weights.shape
                or "opt_e" not in meta["extras"]):
            raise AssertionError("the checkpoint does not load as saved")
        _, w, _ = load_agent_dense(store, name, device="cuda")
        games = trial(get_tuple_set(acfg.n), w, num=256, seed=1)
        if games.odometers.min() <= 0:
            raise AssertionError("the trained agent did not play")
    timer = tr.timer
    seg_s = (timer.totals["train_segment"] + timer.totals["metrics_read"]
             ) / TRAIN_SEGMENTS
    hist = out["train_history"]
    _line("train", n=acfg.n, envs=TRAIN_B, steps_per_call=tcfg.steps_per_call,
          segments=TRAIN_SEGMENTS, episodes=out["episodes"],
          top_score=out["top_score"], best_game_replays=True,
          env_steps_per_s=out["env_steps_per_sec"],
          segment_env_steps_per_s=TRAIN_B * tcfg.steps_per_call / seg_s,
          wall_per_segment_s=seg_s, ma100_first=hist[0] if hist else None,
          ma100_last=hist[-1] if hist else None, ma100_points=len(hist),
          launches=launches, trial_avg_score=float(games.scores.mean()),
          timer=timer.report().splitlines())
    return launches, st


def _replays(store, game: str, top_score: int) -> None:
    """The saved game replays to the run's best score."""
    from tpu2048_torch.engine.core import np_move
    from tpu2048_torch.store.checkpoint import load_game

    rec = load_game(store, game)
    board, score = rec["starting_position"].copy(), 0
    for t in range(rec["odometer"]):
        board, delta, changed = np_move(board, int(rec["moves"][t]))
        if not changed:
            raise AssertionError(f"{game}: illegal move at {t}")
        val, i, j = rec["tiles"][t]
        board[i, j] = val
        score += delta
    if (score != rec["score"] or not (board == rec["final_board"]).all()
            or score != top_score):
        raise AssertionError(f"{game} does not replay to the run's best "
                             "score")


def phase_train_variant(name: str) -> dict:
    """Phase 11: ``Trainer.run`` of the reference's own rule (sgd, alpha
    0.25, explicit 8-image indices) at n=5, 8192 envs, K=64, for
    VARIANT_SEGMENTS segments, then its checkpoint resumed on the card
    (the generator's stream continued) and on the CPU (a fresh stream,
    logged).  Returns the kernels' launches of the run."""
    from tpu2048_torch.config import AgentConfig, TrainConfig
    from tpu2048_torch.obs.logging import Logger
    from tpu2048_torch.ops import kernels
    from tpu2048_torch.store.artifacts import LocalStore, MemoryStore
    from tpu2048_torch.train.loop import Trainer

    acfg = AgentConfig(optimizer="sgd", alpha=0.25, sym_impl="index")
    tcfg = TrainConfig(num_envs=TRAIN_B, steps_per_call=64,
                       episodes=10**9, checkpoint_every=10**9)
    with tempfile.TemporaryDirectory() as root:
        store = LocalStore(root)
        tr = Trainer(name, acfg, tcfg, store=store,
                     logger=Logger(console=False), device="cuda")
        for k in (kernels.eval_class, kernels.grad_class, kernels.fold_class):
            k.launches = 0
        out = tr.run(job=_StopAfter(VARIANT_SEGMENTS))
        torch.cuda.synchronize()
        launches = _launch_counts()
        steps = VARIANT_SEGMENTS * tcfg.steps_per_call
        want = {"eval_class": 2 * steps, "grad_class": steps, "fold_class": 0}
        if launches != want:
            raise AssertionError(f"sgd/index run launched {launches}, "
                                 f"expected {want}")
        st = tr.state
        if not bool(torch.isfinite(st.weights).all()):
            raise AssertionError("sgd/index: non-finite weights")
        if out["episodes"] <= 0:
            raise AssertionError("sgd/index: no episode completed")
        _replays(store, f"best_of_{name}", out["top_score"])
        resumed = {}
        for dev in ("cuda", "cpu"):
            log = Logger(store=MemoryStore(), console=False)
            again = Trainer(name, acfg, tcfg, store=store, logger=log,
                            resume=True, device=dev)
            if not (torch.equal(again.state.weights.cpu(), st.weights.cpu())
                    and torch.equal(again.state.alpha.cpu(), st.alpha.cpu())
                    and int(again.state.metrics.episodes) == out["episodes"]):
                raise AssertionError(f"sgd/index: the resume on {dev} lost "
                                     "the agent")
            fresh = "a fresh stream from seed" in log.tail()
            continued = dev == "cuda" and torch.equal(
                again.draws.generator.get_state(),
                tr.draws.generator.get_state())
            if (dev == "cuda") != continued or (dev == "cpu") != fresh:
                raise AssertionError(f"sgd/index: the resume on {dev} did not "
                                     "take the generator's stream as its type "
                                     "allows")
            resumed[dev] = "stream continued" if continued else "fresh stream"
            del again
    timer = tr.timer
    seg_s = (timer.totals["train_segment"] + timer.totals["metrics_read"]
             ) / VARIANT_SEGMENTS
    hist = out["train_history"]
    _line("train_variant", optimizer=acfg.optimizer, alpha0=acfg.alpha,
          sym_impl=acfg.sym_impl, n=acfg.n, envs=TRAIN_B,
          steps_per_call=tcfg.steps_per_call, segments=VARIANT_SEGMENTS,
          episodes=out["episodes"], top_score=out["top_score"],
          alpha=float(st.alpha), best_game_replays=True,
          env_steps_per_s=out["env_steps_per_sec"],
          segment_env_steps_per_s=TRAIN_B * tcfg.steps_per_call / seg_s,
          wall_per_segment_s=seg_s, ma100_first=hist[0] if hist else None,
          ma100_last=hist[-1] if hist else None, ma100_points=len(hist),
          launches=launches,
          launches_per_step={k: v / steps for k, v in launches.items()},
          resumed=resumed, timer=timer.report().splitlines())
    return launches


def phase_search() -> tuple:
    """The search path: the kernel at the tree's scale, then depth-3
    games through the kernel and through plain gathers.  Returns (the
    path's eval_class launches, the tree-scale check's numbers)."""
    from tpu2048_torch.config import SearchConfig
    from tpu2048_torch.ops import kernels
    from tpu2048_torch.train.trial import trial

    dev = torch.device("cuda")
    g, h, l = SHAPES[0]
    tables, hi, lo = _inputs(g, h, l, SEARCH_B, seed=13, dev=dev)
    got = kernels.eval_class(tables, hi, lo, "bf16")
    if not torch.equal(got, kernels.eval_class_ordered(tables, hi, lo,
                                                       "bf16")):
        raise AssertionError(f"eval_class bf16 at B={SEARCH_B}: not bitwise "
                             "the ordered accumulation of its terms")
    want = kernels.eval_class_reference(tables, hi, lo, "bf16")
    gi = torch.arange(g, device=dev)
    scale = tables.to(torch.bfloat16).float()[gi, hi.long(), lo.long()
                                               ].abs().sum(dim=-1)
    err = (got - want).abs()
    err_max = float(err.max())
    ratio = float((err / scale).max())
    if not bool(torch.isfinite(got).all()) or ratio > REL_TOL:
        raise AssertionError(f"eval_class bf16 at B={SEARCH_B}: error "
                             f"{ratio:.3g} of sum|terms| > {REL_TOL:.3g}")
    del got, want, scale, err
    check = {"max_abs_err": err_max, "max_err_over_sum_abs": ratio,
             **_eval_time(tables, hi, lo, "bf16", inner=5)}
    _line("search_kernel_check", bound=REL_TOL, bitwise_ordered=True,
          **check)
    del tables, hi, lo

    ts, w = _served_agent()
    scfg = SearchConfig(depth=3, width=4, since_empty=6)

    def play(table_ops, **kw):
        return trial(ts, w, num=SEARCH_GAMES, seed=2, search=scfg,
                     table_ops=table_ops, **kw)

    # warm both paths at the largest tier: every game starts crowded
    # (5 empty cells), so all 4 * SEARCH_GAMES roots enter the tree
    crowded = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [1, 2, 3, 0],
                        [0, 0, 0, 0]], np.int8)
    for table_ops in ("auto", "gather"):
        play(table_ops, game_init=crowded, step_cap=32, steps_per_call=32)

    counters = (kernels.eval_class, kernels.grad_class, kernels.fold_class)
    for c in counters:
        c.launches = 0
    r_kernel = play("auto")
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    if launches["eval_class"] == 0:
        raise AssertionError("the search path never launched eval_class")
    r_gather = play("gather")
    if kernels.eval_class.launches != launches["eval_class"]:
        raise AssertionError("the gather search run launched eval_class")
    # the timed runs in ABBA order: kernel, gather, gather, kernel
    r_gather2 = play("gather")
    r_kernel2 = play("auto")
    for r in (r_gather, r_gather2, r_kernel2):
        _check_same_games(r_kernel, r, "search")
    _check_replay(r_kernel, "search")
    odos = r_kernel.odometers
    if odos.min() <= 0 or odos.max() >= 32768:
        raise AssertionError("not every search game was played to its end")
    stats = r_kernel.search_stats
    tree_steps = stats["steps"] - stats["tiers"][0]
    if tree_steps <= 0:
        raise AssertionError("no step of the search run entered the tree")
    moves = int(odos.sum())
    _line("search", games=SEARCH_GAMES, n=ts.n, depth=scfg.depth,
          width=scfg.width, since_empty=scfg.since_empty,
          avg_score=float(r_kernel.scores.mean()), total_moves=moves,
          max_moves=int(odos.max()), steps=stats["steps"],
          tier_histogram=stats["tiers"], tree_steps=tree_steps,
          chunks=stats["chunks"],
          chunks_per_tree_step=stats["chunks"] / tree_steps,
          launches=launches,
          eval_class_launches_per_step=launches["eval_class"] / stats["steps"],
          elapsed_s=r_kernel.elapsed,
          ms_per_step=1e3 * r_kernel.elapsed / stats["steps"],
          abba_ms_per_move=[1e3 * r.elapsed / moves for r in
                            (r_kernel, r_gather, r_gather2, r_kernel2)],
          ms_per_move=1e3 * (r_kernel.elapsed + r_kernel2.elapsed)
          / (2 * moves),
          gather_ms_per_move=1e3 * (r_gather.elapsed + r_gather2.elapsed)
          / (2 * moves),
          kernel_equals_gather=True, best_game_replays=True)
    return launches["eval_class"], check


def _reset_launches() -> None:
    from tpu2048_torch.ops import kernels

    for k in (kernels.eval_class, kernels.grad_class, kernels.fold_class):
        k.launches = 0


def _quiet():
    from tpu2048_torch.obs.logging import Logger

    return Logger(console=False)


def _default_step_launches(steps: int) -> dict:
    """The shipped learner's launches in ``steps`` steps: the bf16
    selection and the exact bootstrap, one class gradient, one fold."""
    return {"eval_class": 2 * steps, "grad_class": steps, "fold_class": steps}


def phase_big_step(n: int) -> None:
    """Phase 12's step check: phase 10's, at n=6 or n=7."""
    from tpu2048_torch.config import AgentConfig, TrainConfig
    from tpu2048_torch.features.ntuple import get_tuple_set

    acfg = AgentConfig(n=n, table_ops="pallas")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    card, plain, slack, launches = _card_step_against_cpu(
        acfg, TrainConfig(num_envs=TRAIN_B))
    errs = _hold_states(card, plain, f"n={n} train step", slack)
    if launches != _default_step_launches(1):
        raise AssertionError(f"n={n} step launched {launches}")
    _line("flagship_step_check", n=n, envs=TRAIN_B,
          weights=int(get_tuple_set(n).total), integers="bitwise",
          max_abs_err=errs, tolerance="2^-17 * max|table| + the entry's "
          "summation-order bound", launches=launches,
          gather_features=int(card.prev_cidx.shape[1]),
          peak_allocated_bytes=torch.cuda.max_memory_allocated(),
          seconds=time.perf_counter() - t0)


def phase_flagship(n: int, segments: int, name: str, save: bool) -> dict:
    """Phase 12's run: ``Trainer.run`` of ``AgentConfig(n=n)`` at the
    shipped ``TrainConfig()`` width for ``segments`` segments; with
    ``save`` the best game is replayed and the checkpoint loaded and
    played.  Returns the kernels' launches of the run."""
    from tpu2048_torch.config import AgentConfig, TrainConfig
    from tpu2048_torch.features.ntuple import get_tuple_set
    from tpu2048_torch.store.artifacts import LocalStore
    from tpu2048_torch.store.checkpoint import load_agent, load_agent_dense
    from tpu2048_torch.train.loop import Trainer
    from tpu2048_torch.train.trial import trial

    acfg = AgentConfig(n=n)  # canonical form, TC, bf16 actor
    shipped = TrainConfig()
    if (shipped.num_envs, shipped.steps_per_call, shipped.record_envs) != (
            TRAIN_B, 64, -1):
        raise AssertionError("the shipped TrainConfig changed its width")
    tcfg = TrainConfig(episodes=10**9, checkpoint_every=10**9)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    played = None
    with tempfile.TemporaryDirectory() as root:
        store = LocalStore(root) if save else None
        tr = Trainer(name, acfg, tcfg, store=store, logger=_quiet(),
                     device="cuda")
        _reset_launches()
        out = tr.run(job=_StopAfter(segments))
        torch.cuda.synchronize()
        launches = _launch_counts()
        steps = segments * tcfg.steps_per_call
        if launches != _default_step_launches(steps):
            raise AssertionError(f"n={n} run launched {launches}, expected "
                                 "every kernel on every step")
        st = tr.state
        if not bool(torch.isfinite(st.weights).all()):
            raise AssertionError(f"n={n}: non-finite weights after training")
        if int(st.env.odometer.max()) > steps or out["episodes"] <= 0:
            raise AssertionError(f"n={n}: the run did not step as asked")
        peak = torch.cuda.max_memory_allocated()
        hist = out["train_history"]
        if save:
            if len(hist) < 2 or not hist[-1] > hist[0]:
                raise AssertionError(f"n={n}: the ma-100 did not rise: {hist}")
            _replays(store, f"best_of_{name}", out["top_score"])
            acfg2, w_np, meta = load_agent(store, name)
            if (acfg2 != acfg or w_np.shape != st.weights.shape
                    or not np.array_equal(meta["extras"]["opt_a"],
                                          st.opt_a.cpu().numpy())):
                raise AssertionError(f"n={n}: the checkpoint does not load "
                                     "as saved")
            del w_np, meta
            _, w, _ = load_agent_dense(store, name, device="cuda")
            games = trial(get_tuple_set(n), w, num=256, seed=1)
            if games.odometers.min() <= 0:
                raise AssertionError(f"n={n}: the trained agent did not play")
            played = float(games.scores.mean())
            del w
    timer = tr.timer
    seg_s = (timer.totals["train_segment"] + timer.totals["metrics_read"]
             ) / segments
    _line("flagship", n=n, weights=int(st.weights.numel()), envs=TRAIN_B,
          steps_per_call=tcfg.steps_per_call, record_envs="all",
          segments=segments, episodes=out["episodes"],
          top_score=out["top_score"], best_game_replays=save or None,
          env_steps_per_s=out["env_steps_per_sec"],
          segment_env_steps_per_s=TRAIN_B * tcfg.steps_per_call / seg_s,
          wall_per_segment_s=seg_s, ma100_first=hist[0] if hist else None,
          ma100_last=hist[-1] if hist else None, ma100_points=len(hist),
          launches=launches,
          launches_per_step={k: v / steps for k, v in launches.items()},
          peak_allocated_bytes=peak, trial_avg_score=played,
          timer=timer.report().splitlines())
    del tr, st
    torch.cuda.empty_cache()
    return launches


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _games_differing(a, b) -> int:
    """Envs whose boards or scores differ between two train states."""
    return int(((a.env.codes != b.env.codes).any(dim=1)
                | (a.env.score != b.env.score)).sum())


def _step_collectives(ts, tcfg, world: int) -> dict:
    """The collectives of one step of the shipped learner under a mesh,
    and their bytes as ``Mesh`` counts them (what each hands back to a
    rank), from the step's shapes: one all-reduce per 16^2..16^4 class
    pair, one all-gather of the gather classes' rows (an index and an
    update per feature, and the row's mask), one of the episode metrics
    (done, score, top tile); per segment one more all-gather, of the
    ranks' best-game candidates."""
    from tpu2048_torch.features.canonical import _gather_feat_ids
    from tpu2048_torch.ops import onehot as oh

    classes = oh.build_table_classes(ts).matmul
    k = len(_gather_feat_ids(ts.n))
    pair = sum(2 * c.g * c.h * c.l * 4 for c in classes)
    rows = tcfg.num_envs * (2 * k + 1) * 4
    metrics = tcfg.num_envs * 3 * 4
    return {"all_reduce": len(classes), "all_gather": 2,
            "bytes": pair + rows + metrics,
            "segment_all_gather": 1,
            "segment_bytes": world * (12 + 16 + 2 * tcfg.max_record_steps)}


def phase_mesh() -> tuple:
    """Phase 13.  Returns (the mesh run's launches, the mesh, the mesh
    trainer's state), the process group left up for phase 14."""
    from tpu2048_torch.config import AgentConfig, MeshConfig, TrainConfig
    from tpu2048_torch.features.ntuple import get_tuple_set
    from tpu2048_torch.parallel import distributed
    from tpu2048_torch.train.loop import Trainer

    coordinator = f"localhost:{_free_port()}"
    if not distributed.initialize(coordinator, num_processes=1, process_id=0):
        raise AssertionError("distributed.initialize returned False")
    backend = torch.distributed.get_backend()
    mesh = distributed.global_mesh(MeshConfig(data=1, model=1))
    if backend != "nccl" or mesh.device.type != "cuda" or mesh.group is None:
        raise AssertionError(f"the mesh is not on NCCL: {backend}, "
                             f"{mesh.device}")

    # one step through the mesh on the card against the unmeshed CPU step
    acfg = AgentConfig(table_ops="pallas")
    t0 = time.perf_counter()
    card, plain, slack, launches = _card_step_against_cpu(
        acfg, TrainConfig(num_envs=TRAIN_B), mesh=mesh)
    errs = _hold_states(card, plain, "mesh train step", slack)
    if launches != _default_step_launches(1):
        raise AssertionError(f"the mesh step launched {launches}")
    _line("mesh_step_check", backend=backend, world=1, n=acfg.n,
          envs=TRAIN_B, integers="bitwise", max_abs_err=errs,
          tolerance="2^-17 * max|table| + the entry's summation-order bound",
          launches=launches, collectives=dict(mesh.counts),
          seconds=time.perf_counter() - t0)

    # one segment of the defaults through the mesh, and without it
    acfg = AgentConfig()
    tcfg = TrainConfig(episodes=10**9, checkpoint_every=10**9)
    ts = get_tuple_set(acfg.n)
    runs = {}
    for what in ("mesh", "plain", "plain_again"):
        tr = Trainer(what, acfg, tcfg, logger=_quiet(),
                     mesh=mesh if what == "mesh" else None, device="cuda")
        tr.run(job=_StopAfter(1))  # warm: allocator, NCCL, clocks
        first = tr.state.env._replace(codes=tr.state.env.codes.clone())
        _reset_launches()
        mesh.counts.update(dict.fromkeys(mesh.counts, 0))
        out = tr.run(job=_StopAfter(1))
        torch.cuda.synchronize()
        if _launch_counts() != _default_step_launches(tcfg.steps_per_call):
            raise AssertionError(f"{what}: launched {_launch_counts()}")
        if not bool(torch.isfinite(tr.state.weights).all()):
            raise AssertionError(f"{what}: non-finite weights")
        runs[what] = (tr.state, out["env_steps_per_sec"], _launch_counts(),
                      dict(mesh.counts), tr.state._replace(env=first))
    want = _step_collectives(ts, tcfg, world=1)
    k = tcfg.steps_per_call
    counted = runs["mesh"][3]
    expected = {"all_reduce": k * want["all_reduce"],
                "all_gather": k * want["all_gather"]
                + want["segment_all_gather"],
                "bytes": k * want["bytes"] + want["segment_bytes"]}
    if counted != expected:
        raise AssertionError(f"the mesh segment ran {counted}, expected "
                             f"{expected}")
    if any(runs[w][3] != dict.fromkeys(counted, 0)
           for w in ("plain", "plain_again")):
        raise AssertionError("an unmeshed run ran a collective")
    _line("mesh", backend=backend, world=1, coordinator="localhost",
          n=acfg.n, envs=TRAIN_B, steps_per_call=k, segments_timed=1,
          launches=runs["mesh"][2],
          launches_per_step={n_: v / k for n_, v in runs["mesh"][2].items()},
          collectives=counted,
          collectives_per_step={"all_reduce": want["all_reduce"],
                                "all_gather": want["all_gather"],
                                "bytes": want["bytes"]},
          collectives_per_segment_end={
              "all_gather": want["segment_all_gather"],
              "bytes": want["segment_bytes"]},
          mesh_env_steps_per_s=runs["mesh"][1],
          plain_env_steps_per_s=runs["plain"][1],
          plain_again_env_steps_per_s=runs["plain_again"][1],
          reading="one run each: a reading, not a comparison",
          games_differing_after_steps=[k, 2 * k],
          games_differing_mesh_vs_plain=[
              _games_differing(runs["mesh"][i], runs["plain"][i])
              for i in (4, 0)],
          games_differing_plain_vs_plain=[
              _games_differing(runs["plain"][i], runs["plain_again"][i])
              for i in (4, 0)])
    return runs["mesh"][2], mesh, runs["mesh"][0]


def phase_fixed_order(mesh, state) -> None:
    """Phase 14: the mesh path's sparse apply is bitwise repeatable on
    the card, alone and inside a mesh step from ``state`` (the phase-13
    mesh trainer's, mid-training)."""
    from tpu2048_torch.agent import td
    from tpu2048_torch.config import AgentConfig, TrainConfig
    from tpu2048_torch.draws import NumpyDraws
    from tpu2048_torch.features.ntuple import get_tuple_set
    from tpu2048_torch.ops import onehot as oh
    from tpu2048_torch.ops.dispatch import scatter_add_ordered

    dev = torch.device("cuda")
    rng = np.random.default_rng(14)
    size, m = 1 << 20, 1 << 18
    # three quarters of the list on 64 entries, the rest anywhere
    hot = rng.integers(0, size, 64)
    flat = np.where(rng.random(m) < 0.75, hot[rng.integers(0, 64, m)],
                    rng.integers(0, size, m))
    flat_t = torch.from_numpy(flat).to(dev)
    upd = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(dev)
    base = torch.from_numpy(rng.standard_normal(size).astype(np.float32)
                            ).to(dev)
    tables = []
    for _ in range(2):
        t = base.clone()
        scatter_add_ordered(t, flat_t, upd)
        tables.append(t)
    torch.cuda.synchronize()
    if not torch.equal(tables[0], tables[1]):
        raise AssertionError("scatter_add_ordered is not bitwise repeatable")
    atomics = [base.clone().index_add_(0, flat_t, upd) for _ in range(2)]
    mass = torch.zeros(size, device=dev).index_add_(0, flat_t, upd.abs())
    hits = torch.zeros(size, device=dev).index_add_(
        0, flat_t, torch.ones(m, device=dev))
    bound = 2.0**-23 * (hits + 1.0) * (mass + base.abs())
    err = (tables[0] - atomics[0]).abs()
    if not bool((err <= bound).all()):
        raise AssertionError("scatter_add_ordered is outside index_add_'s "
                             "summation-order bound")

    # one mesh step, twice, from one mid-training state
    acfg, tcfg = AgentConfig(), TrainConfig()
    ts = get_tuple_set(acfg.n)
    end = max(c.start + c.g * c.h * c.l
              for c in oh.build_table_classes(ts).matmul)
    outs = []
    for _ in range(2):
        step = td.make_train_step(ts, acfg, tcfg, NumpyDraws(5, "cuda"),
                                  mesh=mesh)
        outs.append(step(_to(state, "cuda"))[0])
    torch.cuda.synchronize()
    moved = int((outs[0].weights[end:] != state.weights[end:]).sum())
    if moved == 0:
        raise AssertionError("the mesh step moved no gather-class entry")
    for f in ("weights", "opt_e", "opt_a"):
        if not torch.equal(getattr(outs[0], f)[end:],
                           getattr(outs[1], f)[end:]):
            raise AssertionError(f"two runs of one mesh step differ in the "
                                 f"gather classes' {f}")
    collide = torch.unique(state.prev_cidx[state.prev_valid].reshape(-1),
                           return_counts=True)[1]
    _line("fixed_order", list=m, entries=size,
          most_on_one_entry=int(hits.max()), repeatable="bitwise",
          max_abs_diff_to_index_add=float(err.max()),
          index_add_repeats=bool(torch.equal(atomics[0], atomics[1])),
          mesh_step_gather_entries_moved=moved,
          mesh_step_gather_classes="bitwise over two runs",
          mesh_step_most_rows_on_one_entry=int(collide.max()),
          mesh_step_class_block_repeats=bool(torch.equal(
              outs[0].weights[:end], outs[1].weights[:end])))


def _rank_main(rendezvous: str, ranks: int, rank: int, device: str,
               out: str) -> int:
    """One rank of phase 15: one n=5 segment of RANKS_ENVS envs on a
    mesh of ``ranks``; rank 0 writes the global state."""
    from tpu2048_torch.config import AgentConfig, MeshConfig, TrainConfig
    from tpu2048_torch.parallel import distributed
    from tpu2048_torch.parallel import mesh as pmesh
    from tpu2048_torch.train.loop import Trainer

    if device == "cpu":
        torch.set_num_threads(2)
    if not distributed.initialize(rendezvous, ranks, rank, device=device):
        raise AssertionError("distributed.initialize returned False")
    mesh = distributed.global_mesh(MeshConfig(data=ranks, model=1))
    tr = Trainer("ranks", AgentConfig(), _ranks_tcfg(), logger=_quiet(),
                 mesh=mesh)
    tr.run(job=_StopAfter(1))
    counts = dict(mesh.counts)  # the segment's own, before the checks'
    # every rank's replica of the tables holds the same bits
    for f in ("weights", "opt_e", "opt_a"):
        rows = mesh.all_gather(getattr(tr.state, f).view(torch.int32)[None])
        if not bool((rows == rows[0]).all()):
            raise AssertionError(f"the ranks' replicas differ in {f}")
    full = pmesh.host_full_state(tr.state, mesh)
    if rank == 0:
        np.savez(out, **_flat(full), collectives=json.dumps(counts))
    mesh.barrier()
    torch.distributed.destroy_process_group()
    print(f"RANK_OK {rank}", flush=True)
    return 0


def _ranks_tcfg():
    from tpu2048_torch.config import TrainConfig

    return TrainConfig(num_envs=RANKS_ENVS, steps_per_call=8, ring_size=64,
                       max_record_steps=256, episodes=10**9,
                       checkpoint_every=10**9, seed=15)


def _flat(state) -> dict:
    """A train state as {"env.codes": array, ...}."""
    out = {}
    for f, x in zip(state._fields, state):
        if hasattr(x, "_fields"):
            out.update({f"{f}.{g}": np.asarray(y.cpu() if isinstance(
                y, torch.Tensor) else y) for g, y in zip(x._fields, x)})
        else:
            out[f] = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    return out


def _run_ranks(ranks: int, device: str) -> dict:
    """Start ``ranks`` ranks of this script, wait for them (killed at
    RANKS_TIMEOUT), and return rank 0's global state."""
    here = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "state.npz")
        procs = [subprocess.Popen(
            [sys.executable, here, "--rank", f"file://{tmp}/rendezvous",
             str(ranks), str(r), device, out],
            cwd=os.path.dirname(here), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(ranks)]
        logs = []
        deadline = time.monotonic() + RANKS_TIMEOUT
        try:
            for p in procs:
                logs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0 or f"RANK_OK {r}" not in log:
                raise AssertionError(f"rank {r} of {ranks} on {device} "
                                     f"failed:\n{log}")
        with np.load(out) as z:
            return dict(z)


def _hold_ranks(got: dict, want: dict, what: str, integers: bool) -> float:
    """The ranks' global state against the one-rank run's: every integer
    leaf bitwise when ``integers`` (the logs' spill column and the
    rings' trash slot aside), the tables within 2^-17 of their largest
    entry.  Returns the tables' largest error."""
    worst = 0.0
    for name, b in want.items():
        a = got[name]
        if name in ("recorder.moves", "recorder.spawns"):
            a, b = a[:, :-1], b[:, :-1]
        if name in ("metrics.score_ring", "metrics.tile_ring"):
            a, b = a[:-1], b[:-1]
        if name in ("weights", "opt_e", "opt_a", "prev_value"):
            err = float(np.abs(a - b).max())
            worst = max(worst, err)
            if err > 2.0**-17 * float(np.abs(b).max()):
                raise AssertionError(f"{what}: {name} differs by {err}")
        elif integers and not np.array_equal(a, b):
            raise AssertionError(f"{what}: {name} differs from the one-rank "
                                 "run's")
    return worst


def phase_two_ranks() -> None:
    """Phase 15: two ranks against one."""
    from tpu2048_torch.config import AgentConfig
    from tpu2048_torch.train.loop import Trainer

    t0 = time.perf_counter()
    got = _run_ranks(2, "cpu")
    alone = Trainer("alone", AgentConfig(), _ranks_tcfg(), logger=_quiet(),
                    device="cpu")
    alone.run(job=_StopAfter(1))
    want = _flat(alone.state)
    worst = _hold_ranks(got, want, "two gloo ranks", integers=True)
    _line("two_ranks", backend="gloo", ranks=2,
          where="this machine's CPU: one card cannot hold two NCCL ranks",
          n=5, envs=RANKS_ENVS, steps=8, integers="bitwise against the "
          "one-rank CPU run", replicas="bitwise equal",
          tables_max_abs_err=worst, tolerance="2^-17 * max|table|",
          collectives=json.loads(str(got["collectives"])),
          seconds=time.perf_counter() - t0)
    cards = torch.cuda.device_count()
    if cards >= 2:
        t0 = time.perf_counter()
        got = _run_ranks(2, "cuda")
        alone = Trainer("alone", AgentConfig(), _ranks_tcfg(),
                        logger=_quiet(), device="cuda")
        alone.run(job=_StopAfter(1))
        # the card adds colliding terms in no fixed order: tables only
        worst = _hold_ranks(got, _flat(alone.state), "two NCCL ranks",
                            integers=False)
        _line("two_ranks", backend="nccl", ranks=2, cards=cards,
              replicas="bitwise equal", tables_max_abs_err=worst,
              tolerance="2^-17 * max|table|",
              seconds=time.perf_counter() - t0)
    else:
        _line("two_ranks", backend="nccl", ranks=2, run=False,
              why=f"{cards} card here: NCCL takes one rank per device")


def _model_axis_launches(shard, feat0: int, g: int, steps: int) -> dict:
    """The shipped learner's launches on a rank in ``steps`` steps under
    a model axis: every kernel on every step where the rank holds tuples
    of the 16^4 class, none where it holds none."""
    a, b = shard.tuples(feat0, g)
    return _default_step_launches(steps) if a < b else dict.fromkeys(
        ("eval_class", "grad_class", "fold_class"), 0)


def _model_step_collectives(ts, tcfg) -> dict:
    """Phase 18's model-axis collectives per step of the shipped learner
    on (1, model) where no class is split (n >= 5), from the step's
    shapes: one all-reduce of the selection's pieces (one value per
    16^2..16^4 class and per gather feature, for each of the 4N
    afterstates) and one of the bootstrap's (one per class, N rows)."""
    from tpu2048_torch.ops import onehot as oh

    classes = oh.build_table_classes(ts)
    n, c, k = tcfg.num_envs, len(classes.matmul), len(classes.gather_feats)
    return {"model_all_reduce": 2, "model_all_gather": 0,
            "model_bytes": (c + k) * 4 * n * 4 + c * n * 4}


def _model_rank_main(rendezvous: str, rank: int, backend: str,
                     out: str) -> int:
    """One rank of phase 18 on a (1, 2) mesh: the step checks at n=6
    and n=4, then ``Trainer.run`` of ``AgentConfig(n=6)`` at the shipped
    width; writes its readings to ``<out>/rank<r>.json``."""
    from tpu2048_torch.config import AgentConfig, MeshConfig, TrainConfig
    from tpu2048_torch.features.ntuple import get_tuple_set
    from tpu2048_torch.parallel import distributed
    from tpu2048_torch.store.artifacts import LocalStore
    from tpu2048_torch.store.checkpoint import load_agent, load_agent_dense
    from tpu2048_torch.train.loop import Trainer
    from tpu2048_torch.train.trial import trial

    torch.set_num_threads(4)
    if not distributed.initialize(rendezvous, 2, rank, backend=backend):
        raise AssertionError("distributed.initialize returned False")
    if torch.distributed.get_backend() != backend:
        raise AssertionError(f"the group runs {torch.distributed.get_backend()}")
    mesh = distributed.global_mesh(MeshConfig(data=1, model=2))
    if (mesh.device.type != "cuda" or mesh.model_rank != rank
            or mesh.staged != (backend == "gloo")):
        raise AssertionError(f"rank {rank}: a mesh on {mesh.device}, model "
                             f"rank {mesh.model_rank}, staged {mesh.staged}")
    res = {"rank": rank, "backend": backend, "device": str(mesh.device),
           "steps": {}}

    # (a) one step of 8192 envs against the unmeshed CPU step
    for n in (6, 4):
        t0 = time.perf_counter()
        acfg = AgentConfig(n=n, table_ops="pallas")
        ts = get_tuple_set(n)
        shard = mesh.table_shard(ts)
        tcfg = TrainConfig(num_envs=TRAIN_B)
        mesh.counts.update(dict.fromkeys(mesh.counts, 0))
        card, plain, slack, launches = _card_step_against_cpu(
            acfg, tcfg, mesh=mesh)
        if launches != _model_axis_launches(shard, 0, 17, 1):
            raise AssertionError(f"rank {rank}, n={n}: launched {launches}")
        step = {"n": n, "shard": [shard.lo, shard.hi],
                "tuples": list(shard.tuples(0, 17)),
                "class_split": shard.split(0, 17), "launches": launches,
                "seconds": time.perf_counter() - t0}
        if plain is not None:
            step["max_abs_err"] = _hold_states(
                card, plain, f"model axis n={n} step", slack)
        res["steps"][n] = step
        del card, plain, slack
    mesh.barrier()

    # (b) Trainer.run of the n=6 defaults at the shipped width
    acfg = AgentConfig(n=6)
    ts = get_tuple_set(6)
    shard = mesh.table_shard(ts)
    tcfg = TrainConfig(episodes=10**9, checkpoint_every=10**9)
    store = LocalStore(os.path.join(out, "store"))
    name = "smoke_model_axis"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(name, acfg, tcfg, store=store, logger=_quiet(), mesh=mesh)
    init_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    mesh.counts.update(dict.fromkeys(mesh.counts, 0))
    t0 = time.perf_counter()
    got = tr.run(job=_StopAfter(MODEL_AXIS_SEGMENTS))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, counts = _launch_counts(), dict(mesh.counts)
    steps = MODEL_AXIS_SEGMENTS * tcfg.steps_per_call
    if launches != _model_axis_launches(shard, 0, 17, steps):
        raise AssertionError(f"rank {rank}: the run launched {launches}")
    st = tr.state
    if st.weights.shape != (shard.size,) or st.opt_a.shape != (shard.size,):
        raise AssertionError(f"rank {rank} holds {tuple(st.weights.shape)} "
                             f"entries, not its shard's {shard.size}")
    if not bool(torch.isfinite(st.weights).all()) or got["episodes"] <= 0:
        raise AssertionError(f"rank {rank}: non-finite weights or no episode")
    # the two ranks' replicated leaves (all but the tables) hold the same
    # bits: one data rank, so the env leaves are replicas too (the rings'
    # trash slot and the logs' spill column aside: they take the writes
    # of lanes that do not record, in no set order on the card)
    differ = []
    for f, x in _flat(st._replace(weights=st.alpha, opt_e=st.alpha,
                                  opt_a=st.alpha)).items():
        if f in ("recorder.moves", "recorder.spawns"):
            x = x[:, :-1]
        elif f in ("metrics.score_ring", "metrics.tile_ring"):
            x = x[:-1]
        t = torch.from_numpy(np.ascontiguousarray(x)).reshape(-1)
        t = t.view(torch.int32) if t.dtype == torch.float32 else t
        rows = mesh.all_gather(t.to(mesh.device)[None], "model")
        if not bool((rows == rows[0]).all()):
            differ.append(f)
    if differ:
        raise AssertionError(f"the ranks' replicas differ in {differ}")
    per_step = _model_step_collectives(ts, tcfg)
    res["run"] = {
        "shard": [shard.lo, shard.hi], "shard_entries": shard.size,
        "tables_bytes": 3 * 4 * shard.size, "launches": launches,
        "collectives": counts, "collectives_per_step": per_step,
        "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
        "init_peak_allocated_bytes": init_peak,
        "env_steps_per_s": got["env_steps_per_sec"], "seconds": seconds,
        "episodes": got["episodes"], "top_score": got["top_score"]}
    mesh.barrier()  # every rank has read the counts and the state
    if rank == 0:
        # the checkpoint holds the whole tables; this rank's shard of
        # them is its state's, and the agent plays on the card
        acfg2, w_np, meta = load_agent(store, name)
        if (acfg2 != acfg or w_np.shape != (ts.total,)
                or not np.array_equal(w_np[shard.lo: shard.hi],
                                      st.weights.cpu().numpy())
                or meta["extras"]["opt_a"].shape != (ts.total,)):
            raise AssertionError("the model-axis checkpoint does not load "
                                 "as saved")
        del w_np, meta
        _replays(store, f"best_of_{name}", got["top_score"])
        _, w, _ = load_agent_dense(store, name, device="cuda")
        games = trial(ts, w, num=256, seed=1)
        if games.odometers.min() <= 0:
            raise AssertionError("the model-axis agent did not play")
        res["run"]["trial_avg_score"] = float(games.scores.mean())
        del w
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    mesh.barrier()
    torch.distributed.destroy_process_group()
    print(f"MODEL_RANK_OK {rank}", flush=True)
    return 0


def _run_model_ranks(backend: str) -> list:
    """Start phase 18's two ranks of this script on ``backend``, wait
    for them (killed at MODEL_AXIS_TIMEOUT), and return each rank's
    readings."""
    here = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, here, "--model-rank", f"file://{tmp}/rendezvous",
             str(r), backend, tmp],
            cwd=os.path.dirname(here), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        logs = []
        deadline = time.monotonic() + MODEL_AXIS_TIMEOUT
        try:
            for p in procs:
                logs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
        for r, (p, log) in enumerate(zip(procs, logs)):
            if p.returncode != 0 or f"MODEL_RANK_OK {r}" not in log:
                raise AssertionError(f"model-axis rank {r} on {backend} "
                                     f"failed:\n{log}")
        out = []
        for r in range(2):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                out.append(json.load(f))
        return out


def _model_axis_kernel_times(kstats: dict) -> None:
    """Phase 18's tuple-range launches at n=4's split (tuples 0-8 on rank
    0, 9-16 on rank 1): ``eval_class`` on the range's block of a whole
    (17, 256, 256) table, its (hi, lo) columns made for the range alone,
    bitwise against the ordered sum and timed as in phase 3 (selection
    and bootstrap); ``grad_class`` on the range's columns, checked as in
    phase 5 and timed."""
    from tpu2048_torch.ops import kernels

    dev = torch.device("cuda")
    tables, hi, lo = _inputs(17, 256, 256, SERVE_B, seed=18, dev=dev)
    for a, b in ((0, 9), (9, 17)):
        block = tables[a:b]  # a view into the whole class, contiguous
        for batch, precision in ((SERVE_B, "bf16"), (TRAIN_B, "bf16x2")):
            h_r = hi[:batch, a:b].contiguous()
            l_r = lo[:batch, a:b].contiguous()
            got = kernels.eval_class(block, h_r, l_r, precision)
            if not torch.equal(got, kernels.eval_class_ordered(
                    block, h_r, l_r, precision)):
                raise AssertionError(f"eval_class on tuples {a}-{b - 1} is "
                                     "not the ordered sum")
            row = _eval_time(block, h_r, l_r, precision)
            kstats["eval_class"]["instances"].append(
                {**row, "case": f"model_axis tuples {a}-{b - 1}"})
        args = _grad_inputs(b - a, 256, 256, TRAIN_B, seed=18 + a, dev=dev)
        _grad_check(*args, 256, 256, f"model axis tuples {a}-{b - 1}")
        row = _grad_time(f"model_axis tuples {a}-{b - 1}", args, 256, 256)
        kstats["grad_class"]["instances"].append(row)


def phase_model_axis(kstats: dict) -> dict:
    """Phase 18: the mesh's model axis, two ranks on one card over gloo
    (and on two cards over NCCL where there are two).  Returns the
    kernels' launches of the gloo ranks' n=6 runs, summed."""
    from tpu2048_torch.features.ntuple import get_tuple_set
    from tpu2048_torch.parallel import mesh as pmesh

    t0 = time.perf_counter()
    _model_axis_kernel_times(kstats)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # the ranks share the card with this process
    ts = get_tuple_set(6)
    total = {"eval_class": 0, "grad_class": 0, "fold_class": 0}
    cards = torch.cuda.device_count()
    for backend in ("gloo", "nccl"):
        if backend == "nccl" and cards < 2:
            _line("model_axis", backend="nccl", ranks=2, run=False,
                  why=f"{cards} card here: NCCL takes one rank per device")
            continue
        ranks = _run_model_ranks(backend)
        for r in ranks:
            for n, step in sorted(r["steps"].items()):
                _line("model_axis_step_check", backend=backend,
                      rank=r["rank"], device=r["device"], envs=TRAIN_B,
                      integers="bitwise against the unmeshed CPU step",
                      tolerance="2^-17 * max|table| + the entry's "
                      "summation-order bound", **step)
        run = [r["run"] for r in ranks]
        steps = MODEL_AXIS_SEGMENTS * 64
        sizes = [hi - lo for lo, hi in (x["shard"] for x in run)]
        if sum(sizes) != ts.total or run[0]["shard"][1] != run[1]["shard"][0]:
            raise AssertionError(f"the shards {[x['shard'] for x in run]} do "
                                 "not cover the table once")
        # the counts of the run: its steps, then the save's reads of the
        # three tables (the shard sizes, then the shards)
        save = {"model_all_gather": 6,
                "model_bytes": 3 * (2 * 8 + 2 * max(sizes) * 4)}
        for x in run:
            want = {k: 0 for k in x["collectives"]}
            for k, v in x["collectives_per_step"].items():
                want[k] = steps * v + save.get(k, 0)
            if x["collectives"] != want:
                raise AssertionError(f"a rank ran {x['collectives']}, "
                                     f"expected {want}")
        if backend == "gloo":
            for x in run:
                for k, v in x["launches"].items():
                    total[k] += v
        _line("model_axis", backend=backend, ranks=2, mesh=[1, 2],
              where=("one card, the collectives staged through the host"
                     if backend == "gloo" else f"{cards} cards"),
              n=6, envs=TRAIN_B, steps_per_call=64,
              segments=MODEL_AXIS_SEGMENTS, weights=int(ts.total),
              shards=[x["shard"] for x in run],
              shard_entries=[x["shard_entries"] for x in run],
              launches=[x["launches"] for x in run],
              launches_per_step=[{k: v / steps for k, v in
                                  x["launches"].items()} for x in run],
              collectives=[x["collectives"] for x in run],
              collectives_per_step=[x["collectives_per_step"] for x in run],
              replicas="bitwise equal",
              peak_allocated_bytes=[x["peak_allocated_bytes"] for x in run],
              init_peak_allocated_bytes=[x["init_peak_allocated_bytes"]
                                         for x in run],
              env_steps_per_s=[x["env_steps_per_s"] for x in run],
              reading="env-steps/s of two ranks sharing one card: a reading",
              episodes=run[0]["episodes"], top_score=run[0]["top_score"],
              best_game_replays=True,
              trial_avg_score=run[0].get("trial_avg_score"),
              seconds=time.perf_counter() - t0)
    return total


def _http(port: int, path: str, body=None):
    """GET ``path`` (or POST ``body`` to it) on the local app server;
    the JSON answer."""
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method="GET" if body is None
        else "POST", data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def _wait(what: str, ready, limit_s: float = APP_WAIT_S):
    """Poll ``ready()`` until it returns something true; raise after
    ``limit_s`` seconds."""
    deadline = time.perf_counter() + limit_s
    while True:
        got = ready()
        if got:
            return got
        if time.perf_counter() > deadline:
            raise AssertionError(f"apps: {what} not within {limit_s} s")
        time.sleep(0.25)


def _finished(port: int, name: str):
    """The train job's status once it has finished, else None."""
    st = _http(port, f"/api/train/status?name={name}")
    return st if st["state"] == "finished" else None


def _log_once(port: int, key: str, text: str):
    """The session log once it holds ``text``, else None."""
    log = _http(port, f"/api/logs?key={key}")["text"]
    return log if text in log else None


def _segments(log: str) -> int:
    """The train segments of a job, from its log's timing report."""
    import re

    found = re.findall(r"^train_segment\s+\S+s\s+x(\d+)", log, re.M)
    if len(found) != 1:
        raise AssertionError("apps: no single timing line in the job's log")
    return int(found[0])


def phase_apps() -> dict:
    """Phase 16: the port's HTTP server over an ``AppService`` with no
    device argument (the card), driven over HTTP: a train job of a new
    n=5 agent at the shipped width to APP_EPISODES episodes, then a
    long one stopped; a 1000-game greedy test job whose best game
    replays to its logged score; a device watch at depth 1 / width 2
    with legal moves and rising scores; the card's memory in
    ``/api/stats``; each job's kernel launches.  Returns the launches
    of the phase."""
    import re

    from tpu2048_torch.apps.server import AppServer
    from tpu2048_torch.apps.service import AppService
    from tpu2048_torch.config import TrainConfig
    from tpu2048_torch.engine.core import np_move
    from tpu2048_torch.store.artifacts import MemoryStore

    t0 = time.perf_counter()
    shipped = TrainConfig()
    if (shipped.num_envs, shipped.steps_per_call) != (TRAIN_B, 64):
        raise AssertionError("the shipped TrainConfig changed its width")
    service = AppService(MemoryStore(),
                         default_tcfg=TrainConfig(episodes=APP_EPISODES))
    if service.device.type != "cuda":
        raise AssertionError(f"apps: the service took {service.device}")
    server = AppServer(service, port=0, vacuum_interval=3600)
    server.start()
    port, name = server.port, "app_n5"
    jobs = {}
    _reset_launches()
    try:
        # -- train: a new agent, then a long job stopped ----------------
        before = _launch_counts()
        r = _http(port, "/api/train/start", {
            "params": {"name": name, "n": 5, "episodes": APP_EPISODES},
            "new_agent": True})
        st = _wait("the train job's end", lambda: _finished(port, name))
        if st["error"] is not None:
            raise AssertionError(f"apps: the train job failed: {st['error']}")
        log = _http(port, f"/api/logs?key={r['log']}")["text"]
        steps = _segments(log) * shipped.steps_per_call
        launches = {k: v - before[k] for k, v in _launch_counts().items()}
        if launches != _default_step_launches(steps):
            raise AssertionError(f"apps: the train job launched {launches} "
                                 f"in {steps} steps")
        chart = _http(port, f"/api/chart?name={name}")
        if (not chart["y"] or name not in _http(port, "/api/agents")
                or "ma_100 = " not in log or f"{name} saved" not in log
                or st["result"]["episodes"] < APP_EPISODES):
            raise AssertionError("apps: the train job left no chart, agent, "
                                 "ma-100 line or checkpoint")
        jobs["train"] = dict(
            steps=steps, episodes=st["result"]["episodes"],
            env_steps_per_s=st["result"]["env_steps_per_sec"],
            log_rate=re.findall(r"\((\d+K) env-steps/s\)", log),
            timer=re.findall(r"^(?:train_segment|metrics_read|checkpoint)"
                             r"\s.*$", log, re.M),
            chart_points=len(chart["y"]), launches=launches)
        r = _http(port, "/api/train/start", {
            "params": {"name": name, "n": 5, "episodes": 10**9},
            "new_agent": False})
        _wait("the long job's start", lambda: _log_once(
            port, r["log"], "training session started"))
        if not _http(port, "/api/train/stop", {"name": name})["stopped"]:
            raise AssertionError("apps: the long job did not stop")
        st = _wait("the stopped job's end", lambda: _finished(port, name))
        log = _http(port, f"/api/logs?key={r['log']}")["text"]
        if st["error"] is not None or "training cancelled" not in log:
            raise AssertionError(f"apps: the stopped job: {st}")
        jobs["train_stopped"] = dict(segments=_segments(log))
        # -- test: 1000 greedy games ------------------------------------
        before = _launch_counts()
        r = _http(port, "/api/test/start", {"name": name,
                                            "num": APP_TEST_GAMES,
                                            "depth": 0})
        log = _wait("the test job's best game", lambda: _log_once(
            port, r["log"], "Best game saved"))
        job = service.jobs.get("test", name)
        job.thread.join(timeout=APP_WAIT_S)
        if job.alive or job.error is not None:
            raise AssertionError(f"apps: the test job failed: {job.error}")
        launches = {k: v - before[k] for k, v in _launch_counts().items()}
        if (f"average score of {APP_TEST_GAMES} runs" not in log
                or launches["eval_class"] <= 0
                or launches["grad_class"] or launches["fold_class"]):
            raise AssertionError(f"apps: the test job: {launches}")
        best = int(re.search(r"Best games:\n(?:.*\n){4}score = (\d+)",
                             log).group(1))
        _replays(service.store, f"best_trial_{name}", best)
        frames = _http(port, f"/api/replay?name=best_trial_{name}")
        if frames[-1]["score"] != best or frames[-1]["next_move"] != -1:
            raise AssertionError("apps: /api/replay does not end the best "
                                 "test game at its logged score")
        moves = int(re.search(r"total env-moves = (\d+)", log).group(1))
        secs = float(re.search(r"total time = ([\d.]+)", log).group(1))
        jobs["test"] = dict(games=APP_TEST_GAMES, best=best,
                            avg=job.result["avg"], env_moves=moves,
                            moves_per_s=moves / secs, seconds=secs,
                            launches=launches)
        # -- device watch -----------------------------------------------
        before = _launch_counts()
        sid = _http(port, "/api/watch/start", {
            "name": name, "backend": "device", "depth": 1, "width": 2})[
                "session"]
        def watched():
            got = _http(port, f"/api/watch/frames?session={sid}&since=0")
            done = len(got["frames"]) > APP_WATCH_FRAMES or got["done"]
            return got["frames"] if done else None

        frames = _wait("ten watch frames", watched)
        _http(port, "/api/watch/stop", {"session": sid})
        job = service.jobs.get("watch", sid)
        job.thread.join(timeout=APP_WAIT_S)
        if job.alive or job.error is not None:
            raise AssertionError(f"apps: the watch job failed: {job.error}")
        launches = {k: v - before[k] for k, v in _launch_counts().items()}
        played = [f for f in frames if f["next_move"] in (0, 1, 2, 3)]
        if len(played) < APP_WATCH_FRAMES or launches["eval_class"] <= 0:
            raise AssertionError(f"apps: the watch: {len(played)} moves, "
                                 f"{launches}")
        for f in played:
            if not np_move(np.asarray(f["board"], np.int8),
                           f["next_move"])[2]:
                raise AssertionError(f"apps: an illegal watch move: {f}")
        scores = [f["score"] for f in frames]
        if any(b < a for a, b in zip(scores, scores[1:])):
            raise AssertionError("apps: a watch score fell")
        jobs["watch"] = dict(frames=len(frames), moves=len(played),
                             launches=launches)
        # -- stats ------------------------------------------------------
        now = _http(port, "/api/stats")["now"]
        total_mb = torch.cuda.get_device_properties(0).total_memory / 2**20
        if (not now.get("hbm_in_use_mb", 0) > 0
                or abs(now["hbm_limit_mb"] - total_mb) > 1
                or now["device"] != torch.cuda.get_device_name(0)):
            raise AssertionError(f"apps: /api/stats reads {now}")
        jobs["stats"] = {k: now[k] for k in ("hbm_in_use_mb", "hbm_limit_mb",
                                              "device", "rss_mb")}
    finally:
        server.stop()
    torch.cuda.synchronize()
    launches = _launch_counts()
    _line("apps", seconds=time.perf_counter() - t0, n=5, envs=TRAIN_B,
          launches=launches, **jobs)
    return launches


def phase_trace() -> None:
    """Phase 17: ``Trainer.run(trace_dir=...)`` of the defaults at the
    shipped width for TRACE_SEGMENTS segments; the trace names all three
    kernels (the wrappers' launches, one kernel event each, two for
    ``grad_class``: its fill and its scatter) among the step's other
    kernels; its size, events, kernel events per step and histogram;
    env-steps/s beside an untraced run's, as a reading."""
    import glob

    from tpu2048_torch.config import AgentConfig, TrainConfig
    from tpu2048_torch.train.loop import Trainer

    tcfg = TrainConfig(episodes=10**9, checkpoint_every=10**9)
    steps = TRACE_SEGMENTS * tcfg.steps_per_call
    rates = {}
    with tempfile.TemporaryDirectory() as root:
        for traced in (False, True):
            tr = Trainer("trace", AgentConfig(), tcfg, logger=_quiet(),
                         device="cuda")
            _reset_launches()
            t0 = time.perf_counter()
            out = tr.run(job=_StopAfter(TRACE_SEGMENTS),
                         trace_dir=root if traced else None)
            run_s = time.perf_counter() - t0
            # the loop's own time, apart from the trace's stop and export
            loop_s = (tr.timer.totals["train_segment"]
                      + tr.timer.totals["metrics_read"])
            rates["traced" if traced else "untraced"] = dict(
                env_steps_per_s=out["env_steps_per_sec"],
                loop_env_steps_per_s=TRAIN_B * steps / loop_s,
                run_s=run_s, loop_s=loop_s)
            del tr
        launches = _launch_counts()
        if launches != _default_step_launches(steps):
            raise AssertionError(f"trace: the run launched {launches}")
        files = glob.glob(os.path.join(root, "*.pt.trace.json"))
        if len(files) != 1:
            raise AssertionError(f"trace: {len(files)} trace files")
        size = os.path.getsize(files[0])
        t0 = time.perf_counter()
        with open(files[0]) as f:
            events = json.load(f)["traceEvents"]
        read_s = time.perf_counter() - t0
    kern = [e for e in events if e.get("cat") == "kernel"]
    symbols = {"eval_class": "eval_class_kernel",
               "grad_class": "grad_class_kernel",
               "fold_class": "fold_class_kernel"}
    counts = {k: sum(sym in e["name"] for e in kern)
              for k, sym in symbols.items()}
    fills = sum("zero_pair" in e["name"] for e in kern)
    if counts != launches or fills != launches["grad_class"]:
        raise AssertionError(f"trace: kernel events {counts} (fills {fills}) "
                             f"against launches {launches}")
    hist, kinds = {}, {}
    for e in kern:
        kind = next((k for k, text in KERNEL_KINDS if text in e["name"]),
                    "other")
        for table, key in ((hist, e["name"]), (kinds, kind)):
            h = table.setdefault(key, [0, 0.0])
            h[0] += 1
            h[1] += float(e.get("dur", 0.0))
    if len(hist) <= 4:
        raise AssertionError("trace: no kernels of the step besides the "
                             "three")
    top = sorted(hist.items(), key=lambda kv: -kv[1][1])[:TRACE_TOP]
    device_us = sum(h[1] for h in hist.values())
    _line("trace", n=5, envs=TRAIN_B, segments=TRACE_SEGMENTS, steps=steps,
          trace_bytes=size, events=len(events), kernel_events=len(kern),
          kernel_events_per_step=len(kern) / steps,
          kernel_names=len(hist), kernel_us_per_step=device_us / steps,
          kernels=counts, grad_class_fills=fills, read_s=read_s,
          **rates,
          by_kind={k: {"per_step": c / steps, "us_per_step": us / steps}
                   for k, (c, us) in sorted(kinds.items(),
                                            key=lambda kv: -kv[1][1])},
          top_kernels_by_us=[{"name": n[:120], "count": c,
                              "us_per_step": us / steps}
                             for n, (c, us) in top])


def main() -> int:
    name = phase_device()
    phase_build()
    kstats = {"eval_class": phase_kernel()}
    serve = phase_slice()
    kstats["grad_class"] = phase_grad_class()
    kstats["fold_class"] = phase_fold_class()
    phase_train_step()
    train, trained = phase_train("smoke")
    phase_grad_trained(trained, kstats["grad_class"])
    search, search_check = phase_search()
    kstats["eval_class"]["instances"].append(search_check)
    phase_train_variants(kstats["grad_class"])
    variant = phase_train_variant("smoke_sgd")
    phase_big_step(6)
    flagship = phase_flagship(6, FLAGSHIP_SEGMENTS, "smoke_n6", save=True)
    phase_big_step(7)
    n7 = phase_flagship(7, N7_SEGMENTS, "smoke_n7", save=False)
    meshed, mesh, mesh_state = phase_mesh()
    phase_fixed_order(mesh, mesh_state)
    del mesh_state
    torch.distributed.destroy_process_group()
    phase_two_ranks()
    apps = phase_apps()
    phase_trace()
    model_axis = phase_model_axis(kstats)
    loaded = sorted(m for m in sys.modules if m == "jax" or m == "tpu2048"
                    or m.startswith(("jax.", "tpu2048.")))
    if loaded:
        raise AssertionError(f"the port loaded {loaded}")
    replaces = {
        "eval_class": "tpu2048/ops/pallas_kernels.py:131",
        "grad_class": "tpu2048/ops/pallas_kernels.py:220",
        "fold_class": "tpu2048/ops/fold_kernel.py:435",
    }
    print(json.dumps({"kernels": [{
        "name": k,
        "route": "cuda",
        "source": f"tpu2048_torch/ops/csrc/{k}.cu",
        "replaces": replaces[k],
        "launches": train[k] + variant[k] + flagship[k] + n7[k] + meshed[k]
        + apps[k] + model_axis[k] + (serve + search if k == "eval_class"
                                     else 0),
        "launches_by_path": {"serve": serve if k == "eval_class" else 0,
                             "train": train[k],
                             "search": search if k == "eval_class" else 0,
                             "train_variant": variant[k],
                             "flagship": flagship[k], "n7": n7[k],
                             "mesh": meshed[k], "apps": apps[k],
                             "model_axis": model_axis[k]},
        "bound_by": "bytes",
        # the same two readings under this round's names
        "bound_us": 1e3 * kstats[k]["bound_ms"],
        "library_call_ms": kstats[k]["library_ms"],
        **kstats[k],
    } for k in replaces]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(_rank_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                            sys.argv[5], sys.argv[6]))
    if sys.argv[1:2] == ["--model-rank"]:
        sys.exit(_model_rank_main(sys.argv[2], int(sys.argv[3]), sys.argv[4],
                                  sys.argv[5]))
    sys.exit(main())
