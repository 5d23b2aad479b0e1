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
     entry (a fresh start's collision): hits bitwise, dsum within
     hits * 2^-23 * (sum of |dw| at the entry), the bound between two
     f32 summation orders; then kernel, plain and library
     (``index_add_`` pair) times beside the bound;
  6. fold_class: the D4 class-fold kernel bitwise against the plain
     ``symmetrize_class_sum`` on random pairs (the 16^4 class at n=4
     and n=5, the 16^3 class at n=3, the 16^2 class at n=2); then
     kernel and plain times beside the bound and the earlier reading (no
     library call computes a D4 orbit sum);
  7. train_step: one n=5 train step of 8192 envs through the kernels
     on the card and through their plain versions on the CPU, from one
     state with dyadic weights and the same numpy draws: every integer
     of the state and the staged recorder rows bitwise, the weights and
     TC sums within 2^-17 of the table's largest entry;
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
     and the best game's replay.

Then a JSON line of the kernels of the three paths (name, route,
source, the TPU kernel it replaces, its launches in the serve, train
and search runs, its largest error against the plain version, its,
the plain version's and the library call's time in ms, and its bound:
the bytes it must move, each input read once and each output written
once, over 3.35 TB/s; every timed shape under ``instances``), and last
``{"ok": true, "device": {...}}``.
Any failure raises and exits non-zero; without a CUDA card the script
exits 1 before any phase.  It imports nothing of jax or ``tpu2048``.
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
TRAIN_B = 8192  # envs of the shipped TrainConfig
TRAIN_SEGMENTS = 12
RAGGED_B = 1001
SEARCH_GAMES = 256
SEARCH_B = 2_000_000  # leaf rows of one chunk of the search tree
SHAPES = [(17, 256, 256), (52, 64, 64), (24, 16, 16)]
PRECISIONS = ["bf16x2", "f32", "bf16"]
REL_TOL = 2.0**-20  # of sum |terms|: f32 summation order only
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published, at 700 W
# the kernels' earlier readings at the same shapes, before the
# redesign of eval_class and fold_class (PERF.md section 6, NVIDIA H100
# 80GB HBM3, 700.00 W), printed on the *_time lines beside this run's
# (not in the kernels line, whose numbers are all of this run)
EARLIER_MS = {("eval_class", "bf16", 32768): 0.010267,
              ("eval_class", "bf16x2", 32768): 0.007419,
              ("eval_class", "f32", 32768): 0.007429,
              ("eval_class", "bf16", SEARCH_B): 0.4040,
              ("grad_class", "random", TRAIN_B): 0.009717,
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
          earlier_ms=EARLIER_MS.get(("eval_class", precision, b)),
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


def phase_grad_class() -> dict:
    from tpu2048_torch.ops import kernels

    dev = torch.device("cuda")
    worst, worst_ratio = 0.0, 0.0
    for g, h, l in SHAPES:
        for b in (TRAIN_B, RAGGED_B):
            for collide in (False, True):
                hi, lo, dw, valid = _grad_inputs(g, h, l, b, b + g, dev,
                                                 collide)
                dsum, hits = kernels.grad_class(hi, lo, dw, valid, h, l)
                torch.cuda.synchronize()
                want_d, want_h = kernels.grad_class_reference(
                    hi, lo, dw, valid, h, l)
                if not torch.equal(hits, want_h):
                    raise AssertionError(f"grad_class {g,h,l} B={b}: hits "
                                         "differ from the plain version")
                mass = kernels.grad_class_reference(hi, lo, dw.abs(), valid,
                                                    h, l)[0]
                err = (dsum - want_d).abs()
                bound = 2.0**-23 * hits * mass
                if not bool((err <= bound).all()):
                    raise AssertionError(f"grad_class {g,h,l} B={b}: dsum "
                                         "outside hits * 2^-23 * sum|dw|")
                worst = max(worst, float(err.max()))
                worst_ratio = max(worst_ratio, float(
                    (err / bound.clamp(min=1e-38)).max()))
    _line("grad_class_check", max_abs_err=worst,
          max_err_over_bound=worst_ratio, bound="hits*2^-23*sum|dw|",
          shapes=SHAPES, batches=[TRAIN_B, RAGGED_B],
          cases=["random", "all rows on one entry"], hits="bitwise")
    g, h, l = SHAPES[0]
    rows = []
    for case, collide in (("random", False), ("collide", True)):
        args = _grad_inputs(g, h, l, TRAIN_B, 11, dev, collide)
        k = _device_ms(lambda: kernels.grad_class(*args, h, l))
        pl = _device_ms(lambda: kernels.grad_class_reference(*args, h, l))
        lib = _grad_library(*args, h, l)
        want_h = kernels.grad_class_reference(*args, h, l)[1]
        if not torch.equal(lib()[1], want_h):
            raise AssertionError("the index_add_ pair's hits differ")
        q = _device_ms(lib)
        hi, _lo, _dw, valid = args
        nvalid = int(valid.sum())
        # valid rows' indices and dw, the mask, and both (G, H, L) blocks
        nbytes = (2 * nvalid * g * 4 + nvalid * 4 + valid.numel()
                  + 2 * g * h * l * 4)
        row = {"case": case, "shape": [g, h, l], "batch": TRAIN_B,
               "ms": k[0], "plain_ms": pl[0], "library_ms": q[0],
               "bound_ms": _bound_ms(nbytes), "bytes": nbytes,
               "bound_share": _bound_ms(nbytes) / k[0]}
        rows.append(row)
        _line("grad_class_time", **row,
              earlier_ms=EARLIER_MS.get(("grad_class", case, TRAIN_B)),
              kernel_ms_median_min_max=list(k),
              plain_ms_median_min_max=list(pl),
              library="two index_add_ on precomputed flat indices",
              library_ms_median_min_max=list(q))
    return {"max_abs_err": worst, "ms": rows[0]["ms"],
            "plain_ms": rows[0]["plain_ms"],
            "library_ms": rows[0]["library_ms"],
            "bound_ms": rows[0]["bound_ms"], "instances": rows}


def _grad_library(hi, lo, dw, valid, h, l):
    """The one-call library form of ``grad_class``: two ``index_add_``
    calls on flat indices made here; the zeroed blocks and the invalid
    rows' zeroed dw are made inside the call."""
    g = hi.shape[1]
    gi = torch.arange(g, device=hi.device)
    flat = ((gi * h + hi.long()) * l + lo.long()).reshape(-1)
    count = valid.to(torch.float32)[:, None].expand(-1, g).reshape(-1)

    def call():
        dsum = torch.zeros(g * h * l, dtype=torch.float32, device=hi.device)
        hits = torch.zeros_like(dsum)
        w = torch.where(valid, dw, 0.0)[:, None].expand(-1, g).reshape(-1)
        dsum.index_add_(0, flat, w)
        hits.index_add_(0, flat, count)
        return dsum.view(g, h, l), hits.view(g, h, l)

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


def phase_train_step() -> None:
    from tpu2048_torch.agent import td
    from tpu2048_torch.config import AgentConfig, TrainConfig
    from tpu2048_torch.draws import NumpyDraws
    from tpu2048_torch.features.ntuple import get_tuple_set

    acfg = AgentConfig(table_ops="pallas")  # kernels on the card, plain on CPU
    tcfg = TrainConfig(num_envs=TRAIN_B)
    ts = get_tuple_set(acfg.n)
    t0 = time.perf_counter()
    st = td.init_td_state(ts, acfg, tcfg, NumpyDraws(0, "cpu"), "cpu")
    warm = td.make_train_step(ts, acfg, tcfg, NumpyDraws(1, "cpu"))
    st, _ = warm(warm(st)[0])  # two steps: valid rows and TC sums
    st = st._replace(weights=torch.from_numpy(_dyadic(ts.total, 2)))
    card, rec_card = td.make_train_step(ts, acfg, tcfg, NumpyDraws(3, "cuda"))(
        _to(st, "cuda"))
    torch.cuda.synchronize()
    plain, rec_plain = td.make_train_step(ts, acfg, tcfg,
                                          NumpyDraws(3, "cpu"))(st)
    same = [torch.equal(a.cpu(), b) for a, b in zip(rec_card, rec_plain)]
    same += [torch.equal(a.cpu(), b) for a, b in zip(card.env, plain.env)]
    same += [torch.equal(getattr(card, f).cpu(), getattr(plain, f))
             for f in ("prev_idx", "prev_cidx", "prev_cmult", "prev_valid",
                       "prev_value", "top_tile", "alpha")]
    same += [torch.equal(a.cpu()[:-1] if a.dim() else a.cpu(),
                         b[:-1] if b.dim() else b)  # ring trash slot aside
             for a, b in zip(card.metrics, plain.metrics)]
    if not all(same):
        raise AssertionError("train step: the card's integer state differs "
                             "from the plain CPU step")
    errs = {}
    for f in ("weights", "opt_e", "opt_a"):
        a, b = getattr(card, f).cpu(), getattr(plain, f)
        tol = 2.0**-17 * float(b.abs().max())
        errs[f] = float((a - b).abs().max())
        if not errs[f] <= tol:
            raise AssertionError(f"train step: {f} differs by {errs[f]} > "
                                 f"{tol}")
    _line("train_step_check", n=acfg.n, envs=TRAIN_B, integers="bitwise",
          max_abs_err=errs, tolerance="2^-17 * max|table|",
          episodes_done=int(card.metrics.episodes),
          seconds=time.perf_counter() - t0)


class _StopAfter:
    """A job that asks the trainer to stop after ``n`` segments."""

    def __init__(self, n: int):
        self.left = n

    def should_stop(self) -> bool:
        self.left -= 1
        return self.left < 0


def phase_train(name: str) -> dict:
    from tpu2048_torch.config import AgentConfig, TrainConfig
    from tpu2048_torch.engine.core import np_move
    from tpu2048_torch.features.ntuple import get_tuple_set
    from tpu2048_torch.obs.logging import Logger
    from tpu2048_torch.ops import kernels
    from tpu2048_torch.store.artifacts import LocalStore
    from tpu2048_torch.store.checkpoint import (load_agent, load_agent_dense,
                                                load_game)
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
        rec = load_game(store, f"best_of_{name}")
        board, score = rec["starting_position"].copy(), 0
        for t in range(rec["odometer"]):
            board, delta, changed = np_move(board, int(rec["moves"][t]))
            if not changed:
                raise AssertionError(f"best game: illegal move at {t}")
            val, i, j = rec["tiles"][t]
            board[i, j] = val
            score += delta
        if (score != rec["score"]
                or not (board == rec["final_board"]).all()
                or score != out["top_score"]):
            raise AssertionError("the saved best game does not replay to "
                                 "the run's best score")
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


def main() -> int:
    name = phase_device()
    phase_build()
    kstats = {"eval_class": phase_kernel()}
    serve = phase_slice()
    kstats["grad_class"] = phase_grad_class()
    kstats["fold_class"] = phase_fold_class()
    phase_train_step()
    train = phase_train("smoke")
    search, search_check = phase_search()
    kstats["eval_class"]["instances"].append(search_check)
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
        "launches": train[k] + (serve + search if k == "eval_class"
                                else 0),
        "launches_by_path": {"serve": serve if k == "eval_class" else 0,
                             "train": train[k],
                             "search": search if k == "eval_class" else 0},
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
    sys.exit(main())
