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
     2^-20 of sum |terms|; then kernel and plain times at B = 32768,
     (17, 256, 256), timed with CUDA events;
  4. slice: a canonical-form n=5 agent with dyadic weights is saved in
     the reference's checkpoint format, loaded by the port onto the
     card, and plays 8192 games with ``table_ops="auto"`` (the kernel)
     and again with ``"gather"``; every value is exact in f32, so the
     two runs must agree exactly;
  5. grad_class: the class-gradient kernel against its plain version
     at the three class shapes, B = 8192 and a ragged B = 1001, half
     the rows invalid, with random indices and with every row on one
     entry (a fresh start's collision): hits bitwise, dsum within
     hits * 2^-23 * (sum of |dw| at the entry), the bound between two
     f32 summation orders; then kernel and plain times;
  6. fold_class: the D4 class-fold kernel bitwise against the plain
     ``symmetrize_class_sum`` on random pairs (the 16^4 class at n=4
     and n=5, the 16^3 class at n=3); then kernel and plain times;
  7. train_step: one n=5 train step of 8192 envs through the kernels
     on the card and through their plain versions on the CPU, from one
     state with dyadic weights and the same numpy draws: every integer
     of the state and the staged recorder rows bitwise, the weights and
     TC sums within 2^-17 of the table's largest entry;
  8. train: ``Trainer.run`` at the shipped defaults (n=5, 8192 envs,
     K=64) for 12 segments: every step launched each kernel, the
     weights are finite, episodes completed, the saved best game
     replays to its score, and the checkpoint loads through
     ``tpu2048.store.checkpoint.load_agent`` and plays 256 games
     through the port; env-steps/s, wall per segment, and the ma-100
     of the first and last windows (the learning signal).

Then a JSON line of the kernels of the two paths (name, route, source,
the TPU kernel it replaces, its launches in the serve and train runs,
its largest error against the plain version, and its and the plain
version's time in ms), and last ``{"ok": true, "device": {...}}``.
Any failure raises and exits non-zero; without a CUDA card the script
exits 1 before any phase.  It imports no jax.
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
    w_np = _dyadic(ts.total, 0)
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
    times = {}
    for case, collide in (("random", False), ("collide", True)):
        args = _grad_inputs(g, h, l, TRAIN_B, 11, dev, collide)
        k = _device_ms(lambda: kernels.grad_class(*args, h, l))
        pl = _device_ms(lambda: kernels.grad_class_reference(*args, h, l))
        times[case] = (k, pl)
        _line("grad_class_time", case=case, shape=[g, h, l], batch=TRAIN_B,
              kernel_ms_median_min_max=list(k),
              plain_ms_median_min_max=list(pl))
    return {"max_abs_err": worst, "ms": times["random"][0][0],
            "plain_ms": times["random"][1][0]}


def phase_fold_class() -> dict:
    from tpu2048_torch.features.ntuple import get_tuple_set
    from tpu2048_torch.features.symmetry import symmetrize_class_sum
    from tpu2048_torch.ops import kernels

    dev = torch.device("cuda")
    worst = 0.0
    for n, g, size in ((4, 17, 65536), (5, 17, 65536), (3, 52, 4096)):
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
                                       "n=3 52x16^3"], bitwise=True,
          max_abs_err=worst)
    ts = get_tuple_set(5)
    pair = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (2, 17, 65536)).astype(np.float32)).to(dev)
    k = _device_ms(lambda: kernels.fold_class(ts, 0, 17, pair))
    pl = _device_ms(lambda: symmetrize_class_sum(ts, 0, 17, pair))
    _line("fold_class_time", shape=[2, 17, 65536],
          kernel_ms_median_min_max=list(k), plain_ms_median_min_max=list(pl))
    return {"max_abs_err": worst, "ms": k[0], "plain_ms": pl[0]}


def _to(x, dev):
    """A copy of a (nested) tuple of tensors on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, copy=True)
    return type(x)(*(_to(v, dev) for v in x))


def phase_train_step() -> None:
    from tpu2048.config import AgentConfig, TrainConfig
    from tpu2048_torch.agent import td
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
    from tpu2048.config import AgentConfig, TrainConfig
    from tpu2048.store.artifacts import LocalStore
    from tpu2048.store.checkpoint import load_agent, load_game
    from tpu2048.obs.logging import Logger
    from tpu2048_torch.engine.core import np_move
    from tpu2048_torch.features.ntuple import get_tuple_set
    from tpu2048_torch.ops import kernels
    from tpu2048_torch.store.checkpoint import load_agent_dense
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


def main() -> int:
    name = phase_device()
    phase_build()
    kstats = {"eval_class": phase_kernel()}
    serve = phase_slice()
    kstats["grad_class"] = phase_grad_class()
    kstats["fold_class"] = phase_fold_class()
    phase_train_step()
    train = phase_train("smoke")
    if "jax" in sys.modules:
        raise AssertionError("the port loaded jax")
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
        "launches": train[k] + (serve if k == "eval_class" else 0),
        "launches_by_path": {"serve": serve if k == "eval_class" else 0,
                             "train": train[k]},
        **kstats[k],
    } for k in replaces]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
