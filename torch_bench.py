"""Benchmark harness of the PyTorch port (the twin of ``bench.py``):
prints ONE JSON line.

Headline metric: full TD(0) actor-learner training throughput in
env-steps/s on one CUDA card for the SHIPPED AgentConfig defaults (n=5
features, temporal-coherence optimizer, per-move 8-image symmetry
realized through canonical-orbit indices), with the default
TrainConfig recording (ALL envs logged).  vs_baseline is measured
against the reference's ~770 env-steps/s on its 1 CPU core.  Auxiliary
fields: the pinned n=4 configuration, the n=6 quality-flagship
geometry, engine-only throughput (against the 10M north star), and
greedy evaluation throughput at n=5, n=4 and n=4 under "search".

    python3 torch_bench.py [--trace LOGDIR] [--device cuda|cpu]

The last line holds the same keys, in the same order, as
``bench.py``'s.  Comment lines (starting with ``#``) come before it:
the card's name and power limit as nvidia-smi gives them, and one
``# row <key>: {...}`` line per row with its per-rep seconds (min,
median, max), each kernel's launches in the row (warm-up included) and
the row's peak allocated memory on the card.  ``--device`` defaults to
the CUDA card; without one the run raises.  Imports no jax.
"""

import argparse
import json
import statistics
import subprocess
import time

import torch

from tpu2048_torch.agent import td
from tpu2048_torch.config import AgentConfig, TrainConfig
from tpu2048_torch.draws import TorchDraws
from tpu2048_torch.engine import fast as eng
from tpu2048_torch.features import ntuple
from tpu2048_torch.obs.profiler import device_events, device_trace
from tpu2048_torch.ops import dispatch, kernels
from tpu2048_torch.ops.build import load_library
from tpu2048_torch.train import card_device

# Reference training throughput on its own hardware (env-steps/s):
# 100,000 episodes in ~3 days with ~2,000 moves/episode (README.md:12).
REF_TRAIN_STEPS_PER_SEC = 770.0
ENGINE_NORTH_STAR = 10_000_000.0
KERNELS = (kernels.eval_class, kernels.grad_class, kernels.fold_class)


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Marks:
    """The end of each timed rep on the device's own timeline: a CUDA
    event recorded on the stream (no host sync between reps), or the
    host clock on the CPU, where every op has finished when it
    returns."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.marks = []
        self.mark()

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self) -> list:
        """Seconds between consecutive marks (call after a sync)."""
        pairs = zip(self.marks, self.marks[1:])
        if self.cuda:
            return [a.elapsed_time(b) / 1e3 for a, b in pairs]
        return [b - a for a, b in pairs]


def time_reps(step, state, reps: int, device: torch.device,
              reps_s=None) -> float:
    """``state = step(state)`` once untimed, then ``reps`` times timed;
    returns the wall seconds of the timed reps, from a synchronised
    start to the card's end of the last one.  ``reps_s``, a list, gets
    each rep's seconds."""
    state = step(state)  # warm-up: first launches and allocations
    sync(device)
    t0 = time.time()
    marks = _Marks(device)
    for _ in range(reps):
        state = step(state)
        marks.mark()
    sync(device)
    dt = time.time() - t0
    if reps_s is not None:
        reps_s.extend(marks.seconds())
    return dt


def timeit(fn, *args, device: torch.device, reps: int = 5) -> float:
    """Seconds per call of ``fn(*args)`` over ``reps`` calls, after one
    untimed call."""
    fn(*args)
    sync(device)
    t0 = time.time()
    for _ in range(reps):
        fn(*args)
    sync(device)
    return (time.time() - t0) / reps


def device_cost(fn, device: torch.device, calls: int = 1):
    """Launches (kernels, memsets and copies) and device µs per call,
    read from a ``torch.profiler`` trace of ``fn()``, which makes
    ``calls`` calls: {"launches": x, "device_us": y, "kernels": {name:
    {"launches": per call, "us_each": device µs per launch}}} (the
    port's kernels that ran), or None off the card, where no device
    work is traced."""
    if device.type != "cuda":
        return None
    sync(device)
    # with the host's activity too: a trace of the card's alone dropped
    # most of the long kernels of a call on the H100
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        sync(device)
    events = device_events(prof)
    kernels_us = {}
    for kern in KERNELS:
        mine = [e[2] for e in events if kern.__name__ in e[0]]
        if mine:
            kernels_us[kern.__name__] = {"launches": len(mine) / calls,
                                         "us_each": sum(mine) / len(mine)}
    return {"launches": len(events) / calls,
            "device_us": sum(e[2] for e in events) / calls,
            "kernels": kernels_us}


def cost_line(label: str, cost, per: str = "call") -> str:
    """A comment line of ``device_cost``'s reading for a row."""
    if cost is None:
        return f"# {label}: launches and device us per {per} not measured " \
               f"(no card)"
    line = (f"# {label}: {cost['launches']:.2f} launches, "
            f"{cost['device_us']:.2f} device us per {per}")
    for name, k in cost["kernels"].items():
        line += (f"; {name} {k['launches']:.2f} per {per} at "
                 f"{k['us_each']:.2f} us each")
    return line


def seeded_generator(device: torch.device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def bench_train(n_envs=8192, k=64, reps=8, acfg=None, record_envs=-1,
                device=None, reps_s=None):
    """TD train throughput, env-steps/s: one untimed segment of ``k``
    steps at ``n_envs`` envs, then ``reps`` timed ones (``acfg``: the
    shipped AgentConfig by default).  ``reps_s``, a list, gets each
    timed rep's seconds (``time_reps``), as in the other rows."""
    # k matches TrainConfig.steps_per_call (the SHIPPED default): the
    # headline measures the defaults as shipped
    device = card_device(device, "bench_train")
    if acfg is None:
        # the shipped defaults: the champion quality recipe
        acfg = AgentConfig()
    ts = ntuple.get_tuple_set(acfg.n)
    tcfg = TrainConfig(
        num_envs=n_envs, steps_per_call=k, ring_size=8192,
        record_envs=record_envs, max_record_steps=16384, seed=0,
    )
    draws = TorchDraws(seeded_generator(device, 0))
    state = td.init_td_state(ts, acfg, tcfg, draws, device)
    seg = td.make_train_segment(ts, acfg, tcfg, draws)
    dt = time_reps(seg, state, reps, device, reps_s)
    return reps * k * n_envs / dt


def first_move(codes: torch.Tensor) -> torch.Tensor:
    """Direction 0's afterstate of each board where any move is legal,
    the board itself where none is; no spawn."""
    aft, _delta, legal, _t = eng.afterstates_full(codes)
    return torch.where(legal.any(dim=0)[:, None], aft[0], codes)


def rolled_codes(n_envs: int, draws, moves: int = 3) -> torch.Tensor:
    """Fresh boards rolled ``moves`` times by ``first_move``: the
    breakdown scripts' mid-game-ish boards."""
    codes = eng.new_codes(n_envs, draws)
    for _ in range(moves):
        codes = first_move(codes)
    return codes


def afterstate_cells(aft: torch.Tensor) -> torch.Tensor:
    """(4, N, 4) afterstate codes -> (4, N, 16) cells, directions 1 and
    3 transposed back to the board's own orientation."""
    tperm = torch.arange(16, device=aft.device).reshape(4, 4).T.reshape(16)
    cells4 = eng.cells_from_codes(aft)
    return torch.stack([cells4[0], cells4[1][..., tperm],
                        cells4[2], cells4[3][..., tperm]])


def engine_roll(codes: torch.Tensor, draws, k: int) -> torch.Tensor:
    """``k`` lockstep engine steps of a (N, 4) code batch: all four
    afterstates, a spawn on direction 0's, a fresh board where no move
    is legal.  ``bench.py`` also adds ``delta.sum(...) * 0`` to the
    codes so that XLA keeps the score lanes of its fused gather; eager
    PyTorch drops no output it computed, so the twin leaves it out."""
    n = codes.shape[0]
    for _ in range(k):
        aft, _delta, legal, _t = eng.afterstates_full(codes)
        done = ~legal.any(dim=0)
        draws.split()
        nc, _, _ = eng.spawn_codes(aft[0], draws)
        codes = torch.where(done[:, None], eng.new_codes(n, draws), nc)
    return codes


def bench_engine(n_envs=8192, k=256, reps=6, device=None, reps_s=None):
    """Engine-only lockstep stepping: afterstates + spawn + auto-reset
    (packed row-code representation, the train-path engine)."""
    device = card_device(device, "bench_engine")
    draws = TorchDraws(seeded_generator(device, 0))
    codes = eng.new_codes(n_envs, draws)
    dt = time_reps(lambda c: engine_roll(c, draws, k), codes, reps, device,
                   reps_s)
    return reps * k * n_envs / dt


def eval_roll(eval_fn, w: torch.Tensor, codes: torch.Tensor, draws,
              k: int) -> torch.Tensor:
    """``k`` greedy steps of a (N, 4) code batch: every afterstate
    valued by ``eval_fn(w, cells)`` (directions 1 and 3 transposed
    back), the best legal one taken, a spawn, a fresh board where no
    move is legal."""
    n = codes.shape[0]
    ar = torch.arange(n, device=codes.device)
    for _ in range(k):
        aft, _delta, legal, _t = eng.afterstates_full(codes)
        vals = eval_fn(w, afterstate_cells(aft))
        masked = torch.where(legal, vals, float("-inf"))
        # the first maximal direction, as jnp.argmax takes it
        bd = masked.argmax(dim=0).to(torch.int32)
        chosen = eng.canonicalize_chosen(aft[bd.long(), ar], bd)
        done = ~legal.any(dim=0)
        draws.split()
        nc, _, _ = eng.spawn_codes(chosen, draws)
        codes = torch.where(done[:, None], eng.new_codes(n, draws), nc)
    return codes


def bench_eval(n_envs=8192, k=128, reps=4, n=5, table_ops="auto",
               device=None, reps_s=None):
    """Greedy policy inference throughput (trained-agent play): codes
    engine + table eval, the serve path.  Default geometry is the
    SHIPPED AgentConfig n=5 (dense table, identity indices); ``n=4`` is
    kept for comparability, and ``table_ops="search"`` measures the
    bf16 search-grade evaluator."""
    device = card_device(device, "bench_eval")
    ts = ntuple.get_tuple_set(n)
    w = ntuple.init_weights(ts, seeded_generator(device, 0))
    eval_fn = dispatch.make_evaluator(ts, table_ops)
    draws = TorchDraws(seeded_generator(device, 0))
    codes = eng.new_codes(n_envs, draws)
    dt = time_reps(lambda c: eval_roll(eval_fn, w, c, draws, k), codes,
                   reps, device, reps_s)
    return reps * k * n_envs / dt


def card_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them
    (the first card's line, or the line of ``device``'s index), or
    "cpu"."""
    if device.type != "cuda":
        return "cpu"
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return lines[device.index or 0]


def start(device, who: str, prefix: str = "") -> torch.device:
    """``device`` resolved (the CUDA card when None; without one this
    raises), its ``card_line`` printed after ``prefix``, and on the
    card the kernels' library built and bound, so that no nvcc time
    lands in a timed rep."""
    device = card_device(device, who)
    print(f"{prefix}{card_line(device)}", flush=True)
    if device.type == "cuda":
        load_library()
    return device


def _row(key: str, fn, device: torch.device, **kw) -> float:
    """One row: ``fn(device=device, **kw)``'s rate, with a comment line
    of its per-rep seconds, kernel launches and peak memory."""
    for kern in KERNELS:
        kern.launches = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reps_s = []
    rate = fn(device=device, reps_s=reps_s, **kw)
    info = {
        "rate": rate,
        "reps_s": ({"min": min(reps_s), "median": statistics.median(reps_s),
                    "max": max(reps_s)} if reps_s else None),
        "launches": {kern.__name__: kern.launches for kern in KERNELS},
        "peak_allocated_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None),
    }
    print(f"# row {key}: " + json.dumps(info), flush=True)
    return rate


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--trace", default=None, metavar="LOGDIR",
                   help="capture a torch.profiler device trace of the "
                        "headline train benchmark (Chrome trace format)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    device = start(args.device, "torch_bench", prefix="# ")
    if args.trace:
        with device_trace(args.trace):
            bench_train(reps=1, device=device)
        print(f"# trace written to {args.trace}", flush=True)

    # the SHIPPED defaults — headline
    champion_sps = _row("value", bench_train, device)
    n4_sps = _row(
        "train_n4_pinned_sps", bench_train, device,
        acfg=AgentConfig(n=4, optimizer="sgd", sym_mode="periodic",
                         alpha=0.25),
        record_envs=32,  # the round-1/2 pinned setting, comparability
    )
    n6_sps = _row("train_n6_flagship_sps", bench_train, device,
                  acfg=AgentConfig(n=6), reps=2)  # quality-flagship geometry
    engine_sps = _row("engine_env_steps_per_sec", bench_engine, device)
    # SHIPPED defaults geometry (n=5)
    eval_sps = _row("eval_env_steps_per_sec", bench_eval, device)
    eval_n4_sps = _row("eval_n4_env_steps_per_sec", bench_eval, device, n=4)
    eval_bf16_sps = _row("eval_n4_bf16_env_steps_per_sec", bench_eval, device,
                         n=4, table_ops="search")
    print(
        json.dumps(
            {
                "metric": "train_env_steps_per_sec_1chip_defaults",
                "value": round(champion_sps, 1),
                "unit": "env-steps/s",
                "vs_baseline": round(
                    champion_sps / REF_TRAIN_STEPS_PER_SEC, 2
                ),
                "train_n4_pinned_sps": round(n4_sps, 1),
                "train_n6_flagship_sps": round(n6_sps, 1),
                "engine_env_steps_per_sec": round(engine_sps, 1),
                "engine_vs_north_star_10M": round(
                    engine_sps / ENGINE_NORTH_STAR, 3
                ),
                "eval_env_steps_per_sec": round(eval_sps, 1),
                "eval_n4_env_steps_per_sec": round(eval_n4_sps, 1),
                "eval_n4_bf16_env_steps_per_sec": round(
                    eval_bf16_sps, 1
                ),
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
