#!/usr/bin/env python3
"""Engine step cost breakdown of the PyTorch port on the card (the twin
of ``scripts/bench_engine_breakdown.py``).

Isolates the components of the lockstep engine step (LUT gathers,
spawn, reset, the chosen move's score) in seven bodies, each rolled
``K`` steps over ``N`` envs.  JAX rolls a body inside one
``lax.scan``; eager PyTorch has no twin of that, so here each roll is
a Python loop of ``K`` steps between two synchronisations, and the
host's launch rate is part of every number.  The reference also adds
``delta * 0`` to the codes so that XLA keeps the score lanes live;
eager PyTorch computes every output it is asked for, so the twin
leaves the add out.

Draws come from a ``TorchDraws`` on a seeded generator of the device.
The reference's ``split(k2)`` / ``split(k2, 3)`` in a body is one
``draws.split()`` here, as in ``torch_bench.engine_roll``: the spawn
draws, then the fresh boards' draws, of that step.

Each row prints its rate, ``REPS * K * N`` steps over the wall time,
then a comment line of the launches and device µs per step, read
with ``torch.profiler`` over one more roll of ``PROFILE_STEPS`` steps
(not measured on the CPU).

Usage:
  python3 scripts/torch_bench_engine_breakdown.py [n_envs] [--device D]

``n_envs`` defaults to 8192; ``--device`` to the CUDA card (without
one the run raises).  The first line is the card's name and power
limit.  Imports no jax.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import torch_bench  # noqa: E402
from tpu2048_torch.draws import TorchDraws  # noqa: E402
from tpu2048_torch.engine import fast as eng  # noqa: E402

K = 256
REPS = 6
# steps of the profiled roll: a step launches the same kernels all
# along a roll, and under the profiler it costs ~20x a plain one
PROFILE_STEPS = 32


def gathers_only(cd, draws):
    aft, legal, _t = eng.afterstates_nc(cd)
    # rotate over directions so data keeps changing without spawn
    return torch.where(legal.any(dim=0)[:, None], aft[0], cd)


def gathers_quad(cd, draws):
    aft, _delta, legal = eng.afterstates_codes(cd)  # the quad table
    return torch.where(legal.any(dim=0)[:, None], aft[0], cd)


def full_quad(cd, draws):
    aft, _delta, legal = eng.afterstates_codes(cd)
    done = ~legal.any(dim=0)
    draws.split()
    nc, _, _ = eng.spawn_codes(aft[0], draws)
    return torch.where(done[:, None], eng.new_codes(cd.shape[0], draws), nc)


def spawn_only(cd, draws):
    draws.split()
    nc, _, _ = eng.spawn_codes(cd, draws)
    # clear a row to keep empties available
    nc[:, 0] = 0
    return nc


def gathers_spawn(cd, draws):
    aft, _legal, _t = eng.afterstates_nc(cd)
    draws.split()
    nc, _, _ = eng.spawn_codes(aft[0], draws)
    return nc


def full(cd, draws):
    aft, legal, _t = eng.afterstates_nc(cd)
    done = ~legal.any(dim=0)
    draws.split()
    nc, _, _ = eng.spawn_codes(aft[0], draws)
    return torch.where(done[:, None], eng.new_codes(cd.shape[0], draws), nc)


def full_scored(cd, draws):
    aft, legal, tc = eng.afterstates_nc(cd)
    # the first legal direction, as jnp.argmax of the bool mask takes it
    bd = legal.to(torch.int32).argmax(dim=0).to(torch.int32)
    eng.chosen_delta(cd, tc, bd)
    done = ~legal.any(dim=0)
    draws.split()
    nc, _, _ = eng.spawn_codes(aft[0], draws)
    return torch.where(done[:, None], eng.new_codes(cd.shape[0], draws), nc)


# (label, body), in the reference's order and words
ROWS = (
    ("gathers only", gathers_only),
    ("gathers quad (+scores)", gathers_quad),
    ("full quad (+scores)", full_quad),
    ("spawn only", spawn_only),
    ("gathers + spawn", gathers_spawn),
    ("full step", full),
    ("full + chosen score", full_scored),
)


def roll(body, codes, draws, k: int = K):
    """``k`` steps of ``body`` from ``codes``."""
    for _ in range(k):
        codes = body(codes, draws)
    return codes


def timed(name: str, body, n: int, device: torch.device) -> float:
    """One row: an untimed roll, ``REPS`` timed rolls, the rate line,
    then the launches and device µs per step of one more, shorter roll
    (``PROFILE_STEPS`` steps)."""
    draws = TorchDraws(torch_bench.seeded_generator(device, 0))
    codes = eng.new_codes(n, draws)
    out = roll(body, codes, draws)
    torch_bench.sync(device)
    t0 = time.time()
    for _ in range(REPS):
        out = roll(body, out, draws)
    torch_bench.sync(device)
    dt = time.time() - t0
    rate = REPS * K * n / dt
    print(f"{name:24s}: {rate / 1e6:7.3f}M steps/s", flush=True)
    cost = torch_bench.device_cost(
        lambda: roll(body, out, draws, PROFILE_STEPS), device,
        calls=PROFILE_STEPS)
    print(torch_bench.cost_line(name, cost, per="step"), flush=True)
    return rate


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("n_envs", type=int, nargs="?", default=8192)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    device = torch_bench.start(args.device, "bench_engine_breakdown")
    for name, body in ROWS:
        timed(name, body, args.n_envs, device)


if __name__ == "__main__":
    main()
