#!/usr/bin/env python3
"""Data-parallel scaling of the PyTorch port's train step (the twin of
``scripts/bench_scaling.py``).

Runs the SAME global env batch (n=4, sgd, alpha 0.25, periodic,
"gather"; 1024 envs, K=32 steps per segment, 3 timed segments after
one untimed) on 1, 2, 4 and 8 ranks and compares env-steps/s.  World 1
runs in this process, without a process group; world d > 1 is d
processes of this script, one rank each, that meet through
``tpu2048_torch.parallel.distributed`` at a ``file://`` rendezvous in
a temporary directory and train on a ``MeshConfig(data=d)`` mesh.  A world's ranks are killed after
``RANK_TIMEOUT`` seconds.

  * By default the ranks share the one CUDA card over gloo
    (``initialize(backend="gloo")``: each collective is staged through
    host memory).  Sharing one device, the rate cannot rise with the
    ranks: what the numbers show is what the data-parallel step adds,
    chiefly the per-step all-gather of the sparse update rows.
  * ``--device cpu``: gloo ranks on the host's CPU cores, sharing them.
  * ``--backend nccl``: one rank per card; it raises when there are
    fewer cards than the largest world.

The last line is one JSON object with the reference's keys: ``metric``,
``rows`` (``devices``, ``env_steps_per_sec``, ``overhead_vs_1dev``),
``allreduce_mb_per_step`` (MiB all-reduced per step on rank 0 of the
largest world, measured: this learner all-gathers its sparse update
rows instead, so it is 0 here where the reference's GSPMD all-reduces
the table) and ``note`` (what ran where, and the MiB all-gathered).

Usage:
  python3 scripts/torch_bench_scaling.py [--device D] [--backend gloo|nccl]
      [--worlds 1 2 4 8]

``--device`` defaults to the CUDA card (without one the run raises).
The first line is the card's name and power limit.  Imports no jax.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import torch_bench  # noqa: E402

N = 4
ENVS = 1024
K = 32
REPS = 3
WORLDS = (1, 2, 4, 8)
RANK_TIMEOUT = 300  # seconds for one world's ranks, then they are killed
METRIC = "virtual_mesh_partition_overhead"


def bench_rank(rendezvous: str, world: int, rank: int, device: str,
               backend: str) -> dict:
    """One rank's run: a segment untimed, ``REPS`` timed; returns the
    global env-steps/s and the bytes the all-reduces and the
    all-gathers handed this rank per step."""
    from tpu2048_torch.agent import td
    from tpu2048_torch.config import AgentConfig, MeshConfig, TrainConfig
    from tpu2048_torch.draws import TorchDraws
    from tpu2048_torch.features.ntuple import get_tuple_set
    from tpu2048_torch.parallel import distributed

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    # the reference's configuration
    acfg = AgentConfig(n=N, optimizer="sgd", alpha=0.25,
                       sym_mode="periodic", table_ops="gather")
    tcfg = TrainConfig(num_envs=ENVS, steps_per_call=K, ring_size=2048,
                       record_envs=8, max_record_steps=2048, seed=0)
    ts = get_tuple_set(N)
    mesh = None
    reduced = [0]
    if world > 1:
        if not distributed.initialize(rendezvous, world, rank,
                                      device=device or None,
                                      backend=backend):
            raise RuntimeError("distributed.initialize returned False")
        mesh = distributed.global_mesh(MeshConfig(data=world, model=1))
        all_reduce = mesh.all_reduce

        def counted(x, axis="data"):
            reduced[0] += x.numel() * x.element_size()
            return all_reduce(x, axis)

        mesh.all_reduce = counted
        dev = mesh.device
    else:
        dev = torch.device(device or "cuda")
    draws = TorchDraws(torch_bench.seeded_generator(dev, 0))
    state = td.init_td_state(ts, acfg, tcfg, draws, dev, mesh=mesh)
    seg = td.make_train_segment(ts, acfg, tcfg, draws, mesh=mesh)
    state = seg(state)
    torch_bench.sync(dev)
    reduced[0] = 0
    if mesh is not None:
        mesh.counts.update(dict.fromkeys(mesh.counts, 0))
    t0 = time.time()
    for _ in range(REPS):
        state = seg(state)
    torch_bench.sync(dev)
    dt = time.time() - t0
    if mesh is not None:
        mesh.barrier()
    moved = mesh.counts["bytes"] if mesh is not None else 0
    return {"rank": rank, "device": str(dev),
            "env_steps_per_sec": REPS * K * ENVS / dt,
            "allreduce_bytes_per_step": reduced[0] / (REPS * K),
            "allgather_bytes_per_step": (moved - reduced[0]) / (REPS * K)}


def run_world(world: int, device: str, backend: str) -> dict:
    """``world`` ranks of this script, killed after RANK_TIMEOUT
    seconds; returns rank 0's reading."""
    here = os.path.abspath(__file__)
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, here, "--rank", f"file://{tmp}/rendezvous",
             str(world), str(r), device, backend],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
        logs = []
        deadline = time.monotonic() + RANK_TIMEOUT
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
        if p.returncode != 0:
            raise RuntimeError(f"world {world}: rank {r} exited "
                               f"{p.returncode}:\n{log[-3000:]}")
    found = [ln for ln in logs[0].splitlines()
             if ln.startswith("SCALING_RANK ")]
    if not found:
        raise RuntimeError(f"world {world}: rank 0 printed no reading:\n"
                           f"{logs[0][-3000:]}")
    return json.loads(found[-1].split(" ", 1)[1])


def note(device: torch.device, backend: str, mb: float,
         gathered_mb: float) -> str:
    """What ran where, for the JSON line."""
    if device.type == "cpu":
        where = ("gloo ranks on this host's CPU cores, which they share, "
                 "so the rate cannot rise with the ranks")
    elif backend == "gloo":
        where = (f"gloo ranks that share the one CUDA card "
                 f"({torch.cuda.get_device_name(device)}), each collective "
                 f"staged through host memory, so the rate cannot rise "
                 f"with the ranks")
    else:
        where = (f"NCCL ranks, one CUDA card each "
                 f"({torch.cuda.get_device_name(device)})")
    return (f"The same global batch (n=4, sgd, periodic, {ENVS} envs, "
            f"K={K}) on d {where}; world 1 is one process without a "
            f"process group (the parent).  What grows with d is the cost of the "
            f"data-parallel step: rank 0 all-reduced {mb:.2f} MiB and "
            f"all-gathered {gathered_mb:.2f} MiB a step (this learner's "
            f"sparse update rows, episode metrics and best-game "
            f"candidates, applied in rank order on every rank), measured "
            f"at the largest world.")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                   help="gloo (default; ranks may share a device) or nccl "
                        "(one card per rank)")
    p.add_argument("--worlds", type=int, nargs="+", default=list(WORLDS))
    args = p.parse_args(argv)
    device = torch_bench.start(args.device, "bench_scaling")
    if args.backend == "nccl":
        if device.type != "cuda":
            raise ValueError("NCCL runs between cards, not on the CPU")
        if torch.cuda.device_count() < max(args.worlds):
            raise RuntimeError(
                f"--backend nccl needs one card per rank: "
                f"{max(args.worlds)} ranks, {torch.cuda.device_count()} "
                f"cards")
    # gloo ranks share this device; NCCL ranks take a card each
    rank_device = (str(device) if device.type == "cpu" else
                   f"cuda:{device.index or 0}" if args.backend == "gloo"
                   else "")
    rows = []
    base = None
    mb = gathered_mb = 0.0
    for d in args.worlds:
        got = (bench_rank("", 1, 0, rank_device, args.backend) if d == 1
               else run_world(d, rank_device, args.backend))
        sps = got["env_steps_per_sec"]
        base = base or sps
        mb = max(mb, got["allreduce_bytes_per_step"] / 2**20)
        gathered_mb = max(gathered_mb,
                          got["allgather_bytes_per_step"] / 2**20)
        rows.append({"devices": d, "env_steps_per_sec": round(sps, 1),
                     "overhead_vs_1dev": round(base / sps, 3)})
        print(f"data={d}: {sps / 1e3:.1f}K env-steps/s "
              f"(x{base / sps:.2f} cost vs 1-device)", flush=True)
    print(json.dumps({
        "metric": METRIC,
        "rows": rows,
        "allreduce_mb_per_step": round(mb, 2),
        "note": note(device, args.backend, mb, gathered_mb),
    }), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rendezvous, world, rank, device, backend = sys.argv[2:7]
        out = bench_rank(rendezvous, int(world), int(rank), device, backend)
        if int(rank) == 0:
            print("SCALING_RANK " + json.dumps(out), flush=True)
        sys.exit(0)
    main()
