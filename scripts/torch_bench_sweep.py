#!/usr/bin/env python3
"""Throughput sweep of the PyTorch port on the card (the twin of
``scripts/bench_sweep.py``): the train, engine and eval stages of
``torch_bench.py`` across batch sizes and steps_per_call, in one
process.

Usage:
  python3 scripts/torch_bench_sweep.py [stage ...] [--device cuda|cpu]
          [--envs N [N ...]] [--k K [K ...]]

Stages: train engine eval (default: all).  ``--envs`` replaces every
stage's batch grid and ``--k`` the train stage's K grid (a shorter
sweep); by default the grids are the reference's.  ``--device``
defaults to the CUDA card (without one the run raises).  The first line
is the card's name and power limit.  Imports no jax.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch_bench  # noqa: E402

STAGES = ("train", "engine", "eval")
TRAIN_ENVS = (4096, 8192, 16384, 32768)
TRAIN_KS = (128, 256)
ENGINE_ENVS = (8192, 16384, 32768, 65536)
EVAL_ENVS = (8192, 16384, 32768)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("stages", nargs="*", metavar="stage",
                   help="train, engine or eval (default: all)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--envs", type=int, nargs="+", default=None,
                   help="batch sizes of every stage (default: each "
                        "stage's grid)")
    p.add_argument("--k", type=int, nargs="+", default=list(TRAIN_KS),
                   help="the train stage's steps_per_call grid")
    args = p.parse_args(argv)
    stages = args.stages or list(STAGES)
    unknown = sorted(set(stages) - set(STAGES))
    if unknown:
        p.error(f"unknown stages {unknown}; expected some of {STAGES}")
    device = torch_bench.start(args.device, "bench_sweep")
    if "train" in stages:
        for n_envs in args.envs or TRAIN_ENVS:
            for k in args.k:
                t0 = time.time()
                sps = torch_bench.bench_train(n_envs=n_envs, k=k, reps=4,
                                              device=device)
                print(f"train n_envs={n_envs:6d} k={k:4d}: "
                      f"{sps/1e6:7.3f}M steps/s "
                      f"(wall {time.time()-t0:.0f}s)", flush=True)
    if "engine" in stages:
        for n_envs in args.envs or ENGINE_ENVS:
            sps = torch_bench.bench_engine(n_envs=n_envs, k=256, reps=6,
                                           device=device)
            print(f"engine n_envs={n_envs:6d}: {sps/1e6:7.3f}M steps/s",
                  flush=True)
    if "eval" in stages:
        for n_envs in args.envs or EVAL_ENVS:
            sps = torch_bench.bench_eval(n_envs=n_envs, k=128, reps=4,
                                         device=device)
            print(f"eval n_envs={n_envs:6d}: {sps/1e6:7.3f}M steps/s",
                  flush=True)


if __name__ == "__main__":
    main()
