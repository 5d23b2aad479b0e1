#!/usr/bin/env python3
"""Run a sequence of training experiments in ONE process with the
PyTorch port (the twin of ``scripts/quality_matrix.py``).

One process for the whole matrix, and each run's per-1000 summaries
logged under a distinct agent name (in ``~/.tpu2048``) for later
comparison.

Usage: python3 scripts/torch_quality_matrix.py [matrix.json]
           [--device cuda|cpu]
Default matrix compares batched-TD variants for sample efficiency;
``--device`` defaults to the CUDA card (without one the run raises).
Imports no jax.
"""

import argparse
import faulthandler
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
faulthandler.enable()

from tpu2048_torch.config import AgentConfig, TrainConfig  # noqa: E402
from tpu2048_torch.obs.logging import Logger  # noqa: E402
from tpu2048_torch.store.artifacts import open_store  # noqa: E402
from tpu2048_torch.train.loop import Trainer  # noqa: E402

DEFAULT = [
    # name, acfg overrides, tcfg overrides
    {"name": "m_1k_per", "agent": {"n": 5, "sym_mode": "periodic"},
     "train": {"num_envs": 1024, "episodes": 30000}},
    {"name": "m_1k_sca", "agent": {"n": 5, "sym_mode": "scatter"},
     "train": {"num_envs": 1024, "episodes": 30000}},
    {"name": "m_8k_sca", "agent": {"n": 5, "sym_mode": "scatter"},
     "train": {"num_envs": 8192, "episodes": 30000}},
]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("matrix", nargs="?", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args()
    if args.matrix is not None:
        with open(args.matrix) as f:
            matrix = json.load(f)
    else:
        matrix = DEFAULT
    store = open_store("local", root="~/.tpu2048")
    for spec in matrix:
        name = spec["name"]
        acfg = AgentConfig(**spec.get("agent", {}))
        tcfg = TrainConfig(**spec.get("train", {}))
        print(f"\n===== {name}: {spec} =====", flush=True)
        t0 = time.time()
        tr = Trainer(name, acfg, tcfg, store=store,
                     logger=Logger(console=True), device=args.device)
        out = tr.run()
        print(f"===== {name} DONE in {time.time()-t0:.0f}s: "
              f"episodes={out['episodes']} top={out['top_score']} "
              f"{out['env_steps_per_sec']:.0f} steps/s =====", flush=True)


if __name__ == "__main__":
    main()
