#!/usr/bin/env python3
"""Flagship quality run / training experiment driver of the PyTorch
port (the twin of ``scripts/train_flagship.py``).

    python3 scripts/torch_train_flagship.py [name] [--n 5]
        [--episodes 100000] [--num-envs 8192] [--table-ops gather]
        [--trace DIR] [--device cuda|cpu] ...

Reference best-agent configuration: n=4/5 feature set (17 four-tuples
+ 4 five-cell crosses), 100k episodes, alpha 0.25 / decay 0.75 every
10k episodes (the reference's README.md:12,72).  Here: the same episode
budget on one CUDA card with lockstep envs, and knobs to compare
batched-TD variants (sym_mode, update_mode, env count, schedule).  The
arguments and defaults are the reference driver's; ``--device`` picks
the device (default: the CUDA card; without one the run raises), and
``--trace`` writes a ``torch.profiler`` Chrome trace of the run.  The
agent is stored in ``~/.tpu2048``.  Imports no jax.
"""

import argparse
import faulthandler
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
faulthandler.enable()

from tpu2048_torch.config import AgentConfig, TrainConfig  # noqa: E402
from tpu2048_torch.obs.logging import Logger  # noqa: E402
from tpu2048_torch.store.artifacts import open_store  # noqa: E402
from tpu2048_torch.train.loop import Trainer  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("name", nargs="?", default="flagship")
    p.add_argument("--n", type=int, default=5)
    p.add_argument("--episodes", type=int, default=100_000)
    p.add_argument("--num-envs", type=int, default=8192)
    p.add_argument("--alpha", type=float, default=0.25)
    p.add_argument("--decay", type=float, default=0.75)
    p.add_argument("--decay-step", type=int, default=10_000)
    p.add_argument("--low-alpha-limit", type=float, default=0.01)
    p.add_argument("--sym-mode", default="periodic",
                   choices=["periodic", "scatter", "none"])
    p.add_argument("--sym-impl", default="fold", choices=["fold", "index"])
    p.add_argument("--trace", default=None, metavar="LOGDIR",
                   help="capture a torch.profiler trace of the run "
                        "(Chrome trace JSON, open with Perfetto)")
    p.add_argument("--update-mode", default="mean", choices=["mean", "sum"])
    p.add_argument("--optimizer", default="sgd", choices=["sgd", "tc"])
    p.add_argument("--table-ops", default="gather",
                   choices=["gather", "onehot", "pallas"])
    p.add_argument("--steps-per-call", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args()

    acfg = AgentConfig(
        n=args.n, alpha=args.alpha, decay=args.decay,
        decay_step=args.decay_step, low_alpha_limit=args.low_alpha_limit,
        sym_mode=args.sym_mode, sym_impl=args.sym_impl,
        update_mode=args.update_mode,
        optimizer=args.optimizer, table_ops=args.table_ops,
    )
    tcfg = TrainConfig(
        num_envs=args.num_envs, episodes=args.episodes,
        steps_per_call=args.steps_per_call, seed=args.seed,
    )
    store = open_store("local", root="~/.tpu2048")
    trainer = Trainer(args.name, acfg, tcfg, store=store,
                      logger=Logger(console=True), resume=args.resume,
                      device=args.device)
    out = trainer.run(trace_dir=args.trace)
    print("RESULT", out["episodes"], out["top_score"],
          f"{out['env_steps_per_sec']:.0f} steps/s")


if __name__ == "__main__":
    main()
