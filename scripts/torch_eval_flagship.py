#!/usr/bin/env python3
"""Evaluate a stored agent with the PyTorch port: greedy and/or
expectimax trials (the twin of ``scripts/eval_flagship.py``).

Mirrors the reference's benchmark protocol (QAgent.trial,
r_learning.py:348-406): N full games, report average score,
tile-reach percentages, top boards, ms/move; optional expectimax
depth/width/since_empty (the README's headline search run used
depth=3 width=4 since_empty=6 over 100 games).

Usage:
  python3 scripts/torch_eval_flagship.py <agent> [--num 1000]
          [--depth 0] [--width 1] [--since-empty 6] [--seed 0]
          [--device cuda|cpu]

The agent is read from ``~/.tpu2048``; ``--device`` defaults to the
CUDA card (without one the run raises).  Imports no jax.
"""

import argparse
import faulthandler
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
faulthandler.enable()

from tpu2048_torch.config import SearchConfig  # noqa: E402
from tpu2048_torch.features import ntuple  # noqa: E402
from tpu2048_torch.obs.logging import Logger  # noqa: E402
from tpu2048_torch.store import checkpoint as ckpt  # noqa: E402
from tpu2048_torch.store.artifacts import open_store  # noqa: E402
from tpu2048_torch.train import card_device  # noqa: E402
from tpu2048_torch.train.trial import trial  # noqa: E402


def main():
    p = argparse.ArgumentParser()
    p.add_argument("agent")
    p.add_argument("--num", type=int, default=1000)
    p.add_argument("--depth", type=int, default=0)
    p.add_argument("--width", type=int, default=1)
    p.add_argument("--since-empty", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps-per-call", type=int, default=256)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args()

    device = card_device(args.device, "eval_flagship")
    store = open_store("local", root="~/.tpu2048")
    acfg, weights, meta = ckpt.load_agent_dense(store, args.agent, device)
    ts = ntuple.get_tuple_set(acfg.n)
    print(f"agent {args.agent}: n={acfg.n}, "
          f"episodes={meta.get('episodes')}, "
          f"top_score={meta.get('top_score')}")
    res = trial(
        ts,
        weights,
        num=args.num,
        seed=args.seed,
        search=SearchConfig(depth=args.depth, width=args.width,
                            since_empty=args.since_empty),
        steps_per_call=args.steps_per_call,
        logger=Logger(console=True),
    )
    if res.best_game is not None:
        ckpt.save_game(store, f"best_eval_{args.agent}", res.best_game)
        print(f"best game saved: g/best_eval_{args.agent}.npz")


if __name__ == "__main__":
    main()
