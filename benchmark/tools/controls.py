#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, on the card
at a cell's own size (no measured window):

* sound: the program as the cell runs it, on each seed;
* control: the reference in the precision below the one the
  configuration states, put in the program's place (training: tables in
  bf16; search: the whole tuples' entries in fp8 e4m3, the others in
  bf16), judged as the program is;
* each fault of ``harness/faults.py`` that the cell can have.

    python3 benchmark/tools/controls.py --workload train-n6 \\
        --seeds 1,2,3 --control-seeds 4,5,6 --fault-seeds 7,8,9 \\
        --out results/controls.jsonl

One process: each reading is one line of ``--out`` and of standard
output.  ``--device cpu`` runs it small on the CPU, as the tests do.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))


def reading(cell, seed: int, device, mode: str, seconds: float) -> dict:
    """One reading: the cell's compared numbers under ``mode`` ("sound",
    "control" or a fault's name)."""
    import torch

    from harness import checks, faults, runner

    kind = cell.traffic["driver"]
    d = runner.driver(cell, seed, device)
    if kind == "train":
        # the checked segments are all the check needs
        d.warm = d.checked
        if mode == "control":
            mv = []
            ctl, _ = checks.follow_train(
                d.ts_ref, d.config, seed, d.device, d.n_envs, d.k,
                d.checked, None, None, dtype=torch.bfloat16, ref_moves=mv)
            ref, gap = checks.follow_train(
                d.ts_ref, d.config, seed, d.device, d.n_envs, d.k,
                d.checked, None, None, step_moves=mv)
            from reference import game

            snap = {"w": ctl.w.float(), "e": ctl.e.float(),
                    "a": ctl.a.float(), "codes": game.to_codes(ctl.boards),
                    "score": ctl.score, "odo": ctl.odo,
                    "prev_value": ctl.prev_value,
                    "prev_valid": ctl.prev_valid}
            return checks.train_numbers(d.ts_ref, d.config, seed, snap, ref,
                                        gap, d.device)
        if mode == "sound":
            d.setup()
        else:
            with faults.FAULTS[mode](kind):
                d.setup()
        d.free()
        return d.check()
    # search: a short window at the cell's own load
    if mode in ("sound", "control"):
        d.setup()
        d.window(seconds)
    else:
        with faults.FAULTS[mode](kind):
            d.setup()
            d.window(seconds)
    if mode == "control":
        gap, _, judged = checks.search_judge(d, d.steps, lower=True)
        return {"move_gap": gap if judged else float("inf")}
    d.free()
    return d.check()


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    from harness import spec

    cell = spec.load(args.workload)
    kind = cell.traffic["driver"]
    fault_names = args.faults.split(",") if args.faults else (
        ["half"] if kind == "train" else ["unchanged", "half", "altered"])
    plan = [("sound", s) for s in args.seeds.split(",") if s]
    plan += [("control", s) for s in args.control_seeds.split(",") if s]
    plan += [(f, s) for f in fault_names
             for s in args.fault_seeds.split(",") if s]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as out:
        for mode, seed in plan:
            t = time.time()
            nums = reading(cell, int(seed), args.device, mode, args.seconds)
            rec = {"workload": args.workload, "mode": mode,
                   "seed": int(seed), "numbers": nums,
                   "seconds": time.time() - t}
            out.write(json.dumps(rec) + "\n")
            out.flush()
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
