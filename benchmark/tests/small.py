"""The cells cut to a size a CPU test holds: few envs or games, and the
n=6 training table replaced by n=5's (95.7 M entries in three tables,
with the reference's copies, would not fit a test run)."""

import json
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def n5_tuples() -> list:
    with open(os.path.join(BENCH, "configs", "n5_champion.json")) as f:
        return json.load(f)["tuples"]


def cut(workload: str):
    """The cell of ``workload`` as ``spec.load`` gives it, cut to a
    test's size."""
    from harness import spec

    c = spec.load(workload)
    if workload.startswith("train"):
        c.config["train"].update(num_envs=128, ring_size=8192,
                                 warm_segments=3)
        if workload == "train-n6":
            c.config["agent"]["n"] = 5
            c.config["tuples"] = n5_tuples()
    else:
        c.config["search"]["games"] = 8
    return c
