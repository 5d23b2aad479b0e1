#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the CUDA card.

    python3 benchmark/run.py --workload train-n6 --seed 7 --seconds 30 \\
        --trace 0

From the root of a checkout.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``:
each number compared with the plain reference beside its limit.  The
same numbers end standard error.  Without a CUDA card, or with fewer
cards than the cell asks for, it prints no result and exits 2; if the
JAX stack or the JAX package was loaded, it exits 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)
# compile caches at fixed places inside the checkout (the port builds
# its own kernels into tpu2048_torch/ops/_build/)
for _var, _dir in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(ROOT, "_cache", _dir)
# one host thread for PyTorch's own CPU work: the card does the work,
# and the host's cores are shared
os.environ["OMP_NUM_THREADS"] = "1"
# keep any library from loading the JAX stack on its own
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")


def main(argv=None, device=None, cell=None) -> int:
    """``device``: the card unless a test asks for the CPU, which skips
    the look for a card; ``cell``: the workload's cell as ``spec.load``
    gives it, unless a test hands in one cut to its size."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from harness import runner, spec

    torch.set_num_threads(1)

    if cell is None:
        cell = spec.load(args.workload)
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"{args.workload} needs {cell.chips} CUDA card(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
    result = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                        device, T_START)
    found = runner.banned_modules()
    if found:
        print(f"the run loaded {found}: the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
