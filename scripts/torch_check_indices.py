#!/usr/bin/env python3
"""Feature indices of the PyTorch port on the card, held exactly against
an int64 numpy recomputation (the twin of
``scripts/check_indices_tpu.py``).

The hazard: an index computed as an f32 matmul is exact only at full
f32, and base-14 coefficients (14**5 = 537,824) are not exact in the
10-bit mantissa of TF32, which ``torch.set_float32_matmul_precision(
"high")`` allows for CUDA matmuls.  The port computes indices with
int32 multiply-adds, so they must be exact either way.  This script
checks ``ntuple.feature_indices`` for every geometry n=2..7 over 4096
random boards (the first 8 all max-exponent tiles, which stress the
largest coefficients), once as the port's defaults leave TF32 and once
with TF32 allowed by ``set_float32_matmul_precision("high")`` (every
precision setting restored after, ``chip_smoke._allow_tf32``).  It
exits 1 on any mismatch.

Usage:
  python3 scripts/torch_check_indices.py [--device cuda|cpu]

``--device`` defaults to the CUDA card (without one the run raises).
The first line is the card's name and power limit.  Imports no jax.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch_bench  # noqa: E402
from chip_smoke import _allow_tf32  # noqa: E402
from tpu2048_torch.features import ntuple  # noqa: E402

GEOMETRIES = (2, 3, 4, 5, 6, 7)
BOARDS = 4096


def mismatches(ts, boards: np.ndarray, device: torch.device) -> int:
    """Entries of ``feature_indices`` on ``device`` that differ from the
    int64 recomputation from ``ts.matrix`` (cols 0-15 apply to the raw
    exponents, 16-31 to the exponents clipped at 13) and ``ts.offsets``."""
    got = ntuple.feature_indices(ts, torch.from_numpy(boards).to(device))
    got = got.cpu().numpy().astype(np.int64)
    coeff = np.asarray(ts.matrix).astype(np.int64)
    v = np.concatenate([boards, np.minimum(boards, 13)], axis=-1)
    want = v.astype(np.int64) @ coeff.T + np.asarray(ts.offsets, np.int64)
    return int((got != want).sum())


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    device = torch_bench.start(args.device, "check_indices")
    rng = np.random.default_rng(0)
    boards = rng.integers(0, 16, size=(BOARDS, 16), dtype=np.int32)
    boards[:8] = 15  # all-max boards stress the largest coefficients
    bad_total = 0
    for tf32 in (False, True):
        restore = _allow_tf32("global") if tf32 else None
        try:
            if tf32 and torch.get_float32_matmul_precision() != "high":
                raise RuntimeError("TF32 was not allowed")
            label = ("tf32 allowed (set_float32_matmul_precision('high'))"
                     if tf32 else "defaults")
            for n in GEOMETRIES:
                ts = ntuple.get_tuple_set(n)
                bad = mismatches(ts, boards, device)
                bad_total += bad
                print(f"[{label}] n={n}: num_feat={ts.num_feat} "
                      f"table={ts.total} mismatches={bad} "
                      f"{'OK' if bad == 0 else 'MISMATCH'}", flush=True)
        finally:
            if restore is not None:
                restore()
    if bad_total:
        print(f"{bad_total} mismatched indices", flush=True)
        return 1
    print("all geometries exact on device, with and without TF32",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
