#!/usr/bin/env python3
"""How ``grad_class`` launches its fill and its scatter, measured on a
CUDA card against two other ways to launch the same scatter.

    python3 scripts/torch_grad_variants.py [--out FILE]

Times, with CUDA events (7 x 20 calls queued behind a sleep kernel,
the median), at the (17, 256, 256) class:

  shipped            ``kernels.grad_class``: the port's own fill kernel,
                     then the scatter as its programmatic dependent;
  fill_then_scatter  ``torch.zeros`` of the pair, then the same scatter
                     as a plain launch;
  cooperative        one cooperative launch: zero the pair, sync the
                     grid, scatter;
  fill_alone         ``torch.zeros`` of the pair, nothing else;

on four sets of rows, each with its collision profile printed: random
indices and every row on one entry (B = 8192, half the rows valid),
and the default train step's own indices (``prev_idx`` split into hi
and lo, with ``prev_valid``) one step after a fresh start and after
four segments.  Every variant is checked against the plain version
(hits bitwise, dsum within hits * 2^-23 * sum|dw|) before it is timed.
The two other variants are built from ``scripts/grad_class_variants.cu``
with nvcc into a temporary directory.  Writes JSON to ``--out``
(default ``chiprun_out/grad_variants.json``).  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tpu2048_torch.agent import td  # noqa: E402
from tpu2048_torch.config import AgentConfig, TrainConfig  # noqa: E402
from tpu2048_torch.draws import TorchDraws  # noqa: E402
from tpu2048_torch.features.ntuple import get_tuple_set  # noqa: E402
from tpu2048_torch.ops import build, kernels  # noqa: E402
from tpu2048_torch.ops import onehot as oh  # noqa: E402

G, H, L, B = 17, 256, 256, 8192


def _load_variants(tmp: str) -> ctypes.CDLL:
    lib = os.path.join(tmp, "libgrad_variants.so")
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o", lib,
                    os.path.join(REPO, "scripts", "grad_class_variants.cu")],
                   check=True)
    out = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    out.variant_launch.argtypes = [i, p, p, p, p, p, i, i, i, i, p]
    out.variant_launch.restype = i
    return out


def _device_ms(fn, reps: int = 7, inner: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _cases() -> dict:
    """name -> [hi, lo, dw, valid] on the card."""
    out = {}
    for name, collide in (("random", False), ("collide", True)):
        rng = np.random.default_rng(11)
        hi = rng.integers(0, H, (B, G)).astype(np.int32)
        lo = rng.integers(0, L, (B, G)).astype(np.int32)
        if collide:  # a fresh start: every row on one entry of each table
            hi[:] = lo[:] = 0
        dw = rng.standard_normal(B).astype(np.float32)
        valid = rng.random(B) < 0.5
        out[name] = [torch.from_numpy(a).cuda() for a in (hi, lo, dw, valid)]
    acfg, tcfg = AgentConfig(), TrainConfig(num_envs=B)
    ts = get_tuple_set(acfg.n)
    c = oh.build_table_classes(ts).matmul[0]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    draws = TorchDraws(gen)
    st = td.init_td_state(ts, acfg, tcfg, draws, "cuda")
    dw = torch.from_numpy(np.random.default_rng(5).standard_normal(B)
                          .astype(np.float32)).cuda()

    def rows(state):
        hi, lo = oh._hi_lo(ts, state.prev_idx.reshape(-1, ts.num_feat), c)
        return [hi, lo, dw, state.prev_valid.clone()]

    st, _ = td.make_train_step(ts, acfg, tcfg, draws)(st)
    out["train_fresh"] = rows(st)
    segment = td.make_train_segment(ts, acfg, tcfg, draws)
    for _ in range(4):
        st = segment(st)
    out["train_mid"] = rows(st)
    return out


def _collisions(hi, lo, valid) -> dict:
    """Distinct entries per tuple (least, median, most) among the valid
    rows, and the most rows on one entry."""
    flat = (hi.long() * L + lo.long())[valid]
    distinct, most = [], 0
    for t in range(G):
        _, counts = torch.unique(flat[:, t], return_counts=True)
        distinct.append(int(counts.numel()))
        most = max(most, int(counts.max()) if counts.numel() else 0)
    return {"valid_rows": int(valid.sum()),
            "distinct_per_tuple": [min(distinct), int(np.median(distinct)),
                                   max(distinct)],
            "most_rows_on_one_entry": most}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/grad_variants.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        lib = _load_variants(tmp)
        port = build.load_library()

        def variant(cooperative, hi, lo, dw, valid):
            pair = (torch.empty if cooperative else torch.zeros)(
                (2, G, H, L), device="cuda")
            rc = lib.variant_launch(
                cooperative, hi.data_ptr(), lo.data_ptr(), dw.data_ptr(),
                valid.data_ptr(), pair.data_ptr(), hi.shape[0], G, H, L,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(port.cuda_error_string(rc).decode())
            return pair

        rows = []
        for case, a in _cases().items():
            want = kernels.grad_class_reference(*a, H, L)
            hi, lo, dw, valid = a
            mass = kernels.grad_class_reference(hi, lo, dw.abs(), valid,
                                                H, L)[0]
            calls = {
                "shipped": lambda: kernels.grad_class(*a, H, L),
                "fill_then_scatter": lambda: variant(0, *a),
                "cooperative": lambda: variant(1, *a),
            }
            row = {"case": case, **_collisions(hi, lo, valid)}
            for name, call in calls.items():
                got = call()
                torch.cuda.synchronize()
                if not torch.equal(got[1], want[1]) or not bool(
                        ((got[0] - want[0]).abs()
                         <= 2.0**-23 * want[1] * mass).all()):
                    raise AssertionError(f"{name} disagrees with the plain "
                                         f"version on {case}")
                row[f"{name}_ms"] = _device_ms(call)
            row["fill_alone_ms"] = _device_ms(
                lambda: torch.zeros((2, G, H, L), device="cuda"))
            rows.append(row)
            print(f"grad_variants: {json.dumps(row)}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
