"""Each cell's command, cut small, on the CPU with the kernels' plain
versions: a well-formed last line, and no module of the JAX stack or
the JAX package loaded."""

import json
import os
import subprocess
import sys

import pytest

import run
from small import cut

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ["search-n5", "train-n6", "search-n6"]


def well_formed(line: str) -> dict:
    res = json.loads(line)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    return res


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_small(workload, capsys):
    argv = ["--workload", workload, "--seed", str(2 ** 33 + 7),
            "--seconds", "1", "--trace", "0"]
    assert run.main(argv, device="cpu", cell=cut(workload)) == 0
    out, err = capsys.readouterr()
    res = well_formed(out.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    names = set(res["metrics"])
    assert "setup_s" in names and len(names) == (
        2 if workload.startswith("train") else 3)
    # the compared numbers end standard error too
    assert err.strip().splitlines()[-1].split()[0] == list(res["checks"])[-1]


def test_traced_run_small(capsys):
    argv = ["--workload", "train-n6", "--seed", "11", "--seconds", "1",
            "--trace", "1"]
    assert run.main(argv, device="cpu", cell=cut("train-n6")) == 0
    res = well_formed(capsys.readouterr()[0].strip().splitlines()[-1])
    assert res["correct"]
    assert "train.enqueue_ms_per_step" in res["metrics"]
    # the CPU traces no device: no device metric is reported
    assert "train.device_us_per_step" not in res["metrics"]
    assert "train_step_mfu" not in res["metrics"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_traced_search_placed_by_steps(capsys):
    """The search cell's traced stretch is its first call's steps
    ``trace_from_step`` + 1 .. + ``trace_steps``, however fast they run;
    a CPU run reports no device metric, no share of the card's peak."""
    c = cut("search-n5")
    c.traffic.update(trace_from_step=3, trace_steps=4)
    argv = ["--workload", "search-n5", "--seed", "12", "--seconds", "1",
            "--trace", "1"]
    assert run.main(argv, device="cpu", cell=c) == 0
    res = well_formed(capsys.readouterr()[0].strip().splitlines()[-1])
    assert res["correct"] and res["attempted"] == 7
    assert res["metrics"] == {}
    assert res["device"]["window_s"] > 0


def test_no_card_no_result():
    """Without a card the command prints nothing on stdout, exits 2."""
    r = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", "train-n6", "--seed", "1",
                        "--seconds", "1"], capture_output=True, text=True,
                       cwd=os.path.dirname(BENCH), timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 2 and r.stdout == ""


def test_no_jax_loaded():
    """After a whole run no loaded module's top-level name is the JAX
    stack's or the JAX package's (``tpu2048_torch`` is not
    ``tpu2048``)."""
    code = (
        "import sys, json; sys.path[:0] = %r; import run\n"
        "from small import cut\n"
        "rc = run.main(%r, device='cpu', cell=cut('search-n5'))\n"
        "tops = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps([rc, tops]))\n"
    ) % ([BENCH, os.path.join(BENCH, "tests")],
         ["--workload", "search-n5", "--seed", "3", "--seconds", "1"])
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=os.path.dirname(BENCH), timeout=600)
    rc, tops = json.loads(r.stdout.strip().splitlines()[-1])
    assert rc == 0
    assert "tpu2048_torch" in tops
    assert not {"jax", "jaxlib", "flax", "tpu2048"} & set(tops)


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of train-n6 on the card (skips without one)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"),
                        "--workload", "train-n6", "--seed", "5",
                        "--seconds", "3"], capture_output=True, text=True,
                       cwd=os.path.dirname(BENCH), timeout=1200)
    assert r.returncode == 0, r.stderr[-2000:]
    assert well_formed(r.stdout.strip().splitlines()[-1])["correct"]
