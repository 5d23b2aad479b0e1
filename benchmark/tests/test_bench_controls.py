"""The check refuses its control and every fault the cells can have:
at a test's size on the CPU, through the same readings the limits were
set from on the card (``tools/controls.py``).

The train cells' bf16 control reads 0.38-0.77 on the card at the cells'
size, far over the limits.  At a test's 128 envs its tables drift less
(fewer hits an entry), so there the test holds it to a hundred times
the sound run's reading instead of to the cell's limit."""

import contextlib
import os
import sys

import pytest

from harness import checks, spec
from small import cut

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import controls  # noqa: E402


STEPS = 48  # a search window of this many steps, whatever the CPU's speed


def cell(workload):
    """The cell cut small; a search cell judges every third step."""
    c = cut(workload)
    c.traffic.update(check_every=3, checked_steps=10 ** 6)
    return c


def search_reading(c, seed, mode):
    """``controls.reading`` for a search cell over a window of STEPS
    steps rather than of seconds."""
    from harness import faults, runner

    d = runner.driver(c, seed, "cpu")
    with faults.FAULTS[mode](c.traffic["driver"]) if mode in faults.FAULTS \
            else contextlib.nullcontext():
        d.setup()
        d.steps = d._play(float("inf"),
                          lambda steps, elapsed: len(steps) >= STEPS)[0]
    if mode == "control":
        gap, _, judged = checks.search_judge(d, d.steps, lower=True)
        return {"move_gap": gap if judged else float("inf")}
    d.free()
    return d.check()


def reading(c, seed, mode):
    if c.traffic["driver"] == "search":
        return search_reading(c, seed, mode)
    return controls.reading(c, seed, "cpu", mode, 0.0)


@pytest.mark.parametrize("workload,mode", [
    ("train-n6", "half"), ("train-n6", "unchanged"),
    ("search-n5", "control"), ("search-n5", "half"),
    ("search-n5", "unchanged"), ("search-n5", "altered"),
])
def test_refused(workload, mode):
    c = cell(workload)
    nums = reading(c, 21, mode)
    assert not checks.verdict(nums, c.limits)["correct"], nums


@pytest.mark.parametrize("workload", ["train-n6", "search-n5"])
def test_sound_passes(workload):
    c = cell(workload)
    nums = reading(c, 22, "sound")
    assert checks.verdict(nums, c.limits)["correct"], nums


def test_train_control_far_from_sound():
    c = cell("train-n6")
    sound = controls.reading(c, 23, "cpu", "sound", 4.0)
    ctl = controls.reading(c, 23, "cpu", "control", 4.0)
    for name in ("table_gap_worst_leaf", "value_gap_p90"):
        assert ctl[name] > 100 * sound[name], (name, sound, ctl)


@pytest.mark.parametrize("workload,mode", [
    ("train-n6", "half"), ("train-n6", "unchanged"),
    ("search-n5", "unchanged"), ("search-n5", "altered"),
])
def test_run_says_not_correct(workload, mode, capsys):
    """A whole run of the command, past its look for a card, with the
    timed path broken underneath: its result line says not correct."""
    import json

    import run
    from harness import faults

    argv = ["--workload", workload, "--seed", "31", "--seconds", "2"]
    c = cut(workload)
    with faults.FAULTS[mode](c.traffic["driver"]):
        assert run.main(argv, device="cpu", cell=c) == 0
    res = json.loads(capsys.readouterr()[0].strip().splitlines()[-1])
    assert res["correct"] is False, res["checks"]
