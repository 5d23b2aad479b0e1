"""The harness finds configurations, mixes, metrics and limits by name,
and refuses a name it does not know."""

import json
import os

import pytest

from harness import spec

ROOT = spec.ROOT


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_every_cell_resolves(workload):
    cell = spec.load(workload)
    assert cell.config["name"] == next(
        w["config"] for w in bench()["workloads"] if w["name"] == workload)
    assert os.path.isfile(spec.driver_path(cell.traffic["driver"]))
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer and cell.limits
    for m in cell.per_layer:
        assert m["moves"] in names
        assert callable(spec.reader(m["name"]))


def test_unknown_workload_refused():
    with pytest.raises(KeyError, match="no workload"):
        spec.load("no-such-cell")


def test_unknown_parts_refused(tmp_path):
    b = bench()
    b["workloads"].append({"name": "x", "config": "nope",
                           "traffic": "train-lockstep", "chips": 1,
                           "why": "a test"})
    b["workloads"].append({"name": "y", "config": "n5_champion",
                           "traffic": "nope", "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "no_such_metric", "unit": "%",
                           "better": "higher", "source": "device_trace",
                           "layer": "device", "moves": "setup_s",
                           "workloads": ["train-n6"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(b))
    with pytest.raises(KeyError, match="unknown configuration"):
        spec.load("x", str(path))
    with pytest.raises(KeyError, match="no traffic mix"):
        spec.load("y", str(path))
    with pytest.raises(KeyError, match="no reader"):
        spec.load("train-n6", str(path))


@pytest.mark.parametrize("name", ["no_such_driver", "../run", ""])
def test_unknown_driver_refused(name):
    """A mix's driver is ``harness/<driver>.py``, found by its name."""
    with pytest.raises(KeyError, match="no traffic driver"):
        spec.driver_path(name)


def test_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] == []
    for m in b["end_to_end"]:
        assert m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "metrics",
                                           m["name"] + ".py"))


def _config(entry):
    with open(os.path.join(ROOT, entry["file"])) as f:
        return json.load(f)


def _train_mixes(config_name):
    """The train mixes that the cells of a configuration run."""
    mixes = []
    for w in bench()["workloads"]:
        with open(os.path.join(ROOT, "benchmark", "traffic",
                               w["traffic"] + ".json")) as f:
            traffic = json.load(f)
        if w["config"] == config_name and traffic["driver"] == "train":
            mixes.append(traffic)
    return mixes


@pytest.mark.parametrize("config", [c["name"] for c in bench()["configs"]
                                    if "train" in _config(c)])
def test_train_sizes_fit_the_program(config):
    """A configuration's train sizes stay inside what the program takes:
    the episode ring holds a segment's episodes, the recorder's two int8
    logs (at most one row an env) reserve at most 48 GB of the card, and
    the 8-image index rows count in int32."""
    entry = next(c for c in bench()["configs"] if c["name"] == config)
    cfg = _config(entry)
    run = cfg["train"]
    n, f = int(run["num_envs"]), len(cfg["tuples"])
    mixes = _train_mixes(config)
    assert mixes, f"no train cell runs {config}"
    for traffic in mixes:
        assert run["ring_size"] >= n * traffic["steps_per_call"]
    assert 2 * n * (run["max_record_steps"] + 1) <= 48e9
    assert n * 8 * f < 2**31
