"""The port's flagship drivers (``scripts/torch_train_flagship.py``,
``torch_eval_flagship.py``, ``torch_eval_native.py`` and
``torch_quality_matrix.py``), each run as a subprocess on the CPU at a
tiny size with ``HOME`` in ``tmp_path`` (the scripts' store is
``~/.tpu2048``): each prints its reference's result lines and loads
neither jax nor ``tpu2048``; without ``--device`` and without a card
the device-taking ones raise; and the native twin prints the same
scores and moves as ``scripts/eval_native.py`` on the same stored
agent."""

import json
import os
import subprocess
import sys

import pytest
import torch

from tpu2048_torch.features.ntuple import get_tuple_set
from tpu2048_torch.store import checkpoint as ckpt
from tpu2048_torch.store.artifacts import LocalStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
# seconds for one driver run, then it is killed
LIMIT = 120

# runs a script as ``python script args`` would, then prints the jax
# and tpu2048 modules it loaded as the last line
_WRAP = """
import json, runpy, sys
script = sys.argv[1]
sys.argv = sys.argv[1:]
runpy.run_path(script, run_name="__main__")
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in
                        ("jax", "tpu2048"))))
"""


def _env(home, **kw):
    env = {**os.environ, "HOME": str(home), "OMP_NUM_THREADS": "2",
           "JAX_PLATFORMS": "cpu", **kw}
    env.pop("PYTHONPATH", None)
    return env


def _run(home, script, *args, native_dir=None, wrap=True, cwd=None):
    """One driver run, from ``home`` unless ``cwd`` says otherwise;
    returns its stdout lines (the wrapper's module list checked and
    dropped)."""
    env = _env(home, **({"TPU2048_NATIVE_DIR": str(native_dir)}
                        if native_dir else {}))
    path = os.path.join(SCRIPTS, script)
    cmd = ([sys.executable, "-c", _WRAP, path] if wrap
           else [sys.executable, path]) + [str(a) for a in args]
    proc = subprocess.run(cmd, cwd=str(cwd or home), env=env,
                          capture_output=True, text=True, timeout=LIMIT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    if wrap:
        assert json.loads(lines[-1]) == [], f"{script} loaded {lines[-1]}"
        lines = lines[:-1]
    return lines


@pytest.fixture(scope="module")
def home(tmp_path_factory):
    """A HOME whose store holds "tiny", an n=2 agent trained by the
    train twin (16 envs, "onehot" table ops), and its printed lines."""
    home = tmp_path_factory.mktemp("home")
    lines = _run(home, "torch_train_flagship.py", "tiny", "--n", 2,
                 "--num-envs", 16, "--episodes", 20, "--steps-per-call", 16,
                 "--table-ops", "onehot", "--device", "cpu")
    return home, lines


def test_train_twin_trains_and_stores(home):
    home, lines = home
    [res] = [ln for ln in lines if ln.startswith("RESULT ")]
    episodes, top = int(res.split()[1]), int(res.split()[2])
    assert episodes >= 20 and top > 0 and res.endswith(" steps/s")
    assert any("device = cpu" in ln for ln in lines)
    acfg, w, meta = ckpt.load_agent(LocalStore(str(home / ".tpu2048")),
                                    "tiny")
    assert acfg.n == 2 and acfg.table_ops == "onehot"
    assert meta["episodes"] == episodes and w.shape == (
        get_tuple_set(2).total,)


@pytest.mark.parametrize("depth", [0, 1])
def test_eval_twin_reports_and_saves_the_best_game(home, depth):
    home, _ = home
    lines = _run(home, "torch_eval_flagship.py", "tiny", "--num", 8,
                 "--depth", depth, "--width", 2, "--seed", 3,
                 "--device", "cpu")
    assert lines[0].startswith("agent tiny: n=2, episodes=")
    assert any(ln.startswith("average score of 8 runs = ") for ln in lines)
    assert any(ln.startswith("2048 reached in ") for ln in lines)
    assert ("search steps per compaction tier" in "\n".join(lines)) == (
        depth > 0)
    assert lines[-1] == "best game saved: g/best_eval_tiny.npz"
    assert (home / ".tpu2048" / "g" / "best_eval_tiny.npz").exists()


def test_quality_matrix_twin_runs_its_matrix(home, tmp_path):
    home, _ = home
    matrix = tmp_path / "matrix.json"
    matrix.write_text(json.dumps([
        {"name": "m_tiny", "agent": {"n": 2, "table_ops": "onehot"},
         "train": {"num_envs": 16, "episodes": 10, "steps_per_call": 16}}]))
    lines = _run(home, "torch_quality_matrix.py", matrix, "--device", "cpu")
    assert any(ln.startswith("===== m_tiny: {") for ln in lines)
    [done] = [ln for ln in lines if ln.startswith("===== m_tiny DONE in ")]
    assert " episodes=" in done and done.endswith(" steps/s =====")


def test_native_twin_matches_the_reference_script(home, tmp_path):
    """The same stored agent through ``scripts/eval_native.py`` (JAX)
    and its twin: every line but the two wall times the same."""
    home, _ = home
    args = ["tiny", "--num", 4, "--depth", 1, "--width", 2, "--seed", 2,
            "--threads", 1]
    for d in ("port", "jax"):  # one library build each
        (tmp_path / d).mkdir()
    got = _run(home, "torch_eval_native.py", *args,
               native_dir=tmp_path / "port")
    # the reference script finds its package from the repo's root
    want = _run(home, "eval_native.py", *args, native_dir=tmp_path / "jax",
                wrap=False, cwd=REPO)

    def kept(lines):
        return [ln for ln in lines if not ln.startswith(
            ("total time = ", "average time per move = "))]

    assert kept(got) == kept(want)
    assert any(ln.startswith("score = ") for ln in got)
    assert got[0].startswith("agent tiny: n=2, episodes=")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("script,args", [
    ("torch_train_flagship.py", ["x", "--n", "2"]),
    ("torch_eval_flagship.py", ["tiny"]),
    ("torch_quality_matrix.py", []),
])
def test_drivers_take_the_card_by_default(home, script, args):
    """Without ``--device`` a driver asks for the CUDA card, and
    without one it exits non-zero and says so."""
    home, _ = home
    proc = subprocess.run([sys.executable, os.path.join(SCRIPTS, script),
                           *args], cwd=str(home), env=_env(home),
                          capture_output=True, text=True, timeout=LIMIT)
    assert proc.returncode != 0
    assert "no CUDA card found" in proc.stderr
