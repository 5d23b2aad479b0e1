"""The port's benchmark (``torch_bench.py``) against ``bench.py``, and
its script twins (``scripts/torch_bench_{sweep,search,ops}.py``), on
the CPU at small sizes.

  * the JSON line: with every row function of both modules patched to
    the same rates, both mains print the same last line;
  * the step loops: ``engine_roll`` and ``eval_roll`` against the
    bodies of ``bench.py``'s scans, restated here with
    ``tpu2048.engine.fast``, fed JAX's key schedule, bitwise;
  * the train rows: the configs each row builds equal ``bench.py``'s,
    and one segment of each row's learner at n=4 matches JAX's;
  * the scripts run at tiny sizes, a failing table-op mode raises,
    nothing loads jax or ``tpu2048``, and without a card and without
    ``--device`` every entry point raises.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import torch_bench
from _torch_port import (JaxTrainDraws, JaxTrainFns, check_segment,
                         dyadic_weights, fresh_state, jax_cfg, rand_boards)
from tpu2048.engine import fast as jfast
from tpu2048.features import ntuple as jnt
from tpu2048.ops import dispatch as jdisp
from tpu2048.ops import pallas_kernels as pk
from tpu2048_torch.features import ntuple as tnt
from tpu2048_torch.ops import dispatch as tdisp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = {name: os.path.join(REPO, "scripts", f"torch_bench_{name}.py")
           for name in ("sweep", "search", "ops")}
# seconds for one script run, then it is killed
LIMIT = 120


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"torch_bench_{name}", SCRIPTS[name])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- the JSON line -----------------------------------------------------------


def _fake_train(n_envs=8192, k=64, reps=8, acfg=None, record_envs=-1, **_):
    """A rate that differs with every argument a row passes."""
    n = 5 if acfg is None else acfg.n
    sgd = acfg is not None and acfg.optimizer == "sgd"
    return (1_234_567.891 + 10_000 * n + 100 * reps + record_envs
            + 0.37 * sgd + n_envs / 7 + k / 3)


def _fake_engine(n_envs=8192, k=256, reps=6, **_):
    return 3_456_789.0123 + n_envs / 7 + k / 3 + reps


def _fake_eval(n_envs=8192, k=128, reps=4, n=5, table_ops="auto", **_):
    return (2_345_678.9876 + 10_000 * n + n_envs / 7 + k / 3 + reps
            + 0.77 * (table_ops == "search"))


def _patch_rows(mp, mod, train=_fake_train):
    mp.setattr(mod, "bench_train", train)
    mp.setattr(mod, "bench_engine", _fake_engine)
    mp.setattr(mod, "bench_eval", _fake_eval)


def test_last_line_equals_bench_py(monkeypatch, capsys):
    for mod in (bench, torch_bench):
        _patch_rows(monkeypatch, mod)
    bench.main([])
    want = capsys.readouterr().out.splitlines()[-1]
    torch_bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == want
    assert list(json.loads(lines[-1])) == list(json.loads(want))
    assert all(ln.startswith("# ") for ln in lines[:-1])
    assert lines[0] == "# cpu"
    rows = [json.loads(ln.split(": ", 1)[1]) for ln in lines[1:-1]]
    keys = [ln.split(":", 1)[0][len("# row "):] for ln in lines[1:-1]]
    assert keys == [k for k in json.loads(want)
                    if k not in ("metric", "unit", "vs_baseline",
                                 "engine_vs_north_star_10M")]
    # the patched rows time nothing; the CPU launches no kernel
    for row in rows:
        assert row["reps_s"] is None and row["peak_allocated_bytes"] is None
        assert row["launches"] == {"eval_class": 0, "grad_class": 0,
                                   "fold_class": 0}


# -- the step loops ----------------------------------------------------------


class _RollDraws(JaxTrainDraws):
    """The bench loops' draws: per step ``key, ks, kr = split(key, 3)``,
    a spawn from ``ks`` and fresh boards from ``kr``
    (``bench.py:70-79``, ``:126-130``)."""

    def new(self, n: int):
        return self.reset(n)


def _start_codes(n: int, seed: int) -> np.ndarray:
    """Crowded boards with a dead one (no legal move) in front, so the
    roll resets a board on its first step."""
    boards = rand_boards(n, seed=seed, high=8)
    boards[0] = np.where(np.add.outer(np.arange(4), np.arange(4)) % 2, 1, 2)
    return np.array(jfast.codes_from_boards(jnp.asarray(boards)))


def _jax_engine_roll(codes, key, k):
    """``bench.py:67-80``, the engine scan's body."""
    n_envs = codes.shape[0]

    def body(c, _):
        cd, k2 = c
        aft, delta, legal, _t = jfast.afterstates_full(cd)
        done = ~legal.any(axis=0)
        k2, ks, kr = jax.random.split(k2, 3)
        nc, _, _ = jfast.spawn_codes(aft[0], ks)
        nc = nc + (delta.sum(axis=0, keepdims=True).T * 0)
        nc = jnp.where(done[:, None], jfast.new_codes(n_envs, kr), nc)
        return (nc, k2), None

    (codes, key), _ = jax.lax.scan(body, (codes, key), None, length=k)
    return codes


def test_engine_roll_matches_bench_py_bitwise():
    codes = _start_codes(64, seed=1)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax.jit(_jax_engine_roll, static_argnums=2)(
        jnp.asarray(codes), key, 8))
    got = torch_bench.engine_roll(torch.from_numpy(codes), _RollDraws(key), 8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(want, codes)


def _jax_eval_roll(eval_fn, w, codes, key, k):
    """``bench.py:112-133``, the eval scan's body."""
    n_envs = codes.shape[0]
    tperm = jnp.asarray(np.arange(16).reshape(4, 4).T.reshape(16))

    def body(c, _):
        cd, k2 = c
        aft, delta, legal, _t = jfast.afterstates_full(cd)
        cells4 = jfast.cells_from_codes(aft)
        cells4 = jnp.stack(
            [cells4[0], cells4[1][..., tperm],
             cells4[2], cells4[3][..., tperm]]
        )
        vals = eval_fn(w, cells4)
        masked = jnp.where(legal, vals, -jnp.inf)
        bd = jnp.argmax(masked, axis=0).astype(jnp.int32)
        ar = jnp.arange(n_envs)
        chosen = jfast.canonicalize_chosen(aft[bd, ar], bd)
        done = ~legal.any(axis=0)
        k2, ks, kr = jax.random.split(k2, 3)
        nc, _, _ = jfast.spawn_codes(chosen, ks)
        nc = jnp.where(done[:, None], jfast.new_codes(n_envs, kr), nc)
        return (nc, k2), None

    (codes, key), _ = jax.lax.scan(body, (codes, key), None, length=k)
    return codes


@pytest.mark.parametrize("mode", ["auto", "pallas"])
@pytest.mark.parametrize("n", [4, 5])
def test_eval_roll_matches_bench_py_bitwise(monkeypatch, n, mode):
    """Dyadic weights: every sum is exact, so the evaluators' orders
    do not matter.  "auto" is "gather" on the CPU on both sides; JAX's
    "pallas" runs its kernels in interpret mode, as its own tests do,
    and the port's its kernels' plain versions."""
    if mode == "pallas":
        eval_class = pk.eval_class
        monkeypatch.setattr(
            pk, "eval_class",
            lambda t, h, l, tb=pk.DEFAULT_TB, interpret=False,
            precision="bf16x2": eval_class(t, h, l, tb, True, precision))
    ts = jnt.get_tuple_set(n)
    w = dyadic_weights(ts.total, seed=n)
    codes = _start_codes(64, seed=n)
    key = jax.random.PRNGKey(n)
    jeval = jdisp.make_evaluator(ts, mode)
    want = np.asarray(jax.jit(
        lambda w_, c_, k_: _jax_eval_roll(jeval, w_, c_, k_, 8))(
            jnp.asarray(w), jnp.asarray(codes), key))
    got = torch_bench.eval_roll(
        tdisp.make_evaluator(tnt.get_tuple_set(n), mode),
        torch.from_numpy(w), torch.from_numpy(codes), _RollDraws(key), 8)
    np.testing.assert_array_equal(got.numpy(), want)


# -- the train rows ----------------------------------------------------------


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def row_configs():
    """(JAX's, the port's) (AgentConfig, TrainConfig) of each train row
    of each main, in row order, read where each package's
    ``td.init_td_state`` is called (which then stops the row)."""
    from tpu2048.agent import td as jtd
    from tpu2048_torch.agent import td as ttd

    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, mod, td, argv in (("jax", bench, jtd, []),
                                    ("port", torch_bench, ttd,
                                     ["--device", "cpu"])):
            got = seen[name] = []

            def init(ts, acfg, tcfg, *a, got=got, **kw):
                got.append((acfg, tcfg))
                raise _Stop

            def train(real=mod.bench_train, **kw):
                with pytest.raises(_Stop):
                    real(**kw)
                return 1.0

            mp.setattr(td, "init_td_state", init)
            _patch_rows(mp, mod, train=train)
            mod.main(argv)
    return seen["jax"], seen["port"]


def test_train_rows_build_bench_py_configs(row_configs):
    jax_rows, port_rows = row_configs
    assert len(jax_rows) == len(port_rows) == 3
    for (ja, jt), (pa, pt) in zip(jax_rows, port_rows):
        assert jax_cfg(pa) == ja
        assert jax_cfg(pt) == jt
    assert [a.n for a, _ in port_rows] == [5, 4, 6]


@pytest.fixture(scope="module")
def jaxfns():
    return JaxTrainFns()


@pytest.mark.parametrize("row", [0, 1, 2])
def test_train_row_segment_matches_jax(row_configs, jaxfns, row):
    """One segment of the row's learner, cut to n=4, 16 envs and K=8,
    from the same JAX state: held by ``check_segment``."""
    acfg, tcfg = row_configs[1][row]
    acfg = dataclasses.replace(acfg, n=4)
    tcfg = dataclasses.replace(tcfg, num_envs=16, steps_per_call=8)
    check_segment(jaxfns, acfg, tcfg, fresh_state(acfg, tcfg, 20 + row))


# -- the scripts -------------------------------------------------------------

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


def _env():
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    env.pop("PYTHONPATH", None)
    return env


@pytest.mark.parametrize("name,args,first", [
    ("sweep", ["--envs", 16, "--k", 4], "train n_envs=    16 k=   4: "),
    ("search", [2, 2], "leaf eval [gather] b=2048: "),
    ("ops", [2, 32], "eval gather  "),
])
def test_script_runs_on_cpu(tmp_path, name, args, first):
    proc = subprocess.run(
        [sys.executable, "-c", _WRAP, SCRIPTS[name], *map(str, args),
         "--device", "cpu"],
        cwd=str(tmp_path), env=_env(), capture_output=True, text=True,
        timeout=LIMIT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert json.loads(lines[-1]) == [], f"{name} loaded {lines[-1]}"
    assert lines[0] == "cpu"
    assert any(ln.startswith(first) for ln in lines), lines


def test_ops_script_raises_on_a_failing_mode(monkeypatch):
    mod = _load_script("ops")
    make_evaluator = tdisp.make_evaluator

    def failing(ts, mode, *a, **kw):
        if mode == "onehot":
            def broken(weights, boards):
                raise RuntimeError("onehot broke")
            return broken
        return make_evaluator(ts, mode, *a, **kw)

    monkeypatch.setattr(tdisp, "make_evaluator", failing)
    with pytest.raises(RuntimeError, match="onehot broke"):
        mod.main(["2", "16", "--device", "cpu"])


def test_bench_and_scripts_load_no_jax(tmp_path):
    code = (
        "import importlib.util, json, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import torch_bench\n"
        f"for path in {sorted(SCRIPTS.values())!r}:\n"
        "    spec = importlib.util.spec_from_file_location('s', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "                        if m.split('.')[0] in ('jax', 'tpu2048'))))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          env=_env(), capture_output=True, text=True,
                          timeout=LIMIT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.splitlines()[-1]) == []


@pytest.mark.parametrize("name", ["bench", "sweep", "search", "ops"])
def test_no_card_and_no_device_raises(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = torch_bench.main if name == "bench" else _load_script(name).main
    with pytest.raises(RuntimeError, match="no CUDA card"):
        main([])
