"""The port's serving slice against the JAX reference: ``trial`` at the
full n=5 width with JAX's draws fed to the port, and the checkpoint
path of a canonical agent, both bitwise; plus the port's freedom from
jax."""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import JaxDraws, dyadic_weights

from tpu2048.config import AgentConfig, SearchConfig
from tpu2048.features import ntuple as jnt
from tpu2048.store import checkpoint as jckpt
from tpu2048.store.artifacts import MemoryStore
from tpu2048.train.trial import trial as jax_trial
from tpu2048_torch.features import ntuple as tnt
from tpu2048_torch.store import checkpoint as tckpt
from tpu2048_torch.train import trial as ttrial

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_both(policy, w, seed, **kw):
    """The same trial in both packages, JAX's draws fed to the port;
    returns both results and both final states (logs included)."""
    states = {}

    def grab(key):
        return lambda st: states.__setitem__(key, st)

    kw = dict(num=32, seed=seed, steps_per_call=64, policy=policy, **kw)
    want = jax_trial(jnt.get_tuple_set(5),
                     None if w is None else jnp.asarray(w),
                     progress_cb=grab("jax"), **kw)
    got = ttrial.trial(tnt.get_tuple_set(5),
                       None if w is None else torch.from_numpy(w),
                       draws=JaxDraws(seed), progress_cb=grab("torch"), **kw)
    return got, want, states["torch"], states["jax"]


def _assert_same(got, want, st, sj, step_cap):
    for name in ("scores", "tiles", "odometers", "final_boards"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    # the whole move and spawn logs; the port's spill column is dropped
    for name in ("moves", "spawns"):
        np.testing.assert_array_equal(
            getattr(st, name)[:, :step_cap].numpy(),
            np.asarray(getattr(sj, name)), err_msg=name)
    np.testing.assert_array_equal(st.codes.numpy(), np.asarray(sj.codes))
    assert got.best_game is not None
    assert got.best_game.keys() == want.best_game.keys()
    for k, v in want.best_game.items():
        np.testing.assert_array_equal(got.best_game[k], v, err_msg=k)
    # the replayed record reproduces the device's score and board
    best = int(np.argmax(got.scores))
    assert got.best_game["score"] == got.scores[best]
    np.testing.assert_array_equal(got.best_game["final_board"],
                                  got.final_boards[best])


@pytest.mark.parametrize("policy", ["value", "score", "random"])
def test_trial_matches_jax_n5(policy):
    w = dyadic_weights(jnt.get_tuple_set(5).total, seed=1) \
        if policy == "value" else None
    got, want, st, sj = _run_both(policy, w, seed=0, step_cap=4096)
    assert got.odometers.min() > 0  # every game played
    _assert_same(got, want, st, sj, 4096)


def test_trial_game_init_and_limit_tile_match_jax_n5():
    """A given starting board and an early stop at the 64 tile."""
    w = dyadic_weights(jnt.get_tuple_set(5).total, seed=2)
    start = np.zeros((4, 4), np.int8)
    start[0, 0], start[3, 2] = 1, 2
    got, want, st, sj = _run_both("value", w, seed=3, step_cap=2048,
                                  game_init=start, limit_tile=6)
    assert got.tiles.max() <= 6
    np.testing.assert_array_equal(got.best_game["starting_position"], start)
    _assert_same(got, want, st, sj, 2048)


def test_trial_rejects_search_depth():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttrial.trial(tnt.get_tuple_set(2), None, num=2,
                     search=SearchConfig(depth=1), policy="score")


@pytest.mark.parametrize("canonical", [True, False])
def test_load_agent_dense_bitwise(canonical):
    ts = jnt.get_tuple_set(5)
    w = np.random.default_rng(4).standard_normal(ts.total).astype(np.float32)
    acfg = AgentConfig() if canonical else AgentConfig(sym_impl="fold")
    store = MemoryStore()
    jckpt.save_agent(store, "a", acfg, w)
    _, want, _ = jckpt.load_agent_dense(store, "a")
    acfg2, got, _ = tckpt.load_agent_dense(store, "a", device="cpu")
    assert acfg2 == acfg
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_port_imports_no_jax():
    code = textwrap.dedent("""
        import sys
        import torch
        torch.set_num_threads(2)
        import tpu2048_torch
        import tpu2048_torch.ops.build
        import tpu2048_torch.ops.kernels
        import tpu2048_torch.store.checkpoint
        import tpu2048_torch.agent.td
        import tpu2048_torch.train.loop
        from tpu2048.config import AgentConfig, TrainConfig
        from tpu2048.obs.logging import Logger
        from tpu2048_torch.features import ntuple
        from tpu2048_torch.train.loop import Trainer
        from tpu2048_torch.train.trial import trial
        ts = ntuple.get_tuple_set(5)
        g = torch.Generator()
        g.manual_seed(0)
        r = trial(ts, ntuple.init_weights(ts, g), num=4, seed=0,
                  steps_per_call=64)
        assert r.odometers.min() > 0
        class Once:
            left = 1
            def should_stop(self):
                self.left -= 1
                return self.left < 0
        tr = Trainer("t", AgentConfig(n=4),
                     TrainConfig(num_envs=8, steps_per_call=2),
                     logger=Logger(console=False), device="cpu")
        tr.run(job=Once())
        assert int(tr.state.env.odometer.max()) == 2
        assert "jax" not in sys.modules, "the port loaded jax"
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
