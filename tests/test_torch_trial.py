"""The port's serving slice against the JAX reference: ``trial`` at the
full n=5 width with JAX's draws fed to the port, greedy and with
depth-2 expectimax, and the checkpoint path of a canonical agent, all
bitwise; plus the port's freedom from jax."""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import JaxDraws, dyadic_weights, jax_cfg

from tpu2048.config import to_dict
from tpu2048.features import ntuple as jnt
from tpu2048.store import checkpoint as jckpt
from tpu2048.train.trial import trial as jax_trial
from tpu2048_torch.config import AgentConfig, SearchConfig
from tpu2048_torch.features import ntuple as tnt
from tpu2048_torch.store.artifacts import MemoryStore
from tpu2048_torch.store import checkpoint as tckpt
from tpu2048_torch.train import trial as ttrial

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_both(policy, w, seed, n=5, **kw):
    """The same trial in both packages, JAX's draws fed to the port;
    returns both results and both final states (logs included)."""
    states = {}

    def grab(key):
        return lambda st: states.__setitem__(key, st)

    kw = {"num": 32, "steps_per_call": 64, **kw, "seed": seed,
          "policy": policy}
    jkw = {k: jax_cfg(v) if k == "search" else v for k, v in kw.items()}
    want = jax_trial(jnt.get_tuple_set(n),
                     None if w is None else jnp.asarray(w),
                     progress_cb=grab("jax"), **jkw)
    got = ttrial.trial(tnt.get_tuple_set(n),
                       None if w is None else torch.from_numpy(w),
                       draws=JaxDraws(seed), progress_cb=grab("torch"),
                       device="cpu", **kw)
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


@pytest.mark.parametrize("n", [2, 5])
def test_trial_search_matches_jax(n):
    """Depth-2, width-2 expectimax ("auto" promoted to "search", which
    is "gather" on the CPU in both packages) with JAX's draws, the
    tree's included: every game bitwise."""
    w = dyadic_weights(jnt.get_tuple_set(n).total, seed=6)
    scfg = SearchConfig(depth=2, width=2, since_empty=6)
    got, want, st, sj = _run_both("value", w, seed=5, n=n, num=8,
                                  step_cap=512, search=scfg)
    assert got.odometers.min() > 0
    _assert_same(got, want, st, sj, 512)
    stats = got.search_stats
    # one tier choice per step; the 32 roots fit no smaller tier
    assert set(stats["tiers"]) == {0, 32}
    assert sum(stats["tiers"].values()) == stats["steps"]
    assert stats["tiers"][32] > 0 and stats["chunks"] == stats["tiers"][32]
    assert "upper bound" in got.report and "(lower bound)" in got.report
    # 4 root afterstates + 4 * width * (4 + 4 * width * 4) per move
    assert f"({4 + 4 * 2 * (4 + 4 * 2 * 4)} per move" in got.report


@pytest.mark.parametrize("canonical", [True, False])
def test_load_agent_dense_bitwise(canonical):
    ts = jnt.get_tuple_set(5)
    w = np.random.default_rng(4).standard_normal(ts.total).astype(np.float32)
    acfg = AgentConfig() if canonical else AgentConfig(sym_impl="fold")
    store = MemoryStore()
    jckpt.save_agent(store, "a", jax_cfg(acfg), w)
    _, want, _ = jckpt.load_agent_dense(store, "a")
    acfg2, got, _ = tckpt.load_agent_dense(store, "a", device="cpu")
    assert acfg2 == acfg and to_dict(acfg2) == to_dict(jax_cfg(acfg))
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_port_imports_no_jax():
    """The port serves, searches, trains and checkpoints without
    loading jax or any module of the JAX package."""
    code = textwrap.dedent("""
        import sys
        import tempfile
        import torch
        torch.set_num_threads(2)
        import tpu2048_torch
        import tpu2048_torch.ops.build
        import tpu2048_torch.ops.kernels
        import tpu2048_torch.store.checkpoint
        import tpu2048_torch.agent.td
        import tpu2048_torch.train.loop
        import tpu2048_torch.search.expectimax
        import tpu2048_torch.parallel.distributed
        import tpu2048_torch.parallel.mesh
        import tpu2048_torch.obs.jobs
        import torch_graft_entry
        from tpu2048_torch.config import AgentConfig, SearchConfig, TrainConfig
        from tpu2048_torch.obs.logging import Logger
        from tpu2048_torch.store.artifacts import LocalStore
        from tpu2048_torch.store.checkpoint import load_agent_dense
        from tpu2048_torch.features import ntuple
        from tpu2048_torch.train.loop import Trainer
        from tpu2048_torch.train.trial import trial
        ts = ntuple.get_tuple_set(5)
        g = torch.Generator()
        g.manual_seed(0)
        r = trial(ts, ntuple.init_weights(ts, g), num=4, seed=0,
                  steps_per_call=64)
        assert r.odometers.min() > 0
        r = trial(ts, ntuple.init_weights(ts, g), num=2, seed=0,
                  steps_per_call=8, step_cap=32,
                  search=SearchConfig(depth=1, width=2, since_empty=16))
        assert r.search_stats["tiers"][8] > 0
        class Once:
            left = 1
            def should_stop(self):
                self.left -= 1
                return self.left < 0
        with tempfile.TemporaryDirectory() as root:
            store = LocalStore(root)
            tr = Trainer("t", AgentConfig(n=4),
                         TrainConfig(num_envs=8, steps_per_call=2),
                         store=store, logger=Logger(console=False),
                         device="cpu")
            tr.run(job=Once())
            assert int(tr.state.env.odometer.max()) == 2
            _, w, _ = load_agent_dense(store, "t", device="cpu")
            r = trial(ntuple.get_tuple_set(4), w, num=2, seed=0,
                      steps_per_call=64)
            assert r.odometers.min() > 0
            # a learner off the defaults: the reference's own rule
            tr = Trainer("s", AgentConfig(n=4, optimizer="sgd", alpha=0.25,
                                          sym_impl="index"),
                         TrainConfig(num_envs=8, steps_per_call=2),
                         store=store, logger=Logger(console=False),
                         device="cpu")
            tr.run(job=Once())
            assert int(tr.state.env.odometer.max()) == 2
            assert tr.state.prev_idx.shape[1] == 8
            # under a mesh (of this process alone)
            from tpu2048_torch.parallel import distributed
            assert distributed.initialize() is False
            tr = Trainer("m", AgentConfig(n=4),
                         TrainConfig(num_envs=8, steps_per_call=2),
                         store=store, logger=Logger(console=False),
                         mesh=distributed.global_mesh(device="cpu"))
            tr.run(job=Once())
            assert int(tr.state.env.odometer.max()) == 2
            # on a model axis: rank 1 of a (1, 2) mesh without its peer
            # (its collectives return their input) holds three crosses
            from tpu2048_torch.parallel.mesh import Mesh
            tr = Trainer("ma", AgentConfig(n=5),
                         TrainConfig(num_envs=8, steps_per_call=2),
                         logger=Logger(console=False),
                         mesh=Mesh(1, 2, 1, torch.device("cpu")))
            tr.run(job=Once())
            assert tr.state.weights.shape == (3 * 16**5,)
        fn, args = torch_graft_entry.entry(device="cpu")
        assert fn(*args)[0].shape == (1024,)
        # the apps: a test job served through the service, to its end
        import tpu2048_torch.apps.cli
        import tpu2048_torch.apps.server
        import tpu2048_torch.apps.webui
        import tpu2048_torch.native
        import tpu2048_torch.obs.telemetry
        from tpu2048_torch.apps.service import AppService
        from tpu2048_torch.store.artifacts import MemoryStore
        from tpu2048_torch.store.checkpoint import save_agent
        store = MemoryStore()
        save_agent(store, "a", AgentConfig(n=2),
                   ntuple.init_weights(ntuple.get_tuple_set(2), g).numpy(),
                   {"episodes": 0})
        svc = AppService(store, device="cpu")
        svc.start_test("a", num=2)
        job = svc.jobs.get("test", "a")
        job.thread.join(timeout=120)
        assert job.error is None and job.result["avg"] > 0, job.error
        assert svc.system_stats()["now"]["rss_mb"] > 0
        assert "jax" not in sys.modules, "the port loaded jax"
        ref = sorted(m for m in sys.modules
                     if m == "tpu2048" or m.startswith("tpu2048."))
        assert not ref, f"the port loaded the JAX package: {ref}"
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_card_means_no_default_device(monkeypatch):
    """``Trainer`` and the baselines of ``trial`` default to the CUDA
    card; without one they raise and name the way to the CPU instead
    of falling back to it."""
    from tpu2048_torch.config import TrainConfig
    from tpu2048_torch.train.loop import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Trainer("x", AgentConfig(n=4), TrainConfig(num_envs=8))
    for policy in ("random", "score"):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            ttrial.trial(tnt.get_tuple_set(4), None, num=2, policy=policy)
    r = ttrial.trial(tnt.get_tuple_set(4), None, num=2, policy="score",
                     device="cpu")
    assert r.odometers.min() > 0
