"""The port's ``Trainer`` on CPU: a short n=4 run, its ma-100 history
and best game, and checkpoints that cross between the two packages in
both directions."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpu2048.config import AgentConfig, TrainConfig
from tpu2048.obs.logging import Logger
from tpu2048.obs.metrics import train_history
from tpu2048.store import checkpoint as ckpt
from tpu2048.store.artifacts import MemoryStore
from tpu2048.train.loop import Trainer as JaxTrainer
from tpu2048_torch.engine.core import np_move
from tpu2048_torch.features.ntuple import get_tuple_set
from tpu2048_torch.train.loop import RNG_EXTRA, Trainer

ACFG = AgentConfig(n=4)
TCFG = TrainConfig(num_envs=16, steps_per_call=4, ring_size=256,
                   max_record_steps=1024, episodes=20, checkpoint_every=10,
                   log_every=10, seed=0)


def _quiet():
    return Logger(console=False)


@pytest.fixture(scope="module")
def run():
    """One port run of at least 20 episodes, with its store."""
    store = MemoryStore()
    tr = Trainer("p", ACFG, TCFG, store=store, logger=_quiet(),
                 device="cpu")
    return tr, tr.run(), store


def test_trainer_run_history_and_best_game(run):
    tr, out, store = run
    assert out["episodes"] >= TCFG.episodes
    # one ma-100 point per window of log_every episodes, each the mean
    # of that window's scores (the ring holds every episode so far)
    ring = tr.state.metrics.score_ring.numpy()
    every = TCFG.log_every
    want = [int(ring[i: i + every].mean())
            for i in range(0, out["episodes"] - every + 1, every)]
    assert out["train_history"] == want
    assert train_history(store, "p") == want
    # the saved best game is the run's best and replays to its score
    rec = ckpt.load_game(store, "best_of_p")
    assert rec["score"] == out["top_score"] > 0
    board, score = rec["starting_position"].copy(), 0
    for t in range(rec["odometer"]):
        board, delta, changed = np_move(board, int(rec["moves"][t]))
        assert changed
        val, i, j = rec["tiles"][t]
        board[i, j] = val
        score += delta
    assert score == rec["score"]
    np.testing.assert_array_equal(board, rec["final_board"])


def test_port_checkpoint_resumes_in_jax(run):
    tr, out, store = run
    _, w, meta = ckpt.load_agent(store, "p")
    assert "rng_key" not in meta["extras"]
    assert RNG_EXTRA in meta["extras"]
    jt = JaxTrainer("p", ACFG, TCFG, store=store, logger=_quiet(),
                    resume=True)
    np.testing.assert_array_equal(np.asarray(jt.state.weights),
                                  tr.state.weights.numpy())
    np.testing.assert_array_equal(np.asarray(jt.state.opt_e),
                                  tr.state.opt_e.numpy())
    np.testing.assert_array_equal(np.asarray(jt.state.opt_a),
                                  tr.state.opt_a.numpy())
    assert int(jt.state.metrics.episodes) == out["episodes"]
    assert jt.train_history == out["train_history"]


def test_jax_checkpoint_resumes_in_port():
    ts = get_tuple_set(4)
    rng = np.random.default_rng(0)
    w, e, a = (rng.standard_normal(ts.total).astype(np.float32)
               for _ in range(3))
    store = MemoryStore()
    meta = {"episodes": 1234, "top_score": 5678, "top_tile": 11,
            "alpha": 1.0, "next_decay": 10000, "train_history": [1, 2, 3]}
    ckpt.save_agent(store, "j", ACFG, w, meta, extras={
        "opt_e": e, "opt_a": np.abs(a),
        "rng_key": np.asarray(jax.random.PRNGKey(3), np.uint32)})
    tr = Trainer("j", ACFG, TCFG, store=store, logger=_quiet(),
                 resume=True, device="cpu")
    st = tr.state
    np.testing.assert_array_equal(st.weights.numpy(), w)
    np.testing.assert_array_equal(st.opt_e.numpy(), e)
    np.testing.assert_array_equal(st.opt_a.numpy(), np.abs(a))
    assert int(st.metrics.episodes) == 1234
    assert int(st.metrics.best_score) == 5678
    assert int(st.top_tile) == 11
    assert tr.train_history == [1, 2, 3]


def test_resume_continues_the_generator_stream(run):
    tr, _, store = run
    saved = tr.draws.generator.get_state()
    again = Trainer("p", ACFG, TCFG, store=store, logger=_quiet(),
                    resume=True, device="cpu")
    assert torch.equal(again.draws.generator.get_state(), saved)


def test_trainer_stops_on_cancel():
    class Stop:
        def should_stop(self):
            return True

    tr = Trainer("c", ACFG, TCFG, logger=_quiet(), device="cpu")
    out = tr.run(job=Stop())
    assert out["episodes"] == 0
    assert int(tr.state.env.odometer.max()) == 0


@pytest.mark.parametrize("what", ["mesh", "trace_dir", "representation"])
def test_unported_trainer_options_raise(what):
    store = MemoryStore()
    if what == "mesh":
        with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
            Trainer("x", ACFG, TCFG, mesh=object(), device="cpu")
    elif what == "trace_dir":
        tr = Trainer("x", ACFG, TCFG, logger=_quiet(), device="cpu")
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            tr.run(trace_dir="/nonexistent")
    else:
        dense = dataclasses.replace(ACFG, sym_impl="fold")
        ckpt.save_agent(store, "x", dense,
                        np.zeros(get_tuple_set(4).total, np.float32))
        with pytest.raises(NotImplementedError, match="Queue 1 item 1"):
            Trainer("x", ACFG, TCFG, store=store, resume=True, device="cpu")
