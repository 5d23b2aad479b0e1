"""The port's ``Trainer`` on CPU: a short n=4 run, its ma-100 history
and best game, checkpoints that cross between the two packages in
both directions, resumes that change the table's representation
either way, a resume from a generator of the other device type, and
the reference's own learning rule (sgd) saved and resumed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import jax_cfg

from tpu2048.features import canonical as jcanon
from tpu2048.features import ntuple as jnt
from tpu2048.obs.logging import Logger as JaxLogger
from tpu2048.store import checkpoint as jckpt
from tpu2048.train.loop import Trainer as JaxTrainer
from tpu2048_torch.config import AgentConfig, TrainConfig
from tpu2048_torch.draws import TorchDraws
from tpu2048_torch.engine.core import np_move
from tpu2048_torch.features.ntuple import get_tuple_set
from tpu2048_torch.obs.logging import Logger
from tpu2048_torch.obs.metrics import train_history
from tpu2048_torch.store import checkpoint as ckpt
from tpu2048_torch.store.artifacts import MemoryStore
from tpu2048_torch.train.loop import RNG_DEVICE_EXTRA, RNG_EXTRA, Trainer

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
    jt = JaxTrainer("p", jax_cfg(ACFG), jax_cfg(TCFG), store=store,
                    logger=JaxLogger(console=False), resume=True)
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
    jckpt.save_agent(store, "j", jax_cfg(ACFG), w, meta, extras={
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
    _, _, meta = ckpt.load_agent(store, "p")
    assert str(meta["extras"][RNG_DEVICE_EXTRA]) == "cpu"
    again = Trainer("p", ACFG, TCFG, store=store, logger=_quiet(),
                    resume=True, device="cpu")
    assert torch.equal(again.draws.generator.get_state(), saved)


@pytest.mark.parametrize("tagged", [False, True], ids=["by_size", "by_tag"])
def test_resume_from_a_card_generator_starts_a_fresh_stream(tagged):
    """A checkpoint whose generator state came from the card (16 bytes:
    seed and offset) resumes on the CPU with a fresh stream from the
    config's seed, and says so in the log.  Checkpoints written before
    the device tag are judged by the state's size."""
    store = MemoryStore()
    extras = {RNG_EXTRA: np.arange(16, dtype=np.uint8)}
    if tagged:
        extras[RNG_DEVICE_EXTRA] = np.asarray("cuda")
    ckpt.save_agent(store, "g", ACFG,
                    np.zeros(get_tuple_set(4).total, np.float32),
                    {"episodes": 5}, extras=extras)
    log = Logger(store=MemoryStore(), console=False)
    tr = Trainer("g", ACFG, TCFG, store=store, logger=log, resume=True,
                 device="cpu")
    # a generator from the seed that drew the fresh env boards only
    fresh = TorchDraws(torch.Generator().manual_seed(TCFG.seed))
    fresh.new(TCFG.num_envs)
    assert torch.equal(tr.draws.generator.get_state(),
                       fresh.generator.get_state())
    assert "from cuda, not cpu: a fresh stream from seed 0" in log.tail()
    assert int(tr.state.metrics.episodes) == 5
    tr.run(job=_Once())
    assert int(tr.state.env.odometer.max()) == TCFG.steps_per_call


def test_sgd_agent_saves_and_resumes():
    """The reference's own rule, ``optimizer="sgd", alpha=0.25`` with
    explicit 8-image indices: no TC sums in the checkpoint, and the
    schedule's alpha and next decay carried across a resume."""
    acfg = AgentConfig(n=4, optimizer="sgd", alpha=0.25, sym_impl="index",
                       decay_step=4)
    store = MemoryStore()
    tr = Trainer("s", acfg, TCFG, store=store, logger=_quiet(), device="cpu")
    out = tr.run()
    assert out["episodes"] >= TCFG.episodes
    assert float(tr.state.alpha) < acfg.alpha  # the schedule decayed it
    _, _, meta = ckpt.load_agent(store, "s")
    assert "opt_e" not in meta["extras"]
    again = Trainer("s", acfg, TCFG, store=store, logger=_quiet(),
                    resume=True, device="cpu")
    assert torch.equal(again.state.alpha, tr.state.alpha)
    assert torch.equal(again.state.next_decay, tr.state.next_decay)
    assert torch.equal(again.state.weights, tr.state.weights)
    assert again.state.opt_e.shape == (0,)


def test_trainer_stops_on_cancel():
    class Stop:
        def should_stop(self):
            return True

    tr = Trainer("c", ACFG, TCFG, logger=_quiet(), device="cpu")
    out = tr.run(job=Stop())
    assert out["episodes"] == 0
    assert int(tr.state.env.odometer.max()) == 0


@pytest.mark.parametrize("what", ["mesh", "trace_dir"])
def test_unported_trainer_options_raise(what, tmp_path):
    if what == "mesh":
        # both axes are ported: a model axis needs its processes, and a
        # trainer on one holds its shard of the table
        from tpu2048_torch.config import MeshConfig
        from tpu2048_torch.parallel.mesh import Mesh, make_mesh

        mesh = make_mesh(MeshConfig(data=1, model=1), device="cpu")
        tr = Trainer("x", ACFG, TCFG, logger=_quiet(), mesh=mesh)
        assert tr.device.type == "cpu" and tr.mesh is mesh
        with pytest.raises(ValueError, match="needs 2 processes"):
            make_mesh(MeshConfig(data=1, model=2), device="cpu")
        mesh = Mesh(1, 2, 1, torch.device("cpu"))
        tr = Trainer("x", ACFG, TCFG, logger=_quiet(), mesh=mesh)
        shard = mesh.table_shard(tr.ts)
        assert tr.state.weights.shape == (shard.size,) == (
            tr.ts.total - shard.lo,)
    else:
        # ported: a session cancelled before its first segment still
        # writes its (host-only, on the CPU) trace and says where
        log = Logger(store=MemoryStore(), key="l/t.txt", console=False)
        tr = Trainer("x", ACFG, TCFG, logger=log, device="cpu")

        class Stop:
            def should_stop(self):
                return True

        tr.run(job=Stop(), trace_dir=str(tmp_path / "trace"))
        assert list((tmp_path / "trace").glob("*.pt.trace.json"))
        assert f"device trace written to {tmp_path / 'trace'}" in log.tail()


class _Once:
    """A job that lets the trainer run one segment."""

    left = 1

    def should_stop(self):
        self.left -= 1
        return self.left < 0


def test_dense_checkpoint_resumes_canonical():
    """A dense n=5 agent (``sym_impl="fold"``) saved by the reference
    with its TC extras resumes in the port as ``AgentConfig()``: the
    weights and both extras are JAX's ``from_dense_table`` of the saved
    arrays, bitwise, and a segment trains from them."""
    ts = jnt.get_tuple_set(5)
    rng = np.random.default_rng(9)
    w, e, a = (rng.standard_normal(ts.total).astype(np.float32)
               for _ in range(3))
    a = np.abs(a)
    store = MemoryStore()
    jckpt.save_agent(store, "d", jax_cfg(AgentConfig(sym_impl="fold")), w,
                     {"episodes": 40, "train_history": [5]},
                     extras={"opt_e": e, "opt_a": a})
    tcfg = dataclasses.replace(TCFG, episodes=1000)
    tr = Trainer("d", AgentConfig(), tcfg, store=store, logger=_quiet(),
                 resume=True, device="cpu")
    for name, arr in (("weights", w), ("opt_e", e), ("opt_a", a)):
        want = np.asarray(jcanon.from_dense_table(ts, jnp.asarray(arr)))
        np.testing.assert_array_equal(getattr(tr.state, name).numpy(), want,
                                      err_msg=name)
    assert int(tr.state.metrics.episodes) == 40
    before = tr.state.weights.clone()
    tr.run(job=_Once())
    assert int(tr.state.env.odometer.max()) == tcfg.steps_per_call
    assert bool(torch.isfinite(tr.state.weights).all())
    assert not torch.equal(tr.state.weights, before)


def test_canonical_checkpoint_resumes_dense():
    """A canonical n=5 agent (the defaults) saved by the reference with
    its TC extras resumes in the port as ``sym_impl="fold"``: the
    weights and both extras are JAX's ``to_dense_table`` of the saved
    arrays, bitwise, and a segment trains from them."""
    ts = jnt.get_tuple_set(5)
    rng = np.random.default_rng(10)
    w, e, a = (rng.standard_normal(ts.total).astype(np.float32)
               for _ in range(3))
    a = np.abs(a)
    store = MemoryStore()
    jckpt.save_agent(store, "c", jax_cfg(AgentConfig()), w,
                     {"episodes": 30, "train_history": [4]},
                     extras={"opt_e": e, "opt_a": a})
    dense = AgentConfig(sym_impl="fold")
    tr = Trainer("c", dense, TCFG, store=store, logger=_quiet(),
                 resume=True, device="cpu")
    for name, arr in (("weights", w), ("opt_e", e), ("opt_a", a)):
        want = np.asarray(jcanon.to_dense_table(ts, jnp.asarray(arr)))
        np.testing.assert_array_equal(getattr(tr.state, name).numpy(), want,
                                      err_msg=name)
    assert int(tr.state.metrics.episodes) == 30
    before = tr.state.weights.clone()
    tr.run(job=_Once())
    assert int(tr.state.env.odometer.max()) == TCFG.steps_per_call
    assert bool(torch.isfinite(tr.state.weights).all())
    assert not torch.equal(tr.state.weights, before)
