"""The port at n=6 (the flagship: 95.7 M entries, the 14^6 gather
classes) and n=7 on CPU, at 16 envs: a short ``Trainer`` run learns and
its checkpoint round-trips; two n=6 steps against JAX; and the entry
points of ``torch_graft_entry.py`` (the forward step, and the dry run
of data-parallel training on two gloo ranks)."""

import numpy as np
import pytest
import torch
from _torch_port import JaxTrainFns, check_step, fresh_state

import torch_graft_entry
from tpu2048_torch.config import AgentConfig, TrainConfig
from tpu2048_torch.features.ntuple import get_tuple_set
from tpu2048_torch.obs.logging import Logger
from tpu2048_torch.store import checkpoint as ckpt
from tpu2048_torch.store.artifacts import LocalStore
from tpu2048_torch.train.loop import Trainer

TCFG = TrainConfig(num_envs=16, steps_per_call=4, ring_size=64,
                   max_record_steps=256, seed=0)
TOTALS = {6: 95_662_848, 7: 206_635_008}


class _Segments:
    """A job that lets the trainer run ``n`` segments."""

    def __init__(self, n):
        self.left = n

    def should_stop(self):
        self.left -= 1
        return self.left < 0


@pytest.mark.parametrize("n", [6, 7])
def test_trainer_learns_and_checkpoints(n, tmp_path):
    """Three segments of the shipped learner (canonical form, TC, bf16
    actor, every env recorded): the gather classes' entries move, the
    tables stay finite, and the checkpoint (stored raw at this size)
    loads back bit for bit and resumes."""
    acfg = AgentConfig(n=n)
    ts = get_tuple_set(n)
    assert ts.total == TOTALS[n]
    store = LocalStore(str(tmp_path))
    tr = Trainer("big", acfg, TCFG, store=store, logger=Logger(console=False),
                 device="cpu")
    w0 = tr.state.weights.clone()
    tr.run(job=_Segments(3))
    st = tr.state
    assert int(st.env.odometer.max()) == 3 * TCFG.steps_per_call
    assert st.prev_cidx.shape == (16, 16)
    moved = st.weights != w0
    # the 16^4 class block and the gather classes both learned
    assert bool(moved[: 17 * 65536].any()) and bool(moved[17 * 65536:].any())
    assert bool(torch.isfinite(st.weights).all())
    assert float(st.opt_a.sum()) > 0.0
    acfg2, w, meta = ckpt.load_agent(store, "big")
    assert acfg2 == acfg
    np.testing.assert_array_equal(w, st.weights.numpy())
    np.testing.assert_array_equal(meta["extras"]["opt_e"], st.opt_e.numpy())
    np.testing.assert_array_equal(meta["extras"]["opt_a"], st.opt_a.numpy())
    del w, meta, moved, w0
    if n == 6:  # a second n=7 state would double this test's memory
        again = Trainer("big", acfg, TCFG, store=store,
                        logger=Logger(console=False), resume=True,
                        device="cpu")
        assert torch.equal(again.state.weights, st.weights)
        assert torch.equal(again.state.opt_a, st.opt_a)
        again.run(job=_Segments(1))
        assert not torch.equal(again.state.weights, st.weights)


def test_n6_steps_match_jax():
    """Two steps of the n=6 flagship learner at 8 envs against JAX
    (``table_ops="gather"``), from a fresh state and JAX's draws: the
    second step learns from the first's afterstates.  Integers bitwise,
    tables within 2^-17 (``assert_train_state``)."""
    acfg = AgentConfig(n=6, table_ops="gather")
    tcfg = TrainConfig(num_envs=8, steps_per_call=2, ring_size=16,
                       max_record_steps=32, seed=0)
    jaxfns = JaxTrainFns()
    js = fresh_state(acfg, tcfg, 1)
    _, js = check_step(jaxfns, acfg, tcfg, js)
    st, js = check_step(jaxfns, acfg, tcfg, js)
    assert st.prev_cidx.shape == (8, 16)  # 4 crosses + 12 six-blocks
    assert bool((st.opt_a != 0).any())


def test_entry_forward():
    fn, (weights, boards) = torch_graft_entry.entry(device="cpu")
    best_dir, best_val, done = fn(weights, boards)
    assert best_dir.shape == (1024,) and best_dir.dtype == torch.int32
    assert bool(torch.isfinite(best_val[~done]).all())
    assert not bool(done.any())  # fresh boards can move


def test_entry_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        torch_graft_entry.entry()


def test_dryrun_multichip_two_ranks(capfd):
    torch_graft_entry.dryrun_multichip(2)
    out = capfd.readouterr().out
    assert "dryrun_multichip OK: 2 gloo ranks on the CPU" in out
    assert "flagship n=6 canonical+tc segment OK" in out
