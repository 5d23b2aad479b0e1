"""The port's train step and segment against the JAX reference on CPU.

A JAX train state is carried across (``td_state_from_numpy``) and
both packages step it with the same draws (``JaxTrainDraws``): every
integer of the state, the staged recorder rows, the logs and the
best-game snapshot bitwise; the weight table and the TC sums within
2^-17 of the table's largest entry (the two frameworks sum the same
f32 terms in other orders).  The metrics rings are compared without
their trash slot, which every unfinished lane writes in no set order
(``tpu2048/agent/td.py:807-815``).  JAX runs as its own tests run it:
"auto" resolves to gather on the CPU.
"""

import jax
import pytest
import torch
from _torch_port import (JaxTrainDraws, JaxTrainFns, assert_eq,
                         assert_train_state, dyadic_weights, jax_cfg,
                         near_terminal_state, replay)

from tpu2048.agent import td as jtd
from tpu2048.features import ntuple as jnt
from tpu2048_torch.agent import td as ttd
from tpu2048_torch.config import AgentConfig, TrainConfig
from tpu2048_torch.features import ntuple as tnt
from tpu2048_torch.ops import kernels
from tpu2048_torch.store.checkpoint import td_state_from_numpy

TCFG = TrainConfig(num_envs=32, steps_per_call=8, ring_size=64,
                   max_record_steps=256, seed=0)
# near-terminal start: long segments, so fresh episodes start and end
# inside one; a record limit some of them outrun
TCFG_END = TrainConfig(num_envs=8, steps_per_call=200, ring_size=64,
                       max_record_steps=128, seed=0)


@pytest.fixture(scope="module")
def jaxfns():
    return JaxTrainFns()


@pytest.fixture(scope="module")
def mid_states(jaxfns):
    """Per n: the JAX state one segment after init, so that the
    compared step has valid previous afterstates and TC sums."""
    cache = {}

    def get(n):
        if n not in cache:
            js = jtd.init_td_state(jnt.get_tuple_set(n),
                                   jax_cfg(AgentConfig(n=n)), jax_cfg(TCFG),
                                   jax.random.PRNGKey(n))
            cache[n] = jaxfns.get(AgentConfig(n=n), TCFG, "segment")(js)
        return cache[n]

    return get


@pytest.mark.parametrize("n", [4, 5])
def test_init_td_state_matches_jax(n):
    key = jax.random.PRNGKey(10 + n)
    ts, acfg = jnt.get_tuple_set(n), AgentConfig(n=n)
    js = jtd.init_td_state(ts, jax_cfg(acfg), jax_cfg(TCFG), key)
    st = ttd.init_td_state(tnt.get_tuple_set(n), acfg, TCFG,
                           JaxTrainDraws(key), "cpu")
    assert_eq(st.weights, js.weights, "weights")
    assert st.recorder.moves.shape == (32, TCFG.max_record_steps + 1)
    assert_train_state(st, js, TCFG)


@pytest.mark.parametrize("n", [4, 5])
def test_train_step_matches_jax(n, jaxfns, mid_states):
    js = mid_states(n)
    st = td_state_from_numpy(js, "cpu")
    step = ttd.make_train_step(tnt.get_tuple_set(n), AgentConfig(n=n), TCFG,
                               JaxTrainDraws(js.key))
    st, rs = step(st)
    js, jr = jaxfns.get(AgentConfig(n=n), TCFG, "step")(js)
    for f in rs._fields:
        assert_eq(getattr(rs, f), getattr(jr, f), f"RecStep.{f}")
    # the staged step leaves the logs to the segment's merge
    assert_train_state(st, js, TCFG, logs=False)
    assert bool(st.prev_valid.any())


@pytest.mark.parametrize("n", [4, 5])
def test_train_segment_matches_jax(n, jaxfns, mid_states):
    js = mid_states(n)
    st = td_state_from_numpy(js, "cpu")
    seg = ttd.make_train_segment(tnt.get_tuple_set(n), AgentConfig(n=n),
                                 TCFG, JaxTrainDraws(js.key))
    st = seg(st)
    js = jaxfns.get(AgentConfig(n=n), TCFG, "segment")(js)
    assert_train_state(st, js, TCFG)
    assert int(st.env.odometer.max()) == 2 * TCFG.steps_per_call


def test_segment_from_near_terminal_boards_matches_jax(jaxfns):
    """Episodes end and reset inside the segment, and fresh ones start
    and end inside it too: both candidate sources of the recorder merge
    (``_merge_staged_recorder``), and the overflow flag."""
    tcfg = TCFG_END
    js = near_terminal_state(AgentConfig(n=4), tcfg, seed=5)
    st = td_state_from_numpy(js, "cpu")
    seg = ttd.make_train_segment(tnt.get_tuple_set(4), AgentConfig(n=4),
                                 tcfg, JaxTrainDraws(js.key))
    st = seg(st)
    js = jaxfns.get(AgentConfig(n=4), tcfg, "segment")(js)
    assert_train_state(st, js, tcfg)
    assert int(st.metrics.episodes) > tcfg.num_envs  # in-segment episodes
    assert bool(st.recorder.overflow.any())
    rec = st.recorder
    # the run's best game may have outrun the record limit
    assert 0 < int(rec.best_score) <= int(st.metrics.best_score)
    assert 0 < int(rec.best_len) < tcfg.steps_per_call  # an in-segment game
    assert replay(rec) == int(rec.best_score)


def test_pallas_on_cpu_equals_gather_n5(mid_states):
    """``table_ops="pallas"`` on CPU tensors runs the kernels' plain
    versions (bf16 selection included); with dyadic weights every value
    is exact, so one step equals the gather step bit for bit."""
    js = mid_states(5)
    w = torch.from_numpy(dyadic_weights(jnt.get_tuple_set(5).total, seed=8))
    out = {}
    launches = [k.launches for k in (kernels.eval_class, kernels.grad_class,
                                     kernels.fold_class)]
    for mode in ("pallas", "gather"):
        st = td_state_from_numpy(js, "cpu")._replace(weights=w.clone())
        step = ttd.make_train_step(tnt.get_tuple_set(5),
                                   AgentConfig(table_ops=mode), TCFG,
                                   JaxTrainDraws(js.key))
        out[mode] = step(st)
    assert launches == [k.launches for k in (
        kernels.eval_class, kernels.grad_class, kernels.fold_class)]
    (a, ra), (b, rb) = out["pallas"], out["gather"]
    for f in ra._fields:
        assert_eq(getattr(ra, f), getattr(rb, f), f)
    for x, y in zip(jax.tree_util.tree_leaves(tuple(a)),
                    jax.tree_util.tree_leaves(tuple(b))):
        assert_eq(x, y, "state")
