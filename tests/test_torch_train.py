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

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import JaxTrainDraws, dyadic_weights, jax_cfg

from tpu2048.agent import td as jtd
from tpu2048.engine import fast as jfast
from tpu2048.features import ntuple as jnt
from tpu2048_torch.agent import td as ttd
from tpu2048_torch.config import AgentConfig, TrainConfig
from tpu2048_torch.engine.core import np_move
from tpu2048_torch.features import ntuple as tnt
from tpu2048_torch.ops import kernels
from tpu2048_torch.store.checkpoint import td_state_from_numpy

TCFG = TrainConfig(num_envs=32, steps_per_call=8, ring_size=64,
                   max_record_steps=256, seed=0)
# near-terminal start: long segments, so fresh episodes start and end
# inside one; a record limit some of them outrun
TCFG_END = TrainConfig(num_envs=8, steps_per_call=200, ring_size=64,
                       max_record_steps=128, seed=0)
TOL = 2.0**-17


class _Jax:
    """Each JAX function jitted once per configuration, for the module."""

    def __init__(self):
        self._fns = {}

    def fns(self, n, tcfg):
        key = (n, tcfg)
        if key not in self._fns:
            ts, acfg = jnt.get_tuple_set(n), jax_cfg(AgentConfig(n=n))
            jtcfg = jax_cfg(tcfg)
            self._fns[key] = (
                jax.jit(jtd.make_train_step(ts, acfg, jtcfg, staged=True)),
                jax.jit(jtd.make_train_segment(ts, acfg, jtcfg)),
            )
        return self._fns[key]


@pytest.fixture(scope="module")
def jaxfns():
    return _Jax()


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
            cache[n] = jaxfns.fns(n, TCFG)[1](js)
        return cache[n]

    return get


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, name):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max()),
                               err_msg=name)


def _eq(got, want, name):
    np.testing.assert_array_equal(_np(got), _np(want), err_msg=name)


def _assert_state(st, js, tcfg, logs=True):
    """The port's state against JAX's (see the module doc)."""
    for f in ("codes", "score", "odometer"):
        _eq(getattr(st.env, f), getattr(js.env, f), f"env.{f}")
    for f in ("prev_idx", "prev_valid", "prev_cidx", "prev_cmult",
              "top_tile", "next_decay", "alpha"):
        _eq(getattr(st, f), getattr(js, f), f)
    _close(st.prev_value, js.prev_value, "prev_value")
    for f in ("weights", "opt_e", "opt_a"):
        _close(getattr(st, f), getattr(js, f), f)
    ring = tcfg.ring_size
    for f in st.metrics._fields:
        a, b = _np(getattr(st.metrics, f)), _np(getattr(js.metrics, f))
        if a.ndim:
            a, b = a[:ring], b[:ring]
        _eq(a, b, f"metrics.{f}")
    s = tcfg.max_record_steps
    rec, jrec = st.recorder, js.recorder
    for f in rec._fields:
        a, b = getattr(rec, f), getattr(jrec, f)
        if f in ("moves", "spawns"):
            if not logs:
                continue
            a = a[:, :s]
        _eq(a, b, f"recorder.{f}")


@pytest.mark.parametrize("n", [4, 5])
def test_init_td_state_matches_jax(n):
    key = jax.random.PRNGKey(10 + n)
    ts, acfg = jnt.get_tuple_set(n), AgentConfig(n=n)
    js = jtd.init_td_state(ts, jax_cfg(acfg), jax_cfg(TCFG), key)
    st = ttd.init_td_state(tnt.get_tuple_set(n), acfg, TCFG,
                           JaxTrainDraws(key), "cpu")
    _eq(st.weights, js.weights, "weights")
    assert st.recorder.moves.shape == (32, TCFG.max_record_steps + 1)
    _assert_state(st, js, TCFG)


@pytest.mark.parametrize("n", [4, 5])
def test_train_step_matches_jax(n, jaxfns, mid_states):
    js = mid_states(n)
    st = td_state_from_numpy(js, "cpu")
    step = ttd.make_train_step(tnt.get_tuple_set(n), AgentConfig(n=n), TCFG,
                               JaxTrainDraws(js.key))
    st, rs = step(st)
    js, jr = jaxfns.fns(n, TCFG)[0](js)
    for f in rs._fields:
        _eq(getattr(rs, f), getattr(jr, f), f"RecStep.{f}")
    # the staged step leaves the logs to the segment's merge
    _assert_state(st, js, TCFG, logs=False)
    assert bool(st.prev_valid.any())


@pytest.mark.parametrize("n", [4, 5])
def test_train_segment_matches_jax(n, jaxfns, mid_states):
    js = mid_states(n)
    st = td_state_from_numpy(js, "cpu")
    seg = ttd.make_train_segment(tnt.get_tuple_set(n), AgentConfig(n=n),
                                 TCFG, JaxTrainDraws(js.key))
    st = seg(st)
    js = jaxfns.fns(n, TCFG)[1](js)
    _assert_state(st, js, TCFG)
    assert int(st.env.odometer.max()) == 2 * TCFG.steps_per_call


def _near_terminal_state(seed):
    """A JAX state whose boards are one or two moves from game over:
    checkerboards of two tile values with one or two holes.  Half the
    envs are 10 moves past the record limit, so their logs overflow."""
    tcfg, n = TCFG_END, 4
    js = jtd.init_td_state(jnt.get_tuple_set(n), jax_cfg(AgentConfig(n=n)),
                           jax_cfg(tcfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    m = tcfg.num_envs
    a = rng.integers(1, 7, m)[:, None, None]
    boards = np.where((np.add.outer(np.arange(4), np.arange(4)) % 2) == 0,
                      a, a + 1).astype(np.int8)
    for b in boards:
        b.reshape(16)[rng.choice(16, rng.integers(1, 3), replace=False)] = 0
    codes = jfast.codes_from_boards(jnp.asarray(boards))
    odo = np.where(np.arange(m) % 2 == 0, 0, tcfg.max_record_steps + 10)
    env = jfast.EnvStateC(codes=codes, score=jnp.zeros(m, jnp.int32),
                          odometer=jnp.asarray(odo, jnp.int32))
    return js._replace(env=env, recorder=js.recorder._replace(
        starts=jnp.asarray(boards)))


def _replay(rec) -> int:
    board, score = _np(rec.best_start).copy(), 0
    for t in range(int(rec.best_len)):
        board, delta, changed = np_move(board, int(rec.best_moves[t]))
        assert changed, f"illegal replay move at step {t}"
        sp = int(rec.best_spawns[t]) & 0xFF
        flat = board.reshape(16).copy()  # np_move may return a strided view
        assert flat[sp & 0xF] == 0
        flat[sp & 0xF] = (sp >> 4) + 1
        board = flat.reshape(4, 4)
        score += delta
    return score


def test_segment_from_near_terminal_boards_matches_jax(jaxfns):
    """Episodes end and reset inside the segment, and fresh ones start
    and end inside it too: both candidate sources of the recorder merge
    (``_merge_staged_recorder``), and the overflow flag."""
    tcfg = TCFG_END
    js = _near_terminal_state(seed=5)
    st = td_state_from_numpy(js, "cpu")
    seg = ttd.make_train_segment(tnt.get_tuple_set(4), AgentConfig(n=4),
                                 tcfg, JaxTrainDraws(js.key))
    st = seg(st)
    js = jaxfns.fns(4, tcfg)[1](js)
    _assert_state(st, js, tcfg)
    assert int(st.metrics.episodes) > tcfg.num_envs  # in-segment episodes
    assert bool(st.recorder.overflow.any())
    rec = st.recorder
    # the run's best game may have outrun the record limit
    assert 0 < int(rec.best_score) <= int(st.metrics.best_score)
    assert 0 < int(rec.best_len) < tcfg.steps_per_call  # an in-segment game
    assert _replay(rec) == int(rec.best_score)


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
        _eq(getattr(ra, f), getattr(rb, f), f)
    for x, y in zip(jax.tree_util.tree_leaves(tuple(a)),
                    jax.tree_util.tree_leaves(tuple(b))):
        _eq(x, y, "state")


@pytest.mark.parametrize("field,value", [
    ("optimizer", "sgd"), ("update_mode", "sum"), ("sym_impl", "fold"),
    ("sym_impl", "index"), ("sym_mode", "periodic"), ("sym_mode", "none"),
    ("actor_precision", "bf16x2"), ("engine_mode", "cells"),
])
def test_unported_learner_variants_raise(field, value):
    acfg = dataclasses.replace(AgentConfig(n=4), **{field: value})
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        ttd.make_train_step(tnt.get_tuple_set(4), acfg, TCFG, None)
