"""The port's canonical-form learners off the defaults, its actors and
engines, its unstaged step and the sgd alpha schedule, against JAX's
on CPU:

  * canonical sgd ("mean" and "sum") and canonical TC "sum" at n=5,
    where the gather class's crosses take their own update;
  * ``actor_precision="bf16x2"`` (exact selection, no re-evaluation);
  * ``engine_mode="cells"``, canonical TC at n=5 (the crosses'
    indices recomputed from the chosen board) and sgd "index" at n=4
    (its 8 images from the chosen board);
  * the unstaged step (``staged=False``): logs and best game every
    step, from boards one or two moves from game over;
  * the sgd schedule: each decay trigger fires inside a segment.

Each learner setting is held for one segment from a fresh state and
one step from the state it leaves, with dyadic weights (see
``test_torch_train_tables.py``).  Integers, ``alpha`` and
``next_decay`` are bitwise, the tables within 2^-17 of their largest
entry.
"""

import dataclasses

import jax.numpy as jnp
import pytest
from _torch_port import (AfterSegment, JaxTrainDraws, assert_train_state,
                         check_segment, check_step, dyadic_weights,
                         fresh_state, near_terminal_state, replay)

from tpu2048_torch.agent import td as ttd
from tpu2048_torch.config import AgentConfig, TrainConfig
from tpu2048_torch.features import ntuple as tnt
from tpu2048_torch.store.checkpoint import td_state_from_numpy

TCFG = TrainConfig(num_envs=32, steps_per_call=8, ring_size=64,
                   max_record_steps=256, seed=0)
# "sum" at a small alpha: see test_torch_train_tables.py
VARIANTS = {
    "sgd_canonical": AgentConfig(optimizer="sgd", alpha=0.25),
    "sgd_canonical_sum": AgentConfig(optimizer="sgd", alpha=2.0**-10,
                                     update_mode="sum"),
    "tc_canonical_sum": AgentConfig(alpha=2.0**-4, update_mode="sum"),
    "bf16x2_actor": AgentConfig(n=4, actor_precision="bf16x2"),
    "cells": AgentConfig(engine_mode="cells"),
    "cells_sgd_index": AgentConfig(n=4, engine_mode="cells", optimizer="sgd",
                                   alpha=0.25, sym_impl="index"),
}


@pytest.fixture(scope="module")
def after_segment():
    return AfterSegment(VARIANTS, TCFG, seed0=20)


@pytest.fixture(scope="module")
def jaxfns(after_segment):
    return after_segment.jaxfns


@pytest.mark.parametrize("name", list(VARIANTS))
def test_segment_matches_jax(name, after_segment):
    js = after_segment(name)
    assert int(js.env.odometer.max()) == TCFG.steps_per_call
    if VARIANTS[name].n == 5 and "index" not in name:
        assert js.prev_cidx.shape[1] > 0  # the crosses took part


@pytest.mark.parametrize("name", list(VARIANTS))
def test_step_matches_jax(name, jaxfns, after_segment):
    js = after_segment(name)
    assert bool(js.prev_valid.any())
    js = js._replace(weights=jnp.asarray(dyadic_weights(js.weights.size)))
    check_step(jaxfns, VARIANTS[name], TCFG, js)


# a record limit the long-running half of the envs has passed
TCFG_END = TrainConfig(num_envs=16, steps_per_call=8, ring_size=64,
                       max_record_steps=32, seed=0)


@pytest.mark.parametrize("acfg", [AgentConfig(n=4),
                                  AgentConfig(n=4, engine_mode="cells")],
                         ids=["codes", "cells"])
def test_unstaged_steps_match_jax(acfg, jaxfns):
    """Twelve unstaged steps of the port (one draw source, its own
    state throughout) against JAX's, every step held: the logs without
    the port's spill column, the overflow flags and the best game."""
    js = near_terminal_state(acfg, TCFG_END, seed=7)
    st = td_state_from_numpy(js, "cpu")
    step = ttd.make_train_step(tnt.get_tuple_set(acfg.n), acfg, TCFG_END,
                               JaxTrainDraws(js.key), staged=False)
    jstep = jaxfns.get(acfg, TCFG_END, "unstaged")
    for _ in range(12):
        st, js = step(st), jstep(js)
        assert_train_state(st, js, TCFG_END)
    rec = st.recorder
    assert int(st.metrics.episodes) > 0 and bool(rec.overflow.any())
    assert int(rec.best_score) > 0
    assert replay(rec) == int(rec.best_score)


@pytest.mark.parametrize("trigger", ["episodes", "top_tile", "both"])
def test_sgd_schedule_matches_jax(trigger, jaxfns):
    """The reference's own rule (sgd, alpha 0.25, "index") for one
    segment from boards one or two moves from game over.  Every
    ``decay_step`` episodes (counted after the step's completions) or
    at a game that ends above the top tile so far (the old one), alpha
    decays to ``round(max(alpha * decay, low), 4)``: a small
    ``decay_step`` fires the first, a low starting top tile the
    second."""
    tcfg = TrainConfig(num_envs=32, steps_per_call=12, ring_size=64,
                       max_record_steps=64, seed=0)
    acfg = AgentConfig(n=4, optimizer="sgd", alpha=0.25, sym_impl="index",
                       decay_step=4 if trigger != "top_tile" else 10**6)
    js = near_terminal_state(acfg, tcfg, seed=11)
    if trigger != "episodes":
        # near-terminal boards top out at 2^8, below the starting 2^10
        js = js._replace(top_tile=jnp.int32(5))
    top0 = int(js.top_tile)
    st, js = check_segment(jaxfns, acfg, tcfg, js)
    assert float(st.alpha) < acfg.alpha
    assert int(st.metrics.episodes) > 4
    if trigger == "episodes":
        assert int(st.top_tile) == top0 and int(st.next_decay) > 4
    else:
        assert int(st.top_tile) > top0
    if trigger == "top_tile":
        # moved by the tile trigger alone
        assert int(st.next_decay) > acfg.decay_step


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("rule", ["tc", "sgd_index"])
def test_small_tuple_sets_match_jax(n, rule, jaxfns):
    """n=2 (24 tuples of 16^2) and n=3 (52 of 16^3): the defaults and
    the reference's own rule, one segment and one step each."""
    acfg = AgentConfig(n=n)
    if rule == "sgd_index":
        acfg = dataclasses.replace(acfg, optimizer="sgd", alpha=0.25,
                                   sym_impl="index")
    _, js = check_segment(jaxfns, acfg, TCFG, fresh_state(acfg, TCFG, n))
    js = js._replace(weights=jnp.asarray(dyadic_weights(js.weights.size)))
    check_step(jaxfns, acfg, TCFG, js)
