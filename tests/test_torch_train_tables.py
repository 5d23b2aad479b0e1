"""The port's learners off the canonical form against JAX's, on CPU at
n=4 (one 16^4 class, no gather class): ``sym_impl`` "fold" and
"index" and ``sym_mode`` "periodic" and "none", each under the TC and
the sgd rule, with "mean" and "sum" updates.

For each setting one segment from a fresh state, and one step from the
state that segment leaves (its ``RecStep`` rows included), go through
both packages on the same draws (``JaxTrainDraws``).  The step takes
dyadic weights: "periodic" leaves a D4-symmetric table, on which the
afterstates of a symmetric board tie exactly, and only exact sums
break such ties alike in both packages (first maximum).  Integers are
bitwise, the tables within 2^-17 of their largest entry
(``_torch_port.assert_train_state``).  "auto" resolves to gather on
the CPU.
"""

import dataclasses

import jax.numpy as jnp
import pytest
from _torch_port import AfterSegment, check_step, dyadic_weights

from tpu2048_torch.agent import td as ttd
from tpu2048_torch.config import AgentConfig, TrainConfig
from tpu2048_torch.features import ntuple as tnt

TCFG = TrainConfig(num_envs=32, steps_per_call=8, ring_size=64,
                   max_record_steps=256, seed=0)
SGD = dict(optimizer="sgd", alpha=0.25)
# "sum" adds every env's update to an entry: 32 envs on the same early
# boards would grow the table by orders of magnitude a step at the
# reference's alpha, and the games then part on rounding-level ties
SGD_SUM = dict(optimizer="sgd", alpha=2.0**-10, update_mode="sum")
VARIANTS = {name: dataclasses.replace(AgentConfig(n=4), **kw) for name, kw in {
    "tc_fold": dict(sym_impl="fold"),
    "sgd_fold": dict(sym_impl="fold", **SGD),
    "sgd_fold_sum": dict(sym_impl="fold", **SGD_SUM),
    "tc_index": dict(sym_impl="index"),
    # TC off the canonical form takes the hit mean whatever update_mode
    # says, as the reference does
    "tc_index_sum": dict(sym_impl="index", update_mode="sum"),
    "sgd_index": dict(sym_impl="index", **SGD),
    "sgd_index_sum": dict(sym_impl="index", **SGD_SUM),
    "tc_periodic": dict(sym_mode="periodic"),
    "sgd_periodic_sum": dict(sym_mode="periodic", **SGD_SUM),
    "tc_none": dict(sym_mode="none"),
    "sgd_none": dict(sym_mode="none", **SGD),
}.items()}


@pytest.fixture(scope="module")
def after_segment():
    return AfterSegment(VARIANTS, TCFG, seed0=3)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_segment_matches_jax(name, after_segment):
    js = after_segment(name)
    assert int(js.env.odometer.max()) == TCFG.steps_per_call
    if name.startswith("tc"):
        assert float(abs(js.opt_a).max()) > 0  # the TC sums moved


@pytest.mark.parametrize("name", list(VARIANTS))
def test_step_matches_jax(name, after_segment):
    js = after_segment(name)
    js = js._replace(weights=jnp.asarray(dyadic_weights(js.weights.size)))
    assert bool(js.prev_valid.any())
    st, _ = check_step(after_segment.jaxfns, VARIANTS[name], TCFG, js)
    assert st.prev_idx.shape[1] == (8 if "index" in name else 1)


@pytest.mark.parametrize("field", ["optimizer", "sym_impl", "engine_mode"])
def test_unknown_setting_raises(field):
    acfg = dataclasses.replace(AgentConfig(n=4), **{field: "bogus"})
    with pytest.raises(ValueError, match=f"AgentConfig.{field}='bogus'"):
        ttd.make_train_step(tnt.get_tuple_set(4), acfg, TCFG, None)
