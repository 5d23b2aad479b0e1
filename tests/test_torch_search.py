"""The port's expectimax (``tpu2048_torch/search/expectimax.py``)
against the JAX reference, with JAX's own draws replayed through
``_torch_port.JaxSearchKey``: the tree in both engines, the chunked
and odd-padded estimator, and the root-compacted tiers.

Values are held bitwise at width 2, where a node's average is one f32
addition and the weights are dyadic (``dyadic_weights``, exact in any
summation order); at width 3 and 4 within 2^-20 relative, the room of
another summation order over 3-4 children.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import JaxSearchKey, dyadic_weights

from tpu2048.engine import fast as jfast
from tpu2048.features import ntuple as jnt
from tpu2048.ops import dispatch as jdisp
from tpu2048.search import expectimax as jex
from tpu2048_torch.engine import fast as tfast
from tpu2048_torch.ops import dispatch as tdisp
from tpu2048_torch.search import expectimax as tex

SINCE_EMPTY = 6


def _value_fns(n: int, seed: int = 1):
    """The same gather evaluator of dyadic weights in both packages, as
    (B, 4, 4) -> (B,) value functions."""
    ts = jnt.get_tuple_set(n)
    w = dyadic_weights(ts.total, seed)
    jev, tev = jdisp.make_evaluator(ts, "gather"), tdisp.make_evaluator(
        ts, "gather")
    jw, tw = jnp.asarray(w), torch.from_numpy(w)

    def jv(b):
        return jev(jw, b.reshape(b.shape[:-2] + (16,)))

    def tv(b):
        return tev(tw, b.reshape(b.shape[:-2] + (16,)))

    return jv, tv


def _crowded(b: int, seed: int) -> np.ndarray:
    """(b, 4, 4) int8 boards, ~20% empty (most below ``SINCE_EMPTY``
    empties, so they search), exponents below 14 but for a 14 in the
    corner of every third board: a masked spawn slot on it carries out
    of the row in the codes engine.  Board 1 is full, board 2 has 8
    empties (comfortable)."""
    rng = np.random.default_rng(seed)
    boards = rng.integers(1, 14, (b, 4, 4)).astype(np.int8)
    boards[:, 0, 0] = np.where(np.arange(b) % 3 == 0, 14, boards[:, 0, 0])
    boards[rng.random((b, 4, 4)) < 0.2] = 0
    boards[1] = rng.integers(1, 14, (4, 4))
    boards[2].reshape(16)[::2] = 0
    return boards


def _check(got: torch.Tensor, want, width: int) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if width == 2:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0**-20, atol=0)


@pytest.mark.parametrize("engine", ["cells", "codes"])
@pytest.mark.parametrize("depth,width", [(1, 2), (2, 2), (3, 2), (2, 3),
                                         (3, 4)])
def test_expectimax_value_matches_jax(engine, depth, width):
    jv, tv = _value_fns(2)
    boards = _crowded(24, seed=depth * 10 + width)
    key = jax.random.PRNGKey(depth + 7 * width)
    if engine == "cells":
        jfn, tfn = jex.expectimax_value, tex.expectimax_value
        jin, tin = jnp.asarray(boards), torch.from_numpy(boards)
    else:
        jfn, tfn = jex.expectimax_value_codes, tex.expectimax_value_codes
        jin = jfast.codes_from_boards(jnp.asarray(boards))
        tin = tfast.codes_from_boards(torch.from_numpy(boards))
    want = jax.jit(jfn, static_argnums=(0, 3, 4, 5))(
        jv, jin, key, depth, width, SINCE_EMPTY)
    got = tfn(tv, tin, JaxSearchKey(key), depth, width, SINCE_EMPTY)
    _check(got, want, width)
    vals = got.numpy()
    assert vals[1] == 0.0  # a full root: no spawn, no valid child
    assert vals[2] == float(np.asarray(jv(jnp.asarray(boards[2:3])))[0])


@pytest.mark.parametrize("depth,width,max_leaves,b,input_rep", [
    (2, 3, 100, 32, "cells"),  # one root per chunk
    (2, 2, 200, 13, "codes"),  # 3 roots per chunk, 2 pad boards
])
def test_chunked_estimator_matches_jax(depth, width, max_leaves, b,
                                       input_rep):
    jv, tv = _value_fns(2)
    boards = _crowded(b, seed=b)
    jin, tin = jnp.asarray(boards), torch.from_numpy(boards)
    if input_rep == "codes":
        jin, tin = jfast.codes_from_boards(jin), tfast.codes_from_boards(tin)
    key = jax.random.PRNGKey(3)
    want = jex.make_expectimax_estimator(
        jv, depth, width, SINCE_EMPTY, max_leaves=max_leaves,
        input_rep=input_rep)(jin, key)
    est = tex.make_expectimax_estimator(
        tv, depth, width, SINCE_EMPTY, max_leaves=max_leaves,
        input_rep=input_rep)
    got = est(tin, JaxSearchKey(key))
    _check(got, want, width)
    per_chunk = max(1, max_leaves // (4 * width) ** depth)
    assert est.chunks == -(-b // per_chunk)


def test_estimator_rejects_code_roots_for_the_cells_engine():
    _jv, tv = _value_fns(2)
    with pytest.raises(ValueError, match="cells engine"):
        tex.make_expectimax_estimator(tv, 1, 2, 6, engine_mode="cells",
                                      input_rep="codes")
    with pytest.raises(ValueError, match="engine_mode"):
        tex.make_expectimax_estimator(tv, 1, 2, 6, engine_mode="rows")


@pytest.mark.parametrize("batch", [1, 64, 65, 300, 4096, 32768])
def test_default_tiers_equal(batch):
    assert tex.default_tiers(batch) == jex.default_tiers(batch)


@pytest.mark.parametrize("case", ["comfortable", "sub_tier", "overflow"])
def test_compacted_estimator_matches_jax(case):
    """The tiers of ``tests/test_search.py:238-324``, against JAX run
    eagerly: nothing needy (base values, no tree), 6 of 24 needy (the
    8-root tier, compacted needy-first), 11 of 12 needy (past every
    tier: the full batch)."""
    jv, tv = _value_fns(2)
    b, tiers = (12, (4,)) if case == "overflow" else (24, (8, 16))
    boards = _crowded(b, seed=b + len(case))
    if case == "comfortable":
        need = np.zeros(b, bool)
    elif case == "sub_tier":
        need = np.arange(b) % 4 == 1
    else:
        need = np.ones(b, bool)
        need[0] = False
    key = jax.random.PRNGKey(5)
    want = jex.make_compacted_estimator(
        jv, 1, 2, SINCE_EMPTY, batch=b, tiers=tiers)(
            jnp.asarray(boards), key, jnp.asarray(need))
    est = tex.make_compacted_estimator(tv, 1, 2, SINCE_EMPTY, batch=b,
                                       tiers=tiers)
    got = est(torch.from_numpy(boards), JaxSearchKey(key),
              torch.from_numpy(need))
    _check(got, want, 2)
    tier = {"comfortable": 0, "sub_tier": 8, "overflow": 12}[case]
    assert est.tier_counts == {**dict.fromkeys([0] + sorted(tiers) + [b], 0),
                               tier: 1}
    assert est.tree.chunks == (0 if case == "comfortable" else 1)
    base = tv(torch.from_numpy(boards)).numpy()
    np.testing.assert_array_equal(got.numpy()[~need], base[~need])


def test_compacted_estimator_depth_zero_is_the_base():
    _jv, tv = _value_fns(2)
    boards = torch.from_numpy(_crowded(8, seed=4))
    est = tex.make_compacted_estimator(tv, 0, 4, SINCE_EMPTY, batch=8)
    got = est(boards, None, torch.ones(8, dtype=torch.bool))
    assert torch.equal(got, tv(boards))
