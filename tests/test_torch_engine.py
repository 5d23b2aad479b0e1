"""The port's packed row-code engine against the JAX reference, bitwise.

Inputs are numpy boards made from a seed; random draws are JAX's own
(``_torch_port.JaxDraws``), fed to both engines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import JaxDraws, JaxTrainDraws, rand_boards

from tpu2048.engine import core as jcore
from tpu2048.engine import fast as jfast
from tpu2048.engine import lut as jlut
from tpu2048_torch.draws import TorchDraws
from tpu2048_torch.engine import core as tcore
from tpu2048_torch.engine import fast as tfast
from tpu2048_torch.engine import lut as tlut


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _codes(seed, n=64):
    boards = rand_boards(n, seed)
    return boards, np.array(jfast.codes_from_boards(jnp.asarray(boards)))


def test_row_tables_copy_equal():
    a, b = jlut.build_row_tables(), tlut.build_row_tables()
    for name in a._fields:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_code_tables_copy_equal():
    a, b = jfast.build_code_tables(), tfast.build_code_tables()
    for name in a._fields:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("direction", [0, 1, 2, 3])
def test_np_move_equal(direction):
    for board in rand_boards(32, seed=direction):
        want = jcore.np_move(board, direction)
        got = tcore.np_move(board, direction)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]


def test_conversions_equal():
    boards, codes = _codes(0)
    _eq(tfast.codes_from_boards(torch.from_numpy(boards)), codes)
    tc = torch.from_numpy(codes)
    _eq(tfast.boards_from_codes(tc),
        jfast.boards_from_codes(jnp.asarray(codes)))
    _eq(tfast.cells_from_codes(tc),
        jfast.cells_from_codes(jnp.asarray(codes)))
    _eq(tfast.max_tile_codes(tc), jfast.max_tile_codes(jnp.asarray(codes)))


def test_transpose_codes_equal():
    _, codes = _codes(1)
    _eq(tfast.transpose_codes(torch.from_numpy(codes)),
        jfast.transpose_codes(jnp.asarray(codes)))


@pytest.mark.parametrize("seed", [2, 3])
def test_afterstates_full_equal(seed):
    _, codes = _codes(seed, 128)
    got = tfast.afterstates_full(torch.from_numpy(codes))
    want = jfast.afterstates_full(jnp.asarray(codes))
    for g, w in zip(got, want):
        _eq(g, w)


def test_canonicalize_chosen_equal():
    _, codes = _codes(4)
    best = np.random.default_rng(4).integers(0, 4, len(codes)).astype(np.int32)
    _eq(tfast.canonicalize_chosen(torch.from_numpy(codes),
                                  torch.from_numpy(best)),
        jfast.canonicalize_chosen(jnp.asarray(codes), jnp.asarray(best)))


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_spawn_codes_equal_with_jax_draws(seed):
    _, codes = _codes(seed, 256)
    key = jax.random.PRNGKey(seed)
    draws = JaxDraws()
    draws.k_spawn = key
    got = tfast.spawn_codes(torch.from_numpy(codes), draws)
    want = jfast.spawn_codes(jnp.asarray(codes), key)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("seed", [8, 9])
def test_new_codes_equal_with_jax_draws(seed):
    key = jax.random.PRNGKey(seed)
    draws = JaxDraws()
    draws.k_init = key
    _eq(tfast.new_codes(1000, draws), jfast.new_codes(1000, key))


@pytest.mark.parametrize("seed", [10, 11])
def test_init_and_reset_where_codes_equal_with_jax_draws(seed):
    """The train step's env init (``split(ke, 4)``) and auto-reset
    (fresh boards drawn for the whole batch from ``k_reset``)."""
    key = jax.random.PRNGKey(seed)
    draws = JaxTrainDraws(key)
    env = tfast.init_env_codes(256, draws)
    jenv = jfast.init_env_codes(256, draws.ke)
    for g, w in zip(env, jenv):
        _eq(g, w)
    _, codes = _codes(seed, 256)
    rng = np.random.default_rng(seed)
    score = rng.integers(0, 5000, 256).astype(np.int32)
    odo = rng.integers(0, 900, 256).astype(np.int32)
    done = rng.random(256) < 0.3
    draws.split()
    got = tfast.reset_where_codes(
        tfast.EnvStateC(*map(torch.from_numpy, (codes, score, odo))),
        torch.from_numpy(done), draws)
    want = jfast.reset_where_codes(
        jfast.EnvStateC(*map(jnp.asarray, (codes, score, odo))),
        jnp.asarray(done), draws.k_reset)
    for g, w in zip(got, want):
        _eq(g, w)
    assert (got.score.numpy()[done] == 0).all()
    np.testing.assert_array_equal(got.codes.numpy()[~done], codes[~done])


def test_torch_draws_ranges():
    gen = torch.Generator()
    gen.manual_seed(0)
    d = TorchDraws(gen)
    p1, u1, p2r, u2 = d.new(4096)
    assert p1.dtype == p2r.dtype == torch.int32
    assert u1.dtype == u2.dtype == torch.float32
    assert 0 <= int(p1.min()) and int(p1.max()) == 15
    assert 0 <= int(p2r.min()) and int(p2r.max()) == 14
    u, v = d.spawn(4096)
    assert u.shape == v.shape == (4096,)
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    # two tiles on distinct cells, values 2 or 4
    cells = tfast.cells_from_codes(tfast.new_codes(4096, d))
    assert ((cells > 0).sum(dim=1) == 2).all()
    assert set(cells.unique().tolist()) == {0, 1, 2}
