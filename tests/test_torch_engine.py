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


# -- the cells engine (engine/core.py) --------------------------------------


def _cells_pair(seed, n=128):
    boards = rand_boards(n, seed, high=14)
    return boards, torch.from_numpy(boards), jnp.asarray(boards)


def test_pack_rows_and_max_tile_equal():
    _, tb, jb = _cells_pair(20)
    _eq(tcore.pack_rows(tb), jcore.pack_rows(jb))
    _eq(tcore.max_tile(tb), jcore.max_tile(jb))


@pytest.mark.parametrize("direction", [0, 1, 2, 3])
def test_move_equal(direction):
    _, tb, jb = _cells_pair(21 + direction)
    for g, w in zip(tcore.move(tb, direction), jcore.move(jb, direction)):
        _eq(g, w)


def test_afterstates_and_is_terminal_equal():
    boards, tb, jb = _cells_pair(25)
    # dead boards: a checkerboard of 1/2 and a full board of distinct tiles
    boards[2] = np.indices((4, 4)).sum(axis=0) % 2 + 1
    boards[3] = np.arange(1, 17).reshape(4, 4) % 15 + 1
    tb, jb = torch.from_numpy(boards), jnp.asarray(boards)
    for g, w in zip(tcore.afterstates(tb), jcore.afterstates(jb)):
        _eq(g, w)
    term = tcore.is_terminal(tb)
    _eq(term, jcore.is_terminal(jb))
    assert bool(term[2]) and bool(term[3]) and not bool(term[1])
    # "no legal move" is the same test, but for the empty board 1
    nolegal = ~tcore.afterstates(tb)[2].any(dim=0)
    assert bool(nolegal[1]) and not bool(term[1])
    _eq(term[2:], nolegal[2:].numpy())


@pytest.mark.parametrize("seed", [26, 27])
def test_spawn_equal_with_jax_draws(seed):
    _, tb, jb = _cells_pair(seed, 256)
    key = jax.random.PRNGKey(seed)
    draws = JaxDraws()
    draws.k_spawn = key
    for g, w in zip(tcore.spawn(tb, draws), jcore.spawn(jb, key)):
        _eq(g, w)


def test_new_boards_init_and_reset_where_equal_with_jax_draws():
    key = jax.random.PRNGKey(28)
    draws = JaxDraws()
    draws.k_init = key
    _eq(tcore.new_boards(1000, draws), jcore.new_boards(1000, key))
    env = tcore.init_env(64, draws)
    for g, w in zip(env, jcore.init_env(64, key)):
        _eq(g, w)
    # the reset draws its fresh boards for the whole batch (the train
    # step's ``k_reset`` site, as in ``reset_where_codes``)
    tdraws = JaxTrainDraws(key)
    tdraws.split()
    rng = np.random.default_rng(28)
    done = rng.random(64) < 0.4
    state = tcore.EnvState(env.boards, env.score + 7, env.odometer + 3)
    got = tcore.reset_where(state, torch.from_numpy(done), tdraws)
    want = jcore.reset_where(
        jcore.EnvState(*(jnp.asarray(t.numpy()) for t in state)),
        jnp.asarray(done), tdraws.k_reset)
    for g, w in zip(got, want):
        _eq(g, w)
    assert (got.score.numpy()[done] == 0).all()


def test_afterstates_nc_equal_and_agrees_with_full():
    _, codes = _codes(29, 128)
    # search children whose masked spawn carried out of the row's 16
    # bits: JAX clamps the gather index
    codes[:4, 0] += 0x10000 * np.arange(1, 5, dtype=np.int32)
    got = tfast.afterstates_nc(torch.from_numpy(codes))
    want = jfast.afterstates_nc(jnp.asarray(codes))
    for g, w in zip(got, want):
        _eq(g, w)
    aft, _delta, legal, tcodes = tfast.afterstates_full(
        torch.from_numpy(codes[4:]))
    _eq(got[0][:, 4:], aft.numpy())
    _eq(got[1][:, 4:], legal.numpy())
    _eq(got[2][4:], tcodes.numpy())
