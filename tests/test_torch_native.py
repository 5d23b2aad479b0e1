"""The port's native C++ host engine (``tpu2048_torch/native``) against
the port's own engine and features, the twins of ``tests/test_native.py``,
and the port's parity engine (``tpu2048_torch/engine/parity.py``)
playing the same seeded games as the JAX package's.  (The copies' code
is held equal to the originals in ``tests/test_torch_shared.py``.)"""

import os
import random

import numpy as np
import pytest
import torch

from tpu2048.apps.cli import np_estimator as jax_np_estimator
from tpu2048.engine import parity as jparity
from tpu2048.features import ntuple as jnt
from tpu2048_torch.agent import td
from tpu2048_torch.apps.cli import np_estimator
from tpu2048_torch.engine import core as engine
from tpu2048_torch.engine import parity as tparity
from tpu2048_torch.features import ntuple


@pytest.fixture(scope="module")
def native(tmp_path_factory):
    """The port's native engine, built into this module's own directory
    (xdist workers that build it beside its source at once could load
    each other's half-written library); skips without g++, as the
    JAX package's tests do."""
    old = os.environ.get("TPU2048_NATIVE_DIR")
    os.environ["TPU2048_NATIVE_DIR"] = str(tmp_path_factory.mktemp("native"))
    from tpu2048_torch import native as mod

    try:
        if not mod.available():
            pytest.skip("no native toolchain")
        yield mod
    finally:
        if old is None:
            del os.environ["TPU2048_NATIVE_DIR"]
        else:
            os.environ["TPU2048_NATIVE_DIR"] = old


def _rand_boards(n, seed=0, hi=12):
    rng = np.random.default_rng(seed)
    boards = rng.integers(0, hi, (n, 4, 4)).astype(np.int8)
    boards[rng.random((n, 4, 4)) < 0.3] = 0
    return boards


def test_apply_move_matches_np_move(native):
    ne = native.NativeEngine()
    for board in _rand_boards(200):
        for d in range(4):
            nb, delta, changed = ne.apply_move(board, d)
            rb, rdelta, rchanged = engine.np_move(board, d)
            assert changed == rchanged
            np.testing.assert_array_equal(nb, rb)
            if changed:
                assert delta == rdelta


def test_game_over_matches(native):
    ne = native.NativeEngine()
    boards = _rand_boards(300, seed=1)
    _, _, legal = engine.afterstates(torch.from_numpy(boards))
    expected = (~legal).all(dim=0).numpy()
    for board, want in zip(boards, expected):
        assert ne.game_over(board) == bool(want)


@pytest.mark.parametrize("n", [2, 3, 4, 5, 6])
def test_eval_matches_gather(native, n):
    ts = ntuple.get_tuple_set(n)
    w = np.random.default_rng(n).uniform(-1, 1, ts.total).astype(np.float32)
    ne = native.NativeEngine(ts, w)
    boards = _rand_boards(50, seed=n, hi=15 if n == 6 else 12)
    ref = ntuple.evaluate(ts, torch.from_numpy(w),
                          torch.from_numpy(boards.reshape(50, 16))).numpy()
    got = np.array([ne.evaluate(b) for b in boards])
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=1e-4)


def test_best_move_matches_select_greedy(native):
    """The twin of ``tests/test_native.py``'s: the native greedy move is
    the port's ``td.select_greedy`` on the same boards (direction,
    afterstate and score delta)."""
    ts = ntuple.get_tuple_set(4)
    w = np.random.default_rng(3).uniform(0, 1, ts.total).astype(np.float32)
    ne = native.NativeEngine(ts, w)
    boards = _rand_boards(100, seed=3)
    chosen, best_dir, _, best_delta, done = td.select_greedy(
        ts, torch.from_numpy(w), torch.from_numpy(boards))
    for i, b in enumerate(boards):
        d, aft, delta = ne.best_move(b)
        if bool(done[i]):
            assert d == -1
        else:
            assert d == int(best_dir[i])
            np.testing.assert_array_equal(aft, chosen[i].numpy())
            assert delta == int(best_delta[i])


def test_expectimax_prunes_to_eval(native):
    ts = ntuple.get_tuple_set(2)
    w = np.random.default_rng(0).uniform(0, 1, ts.total).astype(np.float32)
    ne = native.NativeEngine(ts, w)
    board = np.zeros((4, 4), np.int8)
    board[0, 0], board[0, 1] = 3, 2
    v = ne.expectimax(board, depth=3, width=4, since_empty=6)
    assert v == pytest.approx(ne.evaluate(board), rel=1e-6)


def test_expectimax_finite_and_spawn_valid(native):
    ts = ntuple.get_tuple_set(2)
    w = np.random.default_rng(1).uniform(0, 1, ts.total).astype(np.float32)
    ne = native.NativeEngine(ts, w, seed=7)
    board = np.array(
        [[1, 2, 3, 4], [5, 6, 7, 8], [1, 2, 3, 4], [0, 0, 2, 2]], np.int8)
    assert np.isfinite(ne.expectimax(board, depth=3, width=4, since_empty=6))
    nb, pos, val = ne.spawn(board)
    assert board.reshape(16)[pos] == 0 and val in (1, 2)
    assert nb.reshape(16)[pos] == val


def test_native_full_game_replayable(native):
    ts = ntuple.get_tuple_set(4)
    w = np.random.default_rng(2).uniform(0, 0.01, ts.total).astype(
        np.float32)
    ne = native.NativeEngine(ts, w, seed=11)
    score, moves, final = ne.play_game()
    assert moves > 10 and score > 0
    assert ne.game_over(final)


@pytest.mark.parametrize("depth,width", [(0, 1), (1, 2)])
def test_parity_game_plays_the_same_game(depth, width):
    """A seeded ``ParityGame`` under one n=3 value table plays the same
    game, move for move and tile for tile, in both packages."""
    w = np.random.default_rng(9).uniform(0, 1, jnt.get_tuple_set(3).total
                                         ).astype(np.float32)
    games = []
    for parity, est in ((jparity, jax_np_estimator(jnt.get_tuple_set(3), w)),
                        (tparity, np_estimator(ntuple.get_tuple_set(3), w))):
        game = parity.ParityGame(rng=random.Random(2048))
        game.trial_run(est, depth=depth, width=width, since_empty=6,
                       step_limit=400)
        games.append(game.to_record())
    (a, b) = games
    assert a.keys() == b.keys()
    assert a["odometer"] > 20
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)
