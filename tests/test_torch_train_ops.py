"""The feature functions and table ops of the port's learners off the
canonical form against JAX's, on CPU: the 8 D4 images' indices, the
evaluator and the cells engine's greedy selection, the symmetric
projection, and the table-level accumulator and updater
(``make_delta_accumulator``, ``make_updater``) in both of the port's
modes at n=5, whose 16^5 class takes the gather path.

Dyadic values (k * 2^-12) make every sum exact in any order, so there
the comparisons are bitwise; elsewhere they hold within 2^-17 of the
table's largest entry.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import assert_close, dyadic_weights, rand_boards

from tpu2048.agent import td as jtd
from tpu2048.features import ntuple as jnt
from tpu2048.features import symmetry as jsym
from tpu2048.ops import dispatch as jdisp
from tpu2048_torch.agent import td as ttd
from tpu2048_torch.features import ntuple as tnt
from tpu2048_torch.features import symmetry as tsym
from tpu2048_torch.ops import dispatch as tdisp
from tpu2048_torch.ops import kernels


@pytest.mark.parametrize("n", [2, 3, 4, 5, 6, 7])
def test_all_symmetry_indices_equal(n):
    boards = rand_boards(96, seed=n, high=16).reshape(96, 16)
    want = np.asarray(jnt.all_symmetry_indices(jnt.get_tuple_set(n),
                                               jnp.asarray(boards)))
    got = tnt.all_symmetry_indices(tnt.get_tuple_set(n),
                                   torch.from_numpy(boards))
    assert got.dtype == torch.int32 and got.shape == (96, 8, want.shape[-1])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [4, 5])
def test_evaluate_and_select_greedy_equal(n):
    """The plain evaluator, ``evaluate_boards`` and the cells engine's
    ``select_greedy``, bitwise with dyadic weights."""
    ts = jnt.get_tuple_set(n)
    w = dyadic_weights(ts.total, seed=n)
    boards = rand_boards(64, seed=n)
    tts, tw, tb = tnt.get_tuple_set(n), torch.from_numpy(w), torch.from_numpy(
        boards)
    np.testing.assert_array_equal(
        tnt.evaluate(tts, tw, tb.reshape(64, 16)).numpy(),
        np.asarray(jnt.evaluate(ts, jnp.asarray(w),
                                jnp.asarray(boards.reshape(64, 16)))))
    np.testing.assert_array_equal(
        ttd.evaluate_boards(tts, tw, tb).numpy(),
        np.asarray(jtd.evaluate_boards(ts, jnp.asarray(w), jnp.asarray(boards))))
    got = ttd.select_greedy(tts, tw, tb)
    want = jtd.select_greedy(ts, jnp.asarray(w), jnp.asarray(boards))
    for name, g, x in zip(("chosen", "dir", "val", "delta", "done"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x), err_msg=name)
    assert bool(got[4].any()) and not bool(got[4].all())  # a full board ends


@pytest.mark.parametrize("n", [3, 5])
def test_symmetrize_table_and_fold_other_symmetries_equal(n):
    ts = jnt.get_tuple_set(n)
    w = np.random.default_rng(n).standard_normal(ts.total).astype(np.float32)
    tts, tw = tnt.get_tuple_set(n), torch.from_numpy(w)
    np.testing.assert_array_equal(
        tsym.symmetrize_table(tts, tw).numpy(),
        np.asarray(jsym.symmetrize_table(ts, jnp.asarray(w))))
    np.testing.assert_array_equal(
        tsym.fold_other_symmetries(tts, tw).numpy(),
        np.asarray(jsym.fold_other_symmetries(ts, jnp.asarray(w))))


def _index_rows(n, seed, dyadic=True):
    """The "index" learner's rows: (8B, F) indices of 32 boards' 8
    images, their dw (the same on a board's 8 images) and valid."""
    rng = np.random.default_rng(seed)
    boards = rand_boards(32, seed=seed).reshape(32, 16)
    idx = np.asarray(jnt.all_symmetry_indices(
        jnt.get_tuple_set(n), jnp.asarray(boards))).reshape(256, -1)
    dw = (rng.integers(-40, 41, 32) * 2.0**-12 if dyadic
          else rng.standard_normal(32) * 0.01).astype(np.float32)
    valid = rng.random(32) < 0.8
    return idx, np.repeat(dw, 8), np.repeat(valid, 8)


def _pow2_hit_rows(n, seed):
    """Rows whose entries are hit 0, 1, 2 or 4 times by valid rows: 12
    base rows with distinct entries in every feature, repeated 1, 2 or
    4 times, and 4 invalid ones; dyadic dw.  Each hit mean of dyadic
    terms is then exact, whichever sum it divides."""
    ts = tnt.get_tuple_set(n)
    rng = np.random.default_rng(seed)
    base = np.stack([rng.choice(int(z), 16, replace=False) + int(o)
                     for z, o in zip(ts.sizes, ts.offsets)], axis=1)
    copies = [1, 2, 4] * 4 + [1] * 4
    idx = np.repeat(base, copies, axis=0).astype(np.int32)
    valid = np.repeat(np.arange(16) < 12, copies)
    dw = (rng.integers(-40, 41, len(idx)) * 2.0**-12).astype(np.float32)
    perm = rng.permutation(len(idx))
    return idx[perm], dw[perm], valid[perm]


def _port(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("n", [4, 5])
def test_delta_accumulator_matches_jax(n):
    """Dyadic dw on the index learner's rows: both modes' pair bitwise
    JAX's (dsum, hits); with random dw, "pallas" on CPU still equals
    "gather" bit for bit (each entry's terms in row order in both)."""
    ts = jnt.get_tuple_set(n)
    w = np.zeros(ts.total, np.float32)
    idx, dw, valid = _index_rows(n, seed=n)
    want = jdisp.make_delta_accumulator(ts, "gather")(
        *map(jnp.asarray, (w, idx, dw, valid)))
    for mode in ("gather", "pallas"):
        pair = tdisp.make_delta_accumulator(tnt.get_tuple_set(n), mode)(
            *_port(w, idx, dw, valid))
        assert pair.shape == (2, ts.total)
        for got, x, name in zip(pair, want, ("dsum", "hits")):
            np.testing.assert_array_equal(got.numpy(), np.asarray(x),
                                          err_msg=f"{mode} {name}")
    args = _port(w, *_index_rows(n, seed=n + 1, dyadic=False))
    launches = kernels.grad_class.launches
    a = tdisp.make_delta_accumulator(tnt.get_tuple_set(n), "pallas")(*args)
    b = tdisp.make_delta_accumulator(tnt.get_tuple_set(n), "gather")(*args)
    assert torch.equal(a, b)
    assert kernels.grad_class.launches == launches  # plain on CPU tensors


@pytest.mark.parametrize("mean", [True, False], ids=["mean", "sum"])
def test_updater_matches_jax_n5(mean):
    """The index learner's rows with random dw: both modes within 2^-17
    of JAX's updated table; on rows whose hit counts are powers of two,
    with dyadic weights and dw, both modes and JAX bitwise equal."""
    ts, tts = jnt.get_tuple_set(5), tnt.get_tuple_set(5)
    w = dyadic_weights(ts.total, seed=3)
    jupd = jdisp.make_updater(ts, "gather", mean=mean)
    for rows, exact in ((_index_rows(5, seed=9, dyadic=False), False),
                        (_pow2_hit_rows(5, seed=9), True)):
        want = np.asarray(jupd(*map(jnp.asarray, (w,) + rows)))
        for mode in ("gather", "pallas"):
            tw = torch.from_numpy(w.copy())
            out = tdisp.make_updater(tts, mode, mean=mean)(tw, *_port(*rows))
            assert out is tw  # in place
            if exact:
                np.testing.assert_array_equal(tw.numpy(), want, err_msg=mode)
            else:
                assert_close(tw, want, mode)
        assert not np.array_equal(want, w)
