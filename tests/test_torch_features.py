"""The port's features against the JAX reference, bitwise: copied
geometry, feature and canonical indices, the D4 table fold (whole
table and one class), and the canonical-form dense export."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import rand_boards

from tpu2048.features import canonical as jcanon
from tpu2048.features import ntuple as jnt
from tpu2048.features import symmetry as jsym
from tpu2048_torch.features import canonical as tcanon
from tpu2048_torch.features import ntuple as tnt
from tpu2048_torch.features import symmetry as tsym

ALL_N = [2, 3, 4, 5, 6, 7]


def _boards(n_boards, seed, high=16):
    b = rand_boards(n_boards, seed, high).reshape(n_boards, 16)
    b[0] = high - 1  # all cells at the top exponent: the largest indices
    return b


@pytest.mark.parametrize("n", ALL_N)
def test_tuple_set_copy_equal(n):
    a, b = jnt.get_tuple_set(n), tnt.get_tuple_set(n)
    assert a.n == b.n and a.num_feat == b.num_feat and a.total == b.total
    for name in ("matrix", "offsets", "sizes", "sym_perms"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert jnt._cell_tuples(n) == tnt._cell_tuples(n)


@pytest.mark.parametrize("n", ALL_N)
def test_sym_transforms_copy_equal(n):
    assert jsym.build_sym_transforms(n) == tsym.build_sym_transforms(n)
    ts = jnt.get_tuple_set(n)
    assert jsym._table_geometry(ts) == tsym._table_geometry(ts)


@pytest.mark.parametrize("n", ALL_N)
def test_feature_indices_equal(n):
    # n=7's base-16 six-tuples reach 16^6 - 1 = 2^24 - 1 on board 0
    boards = _boards(256, seed=n)
    want = np.asarray(jnt.feature_indices(jnt.get_tuple_set(n),
                                          jnp.asarray(boards)))
    got = tnt.feature_indices(tnt.get_tuple_set(n), torch.from_numpy(boards))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if n == 7:
        ts = tnt.get_tuple_set(7)
        local = got.numpy()[0] - ts.offsets
        assert local.max() == 2**24 - 1


@pytest.mark.parametrize("n", [5, 6])
def test_canonical_gather_indices_equal(n):
    boards = _boards(128, seed=10 + n, high=14)
    jts, tts = jnt.get_tuple_set(n), tnt.get_tuple_set(n)
    want = jcanon.canonical_gather_indices(jts, jnp.asarray(boards))
    got = tcanon.canonical_gather_indices(tts, torch.from_numpy(boards))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_symmetrize_sum_bitwise(n):
    ts = jnt.get_tuple_set(n)
    x = np.random.default_rng(n).standard_normal(ts.total).astype(np.float32)
    want = np.asarray(jsym.symmetrize_sum(ts, jnp.asarray(x)))
    got = tsym.symmetrize_sum(tnt.get_tuple_set(n), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def _class_pair(n: int, seed: int):
    """A random (2, g, size) pair over tuple set n's first 16^k class
    (the 16^4 class at n >= 4, the 16^3 class at n = 3)."""
    ts = jnt.get_tuple_set(n)
    feat0, g, size = jsym._table_geometry(ts)[4][0]
    rng = np.random.default_rng(seed)
    return ts, feat0, g, rng.standard_normal((2, g, size)).astype(np.float32)


@pytest.mark.parametrize("n", [3, 4, 5])
def test_symmetrize_class_sum_bitwise(n):
    ts, feat0, g, pair = _class_pair(n, seed=20 + n)
    want = np.asarray(jsym.symmetrize_class_sum(ts, feat0, g,
                                                jnp.asarray(pair)))
    got = tsym.symmetrize_class_sum(tnt.get_tuple_set(n), feat0, g,
                                    torch.from_numpy(pair))
    np.testing.assert_array_equal(got.numpy(), want)


def test_symmetrize_class_sum_bitwise_to_fused_fold_n4():
    """The fold's plain version against the TPU fold kernel itself
    (Pallas interpret mode)."""
    from tpu2048.ops import fold_kernel as jfold
    from tpu2048.ops.onehot import build_table_classes

    ts, feat0, g, pair = _class_pair(4, seed=30)
    (c,) = build_table_classes(ts).matmul
    want = np.asarray(jfold.fold_class_pair(ts, c, jnp.asarray(pair),
                                            interpret=True))
    got = tsym.symmetrize_class_sum(tnt.get_tuple_set(4), feat0, g,
                                    torch.from_numpy(pair))
    np.testing.assert_array_equal(got.numpy(), want)


def test_canonical_tables_copy_equal_n5():
    ts = jnt.get_tuple_set(5)
    np.testing.assert_array_equal(tcanon.canonical_mask(ts),
                                  jcanon.canonical_mask(ts))
    np.testing.assert_array_equal(tcanon.feature_perm_table(5),
                                  jcanon.feature_perm_table(5))
    np.testing.assert_array_equal(tcanon._gather_feat_ids(5),
                                  jcanon._gather_feat_ids(5))
    np.testing.assert_array_equal(tcanon._gather_region(5),
                                  jcanon._gather_region(5))


def test_to_dense_table_bitwise_n5():
    ts = jnt.get_tuple_set(5)
    w = np.random.default_rng(3).standard_normal(ts.total).astype(np.float32)
    want = np.asarray(jcanon.to_dense_table(ts, jnp.asarray(w)))
    got = tcanon.to_dense_table(tnt.get_tuple_set(5), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)


def test_from_dense_table_bitwise_n5():
    ts = jnt.get_tuple_set(5)
    w = np.random.default_rng(8).standard_normal(ts.total).astype(np.float32)
    want = np.asarray(jcanon.from_dense_table(ts, jnp.asarray(w)))
    got = tcanon.from_dense_table(tnt.get_tuple_set(5), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)
    # the inverse of to_dense_table on an orbit-constant table
    back = tcanon.from_dense_table(
        tnt.get_tuple_set(5), tcanon.to_dense_table(tnt.get_tuple_set(5), got))
    np.testing.assert_allclose(back.numpy(), want, rtol=2.0**-20, atol=0)


def test_init_weights_range():
    ts = tnt.get_tuple_set(3)
    gen = torch.Generator()
    gen.manual_seed(0)
    w = tnt.init_weights(ts, gen)
    assert w.shape == (ts.total,) and w.dtype == torch.float32
    assert 0.0 <= float(w.min()) and float(w.max()) < 0.01
