"""The port's table ops: ``eval_class``'s plain version against the JAX
Pallas kernel (interpret mode), and the evaluators against JAX's.  The
CUDA kernel itself is tested on the card, in ``test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import rand_boards

from tpu2048.features import ntuple as jnt
from tpu2048.ops import dispatch as jdisp
from tpu2048.ops import onehot as joh
from tpu2048.ops import pallas_kernels as pk
from tpu2048_torch.features import ntuple as tnt
from tpu2048_torch.ops import dispatch as tdisp
from tpu2048_torch.ops import kernels
from tpu2048_torch.ops import onehot as toh

SHAPES = [(17, 256, 256), (3, 64, 64)]
PRECISIONS = ["f32", "bf16x2", "bf16"]


def _class_inputs(g, h, l, b, seed):
    rng = np.random.default_rng(seed)
    tables = rng.standard_normal((g, h, l)).astype(np.float32)
    hi = rng.integers(0, h, (b, g)).astype(np.int32)
    lo = rng.integers(0, l, (b, g)).astype(np.int32)
    return tables, hi, lo


@pytest.mark.parametrize("n", [2, 3, 4, 5, 6, 7])
def test_table_classes_copy_equal(n):
    ts = jnt.get_tuple_set(n)
    a, b = joh.build_table_classes(ts), toh.build_table_classes(ts)
    assert a.matmul == b.matmul
    np.testing.assert_array_equal(a.gather_feats, b.gather_feats)
    assert joh.CLASS_DECOMP == toh.CLASS_DECOMP


@pytest.mark.parametrize("g,h,l", SHAPES)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_eval_class_reference_matches_pallas_interpret(g, h, l, precision):
    tables, hi, lo = _class_inputs(g, h, l, 128, seed=g)
    want = np.asarray(pk.eval_class(jnp.asarray(tables), jnp.asarray(hi),
                                    jnp.asarray(lo), 64, True, precision))
    got = kernels.eval_class_reference(torch.from_numpy(tables),
                                       torch.from_numpy(hi),
                                       torch.from_numpy(lo), precision).numpy()
    tmax = float(np.abs(tables).max())
    if precision == "f32":  # tests/test_ops.py:95-97
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    elif precision == "bf16x2":  # tests/test_ops.py:98-101
        np.testing.assert_allclose(got, want, atol=g * 4e-5 * tmax)
    else:  # same bf16 terms; only f32 summation order differs
        np.testing.assert_allclose(got, want, atol=g * 2.0**-24 * tmax)


def test_eval_class_on_cpu_takes_plain_version_and_counts_nothing():
    tables, hi, lo = _class_inputs(3, 64, 64, 100, seed=1)
    t, h, l = (torch.from_numpy(a) for a in (tables, hi, lo))
    before = kernels.eval_class.launches
    got = kernels.eval_class(t, h, l)
    assert kernels.eval_class.launches == before
    torch.testing.assert_close(got, kernels.eval_class_reference(t, h, l),
                               rtol=0, atol=0)


def test_eval_class_rejects_bad_inputs():
    tables, hi, lo = (torch.from_numpy(a)
                      for a in _class_inputs(3, 64, 64, 8, seed=2))
    with pytest.raises(ValueError):
        kernels.eval_class(tables, hi, lo, precision="fp8")
    with pytest.raises(TypeError):
        kernels.eval_class(tables.double(), hi, lo)
    with pytest.raises(TypeError):
        kernels.eval_class(tables, hi.long(), lo)
    with pytest.raises(TypeError):
        kernels.eval_class(tables, hi[:, :2], lo[:, :2])
    with pytest.raises(ValueError):
        kernels.eval_class(tables, hi, lo[:4])


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No compiler means no kernel, loudly: there is no fallback."""
    from pathlib import Path

    from tpu2048_torch.ops import build

    if Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is installed here")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_library()
    assert not (tmp_path / "_build").exists()


def test_resolve_mode():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tdisp.resolve_mode("auto", cpu) == "gather"
    assert tdisp.resolve_mode("auto", cuda) == "pallas"
    assert tdisp.resolve_mode("pallas", cpu) == "pallas"
    for mode in ("search", "onehot"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tdisp.make_evaluator(jnt.get_tuple_set(2), mode)
    with pytest.raises(ValueError):
        tdisp.make_evaluator(jnt.get_tuple_set(2), "bogus")


@pytest.mark.parametrize("mode", ["gather", "pallas", "auto"])
@pytest.mark.parametrize("canonical", [False, True])
def test_make_evaluator_matches_jax_n5(mode, canonical):
    ts = jnt.get_tuple_set(5)
    w = np.random.default_rng(5).standard_normal(ts.total).astype(np.float32)
    boards = rand_boards(2 * 48, seed=5).reshape(2, 48, 16)
    want = np.asarray(jdisp.make_evaluator(ts, "gather", canonical)(
        jnp.asarray(w), jnp.asarray(boards)))
    got = tdisp.make_evaluator(tnt.get_tuple_set(5), mode, canonical)(
        torch.from_numpy(w), torch.from_numpy(boards))
    assert got.shape == (2, 48) and got.dtype == torch.float32
    # f32 sums of 21 terms in another order: within 2^-20 of the sum of
    # the terms' magnitudes (the same evaluator over |w|)
    scale = np.asarray(jdisp.make_evaluator(ts, "gather", canonical)(
        jnp.abs(jnp.asarray(w)), jnp.asarray(boards)))
    np.testing.assert_array_less(np.abs(got.numpy() - want),
                                 2.0**-20 * scale)
