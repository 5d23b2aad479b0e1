"""The port's table ops: the plain versions of ``eval_class`` (the
kernel's ordered sum included) and ``grad_class`` against the JAX
Pallas kernels (interpret mode), the ``fold_class`` kernel's plans
against the plain fold, and the evaluators and class gradients against
JAX's.  The CUDA kernels
themselves are tested on the card, in ``test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import dyadic_weights, rand_boards

from tpu2048.features import ntuple as jnt
from tpu2048.features import symmetry as jsym
from tpu2048.ops import dispatch as jdisp
from tpu2048.ops import onehot as joh
from tpu2048.ops import pallas_kernels as pk
from tpu2048_torch.features import ntuple as tnt
from tpu2048_torch.features import symmetry as tsym
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


@pytest.mark.parametrize("g,h,l", SHAPES)
@pytest.mark.parametrize("precision", PRECISIONS)
def test_eval_class_ordered_matches_pallas_interpret(g, h, l, precision):
    """``eval_class_ordered``, the card kernel's exact arithmetic (and
    ``chip_smoke.py``'s bitwise reference for it), against the Pallas
    kernel in interpret mode: at the existing tolerances, and for
    "bf16" within the 2^-8 bar of ``tests/test_ops.py:146`` of the
    exact f32 sum."""
    tables, hi, lo = _class_inputs(g, h, l, 128, seed=g + 1)
    jt, jh, jl = jnp.asarray(tables), jnp.asarray(hi), jnp.asarray(lo)
    want = np.asarray(pk.eval_class(jt, jh, jl, 64, True, precision))
    got = kernels.eval_class_ordered(torch.from_numpy(tables),
                                     torch.from_numpy(hi),
                                     torch.from_numpy(lo), precision).numpy()
    tmax = float(np.abs(tables).max())
    if precision == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    elif precision == "bf16x2":
        np.testing.assert_allclose(got, want, atol=g * 4e-5 * tmax)
    else:
        np.testing.assert_allclose(got, want, atol=g * 2.0**-24 * tmax)
        exact = np.asarray(pk.eval_class(jt, jh, jl, 64, True, "f32"))
        rel = np.abs(got - exact) / (np.abs(exact) + tmax)
        assert rel.max() < g * 2.0**-8
    # the order is g = 0 .. G-1: the same sum, term by term, in float64
    # differs from it by f32 rounding only
    terms = (tables.astype(np.float64) if precision != "bf16" else
             torch.from_numpy(tables).bfloat16().double().numpy())[
        np.arange(g), hi, lo]
    acc = np.zeros(128, np.float32)
    for gi in range(g):
        acc = (acc + terms[:, gi].astype(np.float32)).astype(np.float32)
    np.testing.assert_array_equal(got, acc)


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


def test_concurrent_first_loads_build_once(monkeypatch, tmp_path):
    """Jobs in many threads that reach the kernels at once build the
    library once and bind it once: the others wait for the first."""
    import ctypes
    import sys
    import threading
    import time
    from pathlib import Path
    from unittest import mock

    from tpu2048_torch.ops import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build, "_LIBRARY", None)
    runs = []

    def slow_nvcc(cmds):
        """Stands for nvcc: writes each output after a while."""
        runs.append(cmds)
        time.sleep(0.3)
        for cmd in cmds:
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return ""

    monkeypatch.setattr(build, "_run_all", slow_nvcc)
    binds = []

    def slow_cdll(path):
        binds.append(path)
        time.sleep(0.3)
        return mock.Mock()

    monkeypatch.setattr(ctypes, "CDLL", slow_cdll)

    def from_threads(fn, n=16):
        start, got = threading.Barrier(n), [None] * n

        def job(i):
            start.wait()
            got[i] = fn()

        threads = [threading.Thread(target=job, args=(i,)) for i in range(n)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        assert got[0] is not None and got.count(got[0]) == n

    from_threads(build.build_library)
    # one build: one batch of compiles, then one link
    assert [any("-shared" in c for c in cmds) for cmds in runs] == [
        False, True]
    assert build._library_path().exists()
    from_threads(build.load_library)
    assert len(runs) == 2 and len(binds) == 1


def test_resolve_mode():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tdisp.resolve_mode("auto", cpu) == "gather"
    assert tdisp.resolve_mode("auto", cuda) == "pallas"
    assert tdisp.resolve_mode("pallas", cpu) == "pallas"
    # "search" resolves as the reference resolves it on and off the TPU
    assert tdisp.resolve_mode("search", cpu) == "gather"
    assert tdisp.resolve_mode("search", cuda) == "search"
    # ... and is "pallas" to the train-side functions
    assert tdisp.uses_kernels("search", cuda)
    assert not tdisp.uses_kernels("search", cpu)
    assert tdisp.uses_kernels("pallas", cpu)
    assert not tdisp.uses_kernels("auto", cpu)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdisp.make_evaluator(jnt.get_tuple_set(2), "onehot")
    with pytest.raises(ValueError):
        tdisp.make_evaluator(jnt.get_tuple_set(2), "bogus")


def test_search_evaluators_on_cpu_match_jax_n5():
    """Off the card "search" is "gather": the evaluator equals JAX's
    "search" evaluator (gather off the TPU), and the train evaluator
    equals its own "gather" form, bitwise with dyadic weights."""
    ts = jnt.get_tuple_set(5)
    w = dyadic_weights(ts.total, seed=7)
    boards = rand_boards(2 * 40, seed=7).reshape(2, 40, 16)
    want = np.asarray(jdisp.make_evaluator(ts, "search")(
        jnp.asarray(w), jnp.asarray(boards)))
    tw, tb = torch.from_numpy(w), torch.from_numpy(boards)
    tts = tnt.get_tuple_set(5)
    np.testing.assert_array_equal(
        tdisp.make_evaluator(tts, "search")(tw, tb).numpy(), want)
    got = tdisp.make_train_evaluator(tts, "search", canonical=True)(tw, tb)
    ref = tdisp.make_train_evaluator(tts, "gather", canonical=True)(tw, tb)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    np.testing.assert_array_equal(
        tdisp.make_mxu_eval_idx(tts, "search")(tw, got[2].reshape(80, -1))
        .numpy(), got[0].reshape(80).numpy())


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


def _grad_inputs(g, h, l, b, seed):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, h, (b, g)).astype(np.int32)
    lo = rng.integers(0, l, (b, g)).astype(np.int32)
    dw = rng.standard_normal(b).astype(np.float32)
    valid = rng.random(b) < 0.7
    return hi, lo, dw, valid


def _grad_loop(hi, lo, dw, valid, h, l):
    """The scatter written out row by row in float64."""
    b, g = hi.shape
    dsum = np.zeros((g, h, l))
    hits = np.zeros((g, h, l))
    for i in np.flatnonzero(valid):
        for gi in range(g):
            dsum[gi, hi[i, gi], lo[i, gi]] += dw[i]
            hits[gi, hi[i, gi], lo[i, gi]] += 1
    return dsum, hits


def _grad_port(hi, lo, dw, valid, h, l):
    return [t.numpy() for t in kernels.grad_class(
        *map(torch.from_numpy, (hi, lo, dw, valid)), h, l)]


def test_grad_class_reference_matches_pallas_interpret():
    """The shapes of ``tests/test_ops.py::test_pallas_grad_class_interpret``:
    one contiguous (2, G, H, L) pair, its hits row bitwise JAX's hits,
    its dsum row within the Pallas kernel's bf16x2 split."""
    g, h, l = 4, 64, 64
    hi, lo, dw, valid = _grad_inputs(g, h, l, 128, seed=1)
    want = pk.grad_for(h, l)(*map(jnp.asarray, (hi, lo, dw, valid)), 64, True)
    pair = kernels.grad_class(*map(torch.from_numpy, (hi, lo, dw, valid)),
                              h, l)
    assert pair.shape == (2, g, h, l) and pair.dtype == torch.float32
    assert pair.is_contiguous()
    dsum, hits = pair.numpy()
    np.testing.assert_array_equal(hits, np.asarray(want[1]))
    wd = np.asarray(want[0])
    ref_d, _ = _grad_loop(hi, lo, dw, valid, h, l)
    mass = _grad_loop(hi, lo, np.abs(dw), valid, h, l)[0]
    # bf16x2 carries ~2^-18 of each term; allow 2^-17 of the entry's mass
    np.testing.assert_array_less(np.abs(dsum - wd), 2.0**-17 * mass + 1e-30)
    np.testing.assert_array_less(np.abs(dsum - ref_d), 2.0**-20 * mass + 1e-30)


@pytest.mark.parametrize("b", [1, 100, 1001])
def test_grad_class_reference_any_batch(b):
    """Ragged batches, which the Pallas kernel does not take."""
    g, h, l = 3, 16, 16
    hi, lo, dw, valid = _grad_inputs(g, h, l, b, seed=b)
    dsum, hits = _grad_port(hi, lo, dw, valid, h, l)
    ref_d, ref_h = _grad_loop(hi, lo, dw, valid, h, l)
    np.testing.assert_array_equal(hits, ref_h)
    mass = _grad_loop(hi, lo, np.abs(dw), valid, h, l)[0]
    np.testing.assert_array_less(np.abs(dsum - ref_d), 2.0**-20 * mass + 1e-30)


@pytest.mark.parametrize("distinct", [1, 2, 5, 32])
def test_grad_class_reference_colliding_rows_bitwise(distinct):
    """Every 32 consecutive rows hit exactly ``distinct`` entries of
    each tuple (the card's test of its warp groups, on the plain
    version): with dyadic dw every sum is exact, so the pair equals
    the float64 loop bit for bit."""
    g, h, l, b = 5, 16, 16, 3 * 32 + 7
    rng = np.random.default_rng(distinct)
    entries = np.stack([rng.choice(h * l, distinct, replace=False)
                        for _ in range(g)])
    flat = entries[np.arange(g), (7 * np.arange(b)[:, None]
                                  + np.arange(g)) % distinct]
    hi, lo = (flat // l).astype(np.int32), (flat % l).astype(np.int32)
    dw = (rng.integers(-40, 41, b) * 2.0**-12).astype(np.float32)
    valid = rng.random(b) < 0.7
    dsum, hits = _grad_port(hi, lo, dw, valid, h, l)
    ref_d, ref_h = _grad_loop(hi, lo, dw, valid, h, l)
    np.testing.assert_array_equal(dsum, ref_d)
    np.testing.assert_array_equal(hits, ref_h)


def test_grad_class_bad_index_and_invalid_rows():
    g, h, l = 3, 16, 16
    hi, lo, dw, valid = _grad_inputs(g, h, l, 50, seed=7)
    valid[:2] = [False, True]
    hi[0, :] = -5  # an invalid row's indices are never read
    lo[1, 2] = l  # a valid row's bad index flags its tuple
    dsum, hits = _grad_port(hi, lo, dw, valid, h, l)
    assert np.isnan(dsum[2, 0, 0])
    assert np.isnan(dsum).sum() == 1
    clean = valid.copy()
    clean[1] = False
    ref_h = _grad_loop(hi, lo, dw, clean, h, l)[1]
    ref_h[:2] += _grad_loop(hi[1:2, :2], lo[1:2, :2], dw[1:2],
                            valid[1:2], h, l)[1]
    np.testing.assert_array_equal(hits, ref_h)


def test_grad_class_on_cpu_counts_nothing_and_checks_inputs():
    hi, lo, dw, valid = map(torch.from_numpy,
                            _grad_inputs(3, 16, 16, 10, seed=3))
    before = kernels.grad_class.launches
    kernels.grad_class(hi, lo, dw, valid, 16, 16)
    assert kernels.grad_class.launches == before
    with pytest.raises(TypeError):
        kernels.grad_class(hi.long(), lo, dw, valid, 16, 16)
    with pytest.raises(TypeError):
        kernels.grad_class(hi, lo, dw.double(), valid, 16, 16)
    with pytest.raises(TypeError):
        kernels.grad_class(hi, lo, dw, valid.int(), 16, 16)
    with pytest.raises(ValueError):
        kernels.grad_class(hi, lo[:5], dw, valid, 16, 16)


@pytest.mark.parametrize("n", [4, 5])
def test_make_class_grads_matches_jax_bitwise(n):
    """Dyadic dw (exact sums in any order) against the reference's
    one-hot einsum path, for both of the port's modes."""
    ts = jnt.get_tuple_set(n)
    rng = np.random.default_rng(n)
    idx = np.array(jnt.feature_indices(
        ts, jnp.asarray(rand_boards(64, seed=n).reshape(64, 16))))
    dw = (rng.integers(-40, 41, 64) * 2.0**-12).astype(np.float32)
    valid = rng.random(64) < 0.8
    _, jfn = jdisp.make_class_grads(ts, "gather")
    want = jfn(*map(jnp.asarray, (idx, dw, valid)))
    for mode in ("gather", "pallas"):
        classes, fn = tdisp.make_class_grads(tnt.get_tuple_set(n), mode)
        got = fn(*map(torch.from_numpy, (idx, dw, valid)))
        assert len(got) == len(want) == len(classes.matmul)
        for c, pair, (wd, wh) in zip(classes.matmul, got, want):
            # one contiguous [dsum; hits] pair per class
            assert pair.shape == (2, c.g, c.h, c.l) and pair.is_contiguous()
            np.testing.assert_array_equal(pair[0].numpy(), np.asarray(wd))
            np.testing.assert_array_equal(pair[1].numpy(), np.asarray(wh))


@pytest.mark.parametrize("canonical", [True, False])
def test_make_train_evaluator_and_mxu_eval_idx_match_jax_n5(canonical):
    """Dyadic weights: every sum is exact, so gather and the plain
    kernels (bf16 selection included) agree with JAX bitwise."""
    ts = jnt.get_tuple_set(5)
    w = dyadic_weights(ts.total, seed=6)
    boards = rand_boards(2 * 40, seed=6).reshape(2, 40, 16)
    want = jdisp.make_train_evaluator(ts, "gather", canonical=canonical,
                                      precision="bf16", split=True)(
        jnp.asarray(w), jnp.asarray(boards))
    jexact = jdisp.make_mxu_eval_idx(ts, "gather")
    for mode in ("gather", "pallas"):
        got = tdisp.make_train_evaluator(
            tnt.get_tuple_set(5), mode, canonical=canonical,
            precision="bf16")(torch.from_numpy(w), torch.from_numpy(boards))
        for g, x in zip(got, want):
            if x is None:
                assert g is None
            else:
                np.testing.assert_array_equal(g.numpy(), np.asarray(x))
        idx2 = got[2].reshape(-1, ts.num_feat)
        np.testing.assert_array_equal(
            tdisp.make_mxu_eval_idx(tnt.get_tuple_set(5), mode)(
                torch.from_numpy(w), idx2).numpy(),
            np.asarray(jexact(jnp.asarray(w), jnp.asarray(idx2.numpy()))))


def _fold_emulated(n, feat0, g, pair: np.ndarray) -> np.ndarray:
    """The D4 orbit sum through ``kernels.fold_plan``'s rounds in
    numpy: each output is the 8-term tree of its leaves in the
    reference's association order, gathered from the input, in f32."""
    plan = kernels.fold_plan(n, feat0, g)
    size = pair.shape[-1]
    k = {256: 2, 4096: 3, 65536: 4}[size]
    t = np.repeat(np.arange(g), size)
    e = np.tile(np.arange(size), g)

    def image(r, t, e):
        p = plan[r, t]
        j = sum(((e >> (4 * (k - 1 - d))) & 15) * p[:, 1 + d]
                for d in range(k))
        return p[:, 0], j

    out = []
    for x in pair:  # one row of the pair
        def at(a):
            return x[a[0], a[1]]

        a = (t, e)
        b = image(2, *a)
        a1, b1 = image(1, *a), image(1, *b)
        leaves = [at(v) for v in (a, image(0, *a), a1, image(0, *a1),
                                  b, image(0, *b), b1, image(0, *b1))]
        y2a = (leaves[0] + leaves[1]) + (leaves[2] + leaves[3])
        y2b = (leaves[4] + leaves[5]) + (leaves[6] + leaves[7])
        out.append((y2a + y2b).reshape(g, size))
    return np.stack(out)


@pytest.mark.parametrize("n", [2, 3, 5])
def test_fold_plan_gives_the_plain_fold_bitwise(n):
    """``kernels.fold_plan``'s rounds, from which the kernel's orbit
    plan is derived, and the 8-term association order reproduce
    ``symmetrize_class_sum`` bit for bit, for each class shape the
    kernel takes (16^2 at n=2, 16^3 at n=3, 16^4 at n=5)."""
    ts = tnt.get_tuple_set(n)
    feat0, g, size = tsym._table_geometry(ts)[4][0]
    pair = np.random.default_rng(n).standard_normal((2, g, size)
                                                    ).astype(np.float32)
    want = tsym.symmetrize_class_sum(ts, feat0, g, torch.from_numpy(pair))
    np.testing.assert_array_equal(_fold_emulated(n, feat0, g, pair),
                                  want.numpy())


def _fold_orbit_emulated(n, feat0, g, pair: torch.Tensor) -> torch.Tensor:
    """The redesigned fold_class kernel's arithmetic in torch, over the
    whole class: for every entry orbit of ``kernels.fold_orbit_plan``,
    the 8 leaves gathered once at its representative's images, and each
    member m's sum of the leaves ``FOLD_CAYLEY[m]`` in the reference's
    association order, written at member m's index."""
    orbits, reps = (torch.from_numpy(a).long()
                    for a in kernels.fold_orbit_plan(n, feat0, g))
    size = pair.shape[-1]
    k = {256: 2, 4096: 3, 65536: 4}[size]
    tile = 4**k
    ob = torch.repeat_interleave(torch.arange(len(orbits)),
                                 orbits[:, 2] - orbits[:, 1])
    reps = torch.from_numpy(kernels.fold_swizzle(reps.numpy(), k))
    glob = orbits[ob[:, None], 4 + (reps >> (2 * k))] + torch.from_numpy(
        kernels._tile_spread((reps & (tile - 1)).numpy(), k))
    x = pair.reshape(pair.shape[0], -1)
    out = torch.full_like(x, float("nan"))
    v = x[:, glob]  # (R, orbits, 8 leaves)
    for m, c in enumerate(kernels.FOLD_CAYLEY):
        lv = v[..., list(c)]
        y2a = (lv[..., 0] + lv[..., 1]) + (lv[..., 2] + lv[..., 3])
        y2b = (lv[..., 4] + lv[..., 5]) + (lv[..., 6] + lv[..., 7])
        out[:, glob[:, m]] = y2a + y2b
    return out.reshape(pair.shape), glob


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_fold_orbit_plan_gives_the_plain_fold_bitwise(n):
    """The redesigned kernel's plan (tile orbits, entry-orbit
    representatives, D4's table in the basis of the words, each
    member's association order) reproduces ``symmetrize_class_sum`` bit
    for bit over the whole class; its representatives are
    ``canonical_mask``'s."""
    from tpu2048_torch.features.canonical import canonical_mask

    ts = tnt.get_tuple_set(n)
    feat0, g, size = tsym._table_geometry(ts)[4][0]
    pair = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (2, g, size)).astype(np.float32))
    got, glob = _fold_orbit_emulated(n, feat0, g, pair)
    want = tsym.symmetrize_class_sum(ts, feat0, g, pair)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    off = int(ts.offsets[feat0])
    canon = np.flatnonzero(canonical_mask(ts)[off: off + g * size])
    np.testing.assert_array_equal(np.sort(glob[:, 0].numpy()), canon)
    orbits, _ = kernels.fold_orbit_plan(n, feat0, g)
    assert orbits[:, 0].max() <= kernels.FOLD_MAX_SLOTS


def test_fold_kernel_source_spells_the_cayley_table():
    """csrc/fold_class.cu writes D4's table out in its FOLD_MEMBER
    lines; they must be ``kernels.FOLD_CAYLEY``, row for row."""
    import re
    from pathlib import Path

    src = (Path(kernels.__file__).parent / "csrc" / "fold_class.cu"
           ).read_text()
    rows = [tuple(int(v) for v in m.group(2).split(","))
            for m in re.finditer(r"^\s*FOLD_MEMBER\((\d+),([\d, ]+)\);",
                                 src, re.M)]
    assert tuple(rows) == kernels.FOLD_CAYLEY


def test_fold_class_on_cpu_is_plain_and_checks_inputs():
    ts = tnt.get_tuple_set(4)
    pair = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 17, 65536)).astype(np.float32))
    before = kernels.fold_class.launches
    got = kernels.fold_class(ts, 0, 17, pair)
    assert kernels.fold_class.launches == before
    np.testing.assert_array_equal(
        got.numpy(), tsym.symmetrize_class_sum(ts, 0, 17, pair).numpy())
    with pytest.raises(TypeError):
        kernels.fold_class(ts, 0, 17, pair[:, :16])
    with pytest.raises(TypeError):
        kernels.fold_class(ts, 0, 17, pair.double())
    with pytest.raises(ValueError, match="16\\^1"):
        kernels.fold_plan(6, 21, 12)  # the 14^6 class
