"""``table_ops="onehot"`` in the port against the JAX reference's
(``tpu2048/ops/onehot.py``, its branches of ``tpu2048/ops/dispatch.py``)
on CPU, from the same seeded numpy inputs: the one-hot evaluator and
updater at n=2..5, the dispatch's evaluator and class gradients, one
train segment and one step at n=4 under the defaults and under sgd with
``sym_impl="index"``, and a greedy and a searching ``trial``.

hits are exact integers and compared bitwise; a sum of dw over an
entry's rows in another order stays within ``hits * 2^-23 * sum |dw|``
of it; the train states are held as ``_torch_port.assert_train_state``
holds them (integers bitwise, floats within 2^-17).  The card's
products, and their refusal under TF32, are tested in
``test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import (AfterSegment, check_step, dyadic_weights,
                         rand_boards)
from test_torch_trial import _assert_same, _run_both

from tpu2048.features import ntuple as jnt
from tpu2048.ops import dispatch as jdisp
from tpu2048.ops import onehot as joh
from tpu2048_torch.config import AgentConfig, SearchConfig, TrainConfig
from tpu2048_torch.features import ntuple as tnt
from tpu2048_torch.ops import dispatch as tdisp
from tpu2048_torch.ops import onehot as toh

ULP = 2.0**-23


def _inputs(n, b, seed):
    """Weights, (b, F) feature indices of random boards, dw and a
    valid mask with about a quarter of the rows out."""
    ts = jnt.get_tuple_set(n)
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(ts.total).astype(np.float32)
    idx = np.array(jnt.feature_indices(
        ts, jnp.asarray(rand_boards(b, seed).reshape(b, 16))))
    dw = (rng.standard_normal(b) * 0.01).astype(np.float32)
    valid = rng.random(b) < 0.75
    return ts, w, idx, dw, valid


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_onehot_eval_matches_jax(n):
    """The port's "onehot" evaluator against JAX's ``onehot_eval``: the
    sum of 4..21 exact terms in another f32 order, within 2^-20 of the
    sum of their magnitudes."""
    ts, w, idx, _dw, _valid = _inputs(n, 96, seed=n)
    classes = joh.build_table_classes(ts)
    want = np.asarray(joh.onehot_eval(ts, classes, jnp.asarray(w),
                                      jnp.asarray(idx)))
    boards = torch.from_numpy(rand_boards(96, n).reshape(96, 16))
    got = tdisp.make_evaluator(tnt.get_tuple_set(n), "onehot")(
        torch.from_numpy(w), boards)
    assert got.shape == (96,) and got.dtype == torch.float32
    scale = np.abs(w)[idx].sum(axis=-1)
    np.testing.assert_array_less(np.abs(got.numpy() - want),
                                 2.0**-20 * scale + 1e-30)


@pytest.mark.parametrize("n", [2, 3, 4, 5])
@pytest.mark.parametrize("mean", [True, False], ids=["mean", "sum"])
def test_onehot_update_matches_jax(n, mean):
    """The port's "onehot" updater against JAX's ``onehot_update``: the
    updated tables, each entry within ``hits * 2^-23 * sum |dw|`` of
    JAX's plus the rounding of the final add; the class gradients'
    hits bitwise and their dsum within that bound."""
    ts, w, idx, dw, valid = _inputs(n, 64, seed=10 + n)
    classes = joh.build_table_classes(ts)
    j = [jnp.asarray(a) for a in (idx, dw, valid)]
    want = np.asarray(joh.onehot_update(ts, classes, jnp.asarray(w), *j,
                                        mean=mean))
    t = [torch.from_numpy(a) for a in (idx, dw, valid)]
    got = tdisp.make_updater(tnt.get_tuple_set(n), "onehot", mean)(
        torch.from_numpy(w.copy()), *t)
    # per entry: its hit count and the sum of its rows' |dw|
    flat = idx[valid].reshape(-1)
    hits = np.bincount(flat, minlength=ts.total)
    absdw = np.bincount(flat, np.repeat(np.abs(dw[valid]), ts.num_feat),
                        minlength=ts.total)
    tol = ULP * (hits * absdw + 2 * np.abs(want))
    assert (np.abs(got.numpy() - want) <= tol).all()
    assert not np.array_equal(want, w)
    # the class gradients of JAX's one-hot einsums
    _c, jfn = jdisp.make_class_grads(ts, "onehot")
    _c, tfn = tdisp.make_class_grads(tnt.get_tuple_set(n), "onehot")
    for c, (jd, jh), pair in zip(classes.matmul, jfn(*j), tfn(*t)):
        assert pair.shape == (2, c.g, c.h, c.l) and pair.is_contiguous()
        np.testing.assert_array_equal(pair[1].numpy(), np.asarray(jh))
        size = c.g * c.h * c.l
        blk = slice(c.start, c.start + size)
        bound = ULP * hits[blk] * absdw[blk]
        assert (np.abs(pair[0].numpy().reshape(size)
                       - np.asarray(jd).reshape(size)) <= bound).all()


@pytest.mark.parametrize("canonical", [False, True],
                         ids=["dense", "canonical"])
def test_make_evaluator_onehot_matches_jax_n5(canonical):
    """JAX's "onehot" evaluator within 2^-20 of the terms' magnitudes,
    and with dyadic weights bitwise both JAX's and the port's "gather"
    (every sum exact)."""
    ts, tts = jnt.get_tuple_set(5), tnt.get_tuple_set(5)
    boards = rand_boards(2 * 40, seed=9).reshape(2, 40, 16)
    jfn = jdisp.make_evaluator(ts, "onehot", canonical)
    tfn = tdisp.make_evaluator(tts, "onehot", canonical)
    w = np.random.default_rng(9).standard_normal(ts.total).astype(np.float32)
    want = np.asarray(jfn(jnp.asarray(w), jnp.asarray(boards)))
    got = tfn(torch.from_numpy(w), torch.from_numpy(boards))
    assert got.shape == (2, 40)
    scale = np.asarray(jfn(jnp.abs(jnp.asarray(w)), jnp.asarray(boards)))
    np.testing.assert_array_less(np.abs(got.numpy() - want), 2.0**-20 * scale)
    d = dyadic_weights(ts.total, seed=9)
    got = tfn(torch.from_numpy(d), torch.from_numpy(boards)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jfn(jnp.asarray(d), jnp.asarray(boards))))
    np.testing.assert_array_equal(got, tdisp.make_evaluator(
        tts, "gather", canonical)(torch.from_numpy(d),
                                  torch.from_numpy(boards)).numpy())


def test_onehot_train_side_functions_follow_the_reference_n5():
    """The train evaluator and the exact re-evaluation read by gathers
    under "onehot" (bitwise "gather"'s); the accumulator is "gather"'s;
    the mode resolves as it is on every device and takes no kernel."""
    tts = tnt.get_tuple_set(5)
    w = torch.from_numpy(dyadic_weights(tts.total, seed=4))
    boards = torch.from_numpy(rand_boards(64, seed=4).reshape(4, 16, 16))
    got = tdisp.make_train_evaluator(tts, "onehot", canonical=True)(w, boards)
    ref = tdisp.make_train_evaluator(tts, "gather", canonical=True)(w, boards)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    idx2 = got[2].reshape(64, -1)
    assert torch.equal(tdisp.make_mxu_eval_idx(tts, "onehot")(w, idx2),
                       tdisp.make_mxu_eval_idx(tts, "gather")(w, idx2))
    dw = torch.linspace(-1.0, 1.0, 64)
    valid = torch.arange(64) % 3 > 0
    assert torch.equal(
        tdisp.make_delta_accumulator(tts, "onehot")(w, idx2, dw, valid),
        tdisp.make_delta_accumulator(tts, "gather")(w, idx2, dw, valid))
    for dev in ("cpu", "cuda"):
        assert tdisp.resolve_mode("onehot", torch.device(dev)) == "onehot"
        assert not tdisp.uses_kernels("onehot", torch.device(dev))


def test_onehot_blocks_give_the_same_values(monkeypatch):
    """Rows evaluated in blocks (a cap far below the batch) give the
    values of one block bitwise; the gradient pair's hits too, and its
    dsum within the summation-order bound."""
    ts = tnt.get_tuple_set(4)
    _ts, w, idx, dw, valid = _inputs(4, 200, seed=21)
    classes = toh.build_table_classes(ts)
    [c] = classes.matmul
    t = [torch.from_numpy(a) for a in (idx, dw, valid)]
    hi, lo = toh._hi_lo(ts, t[0], c)
    tables = toh._class_tables(torch.from_numpy(w), c)
    whole_v = toh.class_values(tables, hi, lo)
    whole_g = toh.class_grads(hi, lo, t[1], t[2], c.h, c.l)
    monkeypatch.setattr(toh, "_BLOCK_ENTRIES", c.g * c.h * 7)
    assert toh._block_rows(c.g, c.h) == 7
    assert torch.equal(toh.class_values(tables, hi, lo), whole_v)
    pair = toh.class_grads(hi, lo, t[1], t[2], c.h, c.l)
    assert torch.equal(pair[1], whole_g[1])
    absdw = toh.class_grads(hi, lo, t[1].abs(), t[2], c.h, c.l)[0]
    assert ((pair[0] - whole_g[0]).abs() <= ULP * pair[1] * absdw).all()


@pytest.mark.parametrize("way", ["backend", "global", "generic"])
def test_onehot_refusal_reads_each_way_tf32_is_allowed(way):
    """``_tf32_allowed`` sees TF32 allowed in each way a caller may
    allow it (cuBLAS's own mode, ``set_float32_matmul_precision``,
    torch's generic mode), ``_check_exact`` then refuses CUDA tensors
    and not CPU ones, and once the settings are back nothing is
    refused.  Flags only: no card is needed."""
    from chip_smoke import _allow_tf32

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    before = torch.get_float32_matmul_precision()
    assert not toh._tf32_allowed()
    restore = _allow_tf32(way)
    try:
        assert toh._tf32_allowed()
        with pytest.raises(RuntimeError, match="needs exact f32"):
            toh._check_exact(cuda)
        toh._check_exact(cpu)
    finally:
        restore()
    assert not toh._tf32_allowed()
    toh._check_exact(cuda)
    assert torch.get_float32_matmul_precision() == before


# -- the train step against JAX's, at n=4 (one 16^4 class) -------------------

TCFG = TrainConfig(num_envs=32, steps_per_call=8, ring_size=64,
                   max_record_steps=256, seed=0)
VARIANTS = {
    # the defaults: canonical form, TC; the class gradients' products
    "tc": AgentConfig(n=4, table_ops="onehot"),
    # the reference's rule: the updater's products, "mean"
    "sgd_index": AgentConfig(n=4, table_ops="onehot", optimizer="sgd",
                             alpha=0.25, sym_impl="index"),
}


@pytest.fixture(scope="module")
def after_segment():
    return AfterSegment(VARIANTS, TCFG, seed0=11)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_onehot_segment_and_step_match_jax(name, after_segment, monkeypatch):
    """One segment from a fresh state, then one step from its end with
    dyadic weights: integers bitwise, tables within 2^-17; the step
    took the one-hot products (the class gradients, or the updater)."""
    calls = []
    real = toh.class_grads
    monkeypatch.setattr(toh, "class_grads", lambda *a, **k: (
        calls.append("class_grads"), real(*a, **k))[1])
    js = after_segment(name)
    assert int(js.env.odometer.max()) == TCFG.steps_per_call
    js = js._replace(weights=jnp.asarray(dyadic_weights(js.weights.size)))
    assert bool(js.prev_valid.any())
    calls.clear()
    st, _ = check_step(after_segment.jaxfns, VARIANTS[name], TCFG, js)
    assert st.prev_idx.shape[1] == (8 if name == "sgd_index" else 1)
    assert calls == ["class_grads"]


# -- trial ------------------------------------------------------------------

@pytest.mark.parametrize("depth", [0, 1])
def test_trial_onehot_matches_jax_n4(depth):
    """``trial(table_ops="onehot")`` in both packages with JAX's draws,
    greedy and with a depth-1 / width-2 search through the one-hot
    evaluator: every game bitwise (dyadic weights, exact values)."""
    w = dyadic_weights(jnt.get_tuple_set(4).total, seed=8)
    kw = dict(num=8, step_cap=512, table_ops="onehot", n=4)
    if depth:
        kw["search"] = SearchConfig(depth=1, width=2, since_empty=6)
    got, want, st, sj = _run_both("value", w, seed=8, **kw)
    assert got.odometers.min() > 0
    _assert_same(got, want, st, sj, 512)



def test_app_jobs_train_and_test_a_onehot_agent():
    """The apps' train job takes ``table_ops="onehot"`` from its
    parameters (a new n=2 agent, 16 envs, on the CPU) and stores it
    with that config; the test job then plays it with a depth-1
    search."""
    from tpu2048_torch.apps.service import AppService
    from tpu2048_torch.store import checkpoint as tckpt
    from tpu2048_torch.store.artifacts import MemoryStore

    tcfg = TrainConfig(num_envs=16, steps_per_call=16, ring_size=64,
                       max_record_steps=256)
    svc = AppService(MemoryStore(), default_tcfg=tcfg, device="cpu")
    svc.start_training({"name": "oh", "n": 2, "table_ops": "onehot",
                        "episodes": 20})
    job = svc.jobs.get("agent", "oh")
    job.thread.join(timeout=120)
    st = svc.training_status("oh")
    assert st["state"] == "finished" and st["error"] is None, st
    acfg, _w, meta = tckpt.load_agent(svc.store, "oh")
    assert acfg.table_ops == "onehot" and meta["episodes"] >= 20
    svc.start_test("oh", num=4, depth=1, width=2)
    job = svc.jobs.get("test", "oh")
    job.thread.join(timeout=120)
    assert job.error is None and job.result["avg"] > 0
