"""The train actor's feature indices from its afterstates' packed row
codes (``kernels.feature_index``) on the CPU:

  * its plain version against the indices of the boards the codes
    hold, at n=2..7, on random codes, on afterstates of played games
    and on boards of exponents 13 and up (n=6 clips them), with the
    up/down slots transposed and with none;
  * the kernel's plan (``kernels.feature_index_plan``), read with the
    arithmetic of ``csrc/feature_index.cu`` in numpy, against the plain
    version;
  * the train evaluator's codes form against its boards form, in each
    mode, and the ``td.index_rows`` counter of the rows it gives the
    kernel's wrapper;
  * the wrapper's and the plan's refusals.

The kernel itself runs in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from tpu2048_torch.agent import td
from tpu2048_torch.config import AgentConfig, TrainConfig
from tpu2048_torch.draws import NumpyDraws
from tpu2048_torch.engine import fast as engf
from tpu2048_torch.features.canonical import canonical_gather_indices
from tpu2048_torch.features.ntuple import feature_indices, get_tuple_set
from tpu2048_torch.obs import profiler
from tpu2048_torch.ops import dispatch, kernels

NS = [2, 3, 4, 5, 6, 7]
SLOTS = {"up_down": (1, 3), "none": ()}
BOARDS = 48


def _pack(cells: np.ndarray) -> np.ndarray:
    """(..., 16) exponents -> (..., 4) int32 row codes."""
    rows = cells.reshape(cells.shape[:-1] + (4, 4)).astype(np.int32)
    return (rows << np.array([12, 8, 4, 0], np.int32)).sum(-1,
                                                           dtype=np.int32)


def _played(seed: int) -> torch.Tensor:
    """(4, N, 4) afterstate codes of games played 120 moves (each the
    first legal direction in a turning order, then a spawn), or to
    their end."""
    draws = NumpyDraws(seed, "cpu")
    codes = engf.new_codes(BOARDS, draws)
    ar = torch.arange(BOARDS)
    for step in range(120):
        aft, _delta, legal, _t = engf.afterstates_full(codes)
        order = torch.tensor([(step + i) % 4 for i in range(4)])
        d = order[legal[order].to(torch.int32).argmax(dim=0)]
        moved = engf.canonicalize_chosen(aft[d, ar], d)
        spawned, _pos, _val = engf.spawn_codes(moved, draws)
        codes = torch.where(legal.any(dim=0)[:, None], spawned, codes)
    return engf.afterstates_full(codes)[0]


def _codes(kind: str, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return torch.from_numpy(
            rng.integers(0, 1 << 16, (4, BOARDS, 4)).astype(np.int32))
    if kind == "high":
        return torch.from_numpy(_pack(rng.integers(11, 16, (4, BOARDS, 16))))
    return _played(seed)


def _boards(codes: torch.Tensor, transposed) -> torch.Tensor:
    """(S, N, 16) the boards the codes hold: a transposed slot's codes
    transposed back first."""
    return torch.stack([engf.cells_from_codes(
        engf.transpose_codes(c) if d in transposed else c)
        for d, c in enumerate(codes)])


@pytest.mark.parametrize("slots", list(SLOTS))
@pytest.mark.parametrize("kind", ["random", "played", "high"])
@pytest.mark.parametrize("n", NS)
def test_reference_equals_the_boards_features(n, kind, slots):
    ts = get_tuple_set(n)
    codes = _codes(kind, seed=n)
    boards = _boards(codes, SLOTS[slots])
    idx, cidx, mult = kernels.feature_index_reference(ts, codes, SLOTS[slots])
    assert idx.dtype == torch.int32 and idx.shape == (4, BOARDS, ts.num_feat)
    assert torch.equal(idx, feature_indices(ts, boards))
    want_c, want_m = canonical_gather_indices(ts, boards)
    if n < 5:  # no gather class
        assert cidx is None and mult is None and want_c.shape[-1] == 0
    else:
        assert torch.equal(cidx, want_c) and torch.equal(mult, want_m)
    plain = kernels.feature_index_reference(ts, codes, SLOTS[slots],
                                            canonical=False)
    assert torch.equal(plain[0], idx) and plain[1] is None


def _plan_indices(plan: np.ndarray, codes: np.ndarray, transposed) -> tuple:
    """The kernel's arithmetic over its plan, in numpy: a board's cells
    read from its codes (a transposed slot's cell (i, c) is nibble i of
    code c), then each direct feature's terms and each gather feature's
    listed images from its digits: image 0 its index, the least of the
    images that can be least (image 0 among them where the plan says
    so) and its count."""
    w = plan.astype(np.int64)
    feats, direct, dterms, gathers, gterms = (int(x) for x in w[:5])
    slots, n, _ = codes.shape
    nib = (codes.astype(np.int64)[..., :, None]
           >> (12 - 4 * np.arange(4))) & 15  # [slot, board, code, nibble]
    across = np.isin(np.arange(slots), list(transposed))[:, None, None, None]
    cells = np.where(across, np.swapaxes(nib, -1, -2), nib).reshape(-1, 16)
    v = np.concatenate([cells, np.minimum(cells, 13)], axis=1)
    idx = np.full((slots * n, feats), -1, np.int64)
    for i in range(direct):
        f, acc = w[8 + 2 * i], np.full(slots * n, w[9 + 2 * i])
        for j in range(dterms):
            acc = acc + v[:, w[136 + 12 * i + 2 * j]] * w[137 + 12 * i + 2 * j]
        idx[:, f] = acc
    cidx = np.zeros((slots * n, gathers), np.int64)
    mult = np.zeros_like(cidx)
    for k in range(gathers):
        d = [v[:, w[952 + 6 * k + j]] if j < gterms else 0 for j in range(6)]
        img = np.stack([w[1048 + 64 * k + 8 * i + 6] + sum(
            d[j] * w[1048 + 64 * k + 8 * i + j] for j in range(6))
            for i in range(w[920 + k])], axis=1)
        idx[:, w[904 + k]] = img[:, 0]
        least = img if w[936 + k] else img[:, 1:]  # image 0 is one of them
        cidx[:, k] = least.min(axis=1)
        mult[:, k] = (least == cidx[:, k:k + 1]).sum(axis=1)
    shape = (slots, n)
    return (idx.reshape(shape + (feats,)), cidx.reshape(shape + (gathers,)),
            mult.reshape(shape + (gathers,)))


@pytest.mark.parametrize("slots", list(SLOTS))
@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("n", NS)
def test_kernel_plan_gives_the_reference(n, canonical, slots):
    ts = get_tuple_set(n)
    codes = _codes("random", seed=10 + n)
    plan = kernels.feature_index_plan(n, canonical)
    assert plan.dtype == np.int32 and plan.shape == (kernels._FI_WORDS,)
    got = _plan_indices(plan, codes.numpy(), SLOTS[slots])
    want = kernels.feature_index_reference(ts, codes, SLOTS[slots], canonical)
    assert np.array_equal(got[0], want[0].numpy())
    if want[1] is None:
        assert got[1].shape[-1] == 0
    else:
        assert np.array_equal(got[1], want[1].numpy())
        assert np.array_equal(got[2], want[2].numpy())


def test_kernel_plan_refuses_a_tuple_set_beyond_its_limits(monkeypatch):
    plan = kernels.feature_index_plan.__wrapped__
    monkeypatch.setattr(kernels, "FI_MAX_GATHER", 8)
    with pytest.raises(ValueError, match="beyond the kernel"):
        plan(6, True)
    plan(6, False)  # no gather features written
    monkeypatch.setattr(kernels, "FI_MAX_FEAT", 32)
    with pytest.raises(ValueError, match="beyond the kernel"):
        plan(6, False)
    monkeypatch.setattr(kernels, "FI_MAX_TERMS", 4)
    with pytest.raises(ValueError, match="beyond the kernel"):
        plan(5, False)


@pytest.mark.parametrize("n,canonical", [(4, True), (5, True), (5, False),
                                         (6, True)])
@pytest.mark.parametrize("mode", ["gather", "pallas", "onehot"])
def test_codes_form_equals_boards_form(mode, n, canonical):
    ts = get_tuple_set(n)
    weights = torch.from_numpy(np.random.default_rng(n).random(
        ts.total, dtype=np.float32))
    codes = _played(seed=30 + n)
    kw = dict(canonical=canonical, precision="bf16")
    by_codes = dispatch.make_train_evaluator(ts, mode, codes=True, **kw)(
        weights, codes, (1, 3))
    by_boards = dispatch.make_train_evaluator(ts, mode, **kw)(
        weights, _boards(codes, (1, 3)))
    for got, want in zip(by_codes, by_boards):
        assert (got is None) == (want is None)
        if want is not None:
            assert got.shape == want.shape and torch.equal(got, want)


@pytest.fixture
def counters(monkeypatch):
    c = {}
    monkeypatch.setattr(profiler, "counters", c)
    return c


def test_codes_form_counts_the_kernels_rows(counters):
    ts = get_tuple_set(5)
    weights = torch.zeros(ts.total)
    codes = _codes("random", seed=3)
    for mode in ("pallas", "gather"):
        ev = dispatch.make_train_evaluator(ts, mode, canonical=True,
                                           codes=True)
        ev(weights, codes, (1, 3))  # no profiler: counts nothing
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]):
            ev(weights, codes, (1, 3))
    # "gather" takes the plain version: only "pallas" gave rows
    assert counters == {"td.index_rows": 4 * BOARDS}


def test_traced_train_segment_counts_every_afterstate(counters):
    """A traced segment of the codes actor gives the kernel's wrapper
    all 4 afterstates of every env, every step; the cells engine none."""
    tcfg = TrainConfig(num_envs=16, steps_per_call=2, ring_size=64,
                       max_record_steps=64, seed=0)
    ts = get_tuple_set(4)
    for engine in ("codes", "cells"):
        acfg = AgentConfig(n=4, table_ops="pallas", engine_mode=engine)
        st = td.init_td_state(ts, acfg, tcfg, NumpyDraws(0, "cpu"), "cpu")
        seg = td.make_train_segment(ts, acfg, tcfg, NumpyDraws(1, "cpu"))
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]):
            seg(st)
    assert counters == {"td.index_rows": 2 * 4 * 16}


@pytest.mark.parametrize("case", ["int64", "three_words", "flat", "strided",
                                  "slot"])
def test_wrapper_refuses_bad_input(case):
    ts = get_tuple_set(5)
    codes = _codes("random", seed=4)
    transposed = (1, 3)
    error = TypeError
    if case == "int64":
        codes = codes.long()
    elif case == "three_words":
        codes = codes[..., :3].contiguous()
    elif case == "flat":
        codes = codes.reshape(-1, 4)
    elif case == "strided":
        codes = codes.transpose(0, 1)
        error = ValueError
    else:
        transposed, error = (1, 4), ValueError
    with pytest.raises(error, match="feature_index"):
        kernels.feature_index(ts, codes, transposed)


def test_wrapper_on_cpu_is_plain_and_counts_nothing():
    ts = get_tuple_set(6)
    codes = _codes("high", seed=6)
    before = kernels.feature_index.launches
    got = kernels.feature_index(ts, codes)
    want = kernels.feature_index_reference(ts, codes)
    assert kernels.feature_index.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    empty = kernels.feature_index(ts, codes[:, :0].contiguous())
    assert [t.shape for t in empty] == [(4, 0, 33), (4, 0, 16), (4, 0, 16)]
