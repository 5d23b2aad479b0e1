"""The port's CUDA kernels on the card: ``eval_class``, ``grad_class``
and ``fold_class`` against their plain PyTorch versions, the serving
slice and the expectimax search through the kernel against the same
games through plain gathers, and one train step through the kernels
against the same step on the CPU through the plain versions.

Every test here needs a CUDA card and skips without one.  The file
imports no jax, so on a machine without it the tests run with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from tpu2048_torch.config import AgentConfig, SearchConfig, TrainConfig
from tpu2048_torch.agent import td
from tpu2048_torch.draws import NumpyDraws
from tpu2048_torch.features.ntuple import get_tuple_set
from tpu2048_torch.features.symmetry import symmetrize_class_sum
from tpu2048_torch.ops import kernels
from tpu2048_torch.train.trial import trial

pytestmark = pytest.mark.cuda

SHAPES = [(17, 256, 256), (52, 64, 64), (24, 16, 16)]


def needs_card() -> torch.device:
    """Skip the calling test unless a CUDA card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(g, h, l, b, seed, dev):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((g, h, l))
                             .astype(np.float32)).to(dev),
            torch.from_numpy(rng.integers(0, h, (b, g)).astype(np.int32)).to(dev),
            torch.from_numpy(rng.integers(0, l, (b, g)).astype(np.int32)).to(dev))


@pytest.mark.parametrize("g,h,l", SHAPES)
@pytest.mark.parametrize("b", [32768, 1001])
@pytest.mark.parametrize("precision", ["bf16x2", "f32", "bf16"])
def test_eval_class_kernel_matches_plain(g, h, l, b, precision):
    dev = needs_card()
    tables, hi, lo = _inputs(g, h, l, b, seed=b + g, dev=dev)
    before = kernels.eval_class.launches
    got = kernels.eval_class(tables, hi, lo, precision)
    torch.cuda.synchronize()
    assert kernels.eval_class.launches == before + 1
    ref_t = tables.to(torch.bfloat16).float() if precision == "bf16" else tables
    want = kernels.eval_class_reference(ref_t, hi, lo, "f32")
    gi = torch.arange(g, device=dev)
    scale = ref_t[gi, hi.long(), lo.long()].abs().sum(dim=-1)
    # f32 summation order only: within 2^-20 of sum |terms|
    assert bool(((got - want).abs() <= 2.0**-20 * scale).all())


@pytest.mark.parametrize("g,h,l", SHAPES)
@pytest.mark.parametrize("precision", ["bf16x2", "f32", "bf16"])
def test_eval_class_kernel_bitwise_ordered(g, h, l, precision):
    """At a ragged B, every precision from the f32 block equals the
    ordered f32 accumulation of its terms (RNE bf16 values for "bf16")
    bit for bit, also from a misaligned index view."""
    dev = needs_card()
    tables, hi, lo = _inputs(g, h, l, 1001, seed=g + 5, dev=dev)
    want = kernels.eval_class_ordered(tables, hi, lo, precision)
    assert torch.equal(kernels.eval_class(tables, hi, lo, precision), want)
    shift = [torch.cat([t.reshape(-1)[:1], t.reshape(-1)])[1:].view(t.shape)
             for t in (hi, lo)]
    assert shift[0].data_ptr() % 16
    assert torch.equal(kernels.eval_class(tables, *shift, precision), want)


def test_eval_class_bf16_at_search_tree_scale():
    """B = 2,000,000 rows, one chunk of the depth-3 / width-4 search
    tree's leaves, through the (17, 256, 256) class in "bf16"."""
    dev = needs_card()
    tables, hi, lo = _inputs(17, 256, 256, 2_000_000, seed=11, dev=dev)
    got = kernels.eval_class(tables, hi, lo, "bf16")
    want = kernels.eval_class_reference(tables, hi, lo, "bf16")
    gi = torch.arange(17, device=dev)
    scale = tables.to(torch.bfloat16).float()[gi, hi.long(), lo.long()
                                               ].abs().sum(dim=-1)
    assert bool(((got - want).abs() <= 2.0**-20 * scale).all())
    assert torch.equal(got, kernels.eval_class_ordered(tables, hi, lo,
                                                       "bf16"))


def test_search_trial_kernel_equals_gather_on_card():
    """Depth-2 / width-2 search of 8 n=5 games: the tree's values
    through the kernel in bf16 ("auto" is "search" on the card) and
    through plain gathers; dyadic weights are exact in bf16, so the
    games are the same."""
    dev = needs_card()
    ts = get_tuple_set(5)
    rng = np.random.default_rng(3)
    w = torch.from_numpy(
        (rng.integers(0, 41, ts.total) * 2.0**-12).astype(np.float32)).to(dev)
    scfg = SearchConfig(depth=2, width=2, since_empty=6)
    before = kernels.eval_class.launches
    a = trial(ts, w, num=8, seed=4, search=scfg, step_cap=2048)
    assert kernels.eval_class.launches > before
    assert a.search_stats["chunks"] > 0
    b = trial(ts, w, num=8, seed=4, search=scfg, step_cap=2048,
              table_ops="gather")
    for name in ("scores", "odometers", "final_boards"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_eval_class_kernel_flags_bad_index():
    dev = needs_card()
    tables, hi, lo = _inputs(3, 64, 64, 300, seed=3, dev=dev)
    hi[7, 1] = 64
    got = kernels.eval_class(tables, hi, lo)
    assert bool(got[7].isnan()) and int(got.isnan().sum()) == 1


def test_trial_kernel_equals_gather_on_card():
    dev = needs_card()
    ts = get_tuple_set(5)
    rng = np.random.default_rng(0)
    w = torch.from_numpy(
        (rng.integers(0, 41, ts.total) * 2.0**-12).astype(np.float32)).to(dev)
    before = kernels.eval_class.launches
    a = trial(ts, w, num=256, seed=1, table_ops="auto")
    assert kernels.eval_class.launches > before
    b = trial(ts, w, num=256, seed=1, table_ops="gather")
    for name in ("scores", "odometers", "final_boards"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def _grad_inputs(g, h, l, b, seed, dev, collide=False):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, h, (b, g)).astype(np.int32)
    lo = rng.integers(0, l, (b, g)).astype(np.int32)
    if collide:  # a fresh start: every row on one entry of each table
        hi[:] = lo[:] = 0
    dw = rng.standard_normal(b).astype(np.float32)
    valid = rng.random(b) < 0.5
    return [torch.from_numpy(a).to(dev) for a in (hi, lo, dw, valid)]


@pytest.mark.parametrize("g,h,l", SHAPES)
@pytest.mark.parametrize("b", [8192, 1001])
@pytest.mark.parametrize("collide", [False, True])
def test_grad_class_kernel_matches_plain(g, h, l, b, collide):
    dev = needs_card()
    hi, lo, dw, valid = _grad_inputs(g, h, l, b, b + g, dev, collide)
    before = kernels.grad_class.launches
    dsum, hits = kernels.grad_class(hi, lo, dw, valid, h, l)
    torch.cuda.synchronize()
    assert kernels.grad_class.launches == before + 1
    want_d, want_h = kernels.grad_class_reference(hi, lo, dw, valid, h, l)
    assert torch.equal(hits, want_h)
    # f32 sums of the same terms in two orders: within hits * 2^-23 of
    # the entry's sum of |dw|
    mass = kernels.grad_class_reference(hi, lo, dw.abs(), valid, h, l)[0]
    assert bool(((dsum - want_d).abs() <= 2.0**-23 * hits * mass).all())


def test_grad_class_kernel_flags_bad_index():
    dev = needs_card()
    hi, lo, dw, valid = _grad_inputs(3, 64, 64, 300, 5, dev)
    valid[:2] = torch.tensor([False, True])
    hi[0] = -7  # an invalid row's indices are never used
    lo[1, 2] = 64
    dsum, _ = kernels.grad_class(hi, lo, dw, valid, 64, 64)
    assert bool(dsum[2, 0, 0].isnan()) and int(dsum.isnan().sum()) == 1


def _dyadic_dw(b, seed, dev):
    """Integers in [-40, 40] x 2^-12: every sum of up to 2^12 of them
    is exact in f32, so dsum is the same in any summation order."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (rng.integers(-40, 41, b) * 2.0**-12).astype(np.float32)).to(dev)


def test_grad_class_returns_the_fold_pair():
    """One contiguous (2, G, H, L) tensor, dsum then hits, that the
    fold takes as (2, G, H * L) without a copy."""
    dev = needs_card()
    g, h, l = SHAPES[0]
    hi, lo, dw, valid = _grad_inputs(g, h, l, 1001, 1, dev)
    pair = kernels.grad_class(hi, lo, dw, valid, h, l)
    assert pair.shape == (2, g, h, l) and pair.dtype == torch.float32
    assert pair.is_contiguous() and pair.data_ptr() % 16 == 0
    dsum, hits = pair
    assert dsum.data_ptr() == pair.data_ptr()
    assert hits.data_ptr() == pair.data_ptr() + 4 * g * h * l
    want = kernels.grad_class_reference(hi, lo, dw, valid, h, l)
    assert want.shape == pair.shape and want.is_contiguous()
    assert torch.equal(hits, want[1])
    assert pair.view(2, g, h * l).data_ptr() == pair.data_ptr()


@pytest.mark.parametrize("g,h,l", SHAPES)
@pytest.mark.parametrize("b", [8192, 1001])
@pytest.mark.parametrize("collide", [False, True])
def test_grad_class_kernel_bitwise_with_dyadic_dw(g, h, l, b, collide):
    dev = needs_card()
    hi, lo, _dw, valid = _grad_inputs(g, h, l, b, b + g + 1, dev, collide)
    dw = _dyadic_dw(b, g, dev)
    got = kernels.grad_class(hi, lo, dw, valid, h, l)
    assert torch.equal(got, kernels.grad_class_reference(hi, lo, dw, valid,
                                                         h, l))


@pytest.mark.parametrize("distinct", [1, 2, 5, 32])
def test_grad_class_kernel_groups_colliding_lanes(distinct):
    """Every 32 consecutive rows (one warp's lanes) hit exactly
    ``distinct`` entries of each tuple, some rows invalid, over three
    full tiles and a ragged one: bitwise with dyadic dw."""
    dev = needs_card()
    g, h, l, b = 5, 16, 16, 3 * 32 + 7
    rng = np.random.default_rng(distinct)
    entries = np.stack([rng.choice(h * l, distinct, replace=False)
                        for _ in range(g)])  # (g, distinct)
    # 7 is prime to 32: 32 consecutive rows take every residue
    pick = (7 * np.arange(b)[:, None] + np.arange(g)) % distinct
    flat = entries[np.arange(g), pick]
    hi = torch.from_numpy((flat // l).astype(np.int32)).to(dev)
    lo = torch.from_numpy((flat % l).astype(np.int32)).to(dev)
    valid = torch.from_numpy(rng.random(b) < 0.7).to(dev)
    dw = _dyadic_dw(b, distinct, dev)
    got = kernels.grad_class(hi, lo, dw, valid, h, l)
    want = kernels.grad_class_reference(hi, lo, dw, valid, h, l)
    assert torch.equal(got, want)
    assert int((want[1] > 0).sum(dim=(1, 2)).max()) <= distinct


@pytest.mark.parametrize("b", [1, 33, 1001])
def test_grad_class_kernel_any_batch(b):
    """One row, one past a 32-row tile, and a ragged last tile; and
    the same rows from a misaligned index view."""
    dev = needs_card()
    g, h, l = SHAPES[0]
    hi, lo, _dw, valid = _grad_inputs(g, h, l, b, b, dev)
    valid[0] = True
    dw = _dyadic_dw(b, b, dev)
    want = kernels.grad_class_reference(hi, lo, dw, valid, h, l)
    assert torch.equal(kernels.grad_class(hi, lo, dw, valid, h, l), want)
    shift = [torch.cat([t.reshape(-1)[:1], t.reshape(-1)])[1:].view(t.shape)
             for t in (hi, lo)]
    assert shift[0].data_ptr() % 16
    assert torch.equal(kernels.grad_class(*shift, dw, valid, h, l), want)


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_fold_class_kernel_bitwise(n):
    dev = needs_card()
    ts = get_tuple_set(n)
    g, size = {2: (24, 256), 3: (52, 4096)}.get(n, (17, 65536))
    pair = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (2, g, size)).astype(np.float32)).to(dev)
    before = kernels.fold_class.launches
    got = kernels.fold_class(ts, 0, g, pair)
    torch.cuda.synchronize()
    assert kernels.fold_class.launches == before + 1
    assert torch.equal(got, symmetrize_class_sum(ts, 0, g, pair))


def _to(x, dev):
    """A copy of a (nested) tuple of tensors on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, copy=True)
    return type(x)(*(_to(v, dev) for v in x))


def test_train_step_card_matches_cpu_plain():
    """One n=5 step through the kernels on the card and through their
    plain versions on the CPU, from one state with dyadic weights and
    the same draws: integers bitwise, tables within 2^-17 of the
    largest entry (the card's atomics reorder f32 sums)."""
    dev = needs_card()
    acfg = AgentConfig(table_ops="pallas")
    tcfg = TrainConfig(num_envs=1024, ring_size=256, max_record_steps=256)
    ts = get_tuple_set(5)
    st = td.init_td_state(ts, acfg, tcfg, NumpyDraws(0, "cpu"), "cpu")
    warm = td.make_train_step(ts, acfg, tcfg, NumpyDraws(1, "cpu"))
    st, _ = warm(warm(st)[0])  # two steps: valid rows and TC sums
    rng = np.random.default_rng(2)
    st = st._replace(weights=torch.from_numpy(
        (rng.integers(0, 41, ts.total) * 2.0**-12).astype(np.float32)))
    launches = (kernels.eval_class.launches, kernels.grad_class.launches,
                kernels.fold_class.launches)
    card, rec_card = td.make_train_step(ts, acfg, tcfg, NumpyDraws(3, dev))(
        _to(st, dev))
    torch.cuda.synchronize()
    assert (kernels.eval_class.launches, kernels.grad_class.launches,
            kernels.fold_class.launches) == (launches[0] + 2,
                                             launches[1] + 1,
                                             launches[2] + 1)
    plain, rec_plain = td.make_train_step(ts, acfg, tcfg,
                                          NumpyDraws(3, "cpu"))(st)
    for a, b in zip(rec_card, rec_plain):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(card.env, plain.env):
        assert torch.equal(a.cpu(), b)
    for name in ("prev_idx", "prev_cidx", "prev_cmult", "prev_valid",
                 "prev_value", "top_tile"):
        assert torch.equal(getattr(card, name).cpu(),
                           getattr(plain, name)), name
    # the rings' trash slot takes every unfinished lane's write, in no
    # set order
    for a, b in zip(card.metrics, plain.metrics):
        if a.dim():
            a, b = a[:-1], b[:-1]
        assert torch.equal(a.cpu(), b)
    for name in ("weights", "opt_e", "opt_a"):
        a, b = getattr(card, name).cpu(), getattr(plain, name)
        tol = 2.0**-17 * float(b.abs().max())
        assert float((a - b).abs().max()) <= tol, name
