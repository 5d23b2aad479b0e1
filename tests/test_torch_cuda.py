"""The port's CUDA kernels on the card: ``eval_class``, ``grad_class``
and ``fold_class`` against their plain PyTorch versions, the serving
slice through the kernel against the same slice through plain
gathers, and one train step through the kernels against the same step
on the CPU through the plain versions.

Every test here needs a CUDA card and skips without one.  The file
imports no jax, so on a machine without it the tests run with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from tpu2048.config import AgentConfig, TrainConfig
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
    hi[0] = -7  # an invalid row's indices are never read
    lo[1, 2] = 64
    dsum, _ = kernels.grad_class(hi, lo, dw, valid, 64, 64)
    assert bool(dsum[2, 0, 0].isnan()) and int(dsum.isnan().sum()) == 1


@pytest.mark.parametrize("n", [3, 4, 5])
def test_fold_class_kernel_bitwise(n):
    dev = needs_card()
    ts = get_tuple_set(n)
    g, size = (52, 4096) if n == 3 else (17, 65536)
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
