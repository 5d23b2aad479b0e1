"""The port's CUDA kernel on the card: ``eval_class`` against its plain
PyTorch version, and the serving slice through the kernel against the
same slice through plain gathers.

Every test here needs a CUDA card and skips without one.  The file
imports no jax, so on a machine without it the tests run with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from tpu2048_torch.features.ntuple import get_tuple_set
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
