"""The port's fixed-order float sums, on the CPU.

``grad_class`` and ``cross_apply`` add their f32 terms in an order that
depends only on the input on the card, so training there repeats bit
for bit from its seed.  Here, without a card:

* ``kernels.grad_class_ordered``, the class-gradient kernel's
  arithmetic in plain PyTorch (its tile counts, per-tuple scan and
  in-tile ranks, then the fixed-shape sums of each bucket), against
  ``grad_class_reference`` on the train step's own rows: within hits *
  2^-23 * sum |dw| of it, hits and the pair with dyadic dw bitwise;
  its order is the stable order by hi;
* ``cross_apply``'s arithmetic (one stable sort, each entry's terms
  summed in windows of 32, the windows in order) against a loop,
  bitwise, and against its term-by-term plain version within the
  summation-order bound;
* ``scatter_add_ordered`` on CPU tensors against a Python loop, bitwise;
* a scan of the training path's sources: no float ``index_add_``
  outside ``scatter_add_ordered`` and the 0/1 hit counts.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu2048_torch.agent import td
from tpu2048_torch.config import AgentConfig, TrainConfig
from tpu2048_torch.draws import NumpyDraws
from tpu2048_torch.features.ntuple import feature_indices, get_tuple_set
from tpu2048_torch.ops import kernels
from tpu2048_torch.ops import onehot as oh

PORT = Path(__file__).resolve().parent.parent / "tpu2048_torch"
SHAPES = [(17, 256, 256), (52, 64, 64), (24, 16, 16)]


def _class_rows(ts, idx, seed):
    """(hi, lo, dw, valid, h, l) of the first 16^2..16^4 class at the
    (B, F) feature indices ``idx``, dw standard normal from ``seed``."""
    c = oh.build_table_classes(ts).matmul[0]
    hi, lo = oh._hi_lo(ts, idx, c)
    b = hi.shape[0]
    dw = torch.from_numpy(np.random.default_rng(seed).standard_normal(b)
                          .astype(np.float32))
    return hi, lo, dw, c.h, c.l


def _step_rows(kw: dict, steps: int, seed: int):
    """The train step's own rows at n=5 and 8192 envs, ``steps`` steps
    after a fresh start: ``prev_idx`` split into hi and lo, one row per
    image, with ``prev_valid``."""
    ts = get_tuple_set(5)
    acfg, tcfg = AgentConfig(**kw), TrainConfig(num_envs=8192)
    st = td.init_td_state(ts, acfg, tcfg, NumpyDraws(0, "cpu"), "cpu")
    step = td.make_train_step(ts, acfg, tcfg, NumpyDraws(1, "cpu"))
    for _ in range(steps):
        st = step(st)[0]
    hi, lo, dw, h, l = _class_rows(
        ts, st.prev_idx.reshape(-1, ts.num_feat), seed)
    valid = st.prev_valid[:, None].expand(-1, st.prev_idx.shape[1])
    return hi, lo, dw, valid.reshape(-1).clone(), h, l


def _midgame_rows(seed: int):
    """8192 mid-game-like boards at n=5 (each cell empty with
    probability 0.4, else an exponent 1 + a geometric count), through
    the port's own feature indices; a tenth of the rows invalid."""
    rng = np.random.default_rng(seed)
    cells = np.where(rng.random((8192, 16)) < 0.4, 0,
                     np.minimum(rng.geometric(0.3, (8192, 16)), 15))
    ts = get_tuple_set(5)
    idx = feature_indices(ts, torch.from_numpy(cells.astype(np.int8)))
    hi, lo, dw, h, l = _class_rows(ts, idx, seed)
    valid = torch.from_numpy(rng.random(8192) >= 0.1)
    return hi, lo, dw, valid, h, l


def _random_rows(g, h, l, b, seed, collide):
    rng = np.random.default_rng(seed)
    hi = rng.integers(0, h, (b, g)).astype(np.int32)
    lo = rng.integers(0, l, (b, g)).astype(np.int32)
    if collide:  # every row on one entry of each table
        hi[:] = lo[:] = 0
    dw = rng.standard_normal(b).astype(np.float32)
    valid = rng.random(b) < 0.5
    return [torch.from_numpy(a) for a in (hi, lo, dw, valid)] + [h, l]


# (label, rows) of the train step's distributions: a fresh start's
# (7,000-8,000 rows on one entry of a tuple), mid-game boards', and the
# "index" learner's 8 x 8192 images after two warm steps
ROWS = {
    "fresh": lambda: _step_rows({}, 1, 1),
    "midgame": lambda: _midgame_rows(2),
    "index_65536": lambda: _step_rows({"sym_impl": "index"}, 3, 3),
}


def _dyadic(b, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.integers(-40, 41, b) * 2.0**-12)
                            .astype(np.float32))


def _hold(hi, lo, dw, valid, h, l):
    """The ordered plan within the summation-order bound of the plain
    version, hits bitwise; the whole pair bitwise with dyadic dw."""
    got = kernels.grad_class_ordered(hi, lo, dw, valid, h, l)
    want = kernels.grad_class_reference(hi, lo, dw, valid, h, l)
    assert got.shape == want.shape and got.is_contiguous()
    assert torch.equal(got[1], want[1])
    mass = kernels.grad_class_reference(hi, lo, dw.abs(), valid, h, l)[0]
    assert bool(((got[0] - want[0]).abs()
                 <= 2.0**-23 * want[1] * mass).all())
    dy = _dyadic(hi.shape[0], hi.shape[0] + 7)
    assert torch.equal(kernels.grad_class_ordered(hi, lo, dy, valid, h, l),
                       kernels.grad_class_reference(hi, lo, dy, valid, h, l))


@pytest.mark.parametrize("rows", list(ROWS))
def test_grad_class_ordered_plan_on_the_step_rows(rows):
    hi, lo, dw, valid, h, l = ROWS[rows]()
    _hold(hi, lo, dw, valid, h, l)


@pytest.mark.parametrize("g,h,l", SHAPES)
@pytest.mark.parametrize("b", [1, 33, 1001, 3 * 1024 + 5])
@pytest.mark.parametrize("collide", [False, True])
def test_grad_class_ordered_plan_any_batch(g, h, l, b, collide):
    """Every class shape, one row, past one warp, ragged, past three
    tiles; random rows and every row on one entry."""
    _hold(*_random_rows(g, h, l, b, b + g, collide))


@pytest.mark.parametrize("rows", ["fresh", "midgame"])
def test_grad_class_order_is_the_stable_order_by_hi(rows):
    """The tile counts, the scan and the in-tile ranks place each
    tuple's valid rows in the stable order by hi: one place each, in
    row order within a bucket, at the bucket's offset."""
    hi, lo, _dw, valid, h, l = ROWS[rows]()
    pos, offsets, totals = kernels.grad_class_order(hi, lo, valid, h, l)
    for t in range(hi.shape[1]):
        live = (pos[:, t] >= 0).nonzero()[:, 0]
        assert torch.equal(live, valid.nonzero()[:, 0])
        order = torch.argsort(hi[live, t].long(), stable=True)
        want = torch.empty_like(live)
        want[order] = torch.arange(live.shape[0])
        assert torch.equal(pos[live, t], want)
        starts = offsets[t, :h, 0]
        assert torch.equal(starts, torch.searchsorted(
            hi[live, t][order].long().contiguous(), torch.arange(h)))
    assert torch.equal(totals, valid.sum().expand(hi.shape[1]))


def test_grad_class_ordered_flags_a_bad_index():
    hi, lo, dw, valid, _h, _l = _random_rows(3, 64, 64, 300, 5, False)
    valid[:2] = torch.tensor([False, True])
    hi[0] = -7  # an invalid row's indices are never used
    lo[1, 2] = 64
    dsum = kernels.grad_class_ordered(hi, lo, dw, valid, 64, 64)[0]
    assert bool(dsum[2, 0, 0].isnan()) and int(dsum.isnan().sum()) == 1


def test_grad_class_ordered_sums_a_bucket_in_its_fixed_shape():
    """One bucket of 6 chunks on one entry: six warps, one chunk each,
    each chunk's 32 terms from 0.0 in row order, the warps' sums from
    0.0 in warp order; the plain version adds the 192 terms in row
    order, which rounds otherwise."""
    b = 6 * 32
    x = np.random.default_rng(4).standard_normal(b).astype(np.float32)
    hi = torch.zeros((b, 1), dtype=torch.int32)
    got = kernels.grad_class_ordered(hi, hi.clone(), torch.from_numpy(x),
                                     torch.ones(b, dtype=torch.bool), 16, 16)
    want = np.float32(0.0)
    for chunk in x.reshape(6, 32):
        part = np.float32(0.0)
        for v in chunk:
            part = np.float32(part + v)
        want = np.float32(want + part)
    assert got[0, 0, 0, 0].item() == want and got[1, 0, 0, 0].item() == b


# -- cross_apply -------------------------------------------------------------


def _cross_inputs(seed, total=4096, m=20_000):
    rng = np.random.default_rng(seed)
    flat = np.where(rng.random(m) < 0.6, rng.integers(0, 8, m),
                    rng.integers(0, total, m))
    valid = rng.random(m) < 0.8
    per = np.where(valid, rng.standard_normal(m), 0.0).astype(np.float32)
    tables = [rng.standard_normal(total).astype(np.float32) for _ in range(2)]
    a = np.abs(rng.standard_normal(total)).astype(np.float32)
    a[:3] = 0.0  # a fresh entry's rate is 1
    return (torch.from_numpy(flat), torch.from_numpy(per),
            torch.from_numpy(valid), *map(torch.from_numpy, tables),
            torch.from_numpy(a))


def _cross_kernel_arithmetic(w, e, a, alpha, flat, per, valid, mean):
    """``csrc/cross_apply.cu``'s arithmetic in numpy loops: a stable
    sort; per window of 32 positions and entry, per and |per| summed in
    position order and the valid updates counted; per entry its windows'
    sums in window order, then the rule from its old E and A."""
    f = np.float32
    order = np.argsort(flat, kind="stable")
    key, p_s, v_s = flat[order], per[order], valid[order]
    sums = {}  # entry -> [P, Q, count], windows added in order
    for w0 in range(0, len(key), 32):
        groups = {}
        for j in range(w0, min(w0 + 32, len(key))):
            g = groups.setdefault(key[j], [f(0), f(0), 0])
            g[0] = f(g[0] + p_s[j])
            g[1] = f(g[1] + abs(p_s[j]))
            g[2] += int(v_s[j])
        for k, (gp, gq, gn) in groups.items():
            t = sums.setdefault(k, [f(0), f(0), 0])
            t[0], t[1], t[2] = f(t[0] + gp), f(t[1] + gq), t[2] + gn
    for k, (p, q, n) in sums.items():
        if mean:
            d = max(f(n), f(1))
            p, q = f(p / d), f(q / d)
        if e is None:
            w[k] = f(w[k] + p)
            continue
        rate = f(abs(e[k]) / max(a[k], f(1e-30))) if a[k] > 0 else f(1)
        w[k] = f(w[k] + f(f(alpha * rate) * p))
        e[k] = f(e[k] + p)
        a[k] = f(a[k] + q)


@pytest.mark.parametrize("tc", [True, False])
@pytest.mark.parametrize("mean", [True, False])
def test_cross_apply_ordered_is_its_kernels_arithmetic(tc, mean):
    """The plain PyTorch form of the kernel's order equals a loop over
    its windows and entries bit for bit; and it stays within the f32
    summation-order bound of the term-by-term plain version, the CPU's
    path, whose ``cross_apply`` launches nothing here."""
    flat, per, valid, w, e, a = _cross_inputs(int(tc) * 2 + int(mean))
    alpha = torch.tensor(0.37, dtype=torch.float32)
    empty = torch.zeros(0)

    def tables():
        return [w.clone(), e.clone() if tc else empty,
                a.clone() if tc else empty]

    loop = [t.numpy().copy() for t in (w, e, a)]
    _cross_kernel_arithmetic(loop[0], loop[1] if tc else None, loop[2],
                             np.float32(0.37), flat.numpy(), per.numpy(),
                             valid.numpy(), mean)
    got = tables()
    kernels.cross_apply_ordered(*got, alpha, flat, per, valid, mean)
    plain = tables()
    before = kernels.cross_apply.launches
    kernels.cross_apply(*plain, alpha, flat, per, valid, mean)
    assert kernels.cross_apply.launches == before  # CPU: the plain version
    want = tables()
    kernels.cross_apply_reference(*want, alpha, flat, per, valid, mean)
    mass = tables()  # each entry's sum of |terms|, from zero tables
    mass[0].zero_()
    kernels.cross_apply_reference(*mass, alpha, flat, per.abs(), valid, mean)
    terms = [mass[0]] + ([mass[2] - a] * 2 if tc else [])
    hits = torch.zeros(w.shape[0]).index_add_(0, flat, torch.ones(
        flat.shape[0]))
    for i in range(3 if tc else 1):
        np.testing.assert_array_equal(got[i].numpy(), loop[i])
        assert torch.equal(plain[i], want[i])
        bound = 2.0**-22 * (hits + 2) * (tables()[i].abs() + terms[i])
        assert bool(((got[i] - want[i]).abs() <= bound).all())


def test_cross_apply_checks_its_inputs():
    flat, per, valid, w, e, a = _cross_inputs(9, m=100)
    alpha = torch.tensor(0.5)
    with pytest.raises(TypeError):
        kernels.cross_apply(w, e, a, alpha, flat.int(), per, valid, True)
    with pytest.raises(TypeError):
        kernels.cross_apply(w, e[:-1], a, alpha, flat, per, valid, True)
    with pytest.raises(TypeError):
        kernels.cross_apply(w, e, a, alpha.double(), flat, per, valid, True)


# -- scatter_add_ordered -----------------------------------------------------


@pytest.mark.parametrize("m", [1, 1000, 1 << 17])
def test_scatter_add_ordered_on_cpu_is_a_loop(m):
    """On CPU tensors the ordered add is ``index_add_``, which walks the
    list: each entry's terms land in the list's order, as a loop adds
    them, on a heavily colliding non-dyadic list."""
    rng = np.random.default_rng(m)
    size = 1 << 12
    flat = np.where(rng.random(m) < 0.75, rng.integers(0, 16, m),
                    rng.integers(0, size, m))
    upd = rng.standard_normal(m).astype(np.float32)
    base = rng.standard_normal(size).astype(np.float32)
    want = base.copy()
    for i, v in zip(flat, upd):
        want[i] = np.float32(want[i] + v)
    got = torch.from_numpy(base.copy())
    kernels.scatter_add_ordered(got, torch.from_numpy(flat),
                                torch.from_numpy(upd))
    np.testing.assert_array_equal(got.numpy(), want)


# -- the training path's sources ----------------------------------------------

# the 0/1 counts a training path may add with index_add_: exact in any
# order, so their order does not matter
COUNTS = {"contrib", "valid.to(torch.float32)",
          "valid.to(torch.float32).reshape(-1)",
          "take.to(torch.float32).reshape(-1)"}


def _index_adds(path: Path):
    """(function, source argument) of each ``index_add_`` call in the
    file, the function the innermost ``def`` around it."""
    tree = ast.parse(path.read_text())
    found = []

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, child.name)
                continue
            if isinstance(child, ast.Call) and \
                    isinstance(child.func, ast.Attribute) and \
                    child.func.attr == "index_add_":
                found.append((fn, ast.unparse(child.args[2])))
            visit(child, fn)

    visit(tree, None)
    return found


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(PORT)) for p in [*PORT.glob("agent/*.py"),
                                       PORT / "ops" / "dispatch.py",
                                       PORT / "ops" / "kernels.py"]))
def test_no_float_index_add_on_the_training_path(path):
    """A float ``index_add_`` on a CUDA tensor adds colliding terms with
    atomics, in no fixed order: on a training path only
    ``scatter_add_ordered`` (on CPU tensors) and the 0/1 hit counts may
    call it."""
    for fn, source in _index_adds(PORT / path):
        assert fn == "scatter_add_ordered" or source in COUNTS, \
            f"{path}: index_add_ of {source} in {fn}"


def test_the_source_scan_sees_the_known_calls():
    """The scan finds the calls it allows, so an empty result above is
    not a scan that found nothing."""
    calls = _index_adds(PORT / "ops" / "dispatch.py")
    assert sum(source == "contrib" for _fn, source in calls) >= 3
    assert ("scatter_add_ordered", "upd") in \
        _index_adds(PORT / "ops" / "kernels.py")
