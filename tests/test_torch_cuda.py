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


VARIANTS = {
    "sgd_fold": dict(optimizer="sgd", alpha=0.25, sym_impl="fold"),
    "tc_index": dict(sym_impl="index"),
    "sgd_index_sum": dict(optimizer="sgd", alpha=2.0**-10, sym_impl="index",
                          update_mode="sum"),
    "sgd_canonical": dict(optimizer="sgd", alpha=0.25),
    "tc_canonical_sum": dict(alpha=2.0**-4, update_mode="sum"),
    "bf16x2_actor": dict(actor_precision="bf16x2"),
    "cells": dict(engine_mode="cells"),
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_train_step_card_matches_cpu_plain(name):
    """The learner settings off the defaults at n=5, one step each, as
    ``chip_smoke.py`` phase 10 holds them at 8192 envs: integers
    bitwise, tables within 2^-17 of the largest entry plus each entry's
    summation-order bound; ``grad_class`` once, ``fold_class`` on the
    canonical form only."""
    needs_card()
    from chip_smoke import _card_step_against_cpu, _hold_states

    tcfg = TrainConfig(num_envs=1024, ring_size=256, max_record_steps=256)
    acfg = AgentConfig(table_ops="pallas", **VARIANTS[name])
    card, plain, slack, launches = _card_step_against_cpu(acfg, tcfg)
    _hold_states(card, plain, name, slack)
    bootstrap = acfg.actor_precision == "bf16" and acfg.engine_mode == "codes"
    assert launches == {"eval_class": 1 + bootstrap, "grad_class": 1,
                        "fold_class": int(acfg.sym_impl == "canonical")}


class _StopAfter:
    """A job that lets the trainer run ``n`` segments."""

    def __init__(self, n):
        self.left = n

    def should_stop(self):
        self.left -= 1
        return self.left < 0


def test_checkpoint_resumes_on_the_other_device_type():
    """An agent trained on the card resumes on the CPU with a fresh
    stream (logged), and on the card with its stream continued; the
    CPU's checkpoint resumes on the card the same way."""
    dev = needs_card()
    from tpu2048_torch.obs.logging import Logger
    from tpu2048_torch.store.artifacts import MemoryStore
    from tpu2048_torch.train.loop import Trainer

    acfg = AgentConfig(n=4, optimizer="sgd", alpha=0.25, sym_impl="index")
    tcfg = TrainConfig(num_envs=256, steps_per_call=8)
    store = MemoryStore()
    for saved_on, other in ((dev, "cpu"), ("cpu", dev)):
        tr = Trainer("x", acfg, tcfg, store=store,
                     logger=Logger(console=False), device=saved_on)
        tr.run(job=_StopAfter(1))
        log = Logger(store=MemoryStore(), console=False)
        again = Trainer("x", acfg, tcfg, store=store, logger=log,
                        resume=True, device=other)
        assert torch.equal(again.state.weights.cpu(), tr.state.weights.cpu())
        assert torch.equal(again.state.alpha.cpu(), tr.state.alpha.cpu())
        assert "a fresh stream from seed" in log.tail()
        same = Trainer("x", acfg, tcfg, store=store,
                       logger=Logger(console=False), resume=True,
                       device=saved_on)
        assert torch.equal(same.draws.generator.get_state(),
                           tr.draws.generator.get_state())
        again.run(job=_StopAfter(1))  # and saves from the other type
        assert bool(torch.isfinite(again.state.weights).all())


@pytest.fixture
def nccl_mesh():
    """A mesh of this process alone through NCCL, from an explicit
    coordinator on localhost; the process group is taken down after
    the test."""
    import socket

    needs_card()
    from tpu2048_torch.config import MeshConfig
    from tpu2048_torch.parallel import distributed

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    assert distributed.initialize(f"localhost:{port}", 1, 0)
    try:
        assert torch.distributed.get_backend() == "nccl"
        yield distributed.global_mesh(MeshConfig(data=1, model=1))
    finally:
        torch.distributed.destroy_process_group()


def test_world_one_nccl_trainer_equals_the_unmeshed_one(nccl_mesh):
    """One step of 1024 envs through the mesh on the card equals the
    unmeshed CPU step (integers bitwise, tables within 2^-17 of the
    largest entry plus each entry's summation-order bound), and one
    segment of ``Trainer(mesh=...)`` at 64 envs equals the unmeshed
    trainer's from the same seed: integers bitwise, tables within
    2^-17 (at full width the card's atomics and temporal coherence let
    whole runs part, so runs are held at a small width and steps at
    any)."""
    from chip_smoke import _card_step_against_cpu, _flat, _hold_states
    from tpu2048_torch.obs.logging import Logger
    from tpu2048_torch.train.loop import Trainer

    mesh = nccl_mesh
    tcfg = TrainConfig(num_envs=1024, ring_size=256, max_record_steps=256)
    card, plain, slack, launches = _card_step_against_cpu(
        AgentConfig(table_ops="pallas"), tcfg, mesh=mesh)
    _hold_states(card, plain, "mesh step", slack)
    assert launches == {"eval_class": 2, "grad_class": 1, "fold_class": 1}
    assert mesh.counts["all_reduce"] == 1 and mesh.counts["all_gather"] == 2

    tcfg = TrainConfig(num_envs=64, steps_per_call=8, ring_size=64,
                       max_record_steps=256, seed=15)
    states = []
    for m in (mesh, None):
        tr = Trainer("w1", AgentConfig(), tcfg, logger=Logger(console=False),
                     mesh=m, device="cuda")
        tr.run(job=_StopAfter(1))
        states.append(_flat(tr.state))
    for name, want in states[1].items():
        got = states[0][name]
        if name in ("weights", "opt_e", "opt_a", "prev_value"):
            assert np.abs(got - want).max() <= 2.0**-17 * np.abs(want).max()
        elif name in ("recorder.moves", "recorder.spawns"):
            np.testing.assert_array_equal(got[:, :-1], want[:, :-1], name)
        elif name in ("metrics.score_ring", "metrics.tile_ring"):
            np.testing.assert_array_equal(got[:-1], want[:-1], name)
        else:
            np.testing.assert_array_equal(got, want, name)


def test_fixed_order_apply_is_bitwise_repeatable():
    """``scatter_add_ordered`` (the mesh path's sparse apply) on a
    non-dyadic, heavily colliding list gives the same bits every time,
    within ``index_add_``'s summation-order bound of it."""
    dev = needs_card()
    from tpu2048_torch.ops.dispatch import scatter_add_ordered

    rng = np.random.default_rng(0)
    size, m = 1 << 18, 1 << 17
    flat = torch.from_numpy(np.where(rng.random(m) < 0.75,
                                     rng.integers(0, 16, m),
                                     rng.integers(0, size, m))).to(dev)
    upd = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(dev)
    base = torch.from_numpy(rng.standard_normal(size).astype(np.float32)
                            ).to(dev)
    outs = []
    for _ in range(3):
        t = base.clone()
        scatter_add_ordered(t, flat, upd)
        outs.append(t)
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    atomic = base.clone().index_add_(0, flat, upd)
    mass = torch.zeros(size, device=dev).index_add_(0, flat, upd.abs())
    hits = torch.zeros(size, device=dev).index_add_(
        0, flat, torch.ones(m, device=dev))
    bound = 2.0**-23 * (hits + 1.0) * (mass + base.abs())
    assert bool(((outs[0] - atomic).abs() <= bound).all())


def test_app_service_test_job_on_the_card():
    """An ``AppService`` with no device argument takes the card: its
    test job plays through ``eval_class`` there, and the service's
    telemetry reads the card's memory."""
    dev = needs_card()
    from tpu2048_torch.apps.service import AppService
    from tpu2048_torch.features.ntuple import init_weights
    from tpu2048_torch.obs import telemetry
    from tpu2048_torch.store.artifacts import MemoryStore
    from tpu2048_torch.store.checkpoint import save_agent

    gen = torch.Generator()
    gen.manual_seed(0)
    store = MemoryStore()
    save_agent(store, "a", AgentConfig(),
               init_weights(get_tuple_set(5), gen).numpy(), {"episodes": 0})
    svc = AppService(store)
    assert svc.device.type == dev.type
    before = kernels.eval_class.launches
    r = svc.start_test("a", num=64)
    job = svc.jobs.get("test", "a")
    job.thread.join(timeout=300)
    assert not job.alive and job.error is None, job.error
    assert kernels.eval_class.launches > before
    assert "average score of 64 runs" in svc.logs(r["log"])
    stats = telemetry.device_memory_stats()
    assert stats["device"] == torch.cuda.get_device_name()
    assert 0 < stats["bytes_in_use"] <= stats["peak_bytes_in_use"]
    assert stats["bytes_limit"] == torch.cuda.get_device_properties(
        dev).total_memory
    now = svc.system_stats()["now"]
    assert now["hbm_in_use_mb"] > 0 and now["device"] == stats["device"]


def test_device_trace_records_the_cards_kernels(tmp_path):
    """``device_trace`` on the card records the CUDA kernels it ran, the
    hand-written ones by name, in a Chrome trace."""
    import json

    from tpu2048_torch.obs.profiler import device_trace

    dev = needs_card()
    tables, hi, lo = _inputs(17, 256, 256, 8192, seed=5, dev=dev)
    with device_trace(str(tmp_path)):
        kernels.eval_class(tables, hi, lo, "bf16")
        torch.cuda.synchronize()
    (path,) = tmp_path.glob("*.pt.trace.json")
    names = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
             if e.get("cat") == "kernel"]
    assert sum("eval_class_kernel" in n for n in names) == 1, names


def test_model_axis_two_gloo_ranks_on_one_card(tmp_path):
    """Two ranks of a (1, 2) mesh share the card over gloo at n=4, where
    the 16^4 class is split 9/8 by tuples: one train step of 1024 envs
    against the unmeshed CPU step (integers bitwise, the tables read
    back whole within 2^-17 of max plus each entry's summation-order
    bound), and each rank's tuple range through ``eval_class`` (bitwise
    its ordered sum) and ``grad_class`` (hits bitwise, dsum within
    hits * 2^-23 * sum |dw|) against their plain versions."""
    needs_card()
    from _torch_dist_worker import run_workers

    run_workers(tmp_path, 2, "card_model", "4", timeout=300)
