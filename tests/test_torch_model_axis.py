"""The mesh's model axis in the port (``tpu2048_torch/parallel/mesh.py``,
``ops/dispatch.py`` and ``agent/td.py`` under ``MeshConfig(model > 1)``)
on CPU: gloo ranks as subprocesses, each holding its shard of the weight
table and the TC sums.

The reference shards the table along its mesh's ``model`` axis and lets
GSPMD add the collectives (``tests/test_sharding.py``); the port asks for
them by hand, so its (data, model) segment is held against JAX's
single-device segment on the same start state and draws, and against the
port's own unmeshed segment: every integer of the state bitwise, the
tables within the tolerance each test states (bitwise where every sum is
exact), and every replica of a leaf bitwise equal to its peers' (the
worker asserts it).  Every subprocess test has its own time limit and
kills its ranks.
"""

import dataclasses
import json
import shutil

import numpy as np
import pytest
import torch
from _torch_dist_worker import (flat_state, record_draws, run_job,
                                run_workers, state_from_flat, train_job)
from _torch_port import (JaxTrainDraws, JaxTrainFns, assert_train_state,
                         fresh_state)
from test_torch_parallel import (JAX_CASES, TCFG_END, assert_same_run,
                                 make_job, near_terminal_flat, save_flat)

from tpu2048_torch.config import AgentConfig, TrainConfig, to_dict
from tpu2048_torch.features.ntuple import get_tuple_set
from tpu2048_torch.ops.onehot import build_table_classes
from tpu2048_torch.parallel import mesh as pmesh
from tpu2048_torch.store import checkpoint as ckpt
from tpu2048_torch.store.artifacts import LocalStore

# seconds for one job's ranks, then they are killed
LIMIT = 120


def model_job(tmp_path, data: int, model: int, job: dict,
              timeout: float = LIMIT) -> dict:
    """``job`` (``_torch_dist_worker.run_job``) on a (data, model) mesh
    of gloo ranks: the global state after it, as a flat dict, with rank
    0's collective counts under ``"counts"``."""
    tag = f"{data}x{model}_{len(list(tmp_path.iterdir()))}"
    out = tmp_path / f"out_{tag}"
    out.mkdir()
    path = tmp_path / f"job_{tag}.json"
    path.write_text(json.dumps({**job, "out": str(out), "model": model}))
    run_workers(tmp_path, data * model, "segment", str(path), timeout)
    with np.load(out / "state.npz") as z:
        res = dict(z)
    res["counts"] = json.loads((out / "counts.json").read_text())
    return res


def model_train(tmp_path, data: int, model: int, job: dict) -> None:
    """``train_job`` (a ``Trainer`` run and its checkpoint) on a (data,
    model) mesh of gloo ranks."""
    path = tmp_path / f"train_{len(list(tmp_path.iterdir()))}.json"
    path.write_text(json.dumps(job))
    run_workers(tmp_path, data * model, "model_trainer", f"{path},{model}",
                LIMIT)


# -- the shard layout, in this process ---------------------------------------

@pytest.mark.parametrize("n", [2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("model", [2, 4])
def test_table_layout_follows_its_rule(n, model):
    """Shards of whole tuple tables, disjoint and covering the table,
    each bound the tuple end nearest its share's (a kernel class that
    fits in one share whole on one rank), so each shard holds at most
    ``total / model`` plus one tuple table beyond the kernel class."""
    ts = get_tuple_set(n)
    bounds, feats = pmesh.table_layout(n, model)
    ends = [int(o) for o in ts.offsets] + [ts.total]
    assert bounds[0] == 0 and bounds[-1] == ts.total
    assert all(a < b for a, b in zip(bounds, bounds[1:]))
    assert [ends[f] for f in feats] == list(bounds)
    share = ts.total / model
    whole = [c for c in build_table_classes(ts).matmul
             if c.g * c.h * c.l <= share]
    for c in whole:
        owners = {pmesh.TableShard(0, bounds, feats).owner(f)
                  for f in range(c.feat0, c.feat0 + c.g)}
        assert len(owners) == 1, (c, owners)
    slack = max(int(s) for s in ts.sizes) + sum(c.g * c.h * c.l
                                                for c in whole)
    for m in range(model):
        sh = pmesh.TableShard(m, bounds, feats)
        assert sh.size <= share + slack, (m, sh.size, share)
        for c in build_table_classes(ts).matmul:
            a, b = sh.tuples(c.feat0, c.g)
            assert c.start + a * c.h * c.l >= sh.lo or a == b
            assert c.start + b * c.h * c.l <= sh.hi or a == b


def test_table_layout_at_the_paths_shapes():
    """n=4 (the whole table one class) splits 9/8 by tuples; n=6 keeps
    the class, the crosses and six 14^6 tables on rank 0 (50.5 M of the
    95.7 M entries)."""
    ts4, ts6 = get_tuple_set(4), get_tuple_set(6)
    assert pmesh.table_layout(4, 2) == ((0, 9 * 65536, ts4.total),
                                        (0, 9, 17))
    sh = pmesh.TableShard(1, *pmesh.table_layout(4, 2))
    assert sh.split(0, 17) and sh.tuples(0, 17) == (9, 17)
    assert sh.tuples(0, 17, 0) == (0, 9) and sh.owner(8) == 0
    bounds, feats = pmesh.table_layout(6, 2)
    assert feats == (0, 27, 33) and bounds[1] == 50_485_632
    sh = pmesh.TableShard(0, bounds, feats)
    assert not sh.split(0, 17) and sh.tuples(0, 17) == (0, 17)
    assert pmesh.TableShard(1, bounds, feats).tuples(0, 17) == (17, 17)
    assert bounds[2] - bounds[1] == ts6.total - 50_485_632
    with pytest.raises(ValueError, match="without a tuple"):
        pmesh.table_layout(4, 32)


@pytest.mark.parametrize("rank", range(4))
def test_shard_td_state_cuts_the_model_axis(rank):
    """On a (2, 2) mesh: the env leaves by the data rank's range, the
    tables by the model rank's shard, the rest whole; a mesh without a
    process group returns its input from every collective."""
    acfg = AgentConfig(n=4)
    tcfg = TrainConfig(num_envs=16, record_envs=6, max_record_steps=32,
                       ring_size=16)
    ts = get_tuple_set(4)
    from tpu2048_torch.agent import td
    from tpu2048_torch.draws import NumpyDraws

    full = td.init_td_state(ts, acfg, tcfg, NumpyDraws(1, "cpu"), "cpu")
    mesh = pmesh.Mesh(2, 2, rank, torch.device("cpu"))
    d, m = divmod(rank, 2)
    assert (mesh.data_rank, mesh.model_rank) == (d, m)
    sh = mesh.table_shard(ts)
    assert (sh.lo, sh.hi) == ((0, 9 * 65536) if m == 0
                              else (9 * 65536, ts.total))
    part = pmesh.shard_td_state(full, mesh, ts)
    specs = flat_state(pmesh.td_state_shardings(mesh, "codes"))
    whole, cut = flat_state(full), flat_state(part)
    rows = min(8, max(0, 6 - 8 * d))
    for name, spec in specs.items():
        want = {pmesh.DATA: lambda x: x[8 * d: 8 * d + 8],
                pmesh.RECORD: lambda x: x[8 * d: 8 * d + rows],
                pmesh.MODEL: lambda x: x[sh.lo: sh.hi],
                pmesh.REPLICATED: lambda x: x}[str(spec)](whole[name])
        np.testing.assert_array_equal(cut[name], want, err_msg=name)
    built = pmesh.init_sharded_td_state(ts, acfg, tcfg, mesh,
                                        NumpyDraws(1, "cpu"))
    for name, x in flat_state(built).items():
        np.testing.assert_array_equal(x, cut[name], err_msg=name)
    x = torch.arange(6.0)
    assert mesh.all_reduce(x, axis="model") is x
    assert mesh.all_gather(x, axis="model") is x
    assert mesh.all_gather_rows(x) == (x,)
    with pytest.raises(ValueError, match="axis"):
        mesh.all_reduce(x, axis="tensor")
    np.testing.assert_array_equal(
        pmesh.host_full(part.weights, mesh, pmesh.MODEL), cut["weights"])
    assert mesh.counts == {"all_reduce": 0, "all_gather": 0, "bytes": 0,
                           "model_all_reduce": 0, "model_all_gather": 0,
                           "model_bytes": 0}


# -- (data=2, model=2) against JAX's single-device segment ------------------

@pytest.mark.parametrize("case", list(JAX_CASES))
def test_model_axis_segment_matches_jax(case, tmp_path):
    """JAX's jitted single-device segment and the port's (2, 2) segment
    from one numpy start state and JAX's own draws.  Integers bitwise;
    weights within 1e-5 absolute under sgd (n=2, the class split by
    tuples) and 2^-17 relative under TC (n=5, the class whole)."""
    acfg, tcfg, segments = JAX_CASES[case]
    jaxfns = JaxTrainFns()
    seg = jaxfns.get(acfg, tcfg, "segment")
    js = fresh_state(acfg, tcfg, tcfg.seed)
    if case == "n5_tc":
        js = seg(js)  # valid previous afterstates and TC sums
    spawn, reset = record_draws(JaxTrainDraws(js.key),
                                segments * tcfg.steps_per_call, tcfg.num_envs)
    start = save_flat(tmp_path, "start", flat_state(js))
    draws = str(tmp_path / "draws.npz")
    np.savez(draws, spawn=spawn, reset=reset)
    for _ in range(segments):
        js = seg(js)
    got = model_job(tmp_path, 2, 2,
                    make_job(acfg, tcfg, segments, start, draws))
    st = state_from_flat(got)
    assert_train_state(st, js, tcfg)
    if acfg.optimizer == "sgd":
        np.testing.assert_allclose(st.weights, np.asarray(js.weights),
                                   rtol=0, atol=1e-5)
    assert got["counts"]["model_all_reduce"] > 0
    assert got["counts"]["all_reduce"] + got["counts"]["all_gather"] > 0


# -- against the port's world-1 run ------------------------------------------

WORLDS = [(1, 2), (2, 2), (1, 4)]


@pytest.mark.parametrize("n", [2, 5])
@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"{w[0]}x{w[1]}")
def test_model_axis_bitwise_with_dyadic_deltas(n, world, tmp_path):
    """Where every update is dyadic (weights and bootstrap values
    multiples of 2^-8, integer rewards, sgd with alpha / num_feat =
    2^-10, the "fold" learner's table-sized pair and D4 fold) every sum
    is exact in f32 in any order, so the meshed step's tables equal the
    unmeshed step's bit for bit: at n=2 the class split by tuples (its
    partial values added across ranks), at n=5 whole on one rank."""
    ts = get_tuple_set(n)
    acfg = AgentConfig(n=n, optimizer="sgd",
                       alpha=ts.num_feat * 2.0**-10, sym_impl="fold")
    tcfg = TrainConfig(num_envs=16, steps_per_call=4, ring_size=64,
                       max_record_steps=128, seed=2)
    mid = run_job(make_job(acfg, tcfg, 1))
    rng = np.random.default_rng(0)
    mid["weights"] = (rng.integers(0, 41, mid["weights"].shape) * 2.0**-8
                      ).astype(np.float32)
    mid["prev_value"] = (np.round(mid["prev_value"] * 256.0) / 256.0
                         ).astype(np.float32)
    assert mid["prev_valid"].all()
    one = dataclasses.replace(tcfg, steps_per_call=1)
    job = make_job(acfg, one, 1, save_flat(tmp_path, "mid", mid))
    want, got = run_job(job), model_job(tmp_path, *world, job)
    assert not np.array_equal(want["weights"], mid["weights"])
    np.testing.assert_array_equal(got["weights"], want["weights"])
    assert_same_run(got, want, one)


@pytest.mark.parametrize("world", [(1, 2), (1, 4)],
                         ids=lambda w: f"{w[0]}x{w[1]}")
def test_model_axis_defaults_bitwise_without_a_data_axis(world, tmp_path):
    """The shipped learner (canonical form, TC, bf16 actor) at n=5 for
    two segments from a fresh state: with one data rank no sum crosses
    ranks but the model group's, which adds exact zeros to each piece's
    one owner, so every leaf equals the unmeshed run's bit for bit."""
    acfg = AgentConfig(n=5)
    tcfg = TrainConfig(num_envs=16, steps_per_call=8, ring_size=64,
                       max_record_steps=128, seed=1)
    job = make_job(acfg, tcfg, 2)
    want, got = run_job(job), model_job(tmp_path, *world, job)
    assert int(want["metrics.episodes"]) >= 0
    for name, x in want.items():
        np.testing.assert_array_equal(got[name], x, err_msg=name)
    # per step: the selection's and the bootstrap's value all-reduces
    assert got["counts"]["model_all_reduce"] == 2 * 2 * tcfg.steps_per_call


OFF_DEFAULT = {
    # TC "index": the accumulator's grad_class on each rank's tuple range
    "tc_index": (4, dict(sym_impl="index", table_ops="pallas")),
    # the reference's own rule: the updater's grad_class on tuple ranges
    "sgd_index": (4, dict(optimizer="sgd", alpha=0.25, sym_impl="index",
                          table_ops="pallas")),
    # the shard-sized pair, all-gathered over the model group for its fold
    "sgd_fold": (4, dict(optimizer="sgd", alpha=0.25, sym_impl="fold")),
    # the projection across shards, at n=5, where the class lies whole on
    # one rank: a D4-symmetric table makes symmetric afterstates tie
    # exactly, and a class split by tuples would add their values in
    # another order and break the ties otherwise than the unmeshed run
    "tc_periodic": (5, dict(sym_mode="periodic")),
}


@pytest.mark.parametrize("name", list(OFF_DEFAULT))
def test_model_axis_off_default_learners(name, tmp_path):
    """Two segments from near-terminal boards, unmeshed and on (2, 2):
    integers bitwise, tables within 2^-17."""
    n, kw = OFF_DEFAULT[name]
    acfg = AgentConfig(n=n, **kw)
    tcfg = dataclasses.replace(TCFG_END, steps_per_call=24, record_envs=5)
    start = save_flat(tmp_path, "start", near_terminal_flat(acfg, tcfg, 7))
    job = make_job(acfg, tcfg, 2, start)
    want = run_job(job)
    assert int(want["metrics.episodes"]) > 0
    assert 0 < int(want["recorder.best_score"])
    assert_same_run(model_job(tmp_path, 2, 2, job), want, tcfg)


def test_model_axis_n6_motivating_case(tmp_path):
    """The twin of the reference's ``test_model_axis_n6_motivating_case``:
    n=6's 95.7 M-entry table cut four ways (sgd, "periodic", plain
    gathers), one segment of 16 envs x 4 steps on 4 ranks.  The shards
    are disjoint and cover the table, each holds at most total / 4 plus
    one tuple table, and the weights are finite after the segment."""
    ts = get_tuple_set(6)
    assert ts.total > 90_000_000
    bounds, _feats = pmesh.table_layout(6, 4)
    sizes = np.diff(bounds)
    assert bounds[0] == 0 and bounds[-1] == ts.total and (sizes > 0).all()
    assert sizes.max() <= ts.total / 4 + ts.sizes.max()
    acfg = AgentConfig(n=6, optimizer="sgd", alpha=0.25,
                       sym_mode="periodic", table_ops="gather")
    tcfg = TrainConfig(num_envs=16, steps_per_call=4, ring_size=32,
                       record_envs=1, max_record_steps=64, seed=0)
    got = model_job(tmp_path, 1, 4, make_job(acfg, tcfg, 1))
    w = got["weights"]
    assert w.shape == (ts.total,) and bool(np.isfinite(w).all())
    assert float(np.abs(w).sum()) > 0.0
    # one all-gather of the table per projection, on top of the step's
    assert got["counts"]["model_all_gather"] >= 1


# -- checkpoints ------------------------------------------------------------

def _ckpt(root, name):
    return ckpt.load_agent(LocalStore(str(root)), name)


def _job(root, name, acfg, tcfg, segments, resume):
    return {"store": str(root), "name": name, "acfg": to_dict(acfg),
            "tcfg": to_dict(tcfg), "segments": segments, "resume": resume}


def test_model_axis_checkpoint_equals_world_1s_and_loads_in_jax(tmp_path):
    """From one unsharded checkpoint of dyadic weights (sgd, "fold",
    alpha / num_feat = 2^-10, n=2: the class split by tuples), one
    resumed segment unmeshed and on (1, 2): ``Trainer.save`` of the
    sharded run equals the unmeshed run's checkpoint bitwise, loads in
    JAX's ``load_agent``, and resumes in an unmeshed run."""
    from tpu2048.store.artifacts import LocalStore as JaxLocalStore
    from tpu2048.store.checkpoint import load_agent as jax_load_agent

    ts = get_tuple_set(2)
    acfg = AgentConfig(n=2, optimizer="sgd", alpha=ts.num_feat * 2.0**-10,
                       sym_impl="fold")
    tcfg = TrainConfig(num_envs=16, steps_per_call=2, ring_size=64,
                       max_record_steps=128, episodes=10**6,
                       checkpoint_every=10**6, seed=3)
    start = (np.random.default_rng(1).integers(0, 41, ts.total) * 2.0**-8
             ).astype(np.float32)
    root = tmp_path / "start"
    ckpt.save_agent(LocalStore(str(root)), "dy", acfg, start)
    alone, meshed = tmp_path / "alone", tmp_path / "meshed"
    shutil.copytree(root, alone)
    shutil.copytree(root, meshed)
    train_job(_job(alone, "dy", acfg, tcfg, 1, True))
    model_train(tmp_path, 1, 2, _job(meshed, "dy", acfg, tcfg, 1, True))
    acfg_a, w_a, meta_a = _ckpt(alone, "dy")
    acfg_m, w_m, meta_m = _ckpt(meshed, "dy")
    assert acfg_m == acfg_a == acfg
    assert not np.array_equal(w_a, start)
    np.testing.assert_array_equal(w_m, w_a)
    for k in ("episodes", "top_score", "alpha", "next_decay"):
        assert meta_m[k] == meta_a[k], k
    np.testing.assert_array_equal(meta_m["extras"]["torch_rng_state"],
                                  meta_a["extras"]["torch_rng_state"])
    jacfg, jw, _meta = jax_load_agent(JaxLocalStore(str(meshed)), "dy")
    assert jacfg.n == 2 and jacfg.sym_impl == "fold"
    np.testing.assert_array_equal(np.asarray(jw), w_m)
    # the sharded run's checkpoint resumes unmeshed
    tr = train_job(_job(meshed, "dy", acfg, tcfg, 1, True))
    assert int(tr.state.metrics.episodes) >= meta_m["episodes"]
    assert tr.state.weights.shape == (ts.total,)


def test_model_axis_tc_checkpoints_cross_both_ways(tmp_path):
    """n=5, the shipped learner: a fresh (1, 2) run's checkpoint (the
    weights and both TC sums) equals the unmeshed run's bitwise; then
    an unmeshed checkpoint resumed on (1, 2) and unmeshed give the same
    checkpoint again."""
    acfg = AgentConfig(n=5)
    tcfg = TrainConfig(num_envs=16, steps_per_call=8, ring_size=64,
                       max_record_steps=128, episodes=10**6,
                       checkpoint_every=10**6, seed=5)
    alone, meshed = tmp_path / "alone", tmp_path / "meshed"
    train_job(_job(alone, "a", acfg, tcfg, 1, False))
    model_train(tmp_path, 1, 2, _job(meshed, "a", acfg, tcfg, 1, False))

    def same(what):
        _c, w_a, meta_a = _ckpt(alone, "a")
        _c, w_m, meta_m = _ckpt(meshed, "a")
        np.testing.assert_array_equal(w_m, w_a, err_msg=what)
        for k in ("opt_e", "opt_a"):
            np.testing.assert_array_equal(meta_m["extras"][k],
                                          meta_a["extras"][k], err_msg=what)
        assert meta_m["episodes"] == meta_a["episodes"], what
        return meta_a

    meta = same("fresh")
    assert float(np.abs(meta["extras"]["opt_a"]).sum()) > 0.0
    # resume the unmeshed checkpoint on (1, 2), and unmeshed
    shutil.rmtree(meshed)
    shutil.copytree(alone, meshed)
    model_train(tmp_path, 1, 2, _job(meshed, "a", acfg, tcfg, 1, True))
    train_job(_job(alone, "a", acfg, tcfg, 1, True))
    assert same("resumed")["episodes"] >= meta["episodes"]


def test_dryrun_multichip_takes_the_model_axis(capfd):
    """``dryrun_multichip(4)`` runs the reference's variant: its n=4
    pass on a (2, 2) mesh, the table sharded along the model axis."""
    import torch_graft_entry

    torch_graft_entry.dryrun_multichip(4)
    out = capfd.readouterr().out
    assert "dryrun_multichip OK: 4 gloo ranks on the CPU" in out
    assert "n=4 segment on a (2, 2) mesh OK" in out
