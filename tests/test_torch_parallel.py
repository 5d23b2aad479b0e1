"""Data-parallel training of the port (``tpu2048_torch/parallel``,
``agent/td.py`` under a mesh) on CPU: gloo ranks as subprocesses.

The reference's sharded segment is its single-device segment under
GSPMD (``tests/test_sharding.py``); the port computes that function by
hand, so its ranks' segment is held against JAX's single-device jitted
segment on the same start state and draws, and against the port's own
unmeshed segment: every integer of the state bitwise (boards, scores,
odometers, episodes, rings, logs, best game), the tables within the
tolerance each test states, and the ranks' replicas bitwise equal to
each other (the worker asserts it).  Every subprocess test has its own
time limit and kills its workers.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from _torch_dist_worker import (flat_state, record_draws, run_job,
                                run_workers, state_from_flat)
from _torch_port import (JaxTrainDraws, JaxTrainFns, assert_train_state,
                         fresh_state)

from tpu2048_torch.agent import td
from tpu2048_torch.config import (AgentConfig, MeshConfig, TrainConfig,
                                  to_dict)
from tpu2048_torch.draws import EnvSliceDraws, NumpyDraws
from tpu2048_torch.engine import fast as engf
from tpu2048_torch.features.ntuple import get_tuple_set
from tpu2048_torch.parallel import distributed
from tpu2048_torch.parallel import mesh as pmesh

def mesh_job(tmp_path, nprocs: int, job: dict) -> dict:
    """``job`` (``_torch_dist_worker.run_job``) on ``nprocs`` gloo
    ranks: the global state after it, as a flat dict, with the ranks'
    collective counts under ``"counts"``."""
    out = tmp_path / f"out_{nprocs}"
    out.mkdir()
    path = tmp_path / f"job_{nprocs}.json"
    path.write_text(json.dumps({**job, "out": str(out)}))
    run_workers(tmp_path, nprocs, "segment", str(path))
    with np.load(out / "state.npz") as z:
        res = dict(z)
    res["counts"] = json.loads((out / "counts.json").read_text())
    return res


def make_job(acfg, tcfg, segments=1, start=None, draws=None, **kw) -> dict:
    return {"acfg": to_dict(acfg), "tcfg": to_dict(tcfg),
            "segments": segments, "start": start, "draws": draws, **kw}


def save_flat(tmp_path, name: str, flat: dict) -> str:
    path = str(tmp_path / f"{name}.npz")
    np.savez(path, **flat)
    return path


def reference_layout(flat: dict, tcfg) -> dict:
    """A port state's flat dict without the logs' spill column and the
    rings' trash slot, which take the writes of lanes that record
    nothing, in no set order."""
    flat = {k: v for k, v in flat.items() if k != "counts"}
    s, ring = tcfg.max_record_steps, tcfg.ring_size
    for f in ("recorder.moves", "recorder.spawns"):
        flat[f] = flat[f][:, :s]
    for f in ("metrics.score_ring", "metrics.tile_ring"):
        flat[f] = flat[f][:ring]
    return flat


def assert_same_run(got: dict, want: dict, tcfg) -> None:
    """Two port runs' global states: integers bitwise, tables and
    bootstrap values within 2^-17 (``assert_train_state``)."""
    assert_train_state(state_from_flat(reference_layout(got, tcfg)),
                       state_from_flat(reference_layout(want, tcfg)), tcfg)


# -- two ranks against JAX's single-device segment ------------------------

JAX_CASES = {
    # the reference's own sharding case (tests/test_sharding.py:50-88)
    "n2_sgd": (AgentConfig(n=2, optimizer="sgd", alpha=0.25),
               TrainConfig(num_envs=64, steps_per_call=8, ring_size=256,
                           record_envs=2, max_record_steps=256, seed=3), 2),
    # the shipped learner: canonical form, TC, bf16 actor, all recorded
    "n5_tc": (AgentConfig(n=5),
              TrainConfig(num_envs=32, steps_per_call=8, ring_size=64,
                          max_record_steps=256, seed=0), 1),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_two_rank_segment_matches_jax(case, tmp_path):
    """JAX's jitted single-device segment and the port's 2-rank segment
    from one numpy start state and JAX's own draws, cut per rank.
    Integers bitwise; weights within 1e-5 absolute under sgd (the
    reference's own bound between its sharded and single-device runs)
    and 2^-17 relative under TC, one segment (``assert_train_state``)."""
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
    got = mesh_job(tmp_path, 2, make_job(acfg, tcfg, segments, start, draws))
    st = state_from_flat(got)
    assert_train_state(st, js, tcfg)
    if acfg.optimizer == "sgd":
        np.testing.assert_allclose(st.weights, np.asarray(js.weights),
                                   rtol=0, atol=1e-5)
    assert got["counts"]["all_gather"] > 0


# -- world 1, 2 and 4 of the port -----------------------------------------

def near_terminal_flat(acfg, tcfg, seed: int) -> dict:
    """A fresh port state (flat) whose boards are one or two moves from
    game over: checkerboards of two tile values with one or two holes;
    every other env is 10 moves past the record limit, so its log
    overflows."""
    ts = get_tuple_set(acfg.n)
    st = td.init_td_state(ts, acfg, tcfg, NumpyDraws(seed, "cpu"), "cpu")
    rng = np.random.default_rng(seed)
    m = tcfg.num_envs
    a = rng.integers(1, 7, m)[:, None, None]
    boards = np.where((np.add.outer(np.arange(4), np.arange(4)) % 2) == 0,
                      a, a + 1).astype(np.int8)
    for b in boards:
        b.reshape(16)[rng.choice(16, rng.integers(1, 3), replace=False)] = 0
    boards = torch.from_numpy(boards)
    odo = torch.from_numpy(np.where(np.arange(m) % 2 == 0, 0,
                                    tcfg.max_record_steps + 10
                                    ).astype(np.int32))
    if acfg.engine_mode == "codes":
        env = st.env._replace(codes=engf.codes_from_boards(boards),
                              odometer=odo)
    else:
        env = st.env._replace(boards=boards, odometer=odo)
    r_env = st.recorder.starts.shape[0]
    return flat_state(st._replace(env=env, recorder=st.recorder._replace(
        starts=boards[:r_env].clone())))


TCFG_END = TrainConfig(num_envs=8, steps_per_call=120, ring_size=64,
                       max_record_steps=64, seed=0)


@pytest.mark.parametrize("record_envs,seed,worlds,again", [
    (3, 5, (2, 4), True), (-1, 3, (2, 4), False), (-1, 6, (4,), True)])
def test_world_1_2_4_agree(record_envs, seed, worlds, again, tmp_path):
    """One long segment from near-terminal boards (episodes end, reset
    and end again inside it: both sources of the best game, the
    overflow flag) unmeshed and on 2 and 4 ranks, with ``record_envs``
    below ``num_envs`` (some ranks record fewer envs, some none) and
    equal to it: integers bitwise, tables within 2^-17.  From seeds 3
    and 6 the best game is played on a later rank than the first; where
    ``again``, some env's second game ends inside the segment too."""
    acfg = AgentConfig(n=4)
    tcfg = dataclasses.replace(TCFG_END, record_envs=record_envs)
    start = save_flat(tmp_path, "start",
                      near_terminal_flat(acfg, tcfg, seed))
    job = make_job(acfg, tcfg, 1, start)
    want = run_job(job)
    assert (int(want["metrics.episodes"]) > tcfg.num_envs) == again
    assert 0 < int(want["recorder.best_score"])
    assert bool(want["recorder.overflow"].any())
    for world in worlds:
        assert_same_run(mesh_job(tmp_path, world, job), want, tcfg)


def _candidate(score: int, fill: int, length: int = 5) -> td._BestGame:
    i8 = torch.int8
    return td._BestGame(
        score=torch.tensor(score, dtype=torch.int32),
        moves=torch.full((16,), fill, dtype=i8),
        spawns=torch.full((16,), fill + 1, dtype=i8),
        start=torch.full((4, 4), fill + 2, dtype=i8),
        length=torch.tensor(length, dtype=torch.int32))


@pytest.mark.parametrize("ranks,winner", [
    # (score, order) per rank; order K = a first completion, K-1-k = an
    # in-segment game that ended at step k (K = 8 here)
    ([(10, 8), (30, 8), (20, 8)], 1),  # the largest score
    ([(30, 7), (30, 8), (30, 3)], 1),  # a first completion beats in-segment
    ([(30, 2), (30, 6), (30, 6)], 1),  # the earlier step, then the lower rank
    ([(-1, 0), (-1, 0)], 0),  # no candidate anywhere
    ([(5, 8), (-1, 0), (5, 8)], 0),  # first maximum in env order
])
def test_global_best_picks_the_single_devices_game(ranks, winner):
    """``_global_best`` over hand-made candidates, the gather played by
    a stand-in: each rank's packed row is recorded, then every rank is
    handed all rows."""
    class Gather:
        rows = None

        def __init__(self):
            self.seen = []

        def all_gather(self, x):
            self.seen.append(x)
            return x if self.rows is None else self.rows

    cands = [_candidate(s, 10 * r) for r, (s, _) in enumerate(ranks)]
    orders = [torch.tensor(o, dtype=torch.int32) for _, o in ranks]
    record = Gather()
    for c, o in zip(cands, orders):
        got = td._global_best(record, c, o, span=9)
        for a, b in zip(got, c):  # alone, a rank gets its own candidate
            assert torch.equal(a, b)
    replay = Gather()
    replay.rows = torch.cat(record.seen)
    for c, o in zip(cands, orders):
        got = td._global_best(replay, c, o, span=9)
        for a, b in zip(got, cands[winner]):
            assert torch.equal(a, b) and a.dtype == b.dtype


# -- dyadic deltas: bitwise tables -----------------------------------------

def test_two_rank_tables_bitwise_with_dyadic_deltas(tmp_path):
    """Where every update is dyadic (weights and bootstrap values
    multiples of 2^-8, integer rewards, sgd with alpha / num_feat =
    2^-10) each sum over envs is exact in f32 in any order, so the
    2-rank step's tables equal the unmeshed step's bit for bit.  (The
    ranks' replicas are bitwise equal in every test of this file.)"""
    acfg = AgentConfig(n=4, optimizer="sgd", alpha=17 * 2.0**-10,
                       sym_impl="fold")
    tcfg = TrainConfig(num_envs=16, steps_per_call=4, ring_size=64,
                       max_record_steps=128, seed=2)
    assert get_tuple_set(4).num_feat == 17
    mid = run_job(make_job(acfg, tcfg, 1))
    rng = np.random.default_rng(0)
    mid["weights"] = (rng.integers(0, 41, mid["weights"].shape) * 2.0**-8
                      ).astype(np.float32)
    mid["prev_value"] = (np.round(mid["prev_value"] * 256.0) / 256.0
                         ).astype(np.float32)
    assert mid["prev_valid"].all()
    one = dataclasses.replace(tcfg, steps_per_call=1)
    job = make_job(acfg, one, 1, save_flat(tmp_path, "mid", mid))
    want, got = run_job(job), mesh_job(tmp_path, 2, job)
    assert not np.array_equal(want["weights"], mid["weights"])
    np.testing.assert_array_equal(got["weights"], want["weights"])
    assert_same_run(got, want, one)


# -- learners off the defaults under two ranks -----------------------------

OFF_DEFAULT = {
    # the table-sized pair is all-reduced before the D4 fold
    "tc_fold": (dict(sym_impl="fold"), {}),
    # the reference's own rule: the updater's rows are all-gathered
    "sgd_index": (dict(optimizer="sgd", alpha=0.25, sym_impl="index"), {}),
    # the same through the kernels' wrappers: class pairs all-reduced
    "sgd_index_pallas": (dict(optimizer="sgd", alpha=0.25, sym_impl="index",
                              table_ops="pallas"), {}),
    "sgd_canonical_sum": (dict(optimizer="sgd", alpha=2.0**-6,
                               update_mode="sum"), {}),
    "tc_periodic": (dict(sym_mode="periodic"), {}),
    # the cells engine's unstaged step: the best game kept every step
    "cells_unstaged": (dict(engine_mode="cells"), dict(staged=False)),
}


@pytest.mark.parametrize("name", list(OFF_DEFAULT))
def test_off_default_learners_on_two_ranks(name, tmp_path):
    """Two segments at n=4 from near-terminal boards, unmeshed and on 2
    ranks: integers bitwise, tables within 2^-17."""
    kw, job_kw = OFF_DEFAULT[name]
    acfg = AgentConfig(n=4, **kw)
    tcfg = dataclasses.replace(TCFG_END, steps_per_call=24, record_envs=5)
    start = save_flat(tmp_path, "start", near_terminal_flat(acfg, tcfg, 7))
    job = make_job(acfg, tcfg, 2, start, **job_kw)
    want = run_job(job)
    assert int(want["metrics.episodes"]) > 0
    assert 0 < int(want["recorder.best_score"])
    assert_same_run(mesh_job(tmp_path, 2, job), want, tcfg)


# -- the mesh's parts, in this process ---------------------------------------

def test_initialize_without_a_coordinator_is_a_noop(monkeypatch):
    for var in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    assert not torch.distributed.is_initialized()
    m = distributed.global_mesh(device="cpu")
    assert (m.data, m.model, m.rank, m.group) == (1, 1, 0, None)
    s = distributed.process_env_slice(128)
    assert (s.start, s.stop) == (0, 128)
    # a coordinator alone is not enough, from the environment either
    monkeypatch.setenv("COORDINATOR_ADDRESS", "localhost:1")
    with pytest.raises(ValueError, match="NUM_PROCESSES"):
        distributed.initialize(device="cpu")
    assert not torch.distributed.is_initialized()


def test_model_axis_and_foreign_sizes_raise():
    # data * model must be the number of processes up (here one)
    for cfg in (MeshConfig(data=1, model=2), MeshConfig(data=2, model=2)):
        with pytest.raises(ValueError, match="one process drives one device"):
            pmesh.make_mesh(cfg, device="cpu")
    # a model axis of a process without a group: its collectives return
    # their input, and it counts the model axis apart
    mesh = pmesh.Mesh(1, 2, 1, torch.device("cpu"))
    assert (mesh.data_rank, mesh.model_rank) == (0, 1)
    x = torch.arange(4.0)
    for axis in ("data", "model"):
        assert mesh.all_reduce(x, axis=axis) is x
        assert mesh.all_gather(x, axis=axis) is x
    assert set(mesh.counts) == {"all_reduce", "all_gather", "bytes",
                                "model_all_reduce", "model_all_gather",
                                "model_bytes"}
    assert not any(mesh.counts.values())
    with pytest.raises(ValueError, match="one process drives one device"):
        pmesh.make_mesh(MeshConfig(data=2, model=1), device="cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        pmesh.make_mesh()  # no card here, and the CPU was not asked for


def test_num_envs_must_divide_by_the_data_axis():
    from tpu2048_torch.obs.logging import Logger
    from tpu2048_torch.train.loop import Trainer

    mesh = pmesh.Mesh(3, 1, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="does not divide"):
        Trainer("x", AgentConfig(n=2), TrainConfig(num_envs=16), mesh=mesh,
                logger=Logger(console=False))
    with pytest.raises(ValueError, match="the mesh runs on cpu"):
        Trainer("x", AgentConfig(n=2), TrainConfig(num_envs=15), mesh=mesh,
                device="cuda")


@pytest.mark.parametrize("rank,rows", [(0, 4), (1, 2), (2, 0), (3, 0)])
def test_shard_td_state_cuts_this_ranks_share(rank, rows):
    """Per-env leaves by env range, the logs by the recorded envs in
    that range, everything else whole (``td_state_shardings``)."""
    acfg = AgentConfig(n=2)
    tcfg = TrainConfig(num_envs=16, record_envs=6, max_record_steps=32,
                       ring_size=16)
    ts = get_tuple_set(2)
    full = td.init_td_state(ts, acfg, tcfg, NumpyDraws(1, "cpu"), "cpu")
    mesh = pmesh.Mesh(4, 1, rank, torch.device("cpu"))
    assert mesh.env_slice(16) == slice(4 * rank, 4 * rank + 4)
    part = pmesh.shard_td_state(full, mesh, ts)
    specs = flat_state(pmesh.td_state_shardings(mesh, "codes"))
    whole, cut = flat_state(full), flat_state(part)
    assert set(specs) == set(whole)
    for name, spec in specs.items():
        lo = 4 * rank
        want = {pmesh.DATA: whole[name][lo: lo + 4] if whole[name].ndim
                else None,
                pmesh.RECORD: whole[name][lo: lo + rows] if whole[name].ndim
                else None,
                pmesh.REPLICATED: whole[name]}[str(spec)]
        np.testing.assert_array_equal(cut[name], want, err_msg=name)
    # built in place, the share is the same (every rank seeds alike)
    built = pmesh.init_sharded_td_state(ts, acfg, tcfg, mesh,
                                        NumpyDraws(1, "cpu"))
    for name, x in flat_state(built).items():
        np.testing.assert_array_equal(x, cut[name], err_msg=name)
    # a replicated leaf is read with no collective, with or without mesh
    np.testing.assert_array_equal(pmesh.host_full(part.weights, mesh),
                                  whole["weights"])
    placed = pmesh.replicate_to_mesh(whole["weights"], mesh)
    assert torch.equal(placed, part.weights) and placed.device == mesh.device
    assert mesh.counts == {"all_reduce": 0, "all_gather": 0, "bytes": 0}


def test_env_slice_draws_are_the_global_batchs():
    """Two ranks' draws, joined, are the draws of one rank alone, and
    both sources advance alike."""
    alone = NumpyDraws(3, "cpu")
    ranks = [EnvSliceDraws(NumpyDraws(3, "cpu"), r, 2) for r in range(2)]
    w = alone.uniform((5,))
    for r in ranks:
        assert torch.equal(r.uniform((5,)), w)
    for site in ("new", "spawn", "reset"):
        want = getattr(alone, site)(8)
        parts = [getattr(r, site)(4) for r in ranks]
        for i, x in enumerate(want):
            assert torch.equal(torch.cat([p[i] for p in parts]), x), site
    assert torch.equal(ranks[0].inner.uniform((3,)), alone.uniform((3,)))


def test_a_mesh_of_one_process_changes_nothing():
    """``Trainer(mesh=...)`` with no process group up: the unmeshed
    run's state, bit for bit, and no collective."""
    from tpu2048_torch.obs.logging import Logger
    from tpu2048_torch.train.loop import Trainer

    acfg = AgentConfig(n=2)
    tcfg = TrainConfig(num_envs=8, steps_per_call=8, ring_size=64,
                       max_record_steps=256, episodes=10, seed=4)
    mesh = distributed.global_mesh(MeshConfig(1, 1), device="cpu")
    a = Trainer("a", acfg, tcfg, logger=Logger(console=False), mesh=mesh)
    b = Trainer("b", acfg, tcfg, logger=Logger(console=False), device="cpu")
    assert a.run()["episodes"] == b.run()["episodes"] >= 10
    for (name, x), y in zip(flat_state(a.state).items(),
                            flat_state(b.state).values()):
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert mesh.counts == {"all_reduce": 0, "all_gather": 0, "bytes": 0}
