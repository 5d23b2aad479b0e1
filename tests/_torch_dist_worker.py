"""Worker process of the port's multi-process tests, and the helpers
the tests share with it (this module imports no jax: the worker
asserts that a run loaded none).

Launched by ``tests/test_torch_parallel.py`` as one of ``nprocs`` CPU
processes that meet through ``tpu2048_torch.parallel.distributed``
(gloo, a ``file://`` rendezvous), or alone for the fault test.

Usage:
  python tests/_torch_dist_worker.py <rendezvous> <nprocs> <rank> \
      segment <job.json>
  python tests/_torch_dist_worker.py <rendezvous> <nprocs> <rank> \
      trainer <store_dir>
  python tests/_torch_dist_worker.py <rendezvous> <nprocs> <rank> \
      model_trainer <job.json>,<model>
  python tests/_torch_dist_worker.py <rendezvous> <nprocs> <rank> \
      card_model <n>
  python tests/_torch_dist_worker.py fault <store_dir> <fresh|resume>

``segment`` runs a job (``run_job``) on the mesh, a (data, model) mesh
when the job names its ``model`` axis, and rank 0 writes the global
state after it (``<out>/state.npz``); ``trainer`` runs the full
``Trainer`` loop, a checkpoint and a resume in every rank;
``model_trainer`` runs a ``Trainer`` job (``train_job``) on a mesh of
``nprocs / model`` x ``model`` ranks; ``card_model`` runs the
model-axis checks on ranks that share one CUDA card (``run_card_model``);
``fault``
trains under a lease until killed, or resumes.  Each prints
``<MODE>_OK <rank>`` on success.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, ".")

import numpy as np  # noqa: E402
import torch  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.abspath(__file__)
# a deadlocked collective must not outlive its test
TIMEOUT = 300


def run_workers(tmp_path, nprocs: int, mode: str, arg: str,
                timeout: float = TIMEOUT) -> list:
    """Start ``nprocs`` worker ranks that meet at a ``file://``
    rendezvous under ``tmp_path`` (no port to collide on), wait for
    them within ``timeout`` seconds in all, kill what is left, and
    check each rank's exit code and its ``<MODE>_OK <rank>`` line."""
    rendezvous = f"file://{tmp_path}/rendezvous_{nprocs}_{time.time_ns()}"
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, rendezvous, str(nprocs), str(i), mode,
             arg],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for i in range(nprocs)
    ]
    outs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out}"
        assert f"{mode.upper()}_OK {i}" in out, f"rank {i} output:\n{out}"
    return outs


# -- states as flat dicts of numpy arrays -------------------------------------

def flat_state(state) -> dict:
    """A train state of either package (nested NamedTuples of arrays)
    as {"env.codes": array, ...}; the reference's RNG key is left out."""
    out = {}
    for f in state._fields:
        x = getattr(state, f)
        if f == "key":
            continue
        if hasattr(x, "_fields"):
            out.update({f"{f}.{g}": _arr(getattr(x, g)) for g in x._fields})
        else:
            out[f] = _arr(x)
    return out


def _arr(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def state_from_flat(flat: dict):
    """The port's ``TDState`` of numpy arrays from ``flat_state``'s
    dict (of either package's state)."""
    from tpu2048_torch.agent import td
    from tpu2048_torch.engine.core import EnvState
    from tpu2048_torch.engine.fast import EnvStateC

    def group(cls, name):
        return cls(**{f: flat[f"{name}.{f}"] for f in cls._fields})

    env_cls = EnvStateC if "env.codes" in flat else EnvState
    return td.TDState(**{
        f: (group(env_cls, f) if f == "env" else
            group(td.Metrics, f) if f == "metrics" else
            group(td.Recorder, f) if f == "recorder" else flat[f])
        for f in td.TDState._fields})


class ReplayDraws:
    """A draw source that replays recorded draws of the global batch:
    ``spawn`` (steps, 2, N) and ``reset`` (steps, 4, N) arrays, one row
    per train step (``record_draws`` makes them from any source)."""

    def __init__(self, spawn: np.ndarray, reset: np.ndarray):
        self._spawn, self._reset, self.step = spawn, reset, -1

    def split(self) -> None:
        self.step += 1

    def spawn(self, n: int):
        u, v = self._spawn[self.step]
        assert u.shape == (n,), (u.shape, n)
        return torch.from_numpy(u.astype(np.float32)), \
            torch.from_numpy(v.astype(np.float32))

    def reset(self, n: int):
        p1, u1, p2r, u2 = self._reset[self.step]
        assert p1.shape == (n,), (p1.shape, n)
        return (torch.from_numpy(p1.astype(np.int32)),
                torch.from_numpy(u1.astype(np.float32)),
                torch.from_numpy(p2r.astype(np.int32)),
                torch.from_numpy(u2.astype(np.float32)))


def record_draws(draws, steps: int, n: int):
    """(spawn, reset) arrays for ``ReplayDraws``: ``steps`` train steps
    of ``n`` envs drawn from ``draws`` in the step's own order.  float64
    holds the f32 uniforms and the int32 positions alike, exactly."""
    spawn, reset = [], []
    for _ in range(steps):
        draws.split()
        spawn.append([_arr(a) for a in draws.spawn(n)])
        reset.append([_arr(a) for a in draws.reset(n)])
    return np.asarray(spawn, np.float64), np.asarray(reset, np.float64)


# -- one job, on a mesh or alone ------------------------------------------------

def run_job(job: dict, mesh=None) -> dict:
    """Run ``job["segments"]`` train segments of ``job["acfg"]`` /
    ``job["tcfg"]`` (config dicts) and return the global state after
    them as a flat dict (on a mesh: a collective; every rank gets it).

    ``job["start"]``: an npz of a global start state (``flat_state``
    of either package's state: the reference's logs gain the port's
    spill column), cut to this rank's share; or None for a fresh state
    from a ``torch.Generator`` seeded with ``tcfg.seed``.  ``job["draws"]``: an
    npz with ``spawn`` and ``reset`` (``ReplayDraws``), or None for the
    same generator.  ``job["staged"]`` false runs the segments' steps
    unstaged, one by one."""
    from tpu2048_torch.agent import td
    from tpu2048_torch.config import AgentConfig, TrainConfig
    from tpu2048_torch.draws import TorchDraws
    from tpu2048_torch.features.ntuple import get_tuple_set
    from tpu2048_torch.parallel import mesh as pmesh
    from tpu2048_torch.store.checkpoint import td_state_from_numpy

    acfg, tcfg = AgentConfig(**job["acfg"]), TrainConfig(**job["tcfg"])
    ts = get_tuple_set(acfg.n)
    gen = torch.Generator()
    gen.manual_seed(tcfg.seed)
    draws = TorchDraws(gen)
    if job.get("start"):
        with np.load(job["start"]) as z:
            state = state_from_flat(dict(z))
        if state.recorder.moves.shape[1] == tcfg.max_record_steps:
            state = td_state_from_numpy(state, "cpu")
        else:  # the port's own layout
            state = state_from_flat({k: torch.from_numpy(v) for k, v
                                     in flat_state(state).items()})
        if mesh is not None:
            state = pmesh.shard_td_state(state, mesh, ts)
    elif mesh is not None:
        state = pmesh.init_sharded_td_state(ts, acfg, tcfg, mesh, draws)
    else:
        state = td.init_td_state(ts, acfg, tcfg, draws, "cpu")
    if job.get("draws"):
        with np.load(job["draws"]) as z:
            draws = ReplayDraws(z["spawn"], z["reset"])
    if job.get("staged", True):
        seg = td.make_train_segment(ts, acfg, tcfg, draws, mesh=mesh)
    else:
        step = td.make_train_step(ts, acfg, tcfg, draws, staged=False,
                                  mesh=mesh)

        def seg(state):
            for _ in range(tcfg.steps_per_call):
                state = step(state)
            return state

    for _ in range(job["segments"]):
        state = seg(state)
    if mesh is None:
        return flat_state(state)
    _assert_replicas_equal(mesh, state)
    return flat_state(pmesh.host_full_state(state, mesh))


def _assert_replicas_equal(mesh, state) -> None:
    """Every leaf of ``state`` holds the same bits on every rank that
    holds a replica of it: a replicated leaf on all ranks, a shard of
    the tables on the ranks of one data group, an env range on the
    ranks of one model group."""
    from tpu2048_torch.parallel import mesh as pmesh

    specs = flat_state(pmesh.td_state_shardings(mesh))
    axes = {pmesh.REPLICATED: ("data", "model"), pmesh.MODEL: ("data",),
            pmesh.DATA: ("model",), pmesh.RECORD: ("model",)}
    for name, x in flat_state(state).items():
        spec = pmesh.DATA if name.startswith("env.") else str(specs[name])
        t = torch.from_numpy(np.ascontiguousarray(x)).reshape(-1)
        if t.dtype == torch.float32:
            t = t.view(torch.int32)  # compare bits: NaN equals NaN
        for axis in axes[spec]:
            if spec != pmesh.REPLICATED and mesh.groups[axis] is None:
                continue
            rows = mesh.all_gather(t[None], axis)
            assert bool((rows == rows[0]).all()), \
                f"replicas differ in {name} over the {axis} axis"


def run_segment(mesh, job_path: str) -> None:
    with open(job_path) as f:
        job = json.load(f)
    out = run_job(job, mesh)
    if mesh.rank == 0:
        np.savez(os.path.join(job["out"], "state.npz"), **out)
        with open(os.path.join(job["out"], "counts.json"), "w") as f:
            json.dump(mesh.counts, f)


def run_trainer(mesh, store_dir: str) -> None:
    """The twin of the reference's two-process trainer test: a run
    whose checkpoints rank 0 alone writes, then a resume in every
    rank."""
    from tpu2048_torch.config import AgentConfig, TrainConfig
    from tpu2048_torch.obs.logging import Logger
    from tpu2048_torch.store.artifacts import LocalStore
    from tpu2048_torch.train.loop import Trainer

    nprocs, rank = mesh.data, mesh.rank
    store = LocalStore(store_dir)
    acfg = AgentConfig(n=2)
    tcfg = TrainConfig(
        num_envs=8 * nprocs, episodes=30, steps_per_call=8, ring_size=256,
        record_envs=2, max_record_steps=2048, checkpoint_every=15,
        log_every=10, seed=0,
    )
    log = Logger(store, key=f"l/logs_rank{rank}.txt", console=False)
    tr = Trainer("dist_agent", acfg, tcfg, store=store, logger=log, mesh=mesh)
    out = tr.run()
    eps1 = out["episodes"]
    assert eps1 >= tcfg.episodes, eps1
    # the checkpoint exists for every rank (rank 0 wrote it)
    assert store.load("a/dist_agent.json") is not None
    w1 = tr.state.weights.clone()
    _assert_replicas_equal(mesh, tr.state)

    # every rank reloads the same checkpoint, builds its share of the
    # state, and training continues
    tr2 = Trainer("dist_agent", acfg, tcfg, store=store,
                  logger=Logger(console=False), mesh=mesh, resume=True)
    eps_resumed = int(tr2.state.metrics.episodes)
    assert eps_resumed == eps1, (eps_resumed, eps1)
    assert torch.equal(tr2.state.weights, w1)
    assert tr2.state.env.score.shape == (8,)  # this rank's envs only
    out2 = tr2.run()
    assert out2["episodes"] >= eps1 + tcfg.episodes, out2["episodes"]
    _assert_replicas_equal(mesh, tr2.state)


class StopAfter:
    """A job that stops a ``Trainer.run`` after ``segments`` segments."""

    parent = None

    def __init__(self, segments: int):
        self.left = segments

    def should_stop(self) -> bool:
        self.left -= 1
        return self.left < 0


def train_job(job: dict, mesh=None):
    """``Trainer.run`` of ``job["segments"]`` segments of agent
    ``job["name"]`` in the store at ``job["store"]`` (resumed when
    ``job["resume"]``), on ``mesh`` or alone on the CPU; its checkpoint
    is saved at the end.  Returns the trainer."""
    from tpu2048_torch.config import AgentConfig, TrainConfig
    from tpu2048_torch.obs.logging import Logger
    from tpu2048_torch.store.artifacts import LocalStore
    from tpu2048_torch.train.loop import Trainer

    acfg, tcfg = AgentConfig(**job["acfg"]), TrainConfig(**job["tcfg"])
    tr = Trainer(job["name"], acfg, tcfg, store=LocalStore(job["store"]),
                 logger=Logger(console=False), mesh=mesh,
                 resume=job.get("resume", False),
                 device=None if mesh is not None else "cpu")
    tr.run(job=StopAfter(job["segments"]))
    return tr


def run_model_trainer(mesh, arg: str) -> None:
    """``train_job`` on the mesh (``arg`` is ``<job.json>,<model>``):
    each rank holds its shard of the tables, the replicas agree, and
    rank 0 has saved the whole tables."""
    from tpu2048_torch.parallel import mesh as pmesh

    with open(arg.split(",")[0]) as f:
        job = json.load(f)
    tr = train_job(job, mesh)
    ts = tr.ts
    shard = mesh.table_shard(ts)
    assert tr.state.weights.shape == (shard.size,), tr.state.weights.shape
    if tr.acfg.optimizer == "tc":
        assert tr.state.opt_e.shape == tr.state.opt_a.shape == (shard.size,)
    _assert_replicas_equal(mesh, tr.state)
    # the whole tables, read by every rank together
    full = pmesh.host_full(tr.state.weights, mesh, pmesh.MODEL)
    assert full.shape == (ts.total,)
    np.testing.assert_array_equal(full[shard.lo: shard.hi],
                                  tr.state.weights.numpy())


def run_card_model(mesh, arg: str) -> None:
    """At n=``arg`` on a (1, ranks) mesh of gloo ranks sharing one card:
    one train step through the kernels against the unmeshed CPU step
    (``chip_smoke._card_step_against_cpu``), and this rank's tuple
    range of the 16^4 class through ``eval_class`` and ``grad_class``
    against their plain versions."""
    from chip_smoke import _card_step_against_cpu, _hold_states

    from tpu2048_torch.config import AgentConfig, TrainConfig
    from tpu2048_torch.features.ntuple import feature_indices, get_tuple_set
    from tpu2048_torch.ops import kernels
    from tpu2048_torch.ops import onehot as oh

    n = int(arg)
    ts = get_tuple_set(n)
    c = oh.build_table_classes(ts).matmul[-1]  # the 16^4 class
    shard = mesh.table_shard(ts)
    a, b = shard.tuples(c.feat0, c.g)
    assert shard.split(c.feat0, c.g) and a < b, (a, b)
    tcfg = TrainConfig(num_envs=1024, ring_size=256, max_record_steps=256)
    card, plain, slack, launches = _card_step_against_cpu(
        AgentConfig(n=n, table_ops="pallas"), tcfg, mesh=mesh)
    if plain is not None:
        _hold_states(card, plain, f"model axis n={n} step", slack)
    assert launches == {"eval_class": 2, "grad_class": 1, "fold_class": 1}
    # the split class's pair is gathered whole for the fold
    assert mesh.counts["model_all_gather"] >= 1
    dev = mesh.device
    gen = torch.Generator(device="cpu")
    gen.manual_seed(mesh.rank)
    full = torch.randn(ts.total, generator=gen).to(dev)
    hl = c.h * c.l
    block = full[c.start + a * hl: c.start + b * hl].view(b - a, c.h, c.l)
    boards = torch.randint(0, 12, (4096, 16), generator=gen).to(dev)
    idx = feature_indices(ts, boards)
    hi, lo = oh._hi_lo(ts, idx, c, a, b)
    for precision in ("bf16", "bf16x2"):
        got = kernels.eval_class(block, hi, lo, precision)
        assert torch.equal(got, kernels.eval_class_ordered(
            block, hi, lo, precision)), precision
    dw = torch.randn(4096, generator=gen).to(dev)
    valid = (torch.rand(4096, generator=gen) < 0.5).to(dev)
    pair = kernels.grad_class(hi, lo, dw, valid, c.h, c.l)
    want = kernels.grad_class_reference(hi, lo, dw, valid, c.h, c.l)
    assert pair.shape == (2, b - a, c.h, c.l)
    assert torch.equal(pair[1], want[1])
    mass = kernels.grad_class_reference(hi, lo, dw.abs(), valid, c.h, c.l)[0]
    assert bool(((pair[0] - want[0]).abs()
                 <= 2.0**-23 * want[1] * mass).all())


def run_fault(store_dir: str, mode: str) -> None:
    """The twin of the reference's fault worker: train under a short
    lease with periodic checkpoints until killed (``fresh``), or resume
    from the last checkpoint and finish (``resume``)."""
    from tpu2048_torch.config import AgentConfig, TrainConfig
    from tpu2048_torch.obs.jobs import Job, JobRegistry
    from tpu2048_torch.obs.logging import Logger
    from tpu2048_torch.store.artifacts import LocalStore
    from tpu2048_torch.train.loop import Trainer

    resume = mode == "resume"
    store = LocalStore(store_dir)
    # short lease: the parent asserts that the crashed run's orphaned
    # lease is reaped by vacuum after expiry
    reg = JobRegistry(store, lease_sec=2.0)
    parent = f"sess_{mode}"
    assert reg.acquire("agent", "fault_agent", parent=parent)
    acfg = AgentConfig(n=2)
    tcfg = TrainConfig(
        num_envs=64,
        # fresh mode never finishes on its own: the parent kills it
        episodes=10_000_000 if not resume else 120,
        steps_per_call=8, ring_size=256, record_envs=2,
        max_record_steps=2048, checkpoint_every=40, seed=0,
    )
    tr = Trainer("fault_agent", acfg, tcfg, store=store,
                 logger=Logger(console=False), resume=resume, device="cpu")
    print(f"START_EPISODES {int(tr.state.metrics.episodes)}", flush=True)
    # the run's heartbeats keep the lease alive while it trains
    out = tr.run(job=Job("train", "fault_agent", parent), registry=reg)
    reg.release("agent", "fault_agent")
    print(f"DONE {out['episodes']}", flush=True)


def _assert_no_jax() -> None:
    loaded = sorted(m for m in sys.modules if m == "jax" or m == "tpu2048"
                    or m.startswith(("jax.", "tpu2048.")))
    assert not loaded, f"the port loaded {loaded}"


def main() -> None:
    # several workers and several test processes share the machine
    torch.set_num_threads(1)
    if sys.argv[1] == "fault":
        run_fault(sys.argv[2], sys.argv[3])
        _assert_no_jax()
        return
    rendezvous, nprocs, rank, mode, arg = sys.argv[1:6]
    nprocs, rank = int(nprocs), int(rank)
    from tpu2048_torch.config import MeshConfig
    from tpu2048_torch.parallel import distributed

    model = 1
    if mode == "segment":
        with open(arg) as f:
            model = json.load(f).get("model", 1)
    elif mode == "model_trainer":
        model = int(arg.split(",")[1])
    elif mode == "card_model":
        model = nprocs
    # the card's ranks share its one device over gloo
    device = "cuda" if mode == "card_model" else "cpu"
    ok = distributed.initialize(coordinator_address=rendezvous,
                                num_processes=nprocs, process_id=rank,
                                device=device, backend="gloo")
    assert ok, "distributed.initialize returned False with explicit args"
    assert distributed.initialize() is True  # safe to call again
    data = nprocs // model
    mesh = distributed.global_mesh(MeshConfig(data=data, model=model))
    assert (mesh.rank, mesh.data, mesh.model, mesh.device.type) == (
        rank, data, model, device)
    assert mesh.staged == (device == "cuda")
    assert (mesh.data_rank, mesh.model_rank) == divmod(rank, model)
    if model == 1:
        sl = distributed.process_env_slice(8 * nprocs)
        assert sl == slice(rank * 8, (rank + 1) * 8), sl
    assert mesh.env_slice(8 * data) == slice(mesh.data_rank * 8,
                                             (mesh.data_rank + 1) * 8)
    {"segment": run_segment, "trainer": run_trainer,
     "model_trainer": run_model_trainer,
     "card_model": run_card_model}[mode](mesh, arg)
    _assert_no_jax()
    torch.distributed.destroy_process_group()
    print(f"{mode.upper()}_OK {rank}", flush=True)


if __name__ == "__main__":
    main()
