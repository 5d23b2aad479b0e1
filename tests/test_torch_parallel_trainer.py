"""The port's ``Trainer`` across processes and across a crash, on CPU:
the twins of ``tests/test_distributed.py`` (two gloo ranks: rank 0
alone writes, both resume) and of ``tests/test_fault.py`` (SIGKILL
mid-run: the lease expires, ``vacuum`` reaps it, a resumed process
trains on from the checkpoint) with the port's ``JobRegistry``."""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
from _torch_dist_worker import REPO, WORKER, run_workers

from tpu2048_torch.obs.jobs import JobRegistry
from tpu2048_torch.store.artifacts import LocalStore


def test_two_process_trainer_run_checkpoint_resume(tmp_path):
    """Each rank builds its share of the state, rank 0 alone writes the
    checkpoints, the best game, the metrics and the log, and both ranks
    resume from the checkpoint and train on."""
    store = tmp_path / "dist_store"
    store.mkdir()
    run_workers(tmp_path, 2, "trainer", str(store))
    assert (store / "a" / "dist_agent.json").exists()
    assert (store / "weights" / "dist_agent.npz").exists()
    assert (store / "g" / "best_of_dist_agent.npz").exists()
    assert (store / "l" / "logs_rank0.txt").read_text()
    # rank 1 was handed a logger too, and wrote nothing through it
    assert (store / "l" / "logs_rank1.txt").read_text() == ""
    lines = (store / "m" / "dist_agent.jsonl").read_text().splitlines()
    episodes = [json.loads(ln)["episodes"] for ln in lines
                if json.loads(ln)["kind"] == "ma100"]
    assert episodes and episodes == sorted(set(episodes)), \
        "a metrics point was written twice"


def _agent_doc(store_dir):
    path = os.path.join(store_dir, "a", "fault_agent.json")
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError):
        return None  # mid-write


def _fault_worker(store_dir, mode):
    return subprocess.Popen(
        [sys.executable, WORKER, "fault", store_dir, mode], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def test_sigkill_mid_run_then_resume(tmp_path):
    store_dir = str(tmp_path / "store")
    os.makedirs(store_dir)
    p = _fault_worker(store_dir, "fresh")
    # wait for the first checkpoint (>= 40 episodes recorded)
    deadline = time.time() + 180
    ckpt_eps = 0
    try:
        while time.time() < deadline:
            doc = _agent_doc(store_dir)
            if doc and doc.get("meta", {}).get("episodes", 0) >= 40:
                ckpt_eps = doc["meta"]["episodes"]
                break
            assert p.poll() is None, p.communicate()[0]
            time.sleep(0.2)
        assert ckpt_eps >= 40, "no checkpoint appeared within 180 s"
        # the run's heartbeats hold the lease while it trains
        reg = JobRegistry(LocalStore(store_dir), lease_sec=2.0)
        assert reg.holder("agent", "fault_agent") == "sess_fresh"
        assert not reg.acquire("agent", "fault_agent", parent="intruder")
        # hard crash: SIGKILL the exact PID (no orderly shutdown)
        os.kill(p.pid, signal.SIGKILL)
    finally:
        if p.poll() is None:
            p.kill()
    p.wait(timeout=30)

    # the crashed session's lease must expire and vacuum must reap it
    assert reg.holder("agent", "fault_agent") in ("sess_fresh", None)
    time.sleep(2.5)  # lease horizon
    assert reg.holder("agent", "fault_agent") is None
    removed = reg.vacuum()
    doc = reg._read()
    assert "fault_agent" not in doc.get("agent", {}), (removed, doc)

    # resume from the checkpoint: continuity of episodes and weights
    with np.load(os.path.join(store_dir, "weights", "fault_agent.npz")) as z:
        w_ckpt = z["weights"].copy()
    ckpt_eps = _agent_doc(store_dir)["meta"]["episodes"]
    p = _fault_worker(store_dir, "resume")
    try:
        out, _ = p.communicate(timeout=240)
    finally:
        if p.poll() is None:
            p.kill()
    assert p.returncode == 0, out
    start_line = [ln for ln in out.splitlines()
                  if ln.startswith("START_EPISODES")][0]
    start_eps = int(start_line.split()[1])
    # resumed exactly from the last completed checkpoint (the crash
    # loses at most checkpoint_every episodes, like the reference)
    assert start_eps == ckpt_eps, (start_eps, ckpt_eps)
    done_line = [ln for ln in out.splitlines() if ln.startswith("DONE")][0]
    final_eps = int(done_line.split()[1])
    assert final_eps >= start_eps + 120
    assert _agent_doc(store_dir)["meta"]["episodes"] == final_eps
    # weights actually advanced from the crash checkpoint
    with np.load(os.path.join(store_dir, "weights", "fault_agent.npz")) as z:
        w_final = z["weights"]
    assert not np.array_equal(w_ckpt, w_final)
    # the resumed run released its lease
    assert reg.holder("agent", "fault_agent") is None
