"""The port's telemetry and device trace (``tpu2048_torch/obs``) on the
CPU: the twins of ``tests/test_obs.py``'s telemetry tests and of
``tests/test_train.py``'s trace test, the card-less behaviour of
``device_memory_stats``, ``device_trace`` itself, and the service's
refusal to pick the CPU on its own."""

import dataclasses
import json

import pytest
import torch

from tpu2048_torch.apps.service import AppService
from tpu2048_torch.config import AgentConfig, TrainConfig
from tpu2048_torch.obs import telemetry
from tpu2048_torch.obs.logging import Logger
from tpu2048_torch.obs.profiler import device_trace
from tpu2048_torch.store.artifacts import MemoryStore
from tpu2048_torch.train.loop import Trainer

TCFG = TrainConfig(num_envs=32, steps_per_call=32, ring_size=256,
                   record_envs=8, max_record_steps=2048, seed=0,
                   episodes=30, checkpoint_every=25, log_every=10)


def test_memory_telemetry_snapshot_and_monitor():
    s = telemetry.snapshot()
    assert s["rss_mb"] > 10  # a real python process
    store = MemoryStore()
    mon = telemetry.MemoryMonitor(store, min_interval=0.0, max_lines=5)
    assert mon.sample(tag="t") is not None
    assert "rss = " in store.load("memory_usage.txt")
    mon.min_interval = 60.0
    assert mon.sample() is None
    mon.min_interval = 0.0
    for _ in range(10):
        mon.sample()
    assert len(store.load("memory_usage.txt").splitlines()) <= 5
    assert "rss = " in mon.tail()


def test_service_heartbeat_samples_memory():
    svc = AppService(MemoryStore(), device="cpu")
    svc.memory.min_interval = 0.0
    svc.heartbeat("web")
    st = svc.system_stats()
    assert st["now"]["rss_mb"] > 0
    assert "rss = " in st["history"]


def test_no_card_no_device_memory_and_cuda_untouched(monkeypatch):
    """Without a card the device's memory is {} and no CUDA call is
    made: nothing initialises CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def touched(*args, **kwargs):
        raise AssertionError("CUDA was called without a card")

    for name in ("current_device", "memory_stats", "get_device_name",
                 "get_device_properties", "init"):
        monkeypatch.setattr(torch.cuda, name, touched)
    assert telemetry.device_memory_stats() == {}
    s = telemetry.snapshot()
    assert "hbm_in_use_mb" not in s and "device" not in s
    assert not torch.cuda.is_initialized()


def test_device_memory_stats_reads_the_card(monkeypatch):
    """With a card, the allocator's current and peak bytes, the card's
    total memory and its name, as ``snapshot`` reports them."""
    stats = {"allocated_bytes.all.current": 3 * 2**20,
             "allocated_bytes.all.peak": 5 * 2**20}

    class Props:
        total_memory = 80 * 2**30

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d: stats)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: Props)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "Card X")
    assert telemetry.device_memory_stats() == {
        "device": "Card X", "bytes_in_use": 3 * 2**20,
        "bytes_limit": 80 * 2**30, "peak_bytes_in_use": 5 * 2**20}
    s = telemetry.snapshot()
    assert s["hbm_in_use_mb"] == 3.0 and s["hbm_limit_mb"] == 80 * 1024.0
    assert s["device"] == "Card X"


def test_device_trace_none_is_a_no_op(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with device_trace(None):
        torch.ones(3).add_(1)
    with device_trace(""):
        pass
    assert list(tmp_path.iterdir()) == []


def test_device_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with device_trace(str(logdir)):
        torch.ones(64).mul_(2).sum()
    files = list(logdir.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::") for n in names), sorted(names)[:20]


def test_device_trace_without_cuda_tracing_raises(tmp_path, monkeypatch):
    """A card that the profiler cannot trace is an error, not a trace of
    the host alone."""
    from torch import profiler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(profiler, "supported_activities",
                        lambda: {profiler.ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="cannot trace the CUDA card"):
        with device_trace(str(tmp_path / "t")):
            pass


def test_trainer_timing_and_device_trace(tmp_path):
    """The twin of ``tests/test_train.py``'s: ``Trainer.run`` times its
    host phases with ``Timer``, and ``trace_dir`` captures the session
    in a ``torch.profiler`` trace and says where."""
    store = MemoryStore()
    log = Logger(store=store, key="l/p.txt", console=False)
    # a short session: tracing multiplies the cost of each op on the CPU
    cfg = dataclasses.replace(TCFG, episodes=2, checkpoint_every=2,
                              log_every=1)
    tr = Trainer("prof", AgentConfig(n=2), cfg, store=store, logger=log,
                 device="cpu")
    tr.run(trace_dir=str(tmp_path / "trace"))
    tail = log.tail()
    assert "timing:" in tail
    assert "train_segment" in tail
    assert f"device trace written to {tmp_path / 'trace'}" in tail
    assert tr.timer.totals["train_segment"] > 0
    assert tr.timer.counts["checkpoint"] >= 1
    trace_files = [p for p in (tmp_path / "trace").rglob("*") if p.is_file()]
    assert trace_files, "no device trace files written"


def test_service_without_a_card_raises(monkeypatch):
    """The twin of ``test_no_card_means_no_default_device``: the service
    takes the card by default and raises at construction without one,
    naming the way to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from tpu2048_torch.apps import cli, server

    with pytest.raises(RuntimeError, match='device="cpu"'):
        AppService(MemoryStore())
    assert AppService(MemoryStore(), device="cpu").device.type == "cpu"
    # the server's and the CLI's trial likewise
    monkeypatch.delenv("TPU2048_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        server.main(["--backend", "memory", "--port", "0"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cli.trial_and_replay(MemoryStore(), "anyone")
