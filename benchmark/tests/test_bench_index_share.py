"""The reader of ``train.index_kernel_share`` (the program's
``td.index_rows`` counter over the traced stretch's afterstates) by
hand, and on a traced CPU segment of the program."""

import pytest

from harness import spans, spec
from harness.trace import Event, Trace

METRIC = "train.index_kernel_share"


def _ctx(kind, device=True, envs=16, steps=2):
    kernels = [Event("k", 0.0, 1.0)] if device else []
    return {"kind": kind, "trace": Trace(kernels, [], 0.0, 2.0, 2e-6),
            "envs": envs, "steps": steps}


@pytest.fixture
def counters(monkeypatch):
    from tpu2048_torch.obs import profiler

    c = {}
    monkeypatch.setattr(profiler, "counters", c)
    return c


def test_index_share_by_hand(counters, monkeypatch):
    read = spec.reader(METRIC)
    # a program that counts no index rows (the parent) reports nothing
    assert read(_ctx("train")) is None
    counters["td.index_rows"] = 4 * 16 * 2
    assert read(_ctx("train")) == 100.0
    counters["td.index_rows"] = 16 * 2
    assert read(_ctx("train")) == 25.0
    assert read(_ctx("search")) is None
    assert read(_ctx("train", device=False)) is None
    from tpu2048_torch.obs import profiler

    monkeypatch.delattr(profiler, "counters")
    assert spans.program_counters() is None
    assert read(_ctx("train")) is None


def test_index_share_of_a_traced_cpu_segment(counters):
    from torch.profiler import ProfilerActivity, profile

    from tpu2048_torch.agent import td
    from tpu2048_torch.config import AgentConfig, TrainConfig
    from tpu2048_torch.draws import NumpyDraws
    from tpu2048_torch.features.ntuple import get_tuple_set

    acfg = AgentConfig(n=4, table_ops="pallas")
    tcfg = TrainConfig(num_envs=16, steps_per_call=2, ring_size=64,
                       max_record_steps=64, seed=0)
    ts = get_tuple_set(acfg.n)
    state = td.init_td_state(ts, acfg, tcfg, NumpyDraws(0, "cpu"), "cpu")
    segment = td.make_train_segment(ts, acfg, tcfg, NumpyDraws(1, "cpu"))
    with profile(activities=[ProfilerActivity.CPU]):
        segment(state)
    assert spec.reader(METRIC)(_ctx("train", envs=16, steps=2)) == 100.0
