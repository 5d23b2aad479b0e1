"""The program's spans (``harness/spans.py``, ``tools/stages.py``) and
the readers of its counters (``metrics/``) on small traces placed by
hand, and on CPU runs of the program."""

import os

import pytest

from harness import spans, spec, trace
from harness.trace import Event, Trace

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ev(name, start, end):
    return Event(name, float(start), float(end - start))


# Two train steps on the host's clock (µs), each with its actor, class
# chain and crosses; the card runs each stage's kernels a little later.
HOST = [ev("td.segment", 0, 200), ev("td.step", 0, 100),
        ev("td.actor", 0, 40), ev("td.class_chain", 40, 70),
        ev("td.crosses", 70, 100), ev("td.step", 100, 200),
        ev("td.actor", 100, 140), ev("td.class_chain", 140, 170),
        ev("td.crosses", 170, 200)]
# kernels: actor 10-30 and 110-125 + 127-135; chain 45-62, 150-160;
# crosses 80-92, 175-195; one at 196-198 that no range holds
DEVICE = [ev("k_actor", 10, 30), ev("grad_class_k", 45, 62),
          ev("k_cross", 80, 92), ev("k_actor", 110, 125),
          ev("eval_class_k", 127, 135), ev("grad_class_k", 150, 160),
          ev("k_cross", 175, 195), ev("k_tail", 196, 198)]
DEVICE_SPANS = [ev("td.actor", 10, 30), ev("td.class_chain", 45, 62),
                ev("td.crosses", 80, 92), ev("td.actor", 110, 135),
                ev("td.class_chain", 150, 160), ev("td.crosses", 175, 195)]
OPS = [ev("aten::add", 5, 8), ev("aten::index", 44, 46)]


def synthetic(device=DEVICE):
    return Trace(list(device), list(OPS), 0.0, 200.0, 400e-6)


SPANS = spans.Spans(HOST, DEVICE_SPANS)


def ctx(kind, tr, steps=2):
    return {"kind": kind, "trace": tr, "steps": steps,
            "window_s": tr.wall_s, "busy_s": trace.busy_us(tr) * 1e-6}


def _tool():
    import importlib.util

    path = os.path.join(BENCH, "tools", "stages.py")
    mod_spec = importlib.util.spec_from_file_location("stages_tool", path)
    tool = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(tool)
    return tool


def test_device_owners_and_gaps_by_hand():
    tr = synthetic()
    assert spans.device_owners(tr, SPANS) == [
        "td.actor", "td.class_chain", "td.crosses", "td.actor", "td.actor",
        "td.class_chain", "td.crosses", spans.OUTSIDE]
    assert spans.gaps(tr) == [(0.0, 10.0), (30.0, 15.0), (62.0, 18.0),
                              (92.0, 18.0), (125.0, 2.0), (135.0, 15.0),
                              (160.0, 15.0), (195.0, 1.0), (198.0, 2.0)]
    # by the host span at each gap's middle: actor 5, 37.5, 101 (the
    # second step's), 126; chain 142.5, 167.5; crosses 71, 195.5, 199
    chains = [c for c, _ in spans.gap_chains(tr, SPANS)]
    assert chains[2] == ("td.segment", "td.step", "td.crosses")
    assert chains[3] == ("td.segment", "td.step", "td.actor")
    table = spans.stage_table(tr, SPANS)
    assert table["td.actor"] == {"device_us": 20 + 15 + 8, "launches": 3,
                                 "idle_us": 10 + 15 + 18 + 2}
    assert table["td.class_chain"] == {"device_us": 17 + 10, "launches": 2,
                                       "idle_us": 15 + 15}
    assert table["td.crosses"] == {"device_us": 12 + 20, "launches": 2,
                                   "idle_us": 18 + 1 + 2}
    assert table[spans.OUTSIDE] == {"device_us": 2.0, "launches": 1,
                                    "idle_us": 0.0}


def test_stage_table_without_spans():
    """A program without spans puts everything outside."""
    tr = synthetic()
    table = spans.stage_table(tr, spans.Spans([], []))
    assert list(table) == [spans.OUTSIDE]
    assert table[spans.OUTSIDE] == {
        "device_us": sum(e.dur for e in DEVICE), "launches": len(DEVICE),
        "idle_us": 200.0 - trace.busy_us(tr)}


def test_stage_kernels_by_hand():
    tr = synthetic()
    top = _tool().top_kernels(tr, spans.device_owners(tr, SPANS), top=1)
    assert top["td.actor"] == [("k_actor", 35.0)]
    assert top["td.class_chain"] == [("grad_class_k", 27.0)]
    assert top[spans.OUTSIDE] == [("k_tail", 2.0)]


@pytest.fixture
def counters(monkeypatch):
    from tpu2048_torch.obs import profiler

    c = {}
    monkeypatch.setattr(profiler, "counters", c)
    return c


def test_counter_readers_by_hand(counters):
    counters.update({"search.steps": 24, "host_reads": 48,
                     "search.roots_needy": 3000,
                     "search.roots_expanded": 4392})
    c = ctx("search", synthetic(), steps=24)
    assert spec.reader("search.host_reads_per_step")(c) == 2.0
    assert spec.reader("search.tree_root_use")(c) == \
        pytest.approx(100 * 3000 / 4392)
    for m in ("search.host_reads_per_step", "search.tree_root_use"):
        assert spec.reader(m)(ctx("train", synthetic())) is None
        # a stretch in which the card ran nothing reports nothing
        assert spec.reader(m)(ctx("search",
                                  synthetic([]))) is None


def test_counter_readers_without_counters(counters, monkeypatch):
    from tpu2048_torch.obs import profiler

    c = ctx("search", synthetic())
    # nothing counted, then a program without counters
    assert spec.reader("search.host_reads_per_step")(c) is None
    assert spec.reader("search.tree_root_use")(c) is None
    monkeypatch.delattr(profiler, "counters")
    assert spans.program_counters() is None
    assert spec.reader("search.host_reads_per_step")(c) is None
    assert spec.reader("search.tree_root_use")(c) is None


def test_counter_readers_on_a_cpu_trial(counters):
    """The program's counters from a traced depth-2 trial on the CPU, 8
    games from a crowded board for 6 steps; the readers take them."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu2048_torch.config import SearchConfig
    from tpu2048_torch.features.ntuple import get_tuple_set
    from tpu2048_torch.train.trial import trial

    ts = get_tuple_set(4)
    g = torch.Generator().manual_seed(5)
    left = [6]

    def stop():
        left[0] -= 1
        return left[0] < 0

    board = np.asarray(spec.load("search-n5").traffic["warm_board"], np.int8)
    with profile(activities=[ProfilerActivity.CPU]):
        trial(ts, torch.rand(ts.total, generator=g) * 0.01, num=8,
              search=SearchConfig(depth=2, width=2, since_empty=6),
              steps_per_call=1, stop_cb=stop, game_init=board, device="cpu")
    assert counters["search.steps"] == 6
    assert counters["host_reads"] == 12
    assert 0 < counters["search.roots_needy"] <= \
        counters["search.roots_expanded"]
    c = ctx("search", synthetic(), steps=6)
    assert spec.reader("search.host_reads_per_step")(c) == 2.0
    assert spec.reader("search.tree_root_use")(c) == pytest.approx(
        100 * counters["search.roots_needy"]
        / counters["search.roots_expanded"])


def test_stages_tool_keeps_the_spans(monkeypatch):
    """The tool's wrap of ``trace._read`` keeps a stretch's program spans
    and leaves its ``Trace`` as the harness reads it: a traced stretch on
    the CPU with the program's spans."""
    import torch

    from tpu2048_torch.obs.profiler import span

    monkeypatch.setattr(trace, "_read", trace._read)  # put back after
    kept = []
    _tool().keep_spans(kept)
    with trace.Traced("cpu") as t:
        with span("td.segment"):
            with span("td.step"):
                torch.ones(8).add_(1)
    (sp,) = kept
    assert [s.name for s in sp.host] == ["td.segment", "td.step"]
    assert sp.device == [] and t.trace.device == []
    assert t.trace.host and \
        all(not h.name.startswith("td.") for h in t.trace.host)
    outer, inner = sp.host
    assert outer.start <= inner.start and \
        inner.start + inner.dur <= outer.start + outer.dur
    assert t.trace._fields == ("device", "host", "start", "end", "wall_s")
