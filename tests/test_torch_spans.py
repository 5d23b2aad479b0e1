"""The port's spans and counters (``tpu2048_torch/obs/profiler.py``).

Off, with no profiler recording, a span is one shared no-op and a count
adds nothing.  On, under a ``torch.profiler`` session on the CPU, the
train segment and the search step export their stages as nested
``user_annotation`` ranges, and the search's counters add up.  Either
way the program computes the same bits.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tpu2048_torch.agent import td
from tpu2048_torch.config import AgentConfig, SearchConfig, TrainConfig
from tpu2048_torch.draws import NumpyDraws, TorchDraws
from tpu2048_torch.engine import fast as engf
from tpu2048_torch.features.ntuple import get_tuple_set
from tpu2048_torch.obs import profiler
from tpu2048_torch.search.expectimax import (make_compacted_estimator,
                                             make_expectimax_estimator)
from tpu2048_torch.train.trial import trial

K = 3
TRAIN_STAGES = ("td.actor", "td.class_chain", "td.crosses", "td.env",
                "td.recorder", "td.episodes", "td.reset")
# ``search.compact`` runs only when the needy roots fit a smaller tier
# (``test_compacted_tree_spans_and_counts``)
SEARCH_SPANS = ("trial.step", "trial.engine", "search.base",
                "search.need_read", "search.tree", "search.expand",
                "search.value", "search.backup", "trial.select",
                "trial.read", "trial.progress")
# a crowded board: every afterstate of it needs the tree
CROWDED = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [1, 2, 3, 0], [0, 0, 0, 2]],
                   np.int8)


@pytest.fixture
def fresh_counters(monkeypatch):
    """The module's counters, empty for this test alone."""
    monkeypatch.setattr(profiler, "counters", {})
    return profiler


def _segment(seed: int):
    """A fresh n=5 state of 8 envs and its K-step segment."""
    ts = get_tuple_set(5)
    acfg = AgentConfig(n=5)
    tcfg = TrainConfig(num_envs=8, steps_per_call=K, ring_size=64,
                       max_record_steps=64)
    st = td.init_td_state(ts, acfg, tcfg, NumpyDraws(seed, "cpu"), "cpu")
    return st, td.make_train_segment(ts, acfg, tcfg,
                                     NumpyDraws(seed + 1, "cpu"))


def _trial(steps: int, depth: int = 2):
    """``steps`` search steps of 4 games from a crowded board, one step
    a segment; every legal afterstate of a live game needs the tree."""
    ts = get_tuple_set(4)
    g = torch.Generator().manual_seed(3)
    weights = torch.rand(ts.total, generator=g) * 0.01
    left = [steps]

    def stop():
        left[0] -= 1
        return left[0] < 0

    return trial(ts, weights, num=4, steps_per_call=1, game_init=CROWDED,
                 search=SearchConfig(depth=depth, width=2, since_empty=16),
                 stop_cb=stop, draws=TorchDraws(g))


def _leaves(x):
    """The tensors of a (nested) NamedTuple state, in field order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for f in x for t in _leaves(f)]
    return []


def _same_bits(a, b) -> None:
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.contiguous().numpy().tobytes() == \
            y.contiguous().numpy().tobytes()


def _spans(prof, tmp_path) -> list:
    """(name, start, end) of the trace's host spans, in start order."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    out = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
           for e in events
           if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return sorted(out, key=lambda s: s[1])


def _inside(spans, outer) -> list:
    _, a, b = outer
    return [s for s in spans if s is not outer and a <= s[1] and s[2] <= b]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def test_span_off_is_the_shared_no_op(fresh_counters, monkeypatch):
    """With no profiler recording, no span opens a ``record_function``
    and no count lands, through a train segment and a depth-1 trial."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiler.span("td.step") is profiler.span("search.tree")
    st, seg = _segment(0)
    seg(st)
    res = _trial(2, depth=1)
    assert res.search_stats["steps"] == 2
    with profiler.Timer().section("metrics_read"):
        pass
    profiler.count("host_reads")
    assert profiler.counters == {}


def test_train_segment_exports_its_stage_spans(tmp_path):
    """``td.segment`` holds K ``td.step``s and the merge; each step holds
    the seven stages once, in the step's order."""
    st, seg = _segment(0)
    prof, _ = _profiled(lambda: seg(st))
    spans = _spans(prof, tmp_path)
    segs = [s for s in spans if s[0] == "td.segment"]
    assert len(segs) == 1
    inner = _inside(spans, segs[0])
    steps = [s for s in inner if s[0] == "td.step"]
    assert len(steps) == K
    assert [s[0] for s in inner if s[0] == "td.merge"] == ["td.merge"]
    assert not [s for s in inner if s[0] == "td.symmetrize"]
    for step in steps:
        names = [s[0] for s in _inside(spans, step)]
        assert names == list(TRAIN_STAGES)


def test_periodic_segment_exports_its_symmetrize_span(tmp_path):
    ts = get_tuple_set(4)
    acfg = AgentConfig(n=4, sym_mode="periodic")
    tcfg = TrainConfig(num_envs=4, steps_per_call=2, ring_size=16,
                       max_record_steps=16)
    st = td.init_td_state(ts, acfg, tcfg, NumpyDraws(0, "cpu"), "cpu")
    seg = td.make_train_segment(ts, acfg, tcfg, NumpyDraws(1, "cpu"))
    prof, _ = _profiled(lambda: seg(st))
    spans = _spans(prof, tmp_path)
    (outer,) = [s for s in spans if s[0] == "td.segment"]
    assert [s[0] for s in _inside(spans, outer)
            if s[0] == "td.symmetrize"] == ["td.symmetrize"]


def test_trial_exports_search_spans_and_counts(fresh_counters, tmp_path):
    """A depth-2 trial of 5 steps: every search span is there, the tree's
    stages lie inside ``search.tree``, and the counters read two host
    reads a step and no more needy roots than the tree ran."""
    prof, res = _profiled(lambda: _trial(5))
    spans = _spans(prof, tmp_path)
    names = {s[0] for s in spans}
    assert set(SEARCH_SPANS) <= names
    steps = [s for s in spans if s[0] == "trial.step"]
    assert len(steps) == 5
    for tree in (s for s in spans if s[0] == "search.tree"):
        inner = [s[0] for s in _inside(spans, tree)]
        # depth 2: a value, an expand and a backup at each of two
        # levels, and the leaves' value
        assert sorted(inner) == sorted(["search.value"] * 3
                                       + ["search.expand"] * 2
                                       + ["search.backup"] * 2)
    for stage in ("trial.engine", "search.base", "search.need_read",
                  "search.tree", "trial.select"):
        assert [sum(s[0] == stage for s in _inside(spans, step))
                for step in steps] == [1] * 5
    c = profiler.counters
    assert c["search.steps"] == res.search_stats["steps"] == 5
    assert c["host_reads"] == 2 * c["search.steps"]
    assert 0 < c["search.roots_needy"] <= c["search.roots_expanded"]
    assert sum(res.search_stats["tiers"].values()) == 5


def test_chunked_tree_counts_its_padding(fresh_counters):
    """Roots run in chunks padded to a whole number: 7 roots at 3 a
    chunk expand 9."""
    est = make_expectimax_estimator(_value, depth=1, width=2,
                                    since_empty=16, max_leaves=24,
                                    input_rep="codes")
    g = torch.Generator().manual_seed(0)
    _profiled(lambda: est(_roots(7), TorchDraws(g).search()))
    assert est.chunks == 3
    assert profiler.counters == {"search.roots_expanded": 9}


def _value(b):
    return b.reshape(b.shape[0], 16).sum(dim=1).float()


def _roots(b: int) -> torch.Tensor:
    return engf.codes_from_boards(torch.from_numpy(CROWDED)).expand(
        b, 4).contiguous()


def test_compacted_tree_spans_and_counts(fresh_counters, tmp_path):
    """10 needy roots of 80 go to the tier of 64: the step reads the card
    once, compacts, and the tree runs 64 roots."""
    est = make_compacted_estimator(_value, depth=1, width=2, since_empty=16,
                                   batch=80, input_rep="codes")
    need = torch.zeros(80, dtype=torch.bool)
    need[::8] = True
    g = torch.Generator().manual_seed(0)
    prof, _ = _profiled(lambda: est(_roots(80), TorchDraws(g).search(),
                                    need))
    names = [s[0] for s in _spans(prof, tmp_path)]
    for stage in ("search.base", "search.need_read", "search.compact",
                  "search.tree"):
        assert names.count(stage) == 1
    assert est.tier_counts[64] == 1
    assert profiler.counters == {"host_reads": 1, "search.roots_needy": 10,
                                 "search.roots_expanded": 64}


def test_spans_leave_the_train_bits_alone():
    """A seeded segment gives the same bits with a profiler as without."""
    st, seg = _segment(7)
    plain = seg(st)
    st, seg = _segment(7)
    _, traced = _profiled(lambda: seg(st))
    _same_bits(plain, traced)


def test_spans_leave_the_trial_alone(fresh_counters):
    """A seeded trial plays the same games with a profiler as without."""
    plain = _trial(4)
    _, traced = _profiled(lambda: _trial(4))
    for f in ("scores", "tiles", "odometers", "final_boards"):
        np.testing.assert_array_equal(getattr(plain, f), getattr(traced, f))
    assert plain.search_stats == traced.search_stats


def test_timer_section_is_a_span(tmp_path):
    """``Trainer.run``'s timed sections show in its trace by name."""
    timer = profiler.Timer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.section("train_segment"):
            torch.ones(4).add_(1)
    assert [s[0] for s in _spans(prof, tmp_path)] == ["train_segment"]
    assert timer.counts == {"train_segment": 1}
