"""The training driver: the port's lockstep learner, driven as
``Trainer.run`` drives it.

Set-up builds one train state and one segment (``td.init_td_state`` and
``td.make_train_segment``, what ``Trainer`` builds on one card), with
the benchmark's weights and draws.  It runs the cell's warm segments,
reading the episode count after each as ``Trainer.run`` does; the first
``checked_segments`` of them are the ones the reference follows.  The
window then runs whole segments until ``seconds`` have passed, each
followed by that one read.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from . import calls, checks
from .draws import KeyedDraws, key_seed
from .trace import Traced, sync


def _program():
    from tpu2048_torch.agent import td
    from tpu2048_torch.config import AgentConfig, TrainConfig
    from tpu2048_torch.features.ntuple import get_tuple_set

    return td, AgentConfig, TrainConfig, get_tuple_set


def make_weights(total: int, seed: int, device, spec: dict) -> torch.Tensor:
    """The table's start: uniform in [low, high), made on the device
    from the seed in one call."""
    g = torch.Generator(device=device)
    g.manual_seed(key_seed(seed, "weights"))
    w = torch.rand(total, generator=g, device=device, dtype=torch.float32)
    return w * (spec["high"] - spec["low"]) + spec["low"]


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        run = config["train"]
        self.n_envs = int(run["num_envs"])
        self.k = int(traffic["steps_per_call"])
        self.warm = int(run["warm_segments"])
        self.checked = int(traffic["checked_segments"])
        if self.warm < self.checked:
            raise ValueError("warm_segments must cover the checked segments")
        td, AgentConfig, TrainConfig, get_tuple_set = _program()
        self.td = td
        self.acfg = AgentConfig(**config["agent"])
        self.tcfg = TrainConfig(
            num_envs=self.n_envs, steps_per_call=self.k,
            ring_size=int(run["ring_size"]),
            record_envs=int(traffic["record_envs"]),
            max_record_steps=int(run["max_record_steps"]), seed=0)
        self.ts = get_tuple_set(self.acfg.n)
        from reference import features

        self.ts_ref = features.tuples_from_config(config["tuples"])
        if self.ts_ref.total != self.ts.total:
            raise ValueError("the configuration's tuples and the program's "
                             "tuple set differ in size")
        self.episodes = 0
        self._check_ring()

    # -- set-up -------------------------------------------------------------

    def setup(self) -> None:
        td = self.td
        self.draws = KeyedDraws(self.seed, self.device)
        w0 = make_weights(self.ts.total, self.seed, self.device,
                          self.config["weights"])
        self.state = td.init_td_state(self.ts, self.acfg, self.tcfg,
                                      self.draws, self.device, weights=w0)
        del w0
        self.segment = td.make_train_segment(self.ts, self.acfg, self.tcfg,
                                             self.draws)
        self.logs: List[torch.Tensor] = []
        self.odos: List[torch.Tensor] = []
        for c in range(self.warm):
            self._one()
            if c < self.checked:
                # the moves the reference follows: each env's log row up
                # to the slots these segments can have written
                self.logs.append(self.state.recorder.moves[
                    :, : self.k * (c + 1)].to("cpu", copy=True))
                self.odos.append(self.state.env.odometer.to("cpu", copy=True))
            if c + 1 == self.checked:
                self.snapshot = checks.train_snapshot(self.state)

    def _one(self) -> None:
        self.state = self.segment(self.state)
        # the one read of the segment, as Trainer.run's
        self.episodes = int(self.state.metrics.episodes)

    def _check_ring(self) -> None:
        """The episode ring must not lap between two reads: a segment
        completes at most num_envs * K episodes, which a ring of that
        size holds."""
        if self.tcfg.ring_size < self.n_envs * self.k:
            raise ValueError("ring_size below num_envs * steps_per_call: "
                             "the ring could lap between two reads")

    # -- the window ---------------------------------------------------------

    def window(self, seconds: float) -> Dict[str, float]:
        sync(self.device)
        spans = []
        segs = 0
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            self.state = self.segment(self.state)
            spans.append(time.perf_counter() - a)
            self.episodes = int(self.state.metrics.episodes)
            segs += 1
            now = time.perf_counter()
            if now - t0 >= seconds:
                break
        wall = now - t0
        self.spans = spans
        steps = segs * self.k
        return {"train_env_steps_per_s": steps * self.n_envs / wall,
                "attempted": segs, "failed": 0}

    def traced(self, seconds: float) -> dict:
        """Per-layer inputs: host spans over untraced segments, then a
        traced stretch with the kernel calls' shapes."""
        from tpu2048_torch.ops import kernels

        span_segments = int(self.traffic["span_segments"])
        trace_segments = int(self.traffic["trace_segments"])
        spans = []
        for _ in range(span_segments):
            a = time.perf_counter()
            self.state = self.segment(self.state)
            spans.append(time.perf_counter() - a)
            self.episodes = int(self.state.metrics.episodes)
        ep0 = self.episodes
        with calls.recording(kernels, ["eval_class", "grad_class"]) as log:
            with Traced(self.device) as t:
                for _ in range(trace_segments):
                    self._one()
        steps = trace_segments * self.k
        return {"kind": "train", "trace": t.trace, "calls": dict(log),
                "steps": steps, "span_steps": span_segments * self.k,
                "spans_s": spans, "envs": self.n_envs,
                "episodes_done": self.episodes - ep0,
                "tuples": self.ts.num_feat, "config": self.config,
                "attempted": span_segments + trace_segments, "failed": 0}

    # -- the check ----------------------------------------------------------

    def free(self) -> None:
        self.state = None
        self.segment = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        return checks.train_check(self)
