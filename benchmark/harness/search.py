"""The search driver: games played to their end with depth-limited
expectimax (``train/trial.py::trial``), one call after another.

Each call plays ``games`` games in lockstep from fresh boards, one step
per segment (``steps_per_call = 1``), so the benchmark's progress
callback sees every step: a step's time is the time between two
callbacks, and the window's last call is cut at its end by ``stop_cb``.
The callback launches nothing: it keeps the step's board, live-game and
odometer tensors, which the program makes anew every step.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from . import calls
from .draws import KeyedDraws, key_seed
from .trace import Traced, sync
from .train import make_weights


class _Step:
    __slots__ = ("draw_step", "codes", "active", "odo", "log", "start")

    def __init__(self, draw_step, codes, active, odo, log, start):
        self.draw_step, self.codes, self.active = draw_step, codes, active
        self.odo, self.log, self.start = odo, log, start


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from tpu2048_torch.config import SearchConfig
        from tpu2048_torch.features.ntuple import get_tuple_set
        from reference import features

        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.games = int(config["search"]["games"])
        self.scfg = SearchConfig(depth=int(traffic["depth"]),
                                 width=int(traffic["width"]),
                                 since_empty=int(traffic["since_empty"]))
        self.ts = get_tuple_set(int(config["agent"]["n"]))
        self.ts_ref = features.tuples_from_config(config["tuples"])
        if self.ts_ref.total != self.ts.total:
            raise ValueError("the configuration's tuples and the program's "
                             "tuple set differ in size")

    def _trial(self, draws, cb, stop, game_init=None):
        from tpu2048_torch.train.trial import trial

        return trial(self.ts, self.weights, num=self.games,
                     search=self.scfg, steps_per_call=1, progress_cb=cb,
                     stop_cb=stop, draws=draws, game_init=game_init)

    def sampled(self, draw_step: int) -> bool:
        """The window's steps that the check judges, drawn from the
        seed."""
        every = int(self.traffic["check_every"])
        return key_seed(self.seed, "check", draw_step) % every == 0

    def setup(self) -> None:
        self.weights = make_weights(self.ts.total, self.seed, self.device,
                                    self.config["weights"])
        # warm-up on draws of their own: a call whose games start from
        # one crowded board, so that its first steps search every root
        warm = KeyedDraws(key_seed(self.seed, "warm-up"), self.device)
        left = [int(self.traffic["warm_steps"])]

        def stop():
            left[0] -= 1
            return left[0] < 0

        self._trial(warm, None, stop,
                    game_init=np.asarray(self.traffic["warm_board"], np.int8))
        self.draws = KeyedDraws(self.seed, self.device)

    def _play(self, seconds: float, on_step=None, keep_all=False):
        """Calls back to back until ``seconds`` have passed, or until
        ``on_step(steps, elapsed)`` returns True: (steps, step times,
        moves, window).  A step keeps its move log (a view of the call's
        log, which no later step writes over) if the check may judge
        it: if it is sampled, or with ``keep_all``."""
        steps: List[_Step] = []
        times: List[float] = []
        moves = [0]
        state = {"log": None, "last": None}
        sync(self.device)
        t0 = time.perf_counter()
        state["last"] = t0
        stop_at = [None]

        def cb(st):
            now = time.perf_counter()
            times.append(now - state["last"])
            state["last"] = now
            first = state["log"] is not st.moves
            state["log"] = st.moves
            keep = keep_all or self.sampled(self.draws.step)
            steps.append(_Step(self.draws.step, st.codes, st.active,
                               st.odometer, st.moves if keep else None,
                               first))
            if on_step is not None and on_step(steps, now - t0):
                stop_at[0] = time.perf_counter()

        def stop():
            if stop_at[0] is None and time.perf_counter() - t0 >= seconds:
                stop_at[0] = time.perf_counter()
            return stop_at[0] is not None

        while stop_at[0] is None:
            res = self._trial(self.draws, cb, stop)
            moves[0] += int(res.odometers.sum())
        return steps, times, moves[0], stop_at[0] - t0

    def window(self, seconds: float) -> dict:
        steps, times, moves, wall = self._play(seconds)
        self.steps = steps
        return {"play_moves_per_s": moves / wall,
                "search_step_ms_p95": float(np.percentile(times, 95)) * 1e3,
                "attempted": len(times), "failed": 0}

    def traced(self, seconds: float) -> dict:
        """Per-layer inputs: the first call plays on untraced from the
        seed's fresh boards up to its step ``trace_from_step``, where its
        largest tier is searched; its next ``trace_steps`` steps are
        traced.  The stretch is placed by steps, not by time, so that
        it holds the same games' same steps however fast the program
        runs."""
        from tpu2048_torch.ops import kernels

        first = int(self.traffic["trace_from_step"])
        last = first + int(self.traffic["trace_steps"])
        tr = Traced(self.device)
        marks = {}

        def on_step(steps, log) -> bool:
            if len(steps) > 1 and steps[-1].start:
                raise RuntimeError(
                    f"the first call ended after {len(steps) - 1} steps, "
                    f"before the traced stretch's end at step {last}")
            if len(steps) in (first, last):
                (tr.start if len(steps) == first else tr.stop)()
                marks[len(steps)] = len(log["eval_class"])
            return len(steps) == last

        with calls.recording(kernels, ["eval_class"]) as log:
            steps, _, _, _ = self._play(
                float("inf"), lambda st, el: on_step(st, log), keep_all=True)
        # the check judges as many steps as a window's run, drawn from
        # the seed among all the steps played, the traced ones among them
        g = np.random.default_rng(key_seed(self.seed, "traced-check"))
        size = min(int(self.traffic["checked_steps"]), len(steps) - 1)
        judged = set(g.choice(np.arange(1, len(steps)), size=size,
                              replace=False).tolist())
        for i, st in enumerate(steps):
            if i not in judged:
                st.log = None
        self.steps = steps
        return {"kind": "search", "trace": tr.trace,
                "calls": {"eval_class":
                          log["eval_class"][marks[first]:marks[last]]},
                "steps": last - first,
                "needy_roots": self._needy(steps[first - 1:last]),
                "games": self.games, "config": self.config,
                "traffic": self.traffic, "attempted": len(steps),
                "failed": 0}

    def _needy(self, steps) -> List[int]:
        """Each traced step's needy roots (a legal move of a live game,
        fewer than since_empty empty cells after it), from the boards
        before it."""
        from reference import game

        out = []
        for prev, cur in zip(steps, steps[1:]):
            if cur.start:
                continue
            boards = game.from_codes(prev.codes)
            aft, _, legal = game.afterstates(boards)
            need = legal & prev.active[None, :] & \
                (game.empties(aft) < self.scfg.since_empty)
            out.append(int(need.sum()))
        return out

    def free(self) -> None:
        self.weights = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        from .checks import search_check

        return search_check(self)
