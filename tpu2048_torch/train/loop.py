"""The host training loop on one device (``tpu2048/train/loop.py``).

The reference's cadence, measured in completed episodes: ma-100
points, per-1000 summaries with tile-reach shares and the best board,
checkpoints through the shared ``tpu2048.store.checkpoint``,
best-game saving, cooperative cancellation.  The hot loop is one
K-step train segment over N lockstep envs; the host reads the
device-resident metrics between segments.

Not ported yet: a device mesh (``mesh=``, ROADMAP.md Queue 1 item 5),
a profiler trace (``trace_dir=``, item 6), and a resume that changes
the table's representation (needs ``from_dense_table``, item 1).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from tpu2048.config import AgentConfig, TrainConfig
from tpu2048.obs.jobs import Job
from tpu2048.obs.logging import Logger
from tpu2048.obs.metrics import MetricsWriter
from tpu2048.obs.profiler import Timer
from tpu2048.store import checkpoint as ckpt
from tpu2048.store.artifacts import ArtifactStore

from ..agent import td
from ..draws import TorchDraws
from ..engine import core as engine
from ..features.canonical import is_canonical
from ..features.ntuple import get_tuple_set

TILE_NAMES = [1 << e for e in range(10, 17)]  # 1024 .. 65536
# the generator's state in a checkpoint's extras (the reference keeps
# its threefry key under "rng_key", which has no torch twin)
RNG_EXTRA = "torch_rng_state"


def _board_str(board: np.ndarray, score: int) -> str:
    lines = ["".join(f"{(1 << int(v)) if v else 0}".ljust(7) for v in row)
             for row in board]
    lines.append(f"score = {score}")
    return "\n".join(lines)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class Trainer:
    """Owns one agent's training session on one device.

    ``device`` defaults to the CUDA card when there is one, else the
    CPU.  Draws come from a ``torch.Generator`` on the device seeded
    with ``tcfg.seed``; its state is saved with every checkpoint.
    """

    def __init__(
        self,
        name: str,
        acfg: AgentConfig,
        tcfg: TrainConfig,
        store: Optional[ArtifactStore] = None,
        logger: Optional[Logger] = None,
        mesh=None,
        resume: bool = False,
        device=None,
    ):
        if mesh is not None:
            raise NotImplementedError(
                "a device mesh is not ported yet: it waits for ROADMAP.md "
                'Queue 1 item 5 ("Data parallel + multi-process")')
        self.name = name
        self.acfg = acfg
        self.tcfg = tcfg
        self.store = store
        self.log = logger or Logger(console=True)
        self.ts = get_tuple_set(acfg.n)
        self.device = torch.device(
            device or ("cuda" if torch.cuda.is_available() else "cpu"))
        self.metrics_writer = (MetricsWriter(store, name)
                               if store is not None else None)
        self.train_history: list = []
        gen = torch.Generator(device=self.device)
        gen.manual_seed(tcfg.seed)
        self.draws = TorchDraws(gen)

        weights = None
        meta: Dict[str, Any] = {}
        self._provenance: Dict[str, Any] = {}
        if resume:
            if store is None:
                raise ValueError("resume requires a store")
            loaded_cfg, w, meta = ckpt.load_agent(store, name)
            if loaded_cfg.n != acfg.n:
                raise ValueError(
                    f"agent '{name}' has n={loaded_cfg.n}, requested n={acfg.n}"
                )
            if is_canonical(loaded_cfg) != is_canonical(acfg):
                raise NotImplementedError(
                    "a resume that changes the table's representation "
                    "(canonical-orbit vs dense) needs from_dense_table, "
                    "which waits for ROADMAP.md Queue 1 item 1")
            weights = torch.from_numpy(np.asarray(w, np.float32))
            self.train_history = list(meta.get("train_history", []))
            self._provenance = {k: meta[k] for k in
                                ("forked_from", "source_episodes") if k in meta}
        self.state = td.init_td_state(self.ts, acfg, tcfg, self.draws,
                                      self.device, weights=weights)
        self._segment = td.make_train_segment(self.ts, acfg, tcfg,
                                              self.draws)
        if resume and meta:
            self._restore(meta)
        self._saved_best = int(self.state.metrics.best_score)

    def _restore(self, meta: Dict[str, Any]) -> None:
        """TC accumulators, generator stream and schedule counters of a
        resumed agent."""
        dev = self.device
        extras = meta.get("extras", {})
        st = self.state
        if self.acfg.optimizer == "tc" and "opt_e" in extras:
            st = st._replace(
                opt_e=torch.from_numpy(np.asarray(extras["opt_e"],
                                                  np.float32)).to(dev),
                opt_a=torch.from_numpy(np.asarray(extras["opt_a"],
                                                  np.float32)).to(dev))
        if RNG_EXTRA in extras:
            # continue the saved stream; env boards restart fresh
            self.draws.generator.set_state(
                torch.from_numpy(np.asarray(extras[RNG_EXTRA], np.uint8)))

        def scalar(v, dtype):
            return torch.tensor(v, dtype=dtype, device=dev)

        self.state = st._replace(
            alpha=scalar(meta.get("alpha", self.acfg.alpha), torch.float32),
            next_decay=scalar(meta.get("next_decay", self.acfg.decay_step),
                              torch.int32),
            top_tile=scalar(meta.get("top_tile", 10), torch.int32),
            metrics=st.metrics._replace(
                episodes=scalar(meta.get("episodes", 0), torch.int32),
                best_score=scalar(meta.get("top_score", 0), torch.int32)),
        )

    # -- cadenced reporting -------------------------------------------------

    def _ring_slice(self, metrics: td.Metrics, count: int) -> tuple:
        ring = self.tcfg.ring_size
        pos = int(metrics.ring_pos)
        take = min(count, pos, ring)
        idx = np.arange(pos - take, pos) % ring
        return _np(metrics.score_ring)[idx], _np(metrics.tile_ring)[idx]

    def _drain_history(self, next_100: int) -> int:
        """Append one ma-100 point per 100-episode window crossed since
        the last drain, each from its own ring span; windows the ring
        has overwritten get the mean over all surviving new episodes,
        logged as coalesced.  Returns the next boundary."""
        every = self.tcfg.log_every
        ring = self.tcfg.ring_size
        met = self.state.metrics
        pos = int(met.ring_pos)
        if pos < next_100:
            return next_100
        scores_np = _np(met.score_ring)
        alpha = float(self.state.alpha)
        coalesced = 0
        while pos >= next_100:
            start, end = next_100 - every, next_100
            if pos - start <= ring:
                window = scores_np[np.arange(start, end) % ring]
            else:  # overwritten: coalesce onto surviving episodes
                window = scores_np[np.arange(pos - ring, pos) % ring]
                coalesced += 1
            ma = int(window.mean())
            self.train_history.append(ma)
            self.log.add(f"episode {next_100}: ma_100 = {ma} "
                         f"(window top {int(window.max())})")
            if self.metrics_writer is not None:
                self.metrics_writer.write(
                    {"kind": "ma100", "episodes": next_100, "ma100": ma,
                     "alpha": alpha})
            next_100 += every
        if coalesced:
            self.log.add(f"({coalesced} ma_{every} windows outran the "
                         f"{ring}-episode ring and were coalesced)")
        return next_100

    def _report_1000(self, episodes: int, t_block: float) -> None:
        scores, tiles = self._ring_slice(self.state.metrics, 1000)
        if len(scores) == 0:
            return
        alpha = float(self.state.alpha)
        self.log.add("\n------")
        self.log.add(f"{round(t_block / 60, 2)} min")
        self.log.add(f"episode = {episodes}")
        self.log.add(f"average over last {len(scores)} episodes = "
                     f"{round(float(scores.mean()), 3)}")
        for j, tile in enumerate(TILE_NAMES):
            r = float((tiles >= j + 10).mean() * 100)
            if r:
                self.log.add(f"{tile} reached in {round(r, 1)} %")
        if int(self.state.recorder.best_score) > 0:
            final = self._best_game_record()
            self.log.add("best recorded game of this agent:")
            self.log.add(_board_str(final["final_board"], final["score"]))
        self.log.add(f"episode = {episodes}, current learning rate = "
                     f"{round(alpha, 4)}")
        self.log.add("------\n")
        if self.metrics_writer is not None:
            self.metrics_writer.write({
                "kind": "summary1000",
                "episodes": episodes,
                "avg1000": float(scores.mean()),
                "reach": {str(t): float((tiles >= j + 10).mean())
                          for j, t in enumerate(TILE_NAMES)},
                "alpha": alpha,
                "top_score": int(self.state.metrics.best_score),
            })

    def _best_game_record(self) -> Dict[str, Any]:
        """The best recorded game as a replayable record (host-side
        replay of the device's move and spawn logs)."""
        rec = self.state.recorder
        length = int(rec.best_len)
        start = _np(rec.best_start).astype(np.int8)
        moves = _np(rec.best_moves)[:length]
        spawns = _np(rec.best_spawns)[:length]
        board = start.copy()
        score = 0
        tiles = []
        for t in range(length):
            nb, delta, _ = engine.np_move(board, int(moves[t]))
            score += delta
            sp = int(spawns[t]) & 0xFF
            pos, val = sp & 0xF, (sp >> 4) + 1
            nb = nb.reshape(16).copy()
            nb[pos] = val
            board = nb.reshape(4, 4)
            tiles.append((val, pos // 4, pos % 4))
        return {
            "starting_position": start,
            "moves": moves.astype(np.int8),
            "tiles": np.asarray(tiles, np.int8).reshape(-1, 3),
            "score": score,
            "odometer": length,
            "final_board": board.astype(np.int8),
        }

    # -- checkpointing ------------------------------------------------------

    def save(self) -> None:
        """The agent in the reference's checkpoint format: weights, the
        TC accumulators, and the generator's state under its own key
        (no ``rng_key``)."""
        if self.store is None:
            return
        st = self.state
        extras = {RNG_EXTRA: _np(self.draws.generator.get_state())}
        if self.acfg.optimizer == "tc":
            extras["opt_e"] = _np(st.opt_e)
            extras["opt_a"] = _np(st.opt_a)
        meta = {
            **self._provenance,
            "episodes": int(st.metrics.episodes),
            "top_score": int(st.metrics.best_score),
            "top_tile": int(st.top_tile),
            "alpha": float(st.alpha),
            "next_decay": int(st.next_decay),
            "train_history": [int(x) for x in self.train_history],
            "num_envs": self.tcfg.num_envs,
        }
        ckpt.save_agent(self.store, self.name, self.acfg, _np(st.weights),
                        meta, extras=extras)

    def _maybe_save_best_game(self) -> None:
        if self.store is None:
            return
        best = int(self.state.recorder.best_score)
        if best > self._saved_best:
            self._saved_best = best
            ckpt.save_game(self.store, f"best_of_{self.name}",
                           self._best_game_record())
            self.log.add(f"\nnew best recorded game ({best})! saved to "
                         f"g/best_of_{self.name}.npz\n")

    # -- main loop ----------------------------------------------------------

    def run(self, job: Optional[Job] = None, registry=None,
            trace_dir: Optional[str] = None) -> Dict[str, Any]:
        """Train until ``tcfg.episodes`` more episodes completed or the
        job is cancelled; host phases are timed with ``Timer`` and
        reported in the final log lines."""
        if trace_dir:
            raise NotImplementedError(
                "device traces (torch.profiler) are not ported yet: they "
                'wait for ROADMAP.md Queue 1 item 6 ("Apps / obs / entry")')
        tcfg = self.tcfg
        timer = self.timer = Timer()
        start_eps = int(self.state.metrics.episodes)
        target = start_eps + tcfg.episodes
        self.log.add(
            f"Agent {self.name} training session started, "
            f"episodes = {start_eps}, target = {target}, "
            f"n = {self.acfg.n}, envs = {tcfg.num_envs}, "
            f"device = {self.device}")
        next_100 = (start_eps // tcfg.log_every + 1) * tcfg.log_every
        next_1000 = (start_eps // tcfg.checkpoint_every + 1
                     ) * tcfg.checkpoint_every
        t_global = t_block = time.time()
        steps_done = 0
        while True:
            if job is not None and job.should_stop():
                self.log.add("training cancelled")
                break
            with timer.section("train_segment"):
                self.state = self._segment(self.state)
            steps_done += tcfg.steps_per_call * tcfg.num_envs
            with timer.section("metrics_read"):
                # the one read of the segment waits for the device
                episodes = int(self.state.metrics.episodes)
                if registry is not None and job is not None:
                    registry.heartbeat(job.parent)
                next_100 = self._drain_history(next_100)
            if episodes >= next_1000:
                with timer.section("checkpoint"):
                    self._report_1000(episodes, time.time() - t_block)
                    t_block = time.time()
                    self._maybe_save_best_game()
                    self.save()
                next_1000 = (episodes // tcfg.checkpoint_every + 1
                             ) * tcfg.checkpoint_every
            if episodes >= target:
                break
        total = time.time() - t_global
        sps = steps_done / max(total, 1e-9)
        self.log.add(
            f"Total time = {int(total) // 60} min {int(total) % 60} sec "
            f"({sps / 1e3:.0f}K env-steps/s)")
        self.log.add("timing:\n" + timer.report())
        self._maybe_save_best_game()
        self.save()
        episodes = int(self.state.metrics.episodes)
        if self.store is not None:
            self.log.add(f"{self.name} saved at episode {episodes}")
        return {
            "episodes": episodes,
            "top_score": int(self.state.metrics.best_score),
            "env_steps_per_sec": sps,
            "train_history": list(self.train_history),
        }
