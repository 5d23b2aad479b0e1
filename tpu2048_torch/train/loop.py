"""The host training loop (``tpu2048/train/loop.py``).

The reference's cadence, measured in completed episodes: ma-100
points, per-1000 summaries with tile-reach shares and the best board,
checkpoints in the reference's format (``store/checkpoint.py``),
best-game saving, cooperative cancellation.  The hot loop is one
K-step train segment over N lockstep envs; the host reads the
device-resident metrics between segments.

A resume may change the table's representation (canonical-orbit vs
dense): the weights and every extra of their shape are converted.  It
may change the device type too: the saved generator state continues
only on a generator of its own type (CPU or CUDA), and otherwise the
stream starts afresh from ``tcfg.seed``, as the log says.

Under a device mesh (``mesh=``, ``parallel/mesh.py``) every rank runs
this loop on its share of the env batch (and, under a model axis, its
shard of the tables); the state's replicated leaves (metrics, best
game, and the tables without a model axis) are the same on all, so
every rank takes the same turns, and only rank 0 writes: checkpoints,
the best game, the metrics file and the log.  A checkpoint holds the
whole tables whatever the mesh, so it loads in any run; a resume cuts
each rank's shard from it.

``run(trace_dir=...)`` traces the whole session with ``torch.profiler``
(``obs/profiler.py::device_trace``).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..agent import td
from ..config import AgentConfig, TrainConfig
from ..draws import TorchDraws
from ..engine import core as engine
from ..features.canonical import (from_dense_table, is_canonical,
                                  to_dense_table)
from ..features.ntuple import get_tuple_set
from ..obs.jobs import Job
from ..obs.logging import Logger
from ..obs.metrics import MetricsWriter
from ..obs.profiler import Timer, device_trace
from ..parallel import mesh as pmesh
from ..store import checkpoint as ckpt
from ..store.artifacts import ArtifactStore
from . import card_device

TILE_NAMES = [1 << e for e in range(10, 17)]  # 1024 .. 65536
# the generator's state in a checkpoint's extras (the reference keeps
# its threefry key under "rng_key", which has no torch twin), and the
# device type of the generator that made it: a state continues only on
# a generator of the same type
RNG_EXTRA = "torch_rng_state"
RNG_DEVICE_EXTRA = "torch_rng_device"
# the state sizes of the two generator types, for checkpoints saved
# without the device tag: (seed, offset) on CUDA, Mersenne Twister on
# the CPU
_RNG_STATE_BYTES = {16: "cuda", 5056: "cpu"}


def rng_state_device(extras: Dict[str, Any]) -> Optional[str]:
    """The device type ("cpu" or "cuda") of the generator whose state a
    checkpoint's extras hold, or None without a state (or one of no
    known size)."""
    if RNG_EXTRA not in extras:
        return None
    if RNG_DEVICE_EXTRA in extras:
        return str(np.asarray(extras[RNG_DEVICE_EXTRA]))
    return _RNG_STATE_BYTES.get(int(np.asarray(extras[RNG_EXTRA]).size))


def _board_str(board: np.ndarray, score: int) -> str:
    lines = ["".join(f"{(1 << int(v)) if v else 0}".ljust(7) for v in row)
             for row in board]
    lines.append(f"score = {score}")
    return "\n".join(lines)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class Trainer:
    """Owns one agent's training session on one device, or this
    rank's part of it on a mesh.

    ``device`` defaults to the CUDA card (under a ``mesh``, to the
    mesh's device), and without one the trainer raises: the CPU runs
    only when asked for (``device="cpu"``).  Draws come from a
    ``torch.Generator`` on the device seeded with ``tcfg.seed``; its
    state is saved with every checkpoint.  Under a mesh
    ``tcfg.num_envs`` is the global env count, every rank seeds alike
    and takes its env range of the draws, and a resume loads the same
    checkpoint in every rank.
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
        self.name = name
        self.acfg = acfg
        self.tcfg = tcfg
        self.store = store
        self.mesh = mesh
        # only one process writes artifacts, metrics and the log
        self._is_writer = mesh is None or mesh.rank == 0
        self.log = ((logger or Logger(console=True)) if self._is_writer
                    else Logger(console=False))
        self.ts = get_tuple_set(acfg.n)
        if mesh is None:
            self.device = card_device(device, "Trainer")
        else:
            self.device = mesh.device
            if device is not None and \
                    torch.device(device).type != mesh.device.type:
                raise ValueError(f"the mesh runs on {mesh.device}, not on "
                                 f"{device}")
        self.metrics_writer = (
            MetricsWriter(store, name)
            if store is not None and self._is_writer else None)
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
            weights = torch.from_numpy(np.asarray(w, np.float32))
            if is_canonical(loaded_cfg) != is_canonical(acfg):
                # resume-and-retune across representations: convert
                # the weights and the TC accumulators alike
                conv = (to_dense_table if is_canonical(loaded_cfg)
                        else from_dense_table)
                shape = weights.shape
                weights = conv(self.ts, weights)
                if "extras" in meta:
                    meta = {**meta, "extras": {
                        k: conv(self.ts, torch.from_numpy(
                            np.asarray(v, np.float32))).numpy()
                        if np.shape(v) == shape else v
                        for k, v in meta["extras"].items()}}
            self.train_history = list(meta.get("train_history", []))
            self._provenance = {k: meta[k] for k in
                                ("forked_from", "source_episodes") if k in meta}
        if mesh is not None:
            # mesh-native init: each rank builds only its share
            self.state = pmesh.init_sharded_td_state(
                self.ts, acfg, tcfg, mesh, self.draws, weights=weights)
            self._segment = pmesh.make_sharded_train_segment(
                self.ts, acfg, tcfg, mesh, self.draws)
        else:
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
            def table(key):
                x = torch.from_numpy(np.asarray(extras[key], np.float32))
                if self.mesh is not None:
                    x = pmesh.shard_table(x, self.mesh, self.ts)
                return x.to(dev)

            st = st._replace(opt_e=table("opt_e"), opt_a=table("opt_a"))
        saved_on = rng_state_device(extras)
        if saved_on == dev.type:
            # continue the saved stream; env boards restart fresh
            self.draws.generator.set_state(
                torch.from_numpy(np.asarray(extras[RNG_EXTRA], np.uint8)))
        elif RNG_EXTRA in extras:
            # another device type's generator state does not fit this
            # one: the stream starts afresh, as the reference's does
            # from a checkpoint without "rng_key"
            self.log.add(f"the saved generator state is from "
                         f"{saved_on or 'an unknown device type'}, not "
                         f"{dev.type}: a fresh stream from seed "
                         f"{self.tcfg.seed}")

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
        TC accumulators, and the generator's state and device type
        under keys of their own (no ``rng_key``).  Under a mesh's model
        axis every rank first reads the sharded tables whole through
        ``host_full`` (a collective over the model group), before the
        writer check, as the reference's every process does; without
        one the tables are replicated, so rank 0 reads its own copy
        with no collective and the other ranks have nothing to do."""
        if self.store is None:
            return
        st = self.state
        sharded = self.mesh is not None and self.mesh.model > 1
        if not (self._is_writer or sharded):
            return
        spec = pmesh.MODEL if sharded else pmesh.REPLICATED
        tables = {f: pmesh.host_full(getattr(st, f), self.mesh, spec)
                  for f in ("weights", "opt_e", "opt_a")
                  if f == "weights" or self.acfg.optimizer == "tc"}
        if not self._is_writer:
            return
        extras = {RNG_EXTRA: _np(self.draws.generator.get_state()),
                  RNG_DEVICE_EXTRA: np.asarray(self.device.type)}
        if self.acfg.optimizer == "tc":
            extras["opt_e"] = tables["opt_e"]
            extras["opt_a"] = tables["opt_a"]
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
        ckpt.save_agent(self.store, self.name, self.acfg, tables["weights"],
                        meta, extras=extras)

    def _maybe_save_best_game(self) -> None:
        if self.store is None or not self._is_writer:
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
        reported in the final log lines.  With ``trace_dir`` the whole
        session runs inside a ``torch.profiler`` trace written there."""
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
        with device_trace(trace_dir):
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
                    if registry is not None and job is not None \
                            and self._is_writer:
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
        if trace_dir:
            self.log.add(f"device trace written to {trace_dir}")
        self._maybe_save_best_game()
        self.save()
        if self.mesh is not None:
            # no rank may leave run() (and possibly re-read the
            # checkpoint for a resume) before rank 0 finished the save
            self.mesh.barrier()
        episodes = int(self.state.metrics.episodes)
        if self.store is not None:
            self.log.add(f"{self.name} saved at episode {episodes}")
        return {
            "episodes": episodes,
            "top_score": int(self.state.metrics.best_score),
            "env_steps_per_sec": sps,
            "train_history": list(self.train_history),
        }
