"""Application service layer of the port (``tpu2048/apps/service.py``):
the capabilities behind every client.

The reference's service, with its four compute calls moved onto the
port: the train job runs the port's ``Trainer``, the test job and the
device watch its ``trial`` (all through the CUDA kernels on the card),
and a fork's change of table form its ``canonical`` conversions.  The
service resolves its device once, at construction: the CUDA card
unless ``device`` says otherwise, and without a card it raises there
rather than in a job's thread.  Everything else is the reference's:
the seven modes of abachurin/2048's web application (SURVEY §1/§2
"Web application": train/test/watch/replay/play/admin/guide) as plain
methods, so that the HTTP server, the CLI, and the pygame viewer are
thin skins over one implementation; jobs under the
JobManager/JobRegistry; watch/play sessions that hold frame buffers
which clients poll at their own cadence.
"""

from __future__ import annotations

import random
import threading
import time
import uuid
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..config import (
    AgentConfig,
    SearchConfig,
    TrainConfig,
    agent_config_from_dict,
    to_dict,
    train_config_from_dict,
)
from ..engine.parity import ParityGame
from ..features import ntuple
from ..obs.jobs import Job, JobManager, JobRegistry
from ..obs.logging import Logger, log_key
from ..obs.metrics import train_history
from ..store import checkpoint as ckpt
from ..store.artifacts import ArtifactStore
from ..train import card_device

# The reference's 7 UI modes (dash_utils.py:15-23).
MODES = [
    {"id": "guide", "label": "Guide"},
    {"id": "train", "label": "Train Agent"},
    {"id": "test", "label": "Test Agent"},
    {"id": "watch", "label": "Watch Agent"},
    {"id": "replay", "label": "Replay Game"},
    {"id": "play", "label": "Play Yourself"},
    {"id": "admin", "label": "Admin"},
]

# Training-params form spec (the reference's field set,
# dash_utils.py:29-38, plus the optimizer choice).  Defaults are the
# champion recipe (AgentConfig defaults); pick optimizer=sgd +
# alpha=0.25 to reproduce the reference's own rule — the decay fields
# only apply there.
PARAMS_SPEC = [
    {"name": "name", "type": "text", "default": "test_agent"},
    # n=7 extends the reference's form range (dash_utils.py:31): the
    # six-tuple blocks packed base 16 unclipped (features/ntuple.py)
    {"name": "n", "type": "select", "default": 5,
     "options": [2, 3, 4, 5, 6, 7]},
    {"name": "optimizer", "type": "select", "default": "tc",
     "options": ["tc", "sgd"]},
    {"name": "alpha", "type": "number", "default": 1.0, "step": 0.0001},
    {"name": "decay", "type": "number", "default": 0.75, "step": 0.01},
    {"name": "decay_step", "type": "number", "default": 10000, "step": 1000},
    {"name": "low_alpha_limit", "type": "number", "default": 0.01,
     "step": 0.0001},
    {"name": "episodes", "type": "number", "default": 100000, "step": 1000},
]


def _frame(board: np.ndarray, score: int, odometer: int,
           next_move: int) -> Dict[str, Any]:
    return {
        "board": np.asarray(board, int).tolist(),
        "score": int(score),
        "odometer": int(odometer),
        "next_move": int(next_move),
    }


class WatchSession:
    """Producer thread fills ``frames``; clients poll ``since`` an index
    (the reference's GAME_PANE history polling)."""

    def __init__(self):
        self.frames: List[Dict[str, Any]] = []
        self.done = False
        self.lock = threading.Lock()

    def add(self, frame: Dict[str, Any]) -> None:
        with self.lock:
            self.frames.append(frame)

    def get(self, since: int) -> Dict[str, Any]:
        with self.lock:
            return {"frames": self.frames[since:], "done": self.done,
                    "total": len(self.frames)}


class AppService:
    """The service over ``store``; its jobs compute on ``device`` (the
    CUDA card by default; ``"cpu"`` only when asked for)."""

    def __init__(self, store: ArtifactStore, default_tcfg:
                 Optional[TrainConfig] = None, device=None):
        self.device = card_device(device, "AppService")
        self.store = store
        self.registry = JobRegistry(store)
        self.jobs = JobManager(self.registry)
        self.default_tcfg = default_tcfg or TrainConfig()
        self.watches: Dict[str, WatchSession] = {}
        self.plays: Dict[str, ParityGame] = {}
        self._lock = threading.Lock()
        from ..obs.telemetry import MemoryMonitor

        self.memory = MemoryMonitor(store)

    # -- discovery / admin (application.py:222-299) ------------------------

    def modes(self) -> List[Dict[str, str]]:
        return MODES

    def guide_docs(self) -> Dict[str, str]:
        """Markdown documents for the Guide mode (the reference serves
        its user guide + 4 project-description pages via modals,
        ``application.py:185-219``).  Read from the repo ``docs/`` tree
        when present, with a built-in fallback for bare installs."""
        import pathlib

        docs_dir = pathlib.Path(__file__).resolve().parents[2] / "docs"
        out: Dict[str, str] = {}
        for key, fn in (("guide", "user_guide.md"),
                        ("project", "project.md"),
                        ("design", "design.md")):
            p = docs_dir / fn
            try:
                out[key] = p.read_text()
            except OSError:
                pass
        out.setdefault("guide", (
            "# tpu2048\n\nTPU-native 2048 RL: train, test, watch and "
            "replay n-tuple TD(0) agents; play yourself; manage stored "
            "artifacts in Admin."
        ))
        return out

    def params_spec(self) -> List[Dict[str, Any]]:
        return PARAMS_SPEC

    def list_agents(self) -> List[str]:
        return [k[len("a/"):-len(".json")]
                for k in self.store.list_keys("a/")]

    def agent_info(self, name: str) -> Dict[str, Any]:
        """Stored hyperparameters + metadata for one agent, with a
        ``form`` dict prefilled by the reference's train-form precedence
        (``application.py:537-552``): agent attributes (the live values
        saved in the checkpoint meta — alpha, episodes) override the
        saved config artifact (``c/config_<name>.json``), which
        overrides the params-spec defaults."""
        doc = self.store.load(ckpt.agent_key(name))
        if doc is None:
            raise KeyError(f"no such agent: {name}")
        stored_cfg = dict(doc.get("config", {}))
        meta = dict(doc.get("meta", {}))
        cfg_artifact = self.store.load(f"c/config_{name}.json") or {}
        form: Dict[str, Any] = {
            s["name"]: s["default"] for s in PARAMS_SPEC
        }
        form["name"] = name
        for field in form:
            if field in cfg_artifact:
                form[field] = cfg_artifact[field]
        for field in form:
            if field in stored_cfg:
                form[field] = stored_cfg[field]
        # live agent attributes win over both configs (the reference
        # fills from the loaded agent first)
        if "alpha" in meta:
            form["alpha"] = meta["alpha"]
        return {
            "name": name,
            "config": stored_cfg,
            "meta": {k: v for k, v in meta.items()
                     if k != "train_history"},
            "history_len": len(meta.get("train_history", [])),
            "form": form,
        }

    def list_games(self) -> List[str]:
        return [k[len("g/"):-len(".npz")]
                for k in self.store.list_keys("g/")]

    def list_files(self) -> List[str]:
        return self.store.list_keys()

    def delete_file(self, key: str) -> None:
        self.store.delete(key)

    def upload_file(self, key: str, data: bytes) -> None:
        self.store.save_bytes(key, data)

    def download_file(self, key: str) -> Optional[bytes]:
        return self.store.load_bytes(key)

    # -- heartbeat / liveness (application.py:164-182,784-805) -------------

    def heartbeat(self, parent: str) -> None:
        self.registry.heartbeat(parent)
        # memory telemetry on the heartbeat cadence, the reference's
        # psutil sampling in refresh_status (start.py:131-141)
        self.memory.sample(tag=parent)

    def vacuum(self) -> List[str]:
        return self.registry.vacuum()

    def system_stats(self) -> Dict[str, Any]:
        """Current host/device memory picture + the sampled history
        (the reference's memory_usage.txt display)."""
        from ..obs import telemetry

        return {"now": telemetry.snapshot(), "history": self.memory.tail()}

    # -- train (application.py:471-621) ------------------------------------

    def start_training(self, params: Dict[str, Any], parent: str = "web",
                       new_agent: bool = True,
                       source_agent: Optional[str] = None) -> Dict[str, Any]:
        """Start a training job.

        Three entry modes, matching the reference's train form semantics
        (``application.py:586-600``):
          * ``new_agent=True``            — fresh weights under a new name
            (existing names are guarded, never silently overwritten);
          * ``new_agent=False``           — resume the named agent,
            retuning hyperparameters from ``params``;
          * ``source_agent="other"``      — FORK: clone another agent's
            weights (and optimizer accumulators) under the new name,
            retune hyperparameters, and train the copy (the reference's
            ``add_weights='weights/<name>.pkl'`` carry-over,
            ``r_learning.py:269-275``).
        """
        name = str(params.get("name", "")).strip()
        if not name or not all(c.isalnum() or c in "-_" for c in name):
            raise ValueError("agent name must be alphanumeric/-/_")
        acfg = agent_config_from_dict(
            {k: v for k, v in params.items() if v is not None}
        )
        episodes = int(params.get("episodes", 100000))
        tcfg = train_config_from_dict(
            {**to_dict(self.default_tcfg), "episodes": episodes}
        )
        if source_agent:
            acfg = self._fork_agent(source_agent, name, acfg)
            resume = True
        else:
            resume = not new_agent
            if resume and not self.store.exists(ckpt.agent_key(name)):
                raise ValueError(f"agent '{name}' does not exist")
            if not resume and self.store.exists(ckpt.agent_key(name)):
                raise ValueError(
                    f"agent '{name}' already exists; continue it, or fork "
                    f"it under a new name"
                )
        # persist the chosen config as an artifact (c/ namespace)
        self.store.save(f"c/config_{name}.json", to_dict(acfg))
        session_log = log_key()
        logger = Logger(store=self.store, key=session_log, console=False)
        self.registry.acquire("log", session_log, parent)

        from ..train.loop import Trainer

        def body(job: Job):
            trainer = Trainer(name, acfg, tcfg, store=self.store,
                              logger=logger, resume=resume,
                              device=self.device)
            return trainer.run(job=job, registry=self.registry)

        job = self.jobs.start(body, "agent", name, parent=parent,
                              exclusive=True)
        return {"job": job.id, "log": session_log}

    def _fork_agent(self, source: str, name: str, acfg: AgentConfig
                    ) -> AgentConfig:
        """Clone ``source``'s weights under ``name`` with retuned
        hyperparameters; the new agent starts its own episode count and
        history (reference weight carry-over semantics)."""
        import dataclasses

        if not self.store.exists(ckpt.agent_key(source)):
            raise ValueError(f"source agent '{source}' does not exist")
        if self.store.exists(ckpt.agent_key(name)):
            raise ValueError(f"agent '{name}' already exists")
        if name == source:
            raise ValueError("fork needs a new name")
        src_cfg, weights, src_meta = ckpt.load_agent(self.store, source)
        # the tuple geometry is baked into the weight table
        acfg = dataclasses.replace(acfg, n=src_cfg.n)
        extras = None
        if acfg.optimizer == "tc" and src_cfg.optimizer == "tc":
            se = src_meta.get("extras", {})
            if "opt_e" in se:
                extras = {"opt_e": se["opt_e"], "opt_a": se["opt_a"]}
        # table-representation conversion when the fork changes the
        # symmetry impl (canonical-orbit form <-> dense, see
        # features/canonical.py); TC accumulators convert the same way
        from ..features import canonical as canon

        if canon.is_canonical(src_cfg) != canon.is_canonical(acfg):
            ts = ntuple.get_tuple_set(acfg.n)
            conv = (canon.to_dense_table if canon.is_canonical(src_cfg)
                    else canon.from_dense_table)
            weights = conv(ts, torch.from_numpy(weights)).numpy()
            if extras is not None:
                extras = {
                    k: conv(ts, torch.from_numpy(np.asarray(v))).numpy()
                    for k, v in extras.items()
                }
        meta = {
            "episodes": 0,
            "alpha": acfg.alpha,
            "next_decay": acfg.decay_step,
            "train_history": [],
            "forked_from": source,
            "source_episodes": int(src_meta.get("episodes", 0)),
        }
        ckpt.save_agent(self.store, name, acfg, np.asarray(weights),
                        meta, extras=extras)
        return acfg

    def stop_training(self, name: str) -> bool:
        return self.jobs.cancel("agent", name)

    def training_status(self, name: str) -> Dict[str, Any]:
        job = self.jobs.get("agent", name)
        if job is None:
            return {"state": "none"}
        return {
            "state": "running" if job.alive else "finished",
            "error": job.error,
            "result": job.result if not job.alive else None,
        }

    def chart(self, name: str) -> Dict[str, Any]:
        """Training-history chart data (application.py:649-693)."""
        hist = train_history(self.store, name)
        if not hist:
            doc = self.store.load(ckpt.agent_key(name)) or {}
            hist = list(doc.get("meta", {}).get("train_history", []))
        return {
            "x": [100 * (i + 1) for i in range(len(hist))],
            "y": hist,
            "agent": name,
        }

    # -- test / collect statistics (application.py:445-468) ----------------

    def start_test(self, name: str, num: int = 100, depth: int = 0,
                   width: int = 1, since_empty: int = 6,
                   parent: str = "web",
                   policy: Optional[str] = None) -> Dict[str, Any]:
        """Evaluate an agent — or, with ``policy`` set to "random" /
        "score", one of the reference's baseline estimators
        (``game_logic.py:5-10``).  The baseline choice is its own field
        so stored agents named "random"/"score" stay evaluable."""
        session_log = log_key()
        logger = Logger(store=self.store, key=session_log, console=False)
        self.registry.acquire("log", session_log, parent)
        if policy in ("random", "score"):
            name, ts, weights = policy, ntuple.get_tuple_set(2), None
        elif policy not in (None, "", "value"):
            raise ValueError(f"unknown policy: {policy}")
        else:
            policy = "value"
            acfg, weights, _ = ckpt.load_agent_dense(self.store, name,
                                                     self.device)
            ts = ntuple.get_tuple_set(acfg.n)

        def body(job: Job):
            from ..train.trial import trial

            logger.add(f"Trial run for {num} games, Agent = {name}")
            logger.add(f"Looking forward: depth={depth}, width={width}, "
                       f"since_empty={since_empty}")
            res = trial(
                ts, weights, num=num, policy=policy, device=self.device,
                search=SearchConfig(depth=depth, width=width,
                                    since_empty=since_empty),
                logger=logger, stop_cb=job.should_stop,
            )
            if res.best_game is not None:
                ckpt.save_game(self.store, f"best_trial_{name}",
                               res.best_game)
                logger.add(f"Best game saved at g/best_trial_{name}.npz")
            return {"avg": float(res.scores.mean())}

        job = self.jobs.start(body, "test", name, parent=parent)
        return {"job": job.id, "log": session_log}

    def stop_test(self, name: str) -> bool:
        return self.jobs.cancel("test", name)

    # -- watch agent play (application.py:398-442) --------------------------

    def start_watch(self, name: str, depth: int = 0, width: int = 1,
                    since_empty: int = 6, parent: str = "web",
                    backend: str = "auto") -> str:
        """Start a live watch session.

        ``backend`` selects the play engine: "native" (C++ host
        engine), "python" (reference-parity sequential engine),
        "device" (the batched expectimax path on the service's device,
        through the CUDA kernels on the card — the same code ``trial``
        runs, streamed one game at a time), or "auto" (native if built,
        else python).
        """
        if backend not in ("auto", "native", "python", "device"):
            raise ValueError(f"unknown watch backend: {backend}")
        # the device path takes the table on its device, once; the host
        # engines as numpy
        on_device = backend == "device"
        acfg, weights, _ = ckpt.load_agent_dense(
            self.store, name, self.device if on_device else "cpu")
        ts = ntuple.get_tuple_set(acfg.n)
        w = None if on_device else weights.numpy()

        session_id = uuid.uuid4().hex[:12]
        ws = WatchSession()
        self.watches[session_id] = ws

        native_engine = None
        if backend in ("auto", "native"):
            try:
                from .. import native as native_mod

                if native_mod.available():
                    native_engine = native_mod.NativeEngine(
                        ts, w, seed=random.getrandbits(32)
                    )
            except Exception:  # pragma: no cover - toolchain-less hosts
                native_engine = None
            if backend == "native" and native_engine is None:
                raise ValueError("native engine not built on this host")

        def body_native(job: Job):
            # C++ fast path: greedy/expectimax stepping at ms latency
            # even for the reference's 1 s/move depth-3 searches.
            ne = native_engine
            board = np.zeros((4, 4), np.int8)
            board, _, _ = ne.spawn(board)
            board, _, _ = ne.spawn(board)
            score, odo = 0, 0
            ws.add(_frame(board, 0, 0, -2))
            while not job.should_stop():
                d, aft, delta = ne.best_move(
                    board, depth=depth, width=width,
                    since_empty=since_empty,
                )
                if d < 0:
                    break
                ws.add(_frame(board, score, odo, d))
                score += delta
                odo += 1
                board, _, _ = ne.spawn(aft)
                if len(ws.frames) > 100000:
                    break
            ws.add(_frame(board, score, odo, -1))
            ws.done = True

        def body_python(job: Job):
            matrix, offsets = ts.matrix, ts.offsets

            def estimator(row: np.ndarray, score: int) -> float:
                v = np.concatenate(
                    [row.ravel(), np.minimum(row.ravel(), 13)]
                )
                idx = (matrix @ v.astype(np.float64)).astype(
                    np.int64
                ) + offsets
                return float(w[idx].sum())

            game = ParityGame(rng=random.Random())
            ws.add(_frame(game.row, 0, 0, -2))
            for state, move in game.generate_run(
                estimator, depth=depth, width=width,
                since_empty=since_empty,
            ):
                if job.should_stop():
                    return
                ws.add(_frame(state.row, state.score, state.odometer, move))
                if len(ws.frames) > 100000:
                    break
            ws.add(_frame(game.row, game.score, game.odometer, -1))
            ws.done = True

        def body_device(job: Job):
            # device path: the SAME batched (compacted) expectimax
            # ``trial`` runs, on a single game with one device step
            # per move; frames are emitted move-by-move with the
            # reference's (pre-move board, chosen move) semantics by
            # diffing consecutive states.
            from ..engine import fast as engf
            from ..train.trial import trial as run_trial

            prev: Dict[str, Any] = {}

            def cb(st):
                board = engf.boards_from_codes(st.codes)[0].cpu().numpy()
                score = int(st.score[0])
                odo = int(st.odometer[0])
                if prev and odo > prev["odo"]:
                    mv = int(st.moves[0, prev["odo"]])
                    ws.add(_frame(prev["board"], prev["score"],
                                  prev["odo"], mv))
                prev.update(board=board, score=score, odo=odo)

            ws.add(_frame(np.zeros((4, 4), np.int8), 0, 0, -2))
            run_trial(
                ts, weights, num=1, steps_per_call=1,
                seed=random.getrandbits(31),
                search=SearchConfig(depth=depth, width=width,
                                    since_empty=since_empty),
                progress_cb=cb, stop_cb=job.should_stop,
            )
            if prev:
                ws.add(_frame(prev["board"], prev["score"], prev["odo"],
                              -1))
            ws.done = True

        if backend == "device":
            body = body_device
        elif backend == "python":
            body = body_python
        else:
            body = body_native if native_engine is not None else body_python
        self.jobs.start(body, "watch", session_id, parent=parent)
        return session_id

    def watch_frames(self, session_id: str, since: int = 0) -> Dict[str, Any]:
        ws = self.watches.get(session_id)
        if ws is None:
            raise KeyError(f"no watch session {session_id}")
        return ws.get(since)

    def stop_watch(self, session_id: str) -> bool:
        return self.jobs.cancel("watch", session_id)

    # -- replay stored game (application.py:321-395) ------------------------

    def replay_frames(self, game_name: str) -> List[Dict[str, Any]]:
        rec = ckpt.load_game(self.store, game_name)
        g = ParityGame(row=np.array(rec["starting_position"], np.int32))
        frames = []
        for t in range(rec["odometer"]):
            move = int(rec["moves"][t])
            frames.append(_frame(g.row, g.score, t, move))
            g.row, g.score, _ = g.pre_move(g.row, g.score, move)
            val, i, j = (int(x) for x in rec["tiles"][t])
            g.row[i, j] = val
        frames.append(_frame(rec["final_board"], rec["score"],
                             rec["odometer"], -1))
        return frames

    # -- play yourself (application.py:696-760) -----------------------------

    def play_new(self) -> Dict[str, Any]:
        session_id = uuid.uuid4().hex[:12]
        game = ParityGame(rng=random.Random())
        with self._lock:
            if len(self.plays) > 256:  # drop oldest sessions
                for k in list(self.plays)[:64]:
                    del self.plays[k]
            self.plays[session_id] = game
        return {"session": session_id,
                **_frame(game.row, 0, 0, -2), "game_over": False}

    def play_move(self, session_id: str, direction: int) -> Dict[str, Any]:
        game = self.plays.get(session_id)
        if game is None:
            raise KeyError(f"no play session {session_id}")
        if direction not in (0, 1, 2, 3):
            raise ValueError("direction must be 0..3")
        new_row, new_score, changed = game.pre_move(
            game.row, game.score, direction
        )
        if changed:
            game.row, game.score = new_row, new_score
            game.odometer += 1
            game.moves.append(direction)
            game.new_tile()
        over = game.game_over(game.row)
        return {
            "session": session_id,
            **_frame(game.row, game.score, game.odometer,
                     -1 if over else -2),
            "changed": bool(changed),
            "game_over": bool(over),
        }

    # -- logs window (application.py:763-858) -------------------------------

    def logs(self, key: str, max_chars: int = 20000) -> str:
        content = self.store.load(key)
        return (content or "")[-max_chars:]

    def clear_logs(self, key: str) -> None:
        self.store.save(key, "")
