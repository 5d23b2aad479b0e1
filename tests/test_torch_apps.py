"""The port's application layer (``tpu2048_torch/apps``) on the CPU.

The twin of every test of ``tests/test_apps.py``, with the same
assertions, against the port's HTTP server over an ``AppService`` on
``device="cpu"``; then the two packages side by side: the JAX
package's ``AppService`` over the same store (no server, no training:
no JAX compile is paid) gives exactly the port's deterministic
outputs, both servers serve the same page, a fork's weights and TC
sums are bitwise JAX's in both directions of the table's form, and an
agent forked by the port plays a trial in JAX's service."""

import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
from _torch_port import jax_cfg

from tpu2048.apps.server import AppServer as JaxAppServer
from tpu2048.apps.service import AppService as JaxAppService
from tpu2048_torch.apps.server import AppServer
from tpu2048_torch.apps.service import AppService
from tpu2048_torch.config import AgentConfig, TrainConfig
from tpu2048_torch.features.ntuple import get_tuple_set
from tpu2048_torch.obs.logging import Logger
from tpu2048_torch.store import checkpoint as ckpt
from tpu2048_torch.store.artifacts import MemoryStore
from tpu2048_torch.train.loop import Trainer

TINY = TrainConfig(
    num_envs=32, steps_per_call=32, ring_size=256, record_envs=8,
    max_record_steps=2048, seed=0, episodes=60, checkpoint_every=50,
    log_every=25,
)


@pytest.fixture(scope="module", autouse=True)
def native_dir(tmp_path_factory):
    """The native engine builds into this module's own directory: xdist
    workers that build it beside its source at once could load each
    other's half-written library."""
    old = os.environ.get("TPU2048_NATIVE_DIR")
    os.environ["TPU2048_NATIVE_DIR"] = str(tmp_path_factory.mktemp("native"))
    yield
    if old is None:
        del os.environ["TPU2048_NATIVE_DIR"]
    else:
        os.environ["TPU2048_NATIVE_DIR"] = old


def _train(store, name):
    Trainer(name, AgentConfig(n=2), TINY, store=store,
            logger=Logger(console=False), device="cpu").run()


def _copy_agent(src_store, src, store, name):
    """``src``'s stored agent under ``name`` in ``store``: a trained
    agent at the price of a copy."""
    acfg, w, meta = ckpt.load_agent(src_store, src)
    extras = meta.pop("extras", None)
    ckpt.save_agent(store, name, acfg, w, meta, extras=extras)


@pytest.fixture(scope="module")
def server():
    store = MemoryStore()
    # pre-train a small agent so test/watch/replay modes have content
    _train(store, "webby")
    service = AppService(store, default_tcfg=TINY, device="cpu")
    srv = AppServer(service, port=0, vacuum_interval=3600)
    srv.start()
    yield srv
    srv.stop()


def _get(server, path):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{server.port}{path}", timeout=30
    ) as r:
        return json.loads(r.read())


def _post(server, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{server.port}{path}",
        data=json.dumps(body or {}).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _wait_finished(server, name):
    deadline = time.time() + 120
    while time.time() < deadline:
        st = _get(server, f"/api/train/status?name={name}")
        if st["state"] == "finished":
            break
        time.sleep(0.2)
    return st


def _wait_log(server, key, text):
    deadline = time.time() + 120
    out = ""
    while time.time() < deadline:
        out = _get(server, f"/api/logs?key={key}")["text"]
        if text in out:
            break
        time.sleep(0.2)
    return out


def test_index_and_health(server):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{server.port}/", timeout=10
    ) as r:
        html = r.read().decode()
    assert "tpu2048" in html
    assert "play-toast" in html and "pointerdown" in html
    assert _get(server, "/api/health")["ok"]


def test_modes_and_params(server):
    modes = _get(server, "/api/modes")
    assert [m["id"] for m in modes] == [
        "guide", "train", "test", "watch", "replay", "play", "admin"
    ]
    params = _get(server, "/api/params")
    names = [p["name"] for p in params]
    assert names == ["name", "n", "optimizer", "alpha", "decay",
                     "decay_step", "low_alpha_limit", "episodes"]


def test_play_flow(server):
    f = _post(server, "/api/play/new")
    assert sum(v != 0 for row in f["board"] for v in row) == 2
    session = f["session"]
    moved = False
    for d in range(4):
        out = _post(server, "/api/play/move",
                    {"session": session, "direction": d})
        if out["changed"]:
            moved = True
            assert out["odometer"] >= 1
            break
    assert moved
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/api/play/move", {"session": session, "direction": 9})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/api/play/move", {"session": "nope", "direction": 0})
    assert e.value.code == 404


def test_train_start_status_stop(server):
    r = _post(server, "/api/train/start", {
        "params": {"name": "webtrained", "n": 2, "alpha": 0.25,
                   "decay": 0.75, "decay_step": 10000,
                   "low_alpha_limit": 0.01, "episodes": 40},
        "new_agent": True,
    })
    assert "job" in r and r["log"].startswith("l/")
    st = _wait_finished(server, "webtrained")
    assert st["state"] == "finished", st
    assert st["error"] is None
    assert "webtrained" in _get(server, "/api/agents")
    logs = _get(server, f"/api/logs?key={r['log']}")
    assert "training session started" in logs["text"]
    assert "device = cpu" in logs["text"]
    chart = _get(server, "/api/chart?name=webtrained")
    assert len(chart["y"]) >= 1
    # duplicate-name lock while running: start long job then conflict
    _post(server, "/api/train/start", {
        "params": {"name": "webtrained", "episodes": 100000, "n": 2},
        "new_agent": False,
    })
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/api/train/start", {
            "params": {"name": "webtrained", "episodes": 10, "n": 2},
            "new_agent": False, "parent": "other-session",
        })
    assert e.value.code == 409
    assert _post(server, "/api/train/stop", {"name": "webtrained"})["stopped"]


def test_agent_info_prefill_precedence(server):
    store = server.service.store
    info = _get(server, "/api/agent?name=webby")
    assert info["form"]["n"] == 2
    assert info["form"]["name"] == "webby"
    assert info["meta"]["episodes"] >= 50
    doc = store.load(ckpt.agent_key("webby"))
    doc["meta"]["alpha"] = 0.125
    store.save(ckpt.agent_key("webby"), doc)
    store.save("c/config_webby.json",
               {"alpha": 0.5, "decay": 0.9, "episodes": 7777})
    info = _get(server, "/api/agent?name=webby")
    assert info["form"]["alpha"] == 0.125
    assert info["form"]["decay"] == 0.75
    assert info["form"]["episodes"] == 7777
    spec = {p["name"]: p for p in _get(server, "/api/params")}
    assert info["form"]["decay_step"] == spec["decay_step"]["default"]
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server, "/api/agent?name=nosuch")
    assert e.value.code == 404


def test_train_rejects_bad_names(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/api/train/start",
              {"params": {"name": "../evil", "episodes": 10}})
    assert e.value.code == 400


def test_test_mode(server):
    r = _post(server, "/api/test/start",
              {"name": "webby", "num": 8, "depth": 0})
    text = _wait_log(server, r["log"], "Best game saved")
    assert "average score of 8 runs" in text
    assert "game 1/8: score = " in text
    assert "games done, running average = " in text
    assert "best_trial_webby" in _get(server, "/api/games")


def test_watch_mode(server):
    r = _post(server, "/api/watch/start", {"name": "webby"})
    session = r["session"]
    deadline = time.time() + 60
    frames = []
    while time.time() < deadline:
        out = _get(server, f"/api/watch/frames?session={session}&since=0")
        frames = out["frames"]
        if len(frames) > 10 or out["done"]:
            break
        time.sleep(0.2)
    assert len(frames) > 1
    f = frames[1]
    assert len(f["board"]) == 4 and f["next_move"] in (-1, 0, 1, 2, 3)
    _post(server, "/api/watch/stop", {"session": session})


def test_watch_mode_device_backend(server):
    """Watch over the device search path: the same batched
    compacted-expectimax code ``trial`` runs, streamed one game at a
    time, here on the service's device (the CPU)."""
    r = _post(server, "/api/watch/start",
              {"name": "webby", "backend": "device", "depth": 1,
               "width": 2, "since_empty": 6})
    session = r["session"]
    deadline = time.time() + 120
    frames, done = [], False
    while time.time() < deadline:
        out = _get(server, f"/api/watch/frames?session={session}&since=0")
        frames, done = out["frames"], out["done"]
        if len(frames) > 10 or done:
            break
        time.sleep(0.2)
    assert len(frames) > 1
    moves = [f["next_move"] for f in frames[1:-1]]
    assert all(m in (0, 1, 2, 3) for m in moves)
    scores = [f["score"] for f in frames]
    assert all(b >= a for a, b in zip(scores, scores[1:]))
    _post(server, "/api/watch/stop", {"session": session})
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/api/watch/start",
              {"name": "webby", "backend": "warp"})
    assert e.value.code == 400


def test_replay_mode(server):
    games = _get(server, "/api/games")
    assert games
    frames = _get(server, f"/api/replay?name={games[0]}")
    assert len(frames) >= 2
    assert frames[-1]["next_move"] == -1
    scores = [f["score"] for f in frames]
    assert all(b >= a for a, b in zip(scores, scores[1:]))


def test_admin_files(server):
    url = f"http://127.0.0.1:{server.port}/api/files/c/upload.json"
    req = urllib.request.Request(url, data=b'{"hello": 1}', method="PUT")
    with urllib.request.urlopen(req, timeout=10) as r:
        assert json.loads(r.read())["ok"]
    assert "c/upload.json" in _get(server, "/api/files")
    with urllib.request.urlopen(url, timeout=10) as r:
        assert json.loads(r.read()) == {"hello": 1}
    req = urllib.request.Request(url, method="DELETE")
    with urllib.request.urlopen(req, timeout=10) as r:
        assert json.loads(r.read())["ok"]
    assert "c/upload.json" not in _get(server, "/api/files")


def test_heartbeat_and_vacuum(server):
    assert _post(server, "/api/heartbeat", {"parent": "web"})["ok"]
    assert "removed" in _post(server, "/api/vacuum")


@pytest.fixture(scope="module")
def cli_store(server):
    store = MemoryStore()
    _copy_agent(server.service.store, "webby", store, "clia")
    ckpt.save_game(store, "best_of_clia",
                   ckpt.load_game(server.service.store, "best_of_webby"))
    return store


def test_cli_render_board():
    from tpu2048_torch.apps.cli import render_board

    buf = io.StringIO()
    board = np.asarray([[1, 0, 2, 3]] * 4, np.int8)
    render_board(board, 120, 7, "hi", out=buf)
    text = buf.getvalue()
    assert "score = 120" in text and "moves = 7" in text
    assert "2" in text and "8" in text


def test_cli_replay_and_watch(cli_store):
    from tpu2048_torch.apps.cli import replay_game, watch_agent

    buf = io.StringIO()
    games = [k for k in cli_store.list_keys("g/")]
    name = games[0][len("g/"):-len(".npz")]
    replay_game(cli_store, name, speed_ms=0, out=buf)
    assert "GAME OVER" in buf.getvalue()
    buf2 = io.StringIO()
    watch_agent(cli_store, "clia", speed_ms=0, max_moves=5, out=buf2)
    assert "next =" in buf2.getvalue()


def test_viewer_headless(cli_store):
    os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
    pytest.importorskip("pygame")
    from tpu2048_torch.apps.viewer import Viewer

    v = Viewer()
    v.draw(np.asarray([[1, 2, 3, 4]] * 4, np.int8), 10, 2, "test")
    games = [k for k in cli_store.list_keys("g/")]
    name = games[0][len("g/"):-len(".npz")]
    v.pygame.time.wait = lambda ms: None
    rec = ckpt.load_game(cli_store, name)
    rec["moves"] = rec["moves"][:3]
    rec["tiles"] = rec["tiles"][:3]
    rec["odometer"] = 3
    ckpt.save_game(cli_store, "short", rec)
    done = threading.Event()

    def run():
        try:
            v.replay(cli_store, "short", speed_ms=0)
        except SystemExit:
            pass
        finally:
            done.set()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    time.sleep(1.0)
    v.pygame.event.post(v.pygame.event.Event(v.pygame.QUIT))
    done.wait(10)
    assert done.is_set()


def test_fork_agent_carries_weights_and_retunes(server):
    store = server.service.store
    _, src_w, src_meta = ckpt.load_agent(store, "webby")
    r = _post(server, "/api/train/start", {
        "params": {"name": "webby_v2", "n": 2, "alpha": 0.5,
                   "episodes": 30},
        "new_agent": True, "source_agent": "webby",
    })
    assert "job" in r
    st = _wait_finished(server, "webby_v2")
    assert st["state"] == "finished" and st["error"] is None, st
    acfg, w, meta = ckpt.load_agent(store, "webby_v2")
    assert acfg.n == 2 and acfg.alpha == 0.5
    assert meta["forked_from"] == "webby"
    assert meta["source_episodes"] == src_meta["episodes"]
    assert w.shape == src_w.shape
    assert not np.allclose(w, src_w)
    assert 0 < meta["episodes"] < src_meta["episodes"] + 100
    for body in (
        {"params": {"name": "webby_v2", "episodes": 10},
         "source_agent": "webby"},
        {"params": {"name": "webby_v3", "episodes": 10},
         "source_agent": "ghost"},
        {"params": {"name": "webby", "episodes": 10},
         "source_agent": "webby"},
    ):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(server, "/api/train/start", {**body, "new_agent": True})
        assert e.value.code == 400


def test_new_agent_name_guard(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, "/api/train/start", {
            "params": {"name": "webby", "n": 2, "episodes": 10},
            "new_agent": True,
        })
    assert e.value.code == 400


def test_baseline_policy_field(server):
    r = _post(server, "/api/test/start", {"policy": "random", "num": 8})
    text = _wait_log(server, r["log"], "average score")
    assert "average score of 8 runs" in text
    assert "Agent = random" in text
    # an agent actually NAMED 'random' is evaluated as an agent
    _copy_agent(server.service.store, "webby", server.service.store,
                "random")
    r2 = _post(server, "/api/test/start", {"name": "random", "num": 4})
    # (log keys have one-second resolution: both jobs may share one)
    text = _wait_log(server, r2["log"], "average score of 4 runs")
    assert "average score of 4 runs" in text


def test_guide_docs_served(server):
    docs = _get(server, "/api/guide")
    assert "guide" in docs and len(docs["guide"]) > 500
    assert "project" in docs and "champion" in docs["project"]
    assert "design" in docs


def test_stats_endpoint(server):
    server.service.memory.min_interval = 0.0
    _post(server, "/api/heartbeat", {"parent": "web"})
    st = _get(server, "/api/stats")
    assert st["now"]["rss_mb"] > 0
    assert "rss = " in st["history"]


# ---------------------------------------------------------------------------
# the two packages' services side by side
# ---------------------------------------------------------------------------


def test_deterministic_outputs_equal_jax(server):
    """Over one store, the JAX service answers every deterministic
    query exactly as the port's does, on agents and games the port's
    ``Trainer`` wrote."""
    port = server.service
    for job in port.jobs.jobs():  # the store stays as it is from here
        job.cancel()
        job.thread.join(timeout=60)
        assert not job.alive
    jax_svc = JaxAppService(port.store)
    assert port.modes() == jax_svc.modes()
    assert port.params_spec() == jax_svc.params_spec()
    assert port.guide_docs() == jax_svc.guide_docs()
    assert port.list_agents() == jax_svc.list_agents()
    assert "webby" in port.list_agents()
    assert port.list_games() == jax_svc.list_games()
    assert "best_of_webby" in port.list_games()
    for name in port.list_agents():
        assert port.agent_info(name) == jax_svc.agent_info(name), name
        assert port.chart(name) == jax_svc.chart(name), name
    for game in port.list_games():
        assert port.replay_frames(game) == jax_svc.replay_frames(game), game


def test_both_servers_serve_the_same_page(server):
    jax_srv = JaxAppServer(JaxAppService(MemoryStore()), port=0,
                           vacuum_interval=3600)
    jax_srv.start()
    try:
        pages = []
        for srv in (server, jax_srv):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/", timeout=10) as r:
                pages.append(r.read())
    finally:
        jax_srv.stop()
    assert pages[0] == pages[1]


def _tc_source(store, name, sym_impl, seed):
    """An n=5 TC agent whose weights and TC sums, in the form
    ``sym_impl`` gives its table, are random on one entry in 64 and
    zero elsewhere (the forms differ at n >= 5, in the 16^5 crosses;
    mostly zero tables keep the store's compression quick)."""
    acfg = AgentConfig(n=5, sym_impl=sym_impl)
    total = get_tuple_set(5).total
    rng = np.random.default_rng(seed)

    def table():
        t = np.zeros(total, np.float32)
        at = rng.choice(total, total // 64, replace=False)
        t[at] = rng.standard_normal(at.size).astype(np.float32)
        return t

    w, e, a = table(), table(), table()
    ckpt.save_agent(store, name, acfg, w,
                    {"episodes": 1234, "alpha": 1.0, "train_history": [5]},
                    extras={"opt_e": e, "opt_a": np.abs(a)})


@pytest.fixture(scope="module")
def forks():
    """``forks(src, dst)``: a store in which each package's service has
    forked one source agent of form ``src`` into form ``dst`` (made once
    per pair)."""
    made = {}

    def fork(src, dst):
        if (src, dst) not in made:
            store = MemoryStore()
            _tc_source(store, "src", src, seed=len(src))
            acfg = AgentConfig(n=2, sym_impl=dst, alpha=0.5)  # n from src
            got = AppService(store, device="cpu")._fork_agent(
                "src", "by_port", acfg)
            want = JaxAppService(store)._fork_agent("src", "by_jax",
                                                    jax_cfg(acfg))
            assert got.n == want.n == 5 and got.sym_impl == dst
            made[src, dst] = store
        return made[src, dst]

    return fork


@pytest.mark.parametrize("src,dst", [("canonical", "fold"),
                                     ("fold", "canonical")])
def test_fork_conversion_is_bitwise_jax(forks, src, dst):
    """A fork that changes the table's form (canonical orbits <->
    dense) converts the weights and both TC sums as JAX's service does,
    bit for bit, and stores the same meta."""
    store = forks(src, dst)
    (_, w_p, m_p), (_, w_j, m_j) = (ckpt.load_agent(store, k)
                                    for k in ("by_port", "by_jax"))
    np.testing.assert_array_equal(w_p, w_j)
    assert not np.array_equal(w_p, ckpt.load_agent(store, "src")[1])
    ex_p, ex_j = m_p.pop("extras"), m_j.pop("extras")
    assert set(ex_p) == set(ex_j) == {"opt_e", "opt_a"}
    for k in ex_p:
        np.testing.assert_array_equal(ex_p[k], ex_j[k])
    assert m_p == m_j


def test_port_fork_plays_in_jax_service(forks):
    """An agent the port's service forked (canonical to dense) loads in
    JAX's service and plays a trial there."""
    store = forks("canonical", "fold")
    jax_svc = JaxAppService(store)
    r = jax_svc.start_test("by_port", num=2, parent="t")
    job = jax_svc.jobs.get("test", "by_port")
    job.thread.join(timeout=120)
    assert not job.alive and job.error is None, job.error
    assert job.result["avg"] > 0
    log = jax_svc.logs(r["log"])
    assert "average score of 2 runs" in log and "Best game saved" in log


def test_a_failed_kernel_build_fails_the_job(server, monkeypatch):
    """A kernel build that fails inside a job (the first kernel call
    raises ``nvcc failed``) ends the job with that error, for the train
    and the test job alike: no job falls back to another path."""
    from tpu2048_torch.agent import td
    from tpu2048_torch.train import trial as trial_mod

    def failing(*args, **kwargs):
        def segment(*a, **k):
            raise RuntimeError("nvcc failed (1): stand-in for a bad build")
        segment.search_stats = None
        return segment

    monkeypatch.setattr(td, "make_train_segment", failing)
    monkeypatch.setattr(trial_mod, "_make_eval_segment", failing)
    service = AppService(server.service.store, default_tcfg=TINY,
                         device="cpu")
    service.start_training({"name": "broken", "n": 2, "episodes": 10})
    service.start_test("webby", num=2)
    for kind, name in (("agent", "broken"), ("test", "webby")):
        job = service.jobs.get(kind, name)
        job.thread.join(timeout=60)
        assert not job.alive
        assert job.error == ("RuntimeError: nvcc failed (1): stand-in for "
                             "a bad build"), (kind, job.error)
    assert service.training_status("broken")["error"].startswith(
        "RuntimeError: nvcc failed")
