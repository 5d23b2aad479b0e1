"""The port's own copies of the JAX package's framework-neutral modules
(``tpu2048_torch/config.py``, ``store/``, ``obs/``, ``engine/parity.py``,
``native/`` and the apps' shared parts) against their originals: the
same config fields, defaults and dicts; the same code; checkpoints and
best games that cross between the two packages in both directions,
bitwise; logs and metrics written alike."""

import dataclasses
import inspect
import io
import re
import tokenize
from pathlib import Path

import numpy as np
import pytest

import tpu2048.config as jcfg
import tpu2048.native as jnative
from tpu2048.apps import cli as jcli
from tpu2048.apps import server as jserver
from tpu2048.apps import service as jservice
from tpu2048.apps import viewer as jviewer
from tpu2048.apps import webui as jwebui
from tpu2048.engine import parity as jparity
from tpu2048.obs import jobs as jjobs
from tpu2048.obs import logging as jlog
from tpu2048.obs import metrics as jmet
from tpu2048.obs import profiler as jprof
from tpu2048.obs import telemetry as jtel
from tpu2048.store import artifacts as jart
from tpu2048.store import checkpoint as jckpt
import tpu2048_torch.config as tcfg
import tpu2048_torch.native as tnative
from tpu2048_torch.apps import cli as tcli
from tpu2048_torch.apps import server as tserver
from tpu2048_torch.apps import service as tservice
from tpu2048_torch.apps import viewer as tviewer
from tpu2048_torch.apps import webui as twebui
from tpu2048_torch.engine import parity as tparity
from tpu2048_torch.obs import jobs as tjobs
from tpu2048_torch.obs import logging as tlog
from tpu2048_torch.obs import metrics as tmet
from tpu2048_torch.obs import profiler as tprof
from tpu2048_torch.obs import telemetry as ttel
from tpu2048_torch.store import artifacts as tart
from tpu2048_torch.store import checkpoint as tckpt


@pytest.mark.parametrize("name", ["AgentConfig", "TrainConfig",
                                  "SearchConfig", "MeshConfig",
                                  "StorageConfig"])
def test_config_fields_defaults_and_dicts(name):
    a, b = getattr(jcfg, name), getattr(tcfg, name)
    fa = [(f.name, f.type, f.default) for f in dataclasses.fields(a)]
    fb = [(f.name, f.type, f.default) for f in dataclasses.fields(b)]
    assert fa == fb
    assert jcfg.to_dict(a()) == tcfg.to_dict(b())
    assert b.__dataclass_params__.frozen


def test_agent_config_from_dict_crosses():
    acfg = tcfg.AgentConfig(n=4, optimizer="sgd", alpha=0.25)
    d = tcfg.to_dict(acfg)
    assert tcfg.to_dict(jcfg.agent_config_from_dict(d)) == d
    back = tcfg.agent_config_from_dict({**jcfg.to_dict(
        jcfg.agent_config_from_dict(d)), "unknown_key": 1})
    assert back == acfg


# copied verbatim: the code and docstrings of each are the original's
# (comments aside: LocalStore words one of its comments differently),
# apart from what ``ADDED`` lists
VERBATIM = [
    (jart, tart, ["ArtifactStore", "_encode", "_decode", "_SerializingStore",
                  "LocalStore", "MemoryStore", "S3Store", "open_store"]),
    (jcfg, tcfg, ["AgentConfig", "TrainConfig", "SearchConfig", "MeshConfig",
                  "StorageConfig", "to_dict", "agent_config_from_dict",
                  "train_config_from_dict"]),
    (jlog, tlog, ["log_key", "Logger"]),
    (jmet, tmet, ["metrics_key", "MetricsWriter", "train_history"]),
    (jjobs, tjobs, ["JobRegistry", "Job", "JobManager"]),
    (jprof, tprof, ["Timer"]),
    (jckpt, tckpt, ["agent_key", "weights_key", "game_key", "load_agent",
                    "save_game", "load_game"]),
    (jparity, tparity, ["random_eval", "score_eval", "ParityGame"]),
    (jnative, tnative, ["_build_dir", "_compile", "_load", "available",
                        "TupleSpecC", "NativeEngine"]),
    # telemetry apart from device_memory_stats, which reads torch.cuda
    (jtel, ttel, ["process_rss_mb", "snapshot", "MemoryMonitor"]),
    (jserver, tserver, ["ApiError", "make_handler", "AppServer"]),
    (jservice, tservice, ["_frame", "WatchSession"]),
    (jcli, tcli, ["render_board", "np_estimator", "play_yourself",
                  "replay_game", "_pick", "_speed"]),
    (jviewer, tviewer, ["main"]),
]


# what the port adds to a copy, taken out before the comparison: a
# ``Timer`` section is also a span of the port's profiler
ADDED = {(tprof, "Timer"): ("            with span(name):\n"
                            "                yield\n",
                            "            yield\n")}


def _port_code(copy, name: str) -> list:
    source = inspect.getsource(getattr(copy, name))
    if (copy, name) in ADDED:
        added, orig = ADDED[copy, name]
        assert source.count(added) == 1, name
        source = source.replace(added, orig)
    return _code_of(source)


@pytest.mark.parametrize("orig,copy,names", VERBATIM,
                         ids=[c.__name__ for _, c, _ in VERBATIM])
def test_copies_are_verbatim(orig, copy, names):
    for name in names:
        assert _port_code(copy, name) == _code(getattr(orig, name)), name


# the copies that load an agent's table take it onto the CPU by name:
# the port's ``load_agent_dense`` puts the table on the device it is
# given, and these host-side players are otherwise the reference's
ON_CPU = [(jcli, tcli, "watch_agent"), (jviewer, tviewer, "Viewer")]


@pytest.mark.parametrize("orig,copy,name", ON_CPU,
                         ids=[n for _, _, n in ON_CPU])
def test_host_players_differ_only_in_taking_the_cpu(orig, copy, name):
    port = inspect.getsource(getattr(copy, name))
    assert port.count('load_agent_dense(store, name, "cpu")') == 1
    port = port.replace('load_agent_dense(store, name, "cpu")',
                        "load_agent_dense(store, name)")
    assert _code_of(port) == _code(getattr(orig, name))


def test_shared_values_are_equal():
    """The page, the modes, the form and the colours are the
    reference's, and so is the telemetry artifact's key."""
    assert twebui.INDEX_HTML == jwebui.INDEX_HTML
    assert tservice.MODES == jservice.MODES
    assert tservice.PARAMS_SPEC == jservice.PARAMS_SPEC
    assert tcli.ANSI_COLORS == jcli.ANSI_COLORS
    assert tviewer.TILE_COLORS == jviewer.TILE_COLORS
    assert ttel.MEMORY_KEY == jtel.MEMORY_KEY


def test_native_source_is_the_reference_code():
    """``engine2048.cpp`` is the reference's, character for character
    once comments are set aside (the copy's header names its origin)."""
    def code(path):
        text = re.sub(r"//[^\n]*", "", path.read_text())
        return [ln.rstrip() for ln in text.splitlines() if ln.strip()]

    src = Path(tnative.__file__).with_name("engine2048.cpp")
    assert tnative._SRC == src
    assert code(src) == code(Path(jnative.__file__).with_name(
        "engine2048.cpp"))


def _code(obj) -> list:
    """The tokens of ``obj``'s source, comments left out."""
    return _code_of(inspect.getsource(obj))


def _code_of(source: str) -> list:
    src = io.StringIO(source).readline
    return [(t.type, t.string) for t in tokenize.generate_tokens(src)
            if t.type not in (tokenize.COMMENT, tokenize.NL)]


@pytest.mark.parametrize("key,inside", [
    ("a/ok.json", True), ("a/../b.json", True), ("../outside.json", False),
    ("a/../../x.json", False), ("/abs.json", False), (".", False),
    ("../s-evil/x.json", False),  # a sibling named like the root
])
def test_local_store_keys_stay_inside_their_root(key, inside, tmp_path):
    """The copy's path check accepts and refuses the keys the
    original does."""
    outcomes = []
    for mod in (jart, tart):
        store = mod.LocalStore(str(tmp_path / "s"))
        try:
            outcomes.append(store._path(key))
        except ValueError:
            outcomes.append(None)
    assert outcomes[0] == outcomes[1]
    assert (outcomes[1] is not None) == inside


def _stores(kind, tmp_path):
    if kind == "local":
        return (jart.LocalStore(str(tmp_path / "j")),
                tart.LocalStore(str(tmp_path / "t")))
    return jart.MemoryStore(), tart.MemoryStore()


def _game(seed):
    rng = np.random.default_rng(seed)
    return {"starting_position": rng.integers(0, 3, (4, 4)),
            "moves": rng.integers(0, 4, 57),
            "tiles": rng.integers(0, 4, (57, 3)),
            "score": int(rng.integers(0, 10**6)), "odometer": 57,
            "final_board": rng.integers(0, 12, (4, 4))}


@pytest.mark.parametrize("kind", ["local", "memory"])
@pytest.mark.parametrize("saver", ["jax", "port"])
def test_checkpoints_cross_both_ways(kind, saver, tmp_path):
    """An agent (weights, extras, meta, config) and a best game saved by
    one package load in the other, bitwise, from each package's own
    store class."""
    save_mod, load_mod = (jckpt, tckpt) if saver == "jax" else (tckpt, jckpt)
    save_cfg = jcfg if saver == "jax" else tcfg
    js, ts = _stores(kind, tmp_path)
    store = js if saver == "jax" else ts
    rng = np.random.default_rng(3)
    w = rng.standard_normal(5000).astype(np.float32)
    extras = {"opt_e": rng.standard_normal(5000).astype(np.float32),
              "torch_rng_state": rng.integers(0, 256, 16).astype(np.uint8)}
    meta = {"episodes": 77, "train_history": [1, 2], "alpha": 1.0}
    acfg = save_cfg.AgentConfig(n=4, sym_impl="fold")
    save_mod.save_agent(store, "a", acfg, w, meta, extras=extras)
    save_mod.save_game(store, "best_of_a", _game(5))
    got_cfg, got_w, got_meta = load_mod.load_agent(store, "a")
    assert tcfg.to_dict(got_cfg) == tcfg.to_dict(acfg)
    assert got_w.dtype == np.float32
    np.testing.assert_array_equal(got_w, w)
    assert set(got_meta["extras"]) == set(extras)
    for k, v in extras.items():
        assert got_meta["extras"][k].dtype == v.dtype
        np.testing.assert_array_equal(got_meta["extras"][k], v)
    assert {k: v for k, v in got_meta.items() if k != "extras"} == meta
    rec, want = load_mod.load_game(store, "best_of_a"), _game(5)
    assert rec.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(rec[k], np.asarray(v).reshape(
            np.shape(rec[k])), err_msg=k)
    # the stored bytes are the same, whichever package wrote them
    other = ts if saver == "jax" else js
    other_mod = tckpt if saver == "jax" else jckpt
    other_cfg = tcfg if saver == "jax" else jcfg
    other_mod.save_agent(other, "a", other_cfg.AgentConfig(
        n=4, sym_impl="fold"), w, meta, extras=extras)
    assert other.load(jckpt.agent_key("a")) == store.load(
        jckpt.agent_key("a"))


def _drive(log_mod, met_mod, store):
    log = log_mod.Logger(store, key="l/logs_x.txt", console=False)
    log.add("first line")
    log("second")
    log.add("")
    mw = met_mod.MetricsWriter(store, "agent")
    for i in range(3):
        mw.write({"kind": "ma100", "episodes": 100 * i, "ma100": 10 * i,
                  "ts": 1.5})
    mw.write({"kind": "summary1000", "episodes": 1000, "ts": 2.0})
    return log, mw


@pytest.mark.parametrize("kind", ["local", "memory"])
def test_logger_and_metrics_write_alike(kind, tmp_path):
    js, ts = _stores(kind, tmp_path)
    jl, jm = _drive(jlog, jmet, js)
    tl, tm = _drive(tlog, tmet, ts)
    assert js.list_keys() == ts.list_keys()
    for key in js.list_keys():
        assert js.load_bytes(key) == ts.load_bytes(key), key
    assert tl.tail() == jl.tail() == "first line\nsecond\n"
    assert tm.read() == jm.read()
    assert tmet.train_history(ts, "agent") == \
        jmet.train_history(js, "agent") == [0, 10, 20]


def test_job_and_timer_behave_alike():
    for mod in (jjobs, tjobs):
        job = mod.Job("train", "a", "local")
        assert not job.should_stop() and not job.alive
        job.cancel()
        assert job.should_stop()
    tj, tt = jprof.Timer(), tprof.Timer()
    for timer in (tj, tt):
        timer.totals, timer.counts = {"a": 1.0, "b": 3.0}, {"a": 2, "b": 1}
        with timer.section("c"):
            pass
    assert tt.counts == tj.counts
    assert tt.report().splitlines()[:2] == tj.report().splitlines()[:2]
