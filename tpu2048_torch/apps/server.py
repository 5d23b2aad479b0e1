"""HTTP service of the port — the web face of the framework
(``tpu2048/apps/server.py``: the same handler, server and JSON API).

Thin JSON API + single-page UI over the port's ``AppService``, in
place of abachurin/2048's 900-line Dash application: a dependency-free
stdlib server with the same seven modes and capabilities (start/stop
train & test jobs, stream board frames, tail logs, chart history,
artifact CRUD, play with keyboard), rendering decoupled from compute.
Its jobs compute on the CUDA card unless ``--device`` (or
``TPU2048_DEVICE``) names another device, such as ``cpu``.

Run: ``python -m tpu2048_torch.apps.server --port 8048 --store ~/.tpu2048``
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

from ..config import TrainConfig
from ..store.artifacts import open_store
from .service import AppService
from .webui import INDEX_HTML


class ApiError(Exception):
    def __init__(self, code: int, message: str):
        super().__init__(message)
        self.code = code


def make_handler(service: AppService):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        # -- plumbing ---------------------------------------------------

        def _send(self, code: int, body: bytes,
                  ctype: str = "application/json") -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj: Any, code: int = 200) -> None:
            self._send(code, json.dumps(obj).encode())

        def _body(self) -> bytes:
            length = int(self.headers.get("Content-Length") or 0)
            return self.rfile.read(length) if length else b""

        def _json_body(self) -> Dict[str, Any]:
            raw = self._body()
            if not raw:
                return {}
            try:
                return json.loads(raw.decode())
            except json.JSONDecodeError as e:
                raise ApiError(400, f"bad JSON body: {e}") from e

        def _route(self) -> Tuple[str, Dict[str, str]]:
            parsed = urllib.parse.urlparse(self.path)
            q = {k: v[0] for k, v in
                 urllib.parse.parse_qs(parsed.query).items()}
            return parsed.path, q

        # -- dispatch ---------------------------------------------------

        def do_GET(self):  # noqa: N802
            try:
                self._get()
            except ApiError as e:
                self._json({"error": str(e)}, e.code)
            except (KeyError, FileNotFoundError) as e:
                self._json({"error": str(e)}, 404)
            except Exception as e:  # noqa: BLE001
                self._json({"error": f"{type(e).__name__}: {e}"}, 500)

        def do_POST(self):  # noqa: N802
            try:
                self._post()
            except ApiError as e:
                self._json({"error": str(e)}, e.code)
            except (KeyError, FileNotFoundError) as e:
                self._json({"error": str(e)}, 404)
            except ValueError as e:
                self._json({"error": str(e)}, 400)
            except RuntimeError as e:
                self._json({"error": str(e)}, 409)
            except Exception as e:  # noqa: BLE001
                self._json({"error": f"{type(e).__name__}: {e}"}, 500)

        def do_PUT(self):  # noqa: N802
            path, _ = self._route()
            if path.startswith("/api/files/"):
                key = urllib.parse.unquote(path[len("/api/files/"):])
                try:
                    service.upload_file(key, self._body())
                    self._json({"ok": True})
                except ValueError as e:
                    self._json({"error": str(e)}, 400)
                return
            self._json({"error": "not found"}, 404)

        def do_DELETE(self):  # noqa: N802
            path, _ = self._route()
            if path.startswith("/api/files/"):
                key = urllib.parse.unquote(path[len("/api/files/"):])
                service.delete_file(key)
                self._json({"ok": True})
                return
            self._json({"error": "not found"}, 404)

        def _get(self):
            path, q = self._route()
            if path == "/" or path == "/index.html":
                self._send(200, INDEX_HTML.encode(), "text/html")
            elif path == "/api/modes":
                self._json(service.modes())
            elif path == "/api/params":
                self._json(service.params_spec())
            elif path == "/api/agents":
                self._json(service.list_agents())
            elif path == "/api/agent":
                self._json(service.agent_info(q["name"]))
            elif path == "/api/games":
                self._json(service.list_games())
            elif path == "/api/files":
                self._json(service.list_files())
            elif path.startswith("/api/files/"):
                key = urllib.parse.unquote(path[len("/api/files/"):])
                data = service.download_file(key)
                if data is None:
                    raise ApiError(404, f"no such file: {key}")
                self._send(200, data, "application/octet-stream")
            elif path == "/api/train/status":
                self._json(service.training_status(q["name"]))
            elif path == "/api/chart":
                self._json(service.chart(q["name"]))
            elif path == "/api/watch/frames":
                self._json(
                    service.watch_frames(q["session"],
                                         int(q.get("since", 0)))
                )
            elif path == "/api/replay":
                self._json(service.replay_frames(q["name"]))
            elif path == "/api/logs":
                self._json({"text": service.logs(q["key"])})
            elif path == "/api/stats":
                self._json(service.system_stats())
            elif path == "/api/guide":
                self._json(service.guide_docs())
            elif path == "/api/health":
                self._json({"ok": True, "time": time.time()})
            else:
                raise ApiError(404, f"not found: {path}")

        def _post(self):
            path, q = self._route()
            body = self._json_body()
            if path == "/api/train/start":
                self._json(service.start_training(
                    body.get("params", {}),
                    parent=body.get("parent", "web"),
                    new_agent=bool(body.get("new_agent", True)),
                    source_agent=body.get("source_agent") or None,
                ))
            elif path == "/api/train/stop":
                self._json({"stopped": service.stop_training(body["name"])})
            elif path == "/api/test/start":
                self._json(service.start_test(
                    body.get("name", ""),
                    num=int(body.get("num", 100)),
                    depth=int(body.get("depth", 0)),
                    width=int(body.get("width", 1)),
                    since_empty=int(body.get("since_empty", 6)),
                    parent=body.get("parent", "web"),
                    policy=body.get("policy") or None,
                ))
            elif path == "/api/test/stop":
                self._json({"stopped": service.stop_test(body["name"])})
            elif path == "/api/watch/start":
                sid = service.start_watch(
                    body["name"],
                    depth=int(body.get("depth", 0)),
                    width=int(body.get("width", 1)),
                    since_empty=int(body.get("since_empty", 6)),
                    parent=body.get("parent", "web"),
                    backend=body.get("backend", "auto"),
                )
                self._json({"session": sid})
            elif path == "/api/watch/stop":
                self._json({"stopped": service.stop_watch(body["session"])})
            elif path == "/api/play/new":
                self._json(service.play_new())
            elif path == "/api/play/move":
                self._json(service.play_move(body["session"],
                                             int(body["direction"])))
            elif path == "/api/heartbeat":
                service.heartbeat(body.get("parent", "web"))
                self._json({"ok": True})
            elif path == "/api/vacuum":
                self._json({"removed": service.vacuum()})
            elif path == "/api/logs/clear":
                service.clear_logs(body["key"])
                self._json({"ok": True})
            else:
                raise ApiError(404, f"not found: {path}")

    return Handler


class AppServer:
    """Owns the HTTP server + a background vacuum thread (the
    reference's vacuum_cleaner interval, application.py:784-805)."""

    def __init__(self, service: AppService, host: str = "127.0.0.1",
                 port: int = 8048, vacuum_interval: float = 300.0):
        self.service = service
        self.httpd = ThreadingHTTPServer((host, port),
                                         make_handler(service))
        self.port = self.httpd.server_address[1]
        self._stop = threading.Event()
        self._vacuum_interval = vacuum_interval
        self._threads = []

    def start(self) -> None:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        self._threads.append(t)

        def vacuum_loop():
            while not self._stop.wait(self._vacuum_interval):
                try:
                    self.service.vacuum()
                except Exception:  # noqa: BLE001
                    pass

        tv = threading.Thread(target=vacuum_loop, daemon=True)
        tv.start()
        self._threads.append(tv)

    def stop(self) -> None:
        self._stop.set()
        self.httpd.shutdown()
        self.httpd.server_close()


def main(argv=None):
    # env-var overrides mirror the reference's PORT / S3_URL contract
    # (application.py:898, start.py:22) with the typed-config names.
    p = argparse.ArgumentParser(description="tpu2048 web service")
    p.add_argument("--host", default=os.environ.get("TPU2048_HOST",
                                                    "127.0.0.1"))
    p.add_argument("--port", type=int,
                   default=int(os.environ.get("PORT", 8048)))
    p.add_argument("--store",
                   default=os.environ.get("TPU2048_STORE", "~/.tpu2048"))
    p.add_argument("--backend",
                   default=os.environ.get("TPU2048_BACKEND", "local"),
                   choices=["local", "memory", "s3"])
    p.add_argument("--num-envs", type=int, default=1024,
                   help="lockstep envs per training job")
    p.add_argument("--device", default=os.environ.get("TPU2048_DEVICE"),
                   help="device of the jobs (default: the CUDA card)")
    args = p.parse_args(argv)
    store = open_store(args.backend, args.store)
    service = AppService(store,
                         default_tcfg=TrainConfig(num_envs=args.num_envs),
                         device=args.device)
    server = AppServer(service, host=args.host, port=args.port)
    server.start()
    print(f"tpu2048 serving on http://{args.host}:{server.port} "
          f"(store: {args.backend}:{args.store}, device: {service.device})")
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
