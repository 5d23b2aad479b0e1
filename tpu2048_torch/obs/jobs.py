"""Job registry with leases + host-side job manager of the port
(``tpu2048/obs/jobs.py``, copied).

Leases with expiry timestamps live in one store document
(``status.json``) with atomic rewrites; a holder refreshes its leases
by heartbeat (``Trainer.run`` does between segments), an orphaned
lease expires, and ``vacuum`` reaps it.  Jobs are owned by a manager,
and cancellation is an explicit ``threading.Event`` per job handle:
``Trainer.run`` polls ``job.should_stop()`` between segments.
``tests/test_torch_shared.py`` holds the copy equal to its original.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

from ..store.artifacts import ArtifactStore

STATUS_KEY = "status.json"
DEFAULT_LEASE_SEC = 240.0


class JobRegistry:
    """Lease table in the artifact store: {kind: {name: {parent, expires}}}."""

    def __init__(self, store: ArtifactStore, lease_sec: float = DEFAULT_LEASE_SEC):
        self.store = store
        self.lease_sec = lease_sec
        self._lock = threading.Lock()

    def _read(self) -> Dict[str, Dict[str, Any]]:
        return self.store.load(STATUS_KEY) or {"agent": {}, "log": {}}

    def _write(self, doc: Dict[str, Any]) -> None:
        self.store.save(STATUS_KEY, doc)

    def acquire(self, kind: str, name: str, parent: str) -> bool:
        """Take (or refresh) a lease.  Returns False if another parent
        holds an unexpired lease — the one-training-per-agent rule."""
        with self._lock:
            doc = self._read()
            entry = doc.setdefault(kind, {}).get(name)
            now = time.time()
            if entry and entry["parent"] != parent and entry["expires"] > now:
                return False
            doc[kind][name] = {
                "parent": parent,
                "expires": now + self.lease_sec,
            }
            self._write(doc)
            return True

    def heartbeat(self, parent: str) -> None:
        """Refresh every lease owned by ``parent``."""
        with self._lock:
            doc = self._read()
            now = time.time()
            for kind in doc:
                for name, entry in doc[kind].items():
                    if entry.get("parent") == parent:
                        entry["expires"] = now + self.lease_sec
            self._write(doc)

    def release(self, kind: str, name: str) -> None:
        with self._lock:
            doc = self._read()
            doc.get(kind, {}).pop(name, None)
            self._write(doc)

    def holder(self, kind: str, name: str) -> Optional[str]:
        entry = self._read().get(kind, {}).get(name)
        if entry and entry["expires"] > time.time():
            return entry["parent"]
        return None

    def vacuum(self) -> List[str]:
        """Drop expired leases; for expired log leases also delete the
        orphaned log artifact (the reference vacuum_cleaner)."""
        removed = []
        with self._lock:
            doc = self._read()
            now = time.time()
            for kind in list(doc):
                for name in list(doc[kind]):
                    if doc[kind][name]["expires"] <= now:
                        doc[kind].pop(name)
                        removed.append(f"{kind}/{name}")
                        if kind == "log":
                            self.store.delete(name)
            self._write(doc)
        return removed


class Job:
    """Handle for one background job."""

    def __init__(self, kind: str, name: str, parent: str):
        self.id = uuid.uuid4().hex[:12]
        self.kind = kind
        self.name = name
        self.parent = parent
        self.cancel_event = threading.Event()
        self.started = time.time()
        self.finished: Optional[float] = None
        self.error: Optional[str] = None
        self.thread: Optional[threading.Thread] = None
        self.result: Any = None

    @property
    def alive(self) -> bool:
        return self.thread is not None and self.thread.is_alive()

    def cancel(self) -> None:
        self.cancel_event.set()

    def should_stop(self) -> bool:
        return self.cancel_event.is_set()


class JobManager:
    """Owns background jobs (train/eval/watch).  The job body receives
    the Job handle and polls ``job.should_stop()`` — no generation
    counters in shared dicts."""

    def __init__(self, registry: Optional[JobRegistry] = None):
        self.registry = registry
        self._jobs: Dict[str, Job] = {}
        self._lock = threading.Lock()

    def start(
        self,
        body: Callable[[Job], Any],
        kind: str,
        name: str,
        parent: str = "local",
        exclusive: bool = False,
    ) -> Job:
        if self.registry is not None and exclusive:
            if not self.registry.acquire(kind, name, parent):
                raise RuntimeError(
                    f"{kind} '{name}' is locked by another session"
                )
        job = Job(kind, name, parent)

        def run():
            try:
                job.result = body(job)
            except Exception as e:  # noqa: BLE001
                job.error = f"{type(e).__name__}: {e}"
            finally:
                job.finished = time.time()
                if self.registry is not None and exclusive:
                    self.registry.release(kind, name)

        t = threading.Thread(target=run, daemon=True, name=f"{kind}:{name}")
        job.thread = t
        with self._lock:
            # a new job for the same (kind, name) cancels the old one,
            # like the reference's generation-counter bump
            old = self._jobs.get(f"{kind}:{name}")
            if old is not None and old.alive:
                old.cancel()
            self._jobs[f"{kind}:{name}"] = job
        t.start()
        return job

    def get(self, kind: str, name: str) -> Optional[Job]:
        return self._jobs.get(f"{kind}:{name}")

    def cancel(self, kind: str, name: str) -> bool:
        job = self.get(kind, name)
        if job is None:
            return False
        job.cancel()
        return True

    def jobs(self) -> List[Job]:
        return list(self._jobs.values())
