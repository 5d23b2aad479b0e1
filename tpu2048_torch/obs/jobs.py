"""Job handles of the port (``tpu2048/obs/jobs.py``, ``Job`` copied).

``Trainer.run`` polls ``job.should_stop()`` between segments; a job
is cancelled through its ``threading.Event``.  The reference's lease
registry and job manager belong to its apps and are not copied.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Optional


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
