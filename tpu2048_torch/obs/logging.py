"""Dual-sink logging of the port (``tpu2048/obs/logging.py``, copied).

Training output goes to the console for CLI runs and to an appendable
store artifact (``l/<session>.txt``) for web runs, through
``ArtifactStore.append_text``.
"""

from __future__ import annotations

import time
from typing import Optional

from ..store.artifacts import ArtifactStore


def log_key(session: Optional[str] = None) -> str:
    session = session or time.strftime("%m%d%H%M%S")
    return f"l/logs_{session}.txt"


class Logger:
    """print-compatible sink: console and/or store artifact."""

    def __init__(
        self,
        store: Optional[ArtifactStore] = None,
        key: Optional[str] = None,
        console: bool = True,
    ):
        self.store = store
        self.key = key or log_key()
        self.console = console
        if store is not None and not store.exists(self.key):
            store.save(self.key, "")

    def add(self, text: str = "") -> None:
        text = str(text)
        if self.console:
            print(text, flush=True)
        if self.store is not None and text:
            self.store.append_text(self.key, text + "\n")

    __call__ = add

    def tail(self, max_chars: int = 20000) -> str:
        if self.store is None:
            return ""
        content = self.store.load(self.key) or ""
        return content[-max_chars:]

    def clear(self) -> None:
        if self.store is not None:
            self.store.save(self.key, "")
