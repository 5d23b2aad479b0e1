"""Structured metrics stream of the port (``tpu2048/obs/metrics.py``,
copied).

An append-only JSONL artifact per agent (``m/<name>.jsonl``) of typed
records, and ``train_history``, which recovers the ma-100 series the
reference charts.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

from ..store.artifacts import ArtifactStore


def metrics_key(name: str) -> str:
    return f"m/{name}.jsonl"


class MetricsWriter:
    def __init__(self, store: ArtifactStore, name: str):
        self.store = store
        self.key = metrics_key(name)

    def write(self, record: Dict[str, Any]) -> None:
        record = dict(record)
        record.setdefault("ts", round(time.time(), 3))
        self.store.append_text(self.key, json.dumps(record) + "\n")

    def read(self) -> List[Dict[str, Any]]:
        raw = self.store.load(self.key)
        if not raw:
            return []
        out = []
        for line in raw.splitlines():
            line = line.strip()
            if line:
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
        return out


def train_history(store: ArtifactStore, name: str) -> List[int]:
    """ma-100 score series (one point per 100 completed episodes),
    the reference's chart data (x = episodes * 100)."""
    return [
        int(r["ma100"])
        for r in MetricsWriter(store, name).read()
        if r.get("kind") == "ma100"
    ]
