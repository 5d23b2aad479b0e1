"""Process + device memory telemetry (``tpu2048/obs/telemetry.py``).

A copy of the reference's module, held equal to it by
``tests/test_torch_shared.py``, apart from ``device_memory_stats``,
which reads the CUDA card through ``torch.cuda`` where the reference
reads jax.  Capability parity with the psutil RSS sampling of
abachurin/2048 (``game2048/start.py:131-141`` there): the host process
RSS is sampled into an appendable ``memory_usage.txt`` artifact on the
heartbeat cadence, and the card's memory picture is sampled next to
it.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

from ..store.artifacts import ArtifactStore

MEMORY_KEY = "memory_usage.txt"


def process_rss_mb() -> float:
    """Resident set size of this process in MiB (psutil, with a /proc
    fallback; -1.0 if neither works)."""
    try:
        import psutil

        return psutil.Process().memory_info().rss / 2**20
    except Exception:  # noqa: BLE001 - psutil-less hosts
        try:
            with open("/proc/self/statm") as f:
                pages = int(f.read().split()[1])
            return pages * os.sysconf("SC_PAGE_SIZE") / 2**20
        except Exception:  # noqa: BLE001
            return -1.0


def device_memory_stats() -> Dict[str, Any]:
    """Memory of the current CUDA card, from PyTorch's caching
    allocator: the bytes its tensors hold now and at their peak, and the
    card's total memory; {} without a card.  Without a card CUDA is
    never initialised."""
    import torch

    if not torch.cuda.is_available():
        return {}
    dev = torch.cuda.current_device()
    stats = torch.cuda.memory_stats(dev)
    return {
        "device": torch.cuda.get_device_name(dev),
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(dev).total_memory),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
    }


def snapshot() -> Dict[str, Any]:
    """One telemetry sample: wall time, host RSS, device HBM."""
    s: Dict[str, Any] = {
        "time": time.time(),
        "rss_mb": round(process_rss_mb(), 1),
    }
    dm = device_memory_stats()
    if dm:
        s["hbm_in_use_mb"] = round(dm.get("bytes_in_use", 0) / 2**20, 1)
        if "bytes_limit" in dm:
            s["hbm_limit_mb"] = round(dm["bytes_limit"] / 2**20, 1)
        s["device"] = dm.get("device", "")
    return s


class MemoryMonitor:
    """Appends telemetry lines to the ``memory_usage.txt`` artifact
    (the reference's file of the same name), rate-limited so heartbeat
    callers can invoke it unconditionally."""

    def __init__(self, store: Optional[ArtifactStore],
                 min_interval: float = 30.0, max_lines: int = 2000):
        self.store = store
        self.min_interval = min_interval
        self.max_lines = max_lines
        self._last = 0.0

    def sample(self, tag: str = "") -> Optional[Dict[str, Any]]:
        now = time.time()
        if now - self._last < self.min_interval:
            return None
        self._last = now
        s = snapshot()
        if self.store is not None:
            line = (
                f"{time.strftime('%Y-%m-%d %H:%M:%S')} "
                f"rss = {s['rss_mb']} MiB"
            )
            if "hbm_in_use_mb" in s:
                line += f", hbm = {s['hbm_in_use_mb']} MiB"
                if "hbm_limit_mb" in s:
                    line += f" / {s['hbm_limit_mb']} MiB"
            if tag:
                line += f" ({tag})"
            self.store.append_text(MEMORY_KEY, line + "\n")
            self._trim()
        return s

    def _trim(self) -> None:
        """Keep the artifact bounded (the reference let its file grow
        without bound — a known wart, not a capability)."""
        text = self.store.load(MEMORY_KEY) or ""
        lines = text.splitlines()
        if len(lines) > self.max_lines:
            self.store.save(
                MEMORY_KEY, "\n".join(lines[-self.max_lines:]) + "\n"
            )

    def tail(self, max_chars: int = 4000) -> str:
        if self.store is None:
            return ""
        return (self.store.load(MEMORY_KEY) or "")[-max_chars:]
