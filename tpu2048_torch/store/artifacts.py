"""Artifact store of the port (``tpu2048/store/artifacts.py``).

A verbatim copy of the reference's store, so the port reads and writes
the same keys and bytes without importing ``tpu2048``.  Artifacts live
under typed prefixes:

    a/        agent metadata (JSON)
    weights/  weight tables (npz arrays, never pickled classes)
    g/        game records (npz)
    c/        training configs (JSON)
    l/        logs (text, appendable)

plus top-level docs.  Backends: local filesystem (default), in-memory
(tests), and S3 (boto3 imported only when an ``S3Store`` is made).
Writes are atomic (tmp + rename) and appends are O(delta).
"""

from __future__ import annotations

import io
import json
import os
import tempfile
import threading
from typing import Any, Dict, List, Optional

import numpy as np

NAMESPACES = ("a/", "weights/", "g/", "c/", "l/")


class ArtifactStore:
    """Interface: keys are namespaced strings with an extension that
    selects the serialization (json / txt / npz)."""

    def save(self, key: str, data: Any) -> None:
        raise NotImplementedError

    def load(self, key: str) -> Any:
        raise NotImplementedError

    def append_text(self, key: str, text: str) -> None:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def list_keys(self, prefix: str = "") -> List[str]:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        return key in self.list_keys()

    def copy(self, src: str, dst: str) -> None:
        self.save_bytes(dst, self.load_bytes(src))

    # bytes-level plumbing used by serialization helpers
    def save_bytes(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def load_bytes(self, key: str) -> bytes:
        raise NotImplementedError


def _encode(key: str, data: Any) -> bytes:
    ext = key.rsplit(".", 1)[-1]
    if ext == "json":
        return json.dumps(data).encode()
    if ext in ("txt", "jsonl", "md"):
        return str(data).encode()
    if ext == "npz":
        buf = io.BytesIO()
        total = sum(
            np.asarray(v).nbytes for v in data.values()
        )
        if total > 64 * 1024 * 1024:
            # big weight tables (the n=6 flagship checkpoint is
            # 1.15 GB): single-thread zlib costs ~a minute per save
            # at the per-1000-episode cadence — store raw instead
            np.savez(buf, **data)
        else:
            np.savez_compressed(buf, **data)
        return buf.getvalue()
    raise ValueError(f"unknown artifact extension: {key}")


def _decode(key: str, raw: bytes) -> Any:
    ext = key.rsplit(".", 1)[-1]
    if ext == "json":
        return json.loads(raw.decode())
    if ext in ("txt", "jsonl", "md"):
        return raw.decode()
    if ext == "npz":
        with np.load(io.BytesIO(raw), allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    raise ValueError(f"unknown artifact extension: {key}")


class _SerializingStore(ArtifactStore):
    def save(self, key: str, data: Any) -> None:
        self.save_bytes(key, _encode(key, data))

    def load(self, key: str) -> Any:
        raw = self.load_bytes(key)
        if raw is None:
            return None
        return _decode(key, raw)


class LocalStore(_SerializingStore):
    """Filesystem-backed store rooted at a directory."""

    def __init__(self, root: str):
        self.root = os.path.abspath(os.path.expanduser(root))
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()

    def _path(self, key: str) -> str:
        p = os.path.normpath(os.path.join(self.root, key))
        # commonpath handles both the sibling-prefix escape (a store
        # at /data and a key reaching /data-evil) and a "/" root
        # (where a trailing-sep startswith check would reject every key)
        if p == self.root or os.path.commonpath([p, self.root]) != self.root:
            raise ValueError(f"key escapes store root: {key}")
        return p

    def save_bytes(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)  # atomic
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise

    def load_bytes(self, key: str) -> Optional[bytes]:
        path = self._path(key)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return f.read()

    def append_text(self, key: str, text: str) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path) or self.root, exist_ok=True)
        with self._lock, open(path, "a") as f:
            f.write(text)

    def delete(self, key: str) -> None:
        path = self._path(key)
        if os.path.exists(path):
            os.remove(path)

    def list_keys(self, prefix: str = "") -> List[str]:
        out = []
        for dirpath, _, files in os.walk(self.root):
            for fn in files:
                rel = os.path.relpath(os.path.join(dirpath, fn), self.root)
                rel = rel.replace(os.sep, "/")
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))


class MemoryStore(_SerializingStore):
    """Dict-backed store for tests."""

    def __init__(self):
        self._data: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def save_bytes(self, key: str, data: bytes) -> None:
        with self._lock:
            self._data[key] = bytes(data)

    def load_bytes(self, key: str) -> Optional[bytes]:
        return self._data.get(key)

    def append_text(self, key: str, text: str) -> None:
        with self._lock:
            self._data[key] = self._data.get(key, b"") + text.encode()

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def list_keys(self, prefix: str = "") -> List[str]:
        return sorted(k for k in self._data if k.startswith(prefix))

    def exists(self, key: str) -> bool:
        return key in self._data


class S3Store(_SerializingStore):
    """Object-store backend (same interface).  Requires boto3; kept as
    a thin adapter so deployments with object storage can swap it in
    for the reference's bucket layout."""

    def __init__(self, bucket: str, region: Optional[str] = None):
        try:
            import boto3  # noqa: PLC0415
        except ImportError as e:
            raise RuntimeError(
                "S3Store requires boto3, which is not installed; "
                "use LocalStore or MemoryStore"
            ) from e
        kw = {"region_name": region} if region else {}
        self._s3 = boto3.resource("s3", **kw)
        self._bucket = self._s3.Bucket(bucket)
        self._name = bucket

    def save_bytes(self, key: str, data: bytes) -> None:
        self._bucket.put_object(Key=key, Body=data)

    def load_bytes(self, key: str):
        try:
            return self._bucket.Object(key).get()["Body"].read()
        except self._s3.meta.client.exceptions.NoSuchKey:
            return None  # missing key == None, like the other stores
        except Exception as e:
            # auth/network errors must NOT read as "no such artifact":
            # surface them (a silent None here could e.g. make resume
            # start from scratch over a transient outage)
            import logging

            logging.getLogger("tpu2048.store").error(
                "S3 read %s/%s failed: %s", self._name, key, e
            )
            raise

    def append_text(self, key: str, text: str) -> None:
        cur = self.load_bytes(key) or b""
        self.save_bytes(key, cur + text.encode())

    def delete(self, key: str) -> None:
        self._bucket.Object(key).delete()

    def list_keys(self, prefix: str = "") -> List[str]:
        return sorted(
            o.key for o in self._bucket.objects.filter(Prefix=prefix)
        )


def open_store(backend: str = "local", root: str = "~/.tpu2048",
               bucket: str = "") -> ArtifactStore:
    if backend == "local":
        return LocalStore(root)
    if backend == "memory":
        return MemoryStore()
    if backend == "s3":
        return S3Store(bucket)
    raise ValueError(f"unknown store backend: {backend}")
