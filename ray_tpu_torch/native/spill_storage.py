"""Pluggable external spill storage (external_storage.py analog).

The reference spills to configurable external storage — local
filesystem or S3-style URIs
(Ray's python/ray/_private/external_storage.py). Here a
SpillingStore writes through one of these backends, selected by
``cfg.spill_storage_uri``:

- ``file:///path`` (or a bare path / empty → the node's spill dir):
  atomic local files, the default.
- ``memory://``: in-process dict — the test double.
- ``s3://bucket/prefix``: S3 object storage through boto3 when
  installed, or any injected client exposing
  put_object/get_object/delete_object/head_object (how tests prove the
  path on a zero-egress image, and how non-AWS S3-compatibles slot in).

Port of ``ray_tpu/native/spill_storage.py``, copied with its imports rewritten.
"""
from __future__ import annotations

import os
import threading
import uuid
from typing import Dict, Optional


class FileSystemBackend:
    """Atomic local files — a unique temp name per write so a concurrent
    spill and duplicate-put fallback for one id never race on one .tmp
    path."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, oid: str) -> str:
        return os.path.join(self.directory, oid)

    def put(self, oid: str, data: bytes) -> None:
        tmp = f"{self._path(oid)}.{uuid.uuid4().hex[:8]}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, self._path(oid))

    def get(self, oid: str) -> bytes:
        try:
            with open(self._path(oid), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise KeyError(oid) from None

    def exists(self, oid: str) -> bool:
        return os.path.exists(self._path(oid))

    def delete(self, oid: str) -> None:
        try:
            os.remove(self._path(oid))
        except OSError:
            pass

    def destroy(self) -> None:
        import shutil

        shutil.rmtree(self.directory, ignore_errors=True)


class MemoryBackend:
    def __init__(self):
        self._d: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def put(self, oid: str, data: bytes) -> None:
        with self._lock:
            self._d[oid] = data

    def get(self, oid: str) -> bytes:
        with self._lock:
            if oid not in self._d:
                raise KeyError(oid)
            return self._d[oid]

    def exists(self, oid: str) -> bool:
        with self._lock:
            return oid in self._d

    def delete(self, oid: str) -> None:
        with self._lock:
            self._d.pop(oid, None)

    def destroy(self) -> None:
        with self._lock:
            self._d.clear()


class S3Backend:
    """S3-compatible object storage. ``client`` injection is first-class
    (reference external_storage takes a session the same way): pass any
    object with put_object/get_object/delete_object/head_object; without
    one, boto3 is required and its absence is a loud error."""

    def __init__(self, bucket: str, prefix: str = "", client=None):
        self.bucket = bucket
        self.prefix = prefix.strip("/")
        if client is None:
            try:
                import boto3  # type: ignore[import-not-found]
            except ImportError as e:
                raise RuntimeError(
                    "spill_storage_uri=s3://... needs boto3 (not in this "
                    "image) or an injected client"
                ) from e
            client = boto3.client("s3")
        self.client = client

    def _key(self, oid: str) -> str:
        return f"{self.prefix}/{oid}" if self.prefix else oid

    def put(self, oid: str, data: bytes) -> None:
        self.client.put_object(
            Bucket=self.bucket, Key=self._key(oid), Body=data
        )

    def get(self, oid: str) -> bytes:
        try:
            reply = self.client.get_object(
                Bucket=self.bucket, Key=self._key(oid)
            )
        except Exception:  # noqa: BLE001 - NoSuchKey et al.
            raise KeyError(oid) from None
        body = reply["Body"]
        return body.read() if hasattr(body, "read") else body

    def exists(self, oid: str) -> bool:
        try:
            self.client.head_object(Bucket=self.bucket, Key=self._key(oid))
            return True
        except Exception:  # noqa: BLE001
            return False

    def delete(self, oid: str) -> None:
        try:
            self.client.delete_object(
                Bucket=self.bucket, Key=self._key(oid)
            )
        except Exception:  # noqa: BLE001
            pass

    def destroy(self) -> None:
        pass  # remote bucket outlives the node


def storage_from_uri(
    uri: Optional[str], default_dir: str, client=None
):
    """Backend from a spill URI (empty/None → node-local files)."""
    if not uri:
        return FileSystemBackend(default_dir)
    if uri.startswith("file://"):
        return FileSystemBackend(uri[len("file://"):] or default_dir)
    if uri.startswith("memory://"):
        return MemoryBackend()
    if uri.startswith("s3://"):
        rest = uri[len("s3://"):]
        bucket, _, prefix = rest.partition("/")
        if not bucket:
            raise ValueError(f"malformed s3 spill uri {uri!r}")
        return S3Backend(bucket, prefix, client=client)
    if "://" not in uri:
        return FileSystemBackend(uri)  # bare path
    raise ValueError(f"unsupported spill storage uri {uri!r}")
