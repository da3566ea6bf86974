"""Object stores of the objectsync tier (counterpart of
`drand_tpu/objectsync/backends.py`'s `ObjectStore` and
`FilesystemBackend`).

The seam the publisher writes through and the client reads through:
``put(name, body)`` and ``get(name) -> bytes`` as coroutines, nothing
else.  `FilesystemBackend` is a directory (tests, and the "publish to a
directory, serve it with any static file server or copy it to a bucket"
path); its writes are atomic (temporary file and rename), so a crashed
publisher never leaves a half-written object where a client could fetch
it.  drand_tpu's `HTTPBackend` and `SyncAdapter` are not ported: they
need `aiohttp`.
"""

from __future__ import annotations

import asyncio
import os


class ObjectStoreError(Exception):
    pass


class ObjectNotFound(ObjectStoreError):
    def __init__(self, name: str):
        super().__init__(f"object {name!r} not found")
        self.name = name


class ObjectStore:
    """Abstract backend: named blobs.  A re-put of identical bytes must be
    harmless (content-addressed objects make every retry idempotent)."""

    async def put(self, name: str, body: bytes) -> None:
        raise NotImplementedError

    async def get(self, name: str) -> bytes:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__


class FilesystemBackend(ObjectStore):
    """A directory as the object store; a name that would leave the
    directory raises ObjectStoreError."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, name: str) -> str:
        path = os.path.normpath(os.path.join(self.root, name))
        root = os.path.abspath(self.root)
        if not os.path.abspath(path).startswith(root + os.sep):
            raise ObjectStoreError(f"object name escapes root: {name!r}")
        return path

    def put_sync(self, name: str, body: bytes) -> None:
        """Atomic write: a reader (or a crash) sees the old object or the
        new one, never a torn middle."""
        path = self._path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(body)
        os.replace(tmp, path)

    def get_sync(self, name: str) -> bytes:
        try:
            with open(self._path(name), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise ObjectNotFound(name) from None

    async def put(self, name: str, body: bytes) -> None:
        await asyncio.to_thread(self.put_sync, name, body)

    async def get(self, name: str) -> bytes:
        return await asyncio.to_thread(self.get_sync, name)

    def describe(self) -> str:
        return f"fs:{self.root}"
