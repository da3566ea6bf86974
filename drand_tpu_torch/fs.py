"""Secure filesystem helpers of the key store (counterpart of
`drand_tpu/fs.py`, drand `fs/fs.go`): folders 0700, files 0600 written
atomically."""

from __future__ import annotations

import os


def create_secure_folder(path: str) -> str:
    """mkdir -p with 0700 permissions."""
    os.makedirs(path, mode=0o700, exist_ok=True)
    os.chmod(path, 0o700)
    return path


def write_secure_file(path: str, data: bytes) -> None:
    """Write with 0600 permissions, atomically (a temporary file, then a
    rename)."""
    tmp = path + ".tmp"
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
    except Exception:
        os.unlink(tmp)
        raise
    os.replace(tmp, path)
    os.chmod(path, 0o600)


def file_exists(path: str) -> bool:
    return os.path.isfile(path)


def list_subfolders(path: str) -> list[str]:
    if not os.path.isdir(path):
        return []
    return sorted(d for d in os.listdir(path)
                  if os.path.isdir(os.path.join(path, d)))
