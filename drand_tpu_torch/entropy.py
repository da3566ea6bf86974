"""Entropy sources for DKG secrets (counterpart of `drand_tpu/entropy.py`,
drand `entropy/entropy.go`): `ScriptReader` runs an executable (the
`--source` flag) whose standard output is the entropy, and `get_random`
mixes it with the OS CSPRNG unless told to use it alone."""

from __future__ import annotations

import os
import subprocess


class ScriptReader:
    """Entropy from an executable's standard output."""

    def __init__(self, path: str):
        self.path = path

    def read(self, n: int) -> bytes:
        out = subprocess.run([self.path], capture_output=True, timeout=30,
                             check=True).stdout
        if len(out) < n:
            raise ValueError(
                f"entropy script produced {len(out)} < {n} bytes")
        return out[:n]


def get_random(source, n: int, user_only: bool = False) -> bytes:
    """n random bytes from `source` (anything with .read(n)), XOR-mixed
    with the OS CSPRNG unless user_only; the CSPRNG alone when there is
    no source or it fails."""
    if source is None:
        return os.urandom(n)
    try:
        user = source.read(n)
    except Exception:
        return os.urandom(n)
    if user_only:
        return user
    return bytes(a ^ b for a, b in zip(user, os.urandom(n)))
