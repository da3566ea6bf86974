"""The wire form of a threshold BLS partial signature (counterpart of
`drand_tpu/crypto/tbls.py`): BE16(signer index) followed by the 96-byte
compressed G2 signature."""

from __future__ import annotations

INDEX_LEN = 2


def index_of(partial: bytes) -> int:
    """The signer index of a partial signature."""
    if len(partial) < INDEX_LEN:
        raise ValueError("partial too short")
    return int.from_bytes(partial[:INDEX_LEN], "big")


def sig_of(partial: bytes) -> bytes:
    return partial[INDEX_LEN:]
