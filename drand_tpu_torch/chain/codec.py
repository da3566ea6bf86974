"""Binary row codec of the beacon store (counterpart of
`drand_tpu/chain/codec.py`; the same bytes, so a database written by
either package reads in the other).

A row is a fixed-layout record

    0x01 | uint64 round | uint16 sig_len | uint16 prev_len | sig | prev
    (little-endian header, 13 bytes)

or, in databases of the legacy writer, `Beacon.to_json`.  A sniff byte
tells them apart: JSON rows start with ``{`` (0x7b), binary rows with
0x01, so every read path takes both.
"""

from __future__ import annotations

import struct

from drand_tpu_torch.chain.beacon import Beacon

MAGIC_V1 = 0x01
_JSON_OPEN = 0x7B                 # ord("{"): every legacy row starts here
_HEADER = struct.Struct("<BQHH")  # magic, round, sig_len, prev_len


class CodecError(ValueError):
    """A row that is neither a valid binary record nor valid JSON."""


def encode_fields(round_: int, signature: bytes, previous_sig: bytes) -> bytes:
    if len(signature) > 0xFFFF or len(previous_sig) > 0xFFFF:
        raise CodecError("signature/prev_sig longer than uint16 row layout")
    return _HEADER.pack(MAGIC_V1, round_, len(signature),
                        len(previous_sig)) + signature + previous_sig


def encode_beacon(beacon: Beacon) -> bytes:
    return encode_fields(beacon.round, beacon.signature, beacon.previous_sig)


def decode_fields(data: bytes) -> tuple[int, bytes, bytes]:
    """-> (round, signature, previous_sig), by the row's sniff byte."""
    if not data:
        raise CodecError("empty store row")
    data = bytes(data)
    first = data[0]
    if first == MAGIC_V1:
        if len(data) < _HEADER.size:
            raise CodecError(f"binary row truncated at {len(data)} bytes")
        _, round_, sig_len, prev_len = _HEADER.unpack_from(data)
        end = _HEADER.size + sig_len + prev_len
        if len(data) != end:
            raise CodecError(
                f"binary row length {len(data)} != declared {end}")
        sig = data[_HEADER.size:_HEADER.size + sig_len]
        return round_, sig, data[_HEADER.size + sig_len:end]
    if first == _JSON_OPEN:
        try:
            b = Beacon.from_json(data)
        except Exception as exc:
            raise CodecError(f"bad JSON row: {exc}") from exc
        return b.round, b.signature, b.previous_sig
    raise CodecError(f"unknown row codec marker 0x{first:02x}")


def decode_beacon(data: bytes) -> Beacon:
    round_, sig, prev = decode_fields(data)
    return Beacon(round=round_, signature=sig, previous_sig=prev)


def make_encoder(codec: str = "binary"):
    """The row writer of a store: 'binary' (the default) or 'json' (the
    legacy layout)."""
    if codec == "json":
        return lambda b: b.to_json()
    if codec == "binary":
        return encode_beacon
    raise ValueError(f"unknown store codec {codec!r} "
                     "(expected 'binary' or 'json')")
