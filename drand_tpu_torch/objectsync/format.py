"""Object layout of the objectsync tier (counterpart of
`drand_tpu/objectsync/format.py`; the same bytes, so objects and
`manifest.json` written by either package read in the other).

The chain is published as immutable, content-addressed segment objects
plus one small mutable ``manifest.json``.  A segment object carries a
contiguous run of store rows (16384 by default, the verify bucket) in the
row codec of `chain/codec.py`, named by the sha256 of its own bytes:

    segments/{start:012d}-{hash}.drs

An object's name commits to its content, so it can be cached forever;
only the manifest (chain identity, segment size, tip and the index of
published segments) changes.  Nothing here is trusted by a consumer: the
client re-verifies every row against its own chain anchor (`client.py`).

Layout v1 (all little-endian):

    magic b"DOS1" | u16 version | u16 row_codec | u64 start_round
    | u32 count | u16 chain_hash_len | u16 scheme_len
    | chain_hash | scheme_id
    | count x (u32 row_len | row)

Rows are each length-prefixed and decoded through the codec's sniff byte,
so binary and legacy JSON rows ride the same layout (the ``row_codec``
header field records the writer; it does not gate reads).
"""

from __future__ import annotations

import hashlib
import json
import struct
from dataclasses import dataclass, field

from drand_tpu_torch.chain import codec as row_codec
from drand_tpu_torch.chain.beacon import Beacon

MAGIC = b"DOS1"
OBJECT_VERSION = 1
ROW_CODEC_BINARY = 1
ROW_CODEC_JSON = 2

# header: magic, version, row_codec, start_round, count, hash_len, scheme_len
_HDR = struct.Struct("<4sHHQIHH")
_ROW_LEN = struct.Struct("<I")

MANIFEST_NAME = "manifest.json"
MANIFEST_VERSION = 1
DEFAULT_SEGMENT_ROUNDS = 16384
NAME_TEMPLATE = "segments/{start:012d}-{hash}.drs"


class ObjectFormatError(ValueError):
    """An object that is not a valid segment/manifest — truncated,
    bit-rotted, wrong chain, or internally inconsistent."""


def content_hash(data: bytes) -> str:
    """The content address: sha256 over the FULL object bytes (header
    included), hex.  Stable across processes and platforms — the object
    name commits to every byte served."""
    return hashlib.sha256(data).hexdigest()


def object_name(start_round: int, hash_hex: str,
                template: str = NAME_TEMPLATE) -> str:
    return template.format(start=start_round, hash=hash_hex)


def _encode_row(round_: int, sig: bytes, prev: bytes, codec: str) -> bytes:
    if codec == "json":
        return Beacon(round=round_, signature=sig,
                      previous_sig=prev).to_json()
    return row_codec.encode_fields(round_, sig, prev)


def encode_rows(rows: list[tuple[int, bytes, bytes]],
                codec: str = "binary") -> bytes:
    """Length-prefixed codec rows: the body of a segment object (and of
    drand_tpu's ``/public/rounds`` HTTP range route)."""
    out = []
    for (r, sig, prev) in rows:
        blob = _encode_row(r, sig, prev, codec)
        out.append(_ROW_LEN.pack(len(blob)))
        out.append(blob)
    return b"".join(out)


def decode_rows(data: bytes, offset: int = 0,
                count: int | None = None) -> list[tuple[int, bytes, bytes]]:
    """Parse a length-prefixed row stream -> (round, sig, prev) tuples.
    ``count=None`` reads to the end of ``data``; any truncation or codec
    failure raises ObjectFormatError (a damaged object must fail loudly,
    never yield a short silent prefix)."""
    rows: list[tuple[int, bytes, bytes]] = []
    n = len(data)
    while offset < n and (count is None or len(rows) < count):
        if offset + _ROW_LEN.size > n:
            raise ObjectFormatError(
                f"row length prefix truncated at byte {offset}")
        (row_len,) = _ROW_LEN.unpack_from(data, offset)
        offset += _ROW_LEN.size
        if offset + row_len > n:
            raise ObjectFormatError(
                f"row truncated: declared {row_len} bytes, "
                f"{n - offset} remain")
        try:
            rows.append(row_codec.decode_fields(data[offset:offset + row_len]))
        except row_codec.CodecError as exc:
            raise ObjectFormatError(f"bad row at byte {offset}: {exc}") \
                from exc
        offset += row_len
    if count is not None and len(rows) != count:
        raise ObjectFormatError(
            f"object carries {len(rows)} rows, header declares {count}")
    return rows


@dataclass
class Segment:
    """A decoded segment object."""
    chain_hash: bytes
    scheme_id: str
    start_round: int
    rows: list[tuple[int, bytes, bytes]]
    row_codec_id: int = ROW_CODEC_BINARY

    @property
    def count(self) -> int:
        return len(self.rows)

    @property
    def end_round(self) -> int:
        return self.start_round + len(self.rows) - 1


def encode_segment(chain_hash: bytes, scheme_id: str,
                   rows: list[tuple[int, bytes, bytes]],
                   codec: str = "binary") -> bytes:
    """Serialize one sealed segment.  Rows must be a contiguous,
    ascending run — the layout commits to [start, start+count) and a gap
    would let a range lie about what it covers."""
    if not rows:
        raise ObjectFormatError("empty segment")
    start = rows[0][0]
    for i, (r, _, _) in enumerate(rows):
        if r != start + i:
            raise ObjectFormatError(
                f"non-contiguous rows: round {r} at index {i} "
                f"(expected {start + i})")
    scheme = scheme_id.encode()
    codec_id = ROW_CODEC_JSON if codec == "json" else ROW_CODEC_BINARY
    hdr = _HDR.pack(MAGIC, OBJECT_VERSION, codec_id, start, len(rows),
                    len(chain_hash), len(scheme))
    return hdr + chain_hash + scheme + encode_rows(rows, codec=codec)


def decode_segment(data: bytes) -> Segment:
    """Parse + structurally validate one segment object.  This is the
    cheap integrity layer (magic, declared lengths, round contiguity);
    cryptographic trust comes ONLY from the client's own verify pass."""
    if len(data) < _HDR.size:
        raise ObjectFormatError(f"object truncated at {len(data)} bytes")
    magic, version, codec_id, start, count, hash_len, scheme_len = \
        _HDR.unpack_from(data)
    if magic != MAGIC:
        raise ObjectFormatError(f"bad magic {magic!r}")
    if version != OBJECT_VERSION:
        raise ObjectFormatError(f"unsupported object version {version}")
    off = _HDR.size
    if len(data) < off + hash_len + scheme_len:
        raise ObjectFormatError("header fields truncated")
    chain_hash = data[off:off + hash_len]
    off += hash_len
    scheme_id = data[off:off + scheme_len].decode()
    off += scheme_len
    rows = decode_rows(data, offset=off, count=count)
    for i, (r, _, _) in enumerate(rows):
        if r != start + i:
            raise ObjectFormatError(
                f"row {i} decodes to round {r}, header declares "
                f"{start + i}")
    return Segment(chain_hash=chain_hash, scheme_id=scheme_id,
                   start_round=start, rows=rows, row_codec_id=codec_id)


@dataclass
class ManifestEntry:
    start: int
    count: int
    hash: str        # content hash (hex) — doubles as the name component
    name: str

    @property
    def end(self) -> int:
        return self.start + self.count - 1

    def to_dict(self) -> dict:
        return {"start": self.start, "count": self.count,
                "hash": self.hash, "name": self.name}


@dataclass
class Manifest:
    """The ONE mutable object.  Everything a cold client needs to plan a
    sync: chain identity, segment size, published tip, and the ordered
    segment index (content hashes included, so a CDN serving a stale
    segment body under a fresh name is caught before decode)."""
    chain_hash: str                 # hex
    scheme_id: str
    segment_rounds: int = DEFAULT_SEGMENT_ROUNDS
    tip: int = 0                    # last round covered by a segment
    template: str = NAME_TEMPLATE
    segments: list[ManifestEntry] = field(default_factory=list)
    version: int = MANIFEST_VERSION

    def validate(self) -> None:
        prev_end = None
        for s in self.segments:
            if s.count < 1:
                raise ObjectFormatError(f"segment at {s.start}: empty")
            if prev_end is not None and s.start != prev_end + 1:
                raise ObjectFormatError(
                    f"manifest gap: segment at {s.start} after round "
                    f"{prev_end}")
            prev_end = s.end
        if self.segments and self.tip != self.segments[-1].end:
            raise ObjectFormatError(
                f"manifest tip {self.tip} != last segment end "
                f"{self.segments[-1].end}")

    def append(self, entry: ManifestEntry) -> None:
        self.segments.append(entry)
        self.tip = entry.end
        self.validate()

    def next_start(self, first_round: int = 1) -> int:
        return self.segments[-1].end + 1 if self.segments else first_round

    def to_json(self) -> bytes:
        return json.dumps({
            "version": self.version,
            "chain_hash": self.chain_hash,
            "scheme_id": self.scheme_id,
            "segment_rounds": self.segment_rounds,
            "tip": self.tip,
            "template": self.template,
            "segments": [s.to_dict() for s in self.segments],
        }, sort_keys=True, indent=1).encode()

    @classmethod
    def from_json(cls, data: bytes) -> "Manifest":
        try:
            d = json.loads(data)
        except (ValueError, UnicodeDecodeError) as exc:
            raise ObjectFormatError(f"bad manifest JSON: {exc}") from exc
        try:
            m = cls(
                chain_hash=str(d["chain_hash"]),
                scheme_id=str(d["scheme_id"]),
                segment_rounds=int(d["segment_rounds"]),
                tip=int(d["tip"]),
                template=str(d.get("template", NAME_TEMPLATE)),
                segments=[ManifestEntry(
                    start=int(s["start"]), count=int(s["count"]),
                    hash=str(s["hash"]), name=str(s["name"]))
                    for s in d.get("segments", [])],
                version=int(d.get("version", MANIFEST_VERSION)),
            )
        except (KeyError, TypeError, ValueError) as exc:
            raise ObjectFormatError(f"bad manifest field: {exc}") from exc
        if m.version != MANIFEST_VERSION:
            raise ObjectFormatError(
                f"unsupported manifest version {m.version}")
        m.validate()
        return m
