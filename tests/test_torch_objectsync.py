"""The port's objectsync tier, store decorators and `objectsync` CLI on the
CPU, held against drand_tpu's on the same rows, stores and directories:
segment objects, content hashes and manifests byte-equal and decoded both
ways; the filesystem backend's name guard; the publisher (sealed segments
only, resume from the manifest); the verify-then-commit client with the
port's ChainVerifier(device="cpu") on real signatures (segments of at
most 32 rounds on the host tier, one of 40 on the CPU Verifier), its stop
at the verified prefix and `up_to`; `AppendStore` and `SchemeStore`; and
the two CLIs' `sync` on the same directory.  The tolerance is exact
equality of bytes, rows, tips and results.
"""

import asyncio
import json
import os
import sqlite3
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from drand_tpu.chain import scheme as JS
from drand_tpu.chain import store as JST
from drand_tpu.chain.beacon import Beacon as JBeacon
from drand_tpu.chain.verify import ChainVerifier as JChainVerifier
from drand_tpu.objectsync import backends as JB
from drand_tpu.objectsync import client as JCL
from drand_tpu.objectsync import format as JF
from drand_tpu.objectsync import publisher as JPUB
from drand_tpu_torch import dispatch as D
from drand_tpu_torch import fixtures as TFX
from drand_tpu_torch import objectsync as OS
from drand_tpu_torch.chain import scheme as S
from drand_tpu_torch.chain import store as ST
from drand_tpu_torch.chain.beacon import Beacon
from drand_tpu_torch.chain.verify import ChainVerifier
from drand_tpu_torch.crypto.bls12381 import curve as GC
from drand_tpu_torch.objectsync import format as F

ROOT = Path(__file__).resolve().parents[1]
CHAIN_HASH = bytes(range(32))
CHAINED, UNCHAINED = "pedersen-bls-chained", "pedersen-bls-unchained"
UNCHAINED_512 = (TFX.G1_FIXTURE.parent
                 / "bench_sigs_unchained_512_d6a762f2_ff8a2cc7.npy")
GOLDEN_V1_HASH = \
    "4190354217ffc2557cb9c28c5e1a98f4340bab29c9068cfadf2290d66611e95f"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seeded_rows(seed: int, start: int, count: int, sig_len: int = 96):
    """Contiguous chained (round, sig, prev) rows of seeded bytes."""
    rng = np.random.default_rng(seed)
    sigs = [rng.bytes(sig_len) for _ in range(count + 1)]
    return [(start + i, sigs[i + 1], sigs[i]) for i in range(count)]


def files(root) -> dict:
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def table(path):
    con = sqlite3.connect(path)
    try:
        return con.execute("SELECT round, data FROM beacons "
                           "ORDER BY round").fetchall()
    finally:
        con.close()


# -- format ------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["binary", "json"])
@pytest.mark.parametrize("seed,start,count", [(1, 1, 16), (2, 16385, 40),
                                              (3, 2**40, 3)])
def test_segment_bytes_match_reference(codec, seed, start, count):
    rows = seeded_rows(seed, start, count)
    ours = F.encode_segment(CHAIN_HASH, CHAINED, rows, codec=codec)
    ref = JF.encode_segment(CHAIN_HASH, CHAINED, rows, codec=codec)
    assert ours == ref
    h = F.content_hash(ours)
    assert h == JF.content_hash(ref)
    assert F.object_name(start, h) == JF.object_name(start, h)
    for seg in (F.decode_segment(ref), JF.decode_segment(ours)):
        assert (seg.chain_hash, seg.scheme_id, seg.start_round, seg.rows,
                seg.row_codec_id) == (CHAIN_HASH, CHAINED, start, rows,
                                      F.ROW_CODEC_JSON if codec == "json"
                                      else F.ROW_CODEC_BINARY)
    mixed = F.encode_rows(rows[:1], codec="json") + F.encode_rows(rows[1:])
    assert mixed == JF.encode_rows(rows[:1], codec="json") + \
        JF.encode_rows(rows[1:])
    assert F.decode_rows(mixed) == JF.decode_rows(mixed) == rows


def test_segment_golden_content_hash():
    blob = F.encode_segment(b"\x01\x02", "s", [(5, b"AB", b"ZY"),
                                               (6, b"CD", b"AB")])
    assert F.content_hash(blob) == GOLDEN_V1_HASH


@pytest.mark.parametrize("damage", ["truncated_row", "bad_magic",
                                    "truncated_header", "wrong_count",
                                    "round_mismatch", "bad_version"])
def test_segment_damage_rejected_as_reference(damage):
    rows = seeded_rows(4, 10, 8)
    blob = F.encode_segment(CHAIN_HASH, CHAINED, rows)
    bad = {"truncated_row": blob[:-3], "bad_magic": b"NOPE" + blob[4:],
           "truncated_header": blob[:F._HDR.size - 2],
           "wrong_count": blob[:16] + (9).to_bytes(4, "little") + blob[20:],
           "round_mismatch": blob[:8] + (11).to_bytes(8, "little")
           + blob[16:],
           "bad_version": blob[:4] + (2).to_bytes(2, "little") + blob[6:]
           }[damage]
    with pytest.raises(F.ObjectFormatError):
        F.decode_segment(bad)
    with pytest.raises(JF.ObjectFormatError):
        JF.decode_segment(bad)


def test_encode_refuses_gaps_and_empty_as_reference():
    for rows in ([(1, b"a", b""), (3, b"b", b"")], []):
        with pytest.raises(F.ObjectFormatError):
            F.encode_segment(CHAIN_HASH, CHAINED, rows)
        with pytest.raises(JF.ObjectFormatError):
            JF.encode_segment(CHAIN_HASH, CHAINED, rows)


def test_manifest_bytes_match_reference():
    ours = F.Manifest(chain_hash=CHAIN_HASH.hex(), scheme_id=CHAINED,
                      segment_rounds=16)
    ref = JF.Manifest(chain_hash=CHAIN_HASH.hex(), scheme_id=CHAINED,
                      segment_rounds=16)
    for start, h in ((1, "aa"), (17, "bb")):
        ours.append(F.ManifestEntry(start=start, count=16, hash=h,
                                    name=f"segments/{h}"))
        ref.append(JF.ManifestEntry(start=start, count=16, hash=h,
                                    name=f"segments/{h}"))
    assert ours.to_json() == ref.to_json()
    assert ours.tip == 32 and ours.next_start() == ref.next_start() == 33
    assert F.Manifest.from_json(ref.to_json()).to_json() == ref.to_json()
    assert JF.Manifest.from_json(ours.to_json()).to_json() == ours.to_json()
    for bad in (b"{not json", json.dumps({"version": 99}).encode(),
                json.dumps({"chain_hash": "00", "scheme_id": "s",
                            "segment_rounds": 16, "tip": 5}).encode()
                .replace(b'"tip": 5', b'"tip": 5, "segments": '
                         b'[{"start": 1, "count": 4, "hash": "a", '
                         b'"name": "a"}]'),
                json.dumps({"chain_hash": "00", "scheme_id": "s"}).encode()):
        with pytest.raises(F.ObjectFormatError):
            F.Manifest.from_json(bad)
        with pytest.raises(JF.ObjectFormatError):
            JF.Manifest.from_json(bad)
    with pytest.raises(F.ObjectFormatError):
        ours.append(F.ManifestEntry(start=40, count=16, hash="c", name="z"))


# -- backend -----------------------------------------------------------------

@pytest.mark.parametrize("name", ["../escape", "/etc/passwd",
                                  "segments/../../x", ".", ""])
def test_filesystem_backend_name_guard(tmp_path, name):
    ours, ref = OS.FilesystemBackend(str(tmp_path / "a")), \
        JB.FilesystemBackend(str(tmp_path / "b"))
    with pytest.raises(OS.ObjectStoreError):
        ours.get_sync(name)
    with pytest.raises(OS.ObjectStoreError):
        ours.put_sync(name, b"x")
    with pytest.raises(JB.ObjectStoreError):
        ref.get_sync(name)


def test_filesystem_backend_round_trip(tmp_path):
    async def main():
        be = OS.FilesystemBackend(str(tmp_path))
        await be.put("segments/a", b"hello")
        await be.put("segments/a", b"hello")
        assert await be.get("segments/a") == b"hello"
        with pytest.raises(OS.ObjectNotFound):
            await be.get("segments/missing")
    asyncio.run(main())
    assert [p.name for p in tmp_path.rglob("*") if p.is_file()] == ["a"]
    assert OS.FilesystemBackend(str(tmp_path)).describe() == \
        JB.FilesystemBackend(str(tmp_path)).describe()


# -- publisher ---------------------------------------------------------------

def source_store(path, rows, seed=b"\x07" * 32):
    """A port SqliteStore of the genesis seed and `rows`."""
    store = ST.SqliteStore(str(path))
    store.put_many([Beacon(0, seed)] + [Beacon(r, s, p) for r, s, p in rows])
    return store


def publish(store, root, segment_rounds, scheme=CHAINED, ref=False):
    """Publish a store's sealed segments into `root` with the port's
    publisher, or drand_tpu's: (objects written, snapshot)."""
    publisher = JPUB.ObjectPublisher if ref else OS.ObjectPublisher
    backend = JB.FilesystemBackend if ref else OS.FilesystemBackend

    async def main():
        pub = publisher(store, backend(str(root)), chain_hash=CHAIN_HASH,
                        scheme_id=scheme, segment_rounds=segment_rounds)
        await pub.load_manifest()
        n = await pub.publish_sealed()
        return n, pub.snapshot()
    return asyncio.run(main())


def test_publisher_publishes_only_sealed_segments(tmp_path):
    rows = seeded_rows(5, 1, 40)
    store = source_store(tmp_path / "db.sqlite", rows)
    n, snap = publish(store, tmp_path / "objects", 16)
    assert n == 2
    m = F.Manifest.from_json((tmp_path / "objects" / F.MANIFEST_NAME)
                             .read_bytes())
    assert [e.start for e in m.segments] == [1, 17] and m.tip == 32
    for e in m.segments:
        blob = (tmp_path / "objects" / e.name).read_bytes()
        assert F.content_hash(blob) == e.hash
        assert F.decode_segment(blob).rows == rows[e.start - 1:e.end]
    assert snap["published_tip"] == 32 and snap["lag_rounds"] == 8
    assert snap["attached"] is False and snap["last_error"] == ""
    assert publish(store, tmp_path / "objects", 16)[0] == 0
    store.close()


def test_publisher_resumes_from_manifest(tmp_path):
    """A backend lost after the first segment: a fresh publisher resumes
    at round 17, and the directory ends equal to one published in one go;
    a manifest of another chain is refused and the manifest's segment
    size wins."""
    rows = seeded_rows(6, 1, 48)
    store = source_store(tmp_path / "db.sqlite", rows)
    root = tmp_path / "objects"

    class Dies(OS.FilesystemBackend):
        puts = 0

        async def put(self, name, body):
            if name != F.MANIFEST_NAME:
                Dies.puts += 1
                if Dies.puts > 1:
                    raise RuntimeError("backend lost")
            await super().put(name, body)

    async def first():
        pub = OS.ObjectPublisher(store, Dies(str(root)), CHAIN_HASH, CHAINED,
                                 segment_rounds=16)
        await pub.load_manifest()
        with pytest.raises(RuntimeError):
            await pub.publish_sealed()
    asyncio.run(first())
    assert F.Manifest.from_json((root / F.MANIFEST_NAME).read_bytes()).tip \
        == 16
    assert publish(store, root, 999)[0] == 2        # the manifest's 16 wins
    publish(store, tmp_path / "at_once", 16)
    assert files(root) == files(tmp_path / "at_once")

    async def foreign():
        pub = OS.ObjectPublisher(store, OS.FilesystemBackend(str(root)),
                                 b"\xff" * 32, CHAINED, segment_rounds=16)
        with pytest.raises(OS.PublisherError):
            await pub.load_manifest()
    asyncio.run(foreign())
    store.close()


def test_publisher_live_drive_and_attach(tmp_path):
    """attach skips a store without the tail-callback seam, as drand_tpu's
    does, and publish_sealed still publishes on demand; on a
    CallbackStore it registers the live drive's tail callback (attached
    in the snapshot), and detach removes it."""
    rows = seeded_rows(7, 1, 16)
    base = source_store(tmp_path / "db.sqlite", rows)

    async def main():
        bare = OS.ObjectPublisher(base, OS.FilesystemBackend(
            str(tmp_path / "bare")), CHAIN_HASH, CHAINED, segment_rounds=16)
        bare.attach()
        assert await bare.publish_sealed() == 1
        snap = bare.snapshot()
        assert snap["attached"] is False and snap["published_tip"] == 16
        cbs = ST.CallbackStore(base, workers=1)
        live = OS.ObjectPublisher(cbs, OS.FilesystemBackend(
            str(tmp_path / "live")), CHAIN_HASH, CHAINED, segment_rounds=16)
        live.attach()
        assert live.snapshot()["attached"] is True
        assert list(cbs._tail_cbs) == ["objectsync-pub"]
        live.detach()
        assert live.snapshot()["attached"] is False and not cbs._tail_cbs
        cbs._pool.shutdown(wait=True)
    asyncio.run(main())
    base.close()


def test_port_published_directory_equals_reference(tmp_path):
    """One store published by both packages' publishers (a database the
    port wrote, opened by drand_tpu's store too): every object and the
    manifest byte-equal; a JSON-codec store as well."""
    for codec in ("binary", "json"):
        path = tmp_path / f"{codec}.sqlite"
        rows = seeded_rows(8, 1, 50)
        store = ST.SqliteStore(str(path), codec=codec)
        store.put_many([Beacon(0, b"\x01" * 32)]
                       + [Beacon(r, s, p) for r, s, p in rows])
        jstore = JST.SqliteStore(str(path))
        ours = publish(store, tmp_path / f"ours-{codec}", 16)
        ref = publish(jstore, tmp_path / f"ref-{codec}", 16, ref=True)
        assert ours[0] == ref[0] == 3
        assert files(tmp_path / f"ours-{codec}") == \
            files(tmp_path / f"ref-{codec}")
        for k in ("segment_rounds", "published_segments", "published_tip",
                  "store_tip", "lag_rounds", "attached", "last_error"):
            assert ours[1][k] == ref[1][k]
        store.close()
        jstore.close()


# -- store decorators --------------------------------------------------------

def _decorated(pkg, path, decouple):
    base = pkg.SqliteStore(str(path))
    return base, pkg.SchemeStore(pkg.AppendStore(base), decouple)


@pytest.mark.parametrize("decouple", [False, True])
def test_append_and_scheme_stores_match_reference(tmp_path, decouple):
    """The same puts through SchemeStore(AppendStore(SqliteStore)) of both
    packages: each accepted or refused alike, and the tables equal."""
    rows = seeded_rows(9, 1, 8)
    b = [(r, s, p) for r, s, p in rows]
    steps = [
        ("put", [(0, b[0][2], b"")]),                      # genesis
        ("put", [b[0]]), ("put", [b[0]]),                 # idempotent re-put
        ("put", [b[2]]),                                   # a gap
        ("put", [(2, b[1][1], b"\x00" * 96)]),             # a broken link
        ("put_many", [b[1], b[2], b[3]]),
        ("put_many", [b[3], b[4], b[5]]),                  # head re-put
        ("put_many", [b[6], b[6], b[7]]),                  # in-segment dup
        ("put_many", [(10, b"\x03" * 96, b[7][1])]),       # a gap
        ("put_many", [(9, b"\x03" * 96, b"\x04" * 96)]),   # a broken link
        ("put_many", []),
    ]
    outcomes = []
    for pkg, bc in ((ST, Beacon), (JST, JBeacon)):
        path = tmp_path / f"{pkg.__name__}.sqlite"
        base, store = _decorated(pkg, path, decouple)
        got = []
        for op, items in steps:
            beacons = [bc(r, s, p) for r, s, p in items]
            try:
                getattr(store, op)(beacons[0] if op == "put" else beacons)
                got.append("ok")
            except pkg.StoreError as exc:
                got.append(str(exc))
        outcomes.append((got, table(path), store.last().round, len(store)))
        base.close()
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0].count("ok") == (9 if decouple else 7)
    assert outcomes[0][2] == (9 if decouple else 8)


# -- the client on real signatures ------------------------------------------

@pytest.fixture(scope="module")
def chained_dir(tmp_path_factory):
    """Rounds 1-64 of the committed chained fixture published in segments
    of 16 from a port store (round 65 unsealed): (root, sigs, pk, seed)."""
    sigs, pk_bytes, seed = TFX.load_chained_fixture()
    tmp = tmp_path_factory.mktemp("chained")
    rows = [(r, bytes(sigs[r - 1]), seed if r == 1 else bytes(sigs[r - 2]))
            for r in range(1, 66)]
    store = source_store(tmp / "source.sqlite", rows, seed)
    publish(store, tmp / "objects", 16)
    store.close()
    return tmp, sigs, pk_bytes, seed


def sync(root, db, pk_bytes, seed, scheme=CHAINED, up_to=0, pkg="ours",
         anchor_rows=()):
    """One sync of a fresh store anchored on the seed (and `anchor_rows`
    after it) from `root`, by the port's client and ChainVerifier on the
    CPU or by drand_tpu's; returns (result dict, stats, the table)."""
    if pkg == "ours":
        base, store = _decorated(ST, db, S.scheme_by_id(scheme)
                                 .decouple_prev_sig)
        store.put(Beacon(0, seed))
        store.put_many([Beacon(*r) for r in anchor_rows])
        client = OS.ObjectSyncClient(
            OS.FilesystemBackend(str(root)), store,
            ChainVerifier(S.scheme_by_id(scheme), pk_bytes, device="cpu"),
            chain_hash=CHAIN_HASH)
    else:
        base, store = _decorated(JST, db, JS.scheme_by_id(scheme)
                                 .decouple_prev_sig)
        store.put(JBeacon(0, seed))
        store.put_many([JBeacon(*r) for r in anchor_rows])
        client = JCL.ObjectSyncClient(
            JB.FilesystemBackend(str(root)), store,
            JChainVerifier(JS.scheme_by_id(scheme), pk_bytes),
            chain_hash=CHAIN_HASH)
    res = asyncio.run(client.sync(up_to=up_to))
    base.close()
    return res.to_dict(), dict(client.stats), table(db)


def test_client_syncs_what_the_reference_syncs(chained_dir, tmp_path):
    """Four 16-round segments on the host tier: the same result and a
    table equal to the reference's and to the source's rows 0-64; a
    second sync finds nothing new."""
    root, _, pk, seed = chained_dir
    D.DISPATCH.clear()
    ours = sync(root / "objects", tmp_path / "a.sqlite", pk, seed)
    assert {r.seam for r in D.DISPATCH.records()} == {"native"}
    ref = sync(root / "objects", tmp_path / "b.sqlite", pk, seed, pkg="ref")
    assert ours[0] == ref[0] == {"ok": True, "synced_to": 64,
                                 "segments": 4, "rounds": 64, "error": ""}
    assert ours[2] == ref[2] == table(root / "source.sqlite")[:65]
    assert (ours[1]["segments"], ours[1]["rounds"]) == (4, 64)

    async def again():
        base, store = _decorated(ST, tmp_path / "a.sqlite", False)
        res = await OS.ObjectSyncClient(
            OS.FilesystemBackend(str(root / "objects")), store,
            ChainVerifier(S.scheme_by_id(CHAINED), pk, device="cpu"),
            chain_hash=CHAIN_HASH).sync()
        base.close()
        return res.to_dict()
    assert asyncio.run(again()) == {"ok": True, "synced_to": 64,
                                    "segments": 0, "rounds": 0, "error": ""}


def _poison(src, dst, seg_index, round_):
    """Copy the published directory and rewrite segment `seg_index` with
    round `round_`'s signature flipped, re-hashed and re-named in the
    manifest (an object a lying origin would serve)."""
    dst.mkdir()
    for name, data in files(src).items():
        (dst / name).parent.mkdir(parents=True, exist_ok=True)
        (dst / name).write_bytes(data)
    m = F.Manifest.from_json((dst / F.MANIFEST_NAME).read_bytes())
    e = m.segments[seg_index]
    seg = F.decode_segment((dst / e.name).read_bytes())
    rows = [(r, bytes(s[:40]) + bytes([s[40] ^ 1]) + bytes(s[41:])
             if r == round_ else s, p) for r, s, p in seg.rows]
    blob = F.encode_segment(seg.chain_hash, seg.scheme_id, rows)
    (dst / e.name).unlink()
    e.hash = F.content_hash(blob)
    e.name = F.object_name(e.start, e.hash)
    (dst / e.name).write_bytes(blob)
    (dst / F.MANIFEST_NAME).write_bytes(m.to_json())
    return e.name


def test_client_stops_at_the_verified_prefix(chained_dir, tmp_path):
    """A poisoned third segment (round 40 flipped, re-hashed): both
    clients stop at round 32 with the same error and tables; an object
    altered without re-hashing: a content-hash error, nothing past the
    prefix; `up_to` 40 truncates inside the third segment."""
    root, _, pk, seed = chained_dir
    name = _poison(root / "objects", tmp_path / "poisoned", 2, 40)
    ours = sync(tmp_path / "poisoned", tmp_path / "a.sqlite", pk, seed)
    ref = sync(tmp_path / "poisoned", tmp_path / "b.sqlite", pk, seed,
               pkg="ref")
    assert ours[0] == ref[0]
    assert (ours[0]["ok"], ours[0]["synced_to"], ours[0]["segments"]) == \
        (False, 32, 2)
    assert name in ours[0]["error"] and "[40, 41]" in ours[0]["error"]
    assert ours[2] == ref[2] == table(root / "source.sqlite")[:33]

    corrupt = tmp_path / "corrupt"
    _poison(root / "objects", corrupt, 1, 20)
    m = F.Manifest.from_json((root / "objects" / F.MANIFEST_NAME)
                             .read_bytes())
    # the second segment's new bytes under its old name and hash
    new = F.Manifest.from_json((corrupt / F.MANIFEST_NAME).read_bytes())
    (corrupt / m.segments[1].name).write_bytes(
        (corrupt / new.segments[1].name).read_bytes())
    (corrupt / F.MANIFEST_NAME).write_bytes(m.to_json())
    ours = sync(corrupt, tmp_path / "c.sqlite", pk, seed)
    assert (ours[0]["ok"], ours[0]["synced_to"]) == (False, 16)
    assert "content hash mismatch" in ours[0]["error"]
    assert ours[2] == table(root / "source.sqlite")[:17]
    with pytest.raises(OS.CorruptObjectError):
        asyncio.run(OS.ObjectSyncClient(
            OS.FilesystemBackend(str(corrupt)), None, None)._fetch_segment(
                F.ManifestEntry(**{k: getattr(m.segments[1], k)
                                   for k in ("start", "count", "hash",
                                             "name")})))

    ours = sync(root / "objects", tmp_path / "d.sqlite", pk, seed, up_to=40)
    ref = sync(root / "objects", tmp_path / "e.sqlite", pk, seed, up_to=40,
               pkg="ref")
    assert ours[0] == ref[0] == {"ok": True, "synced_to": 40,
                                 "segments": 3, "rounds": 40, "error": ""}
    assert ours[2] == ref[2] == table(root / "source.sqlite")[:41]


def test_client_segment_on_the_cpu_verifier(tmp_path):
    """Unchained rounds 1-120 in segments of 40 against a store holding
    rounds 1-36: the first segment's last 4 rounds and, with `up_to` 100,
    the third's first 20 verify on the host tier; the second (40 rounds)
    is one Verifier batch on the CPU.  The synced rows equal the
    source's."""
    sigs = np.load(UNCHAINED_512)
    pk = GC.g1_to_bytes(TFX.fixture_keypair()[1])
    seed = b"\x05" * 32
    rows = [(r, bytes(sigs[r - 1]), b"") for r in range(1, 121)]
    store = source_store(tmp_path / "source.sqlite", rows, seed)
    publish(store, tmp_path / "objects", 40, scheme=UNCHAINED)
    store.close()
    D.DISPATCH.clear()
    ours = sync(tmp_path / "objects", tmp_path / "a.sqlite", pk, seed,
                scheme=UNCHAINED, up_to=100, anchor_rows=rows[:36])
    assert ours[0] == {"ok": True, "synced_to": 100, "segments": 3,
                       "rounds": 64, "error": ""}
    assert [(r.n, r.bucket) for r in D.DISPATCH.records("verify")] == \
        [(40, 64)]
    assert len(D.DISPATCH.records("native")) == 24
    assert ours[2] == table(tmp_path / "source.sqlite")[:101]


# -- the CLIs ----------------------------------------------------------------

def cli(pkg, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-m", pkg, "objectsync", *args],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600, env=env)
    try:
        body = json.loads(out.stdout)
    except ValueError:
        body = None
    return out.returncode, body, out.stderr


def test_cli_sync_exits_as_the_reference(chained_dir, tmp_path):
    """`objectsync sync` of both CLIs on the clean directory, then on a
    poisoned one: the same exit codes, results and tables; `publish` and
    `status` of both on one database: the same directory and summary."""
    root, _, pk, seed = chained_dir
    _poison(root / "objects", tmp_path / "poisoned", 3, 55)
    common = ["--chain-hash", CHAIN_HASH.hex(), "--public-key", pk.hex(),
              "--genesis-seed", seed.hex(), "--scheme", CHAINED]
    for src, want_rc, tip in ((root / "objects", 0, 64),
                              (tmp_path / "poisoned", 1, 48)):
        got = {}
        for pkg, extra in (("drand_tpu_torch.cli", ["--device", "cpu"]),
                           ("drand_tpu.cli", [])):
            db = tmp_path / f"{pkg}-{src.name}.sqlite"
            rc, body, err = cli(pkg, "sync", "--dir", str(src), "--db",
                                str(db), *common, *extra)
            assert rc == want_rc, err[-2000:]
            body.pop("stats")
            got[pkg] = (body, table(db))
        assert got["drand_tpu_torch.cli"] == got["drand_tpu.cli"]
        assert got["drand_tpu.cli"][0]["synced_to"] == tip
    for pkg in ("drand_tpu_torch.cli", "drand_tpu.cli"):
        rc, body, err = cli(pkg, "publish", "--dir", str(tmp_path / pkg),
                            "--db", str(root / "source.sqlite"),
                            "--chain-hash", CHAIN_HASH.hex(),
                            "--segment-rounds", "16")
        assert rc == 0 and body["published_now"] == 4, err[-2000:]
        rc, body, err = cli(pkg, "status", "--dir", str(tmp_path / pkg))
        assert rc == 0 and body.pop("backend").endswith(pkg)
        got[pkg] = body
    assert got["drand_tpu_torch.cli"] == got["drand_tpu.cli"] == {
        "chain_hash": CHAIN_HASH.hex(), "scheme": CHAINED,
        "segment_rounds": 16, "segments": 4, "tip": 64}
    assert files(tmp_path / "drand_tpu_torch.cli") == \
        files(tmp_path / "drand_tpu.cli") == files(root / "objects")
