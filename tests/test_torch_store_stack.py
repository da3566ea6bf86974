"""The port's full chain-store stack, chain info, round-time arithmetic,
wire converters and request metadata on the CPU, held against drand_tpu's
on the same inputs: `new_chain_store`'s decorator order and `.insecure`,
the tables both stacks write, the append and linkage refusals,
`CallbackStore`'s callback order, `DiscrepancyStore`'s latencies under a
fixed clock, `Info.hash()`, `chain.time`, the
ChainInfoPacket/BeaconPacket/SyncChunk converters both ways, the metadata
bytes, and the objectsync publisher's live drive on a growing
CallbackStore.  The tolerance is exact equality of bytes, rows, lists and
floats.
"""

import asyncio
import sqlite3
from pathlib import Path

import numpy as np
import pytest

from drand_tpu.chain import info as JI
from drand_tpu.chain import segment as JSEG
from drand_tpu.chain import store as JST
from drand_tpu.chain import time as JT
from drand_tpu.chain.beacon import Beacon as JBeacon
from drand_tpu.core import convert as JC
from drand_tpu.net import client as JNC
from drand_tpu.objectsync import backends as JB
from drand_tpu.objectsync import publisher as JPUB
from drand_tpu_torch import objectsync as OS
from drand_tpu_torch.chain import info as I
from drand_tpu_torch.chain import segment as SEG
from drand_tpu_torch.chain import store as ST
from drand_tpu_torch.chain import time as T
from drand_tpu_torch.chain.beacon import Beacon
from drand_tpu_torch.core import convert as C
from drand_tpu_torch.net import client as NC

CHAINED, UNCHAINED = "pedersen-bls-chained", "pedersen-bls-unchained"
SEED = b"\x07" * 32


class Group:
    period = 30
    genesis_time = 1_600_000_000

    def __init__(self, scheme_id):
        self.scheme_id = scheme_id


def seeded_beacons(seed: int, count: int, chained: bool = True,
                   beacon=Beacon):
    """Rounds 1..count of seeded 96-byte signatures, linked to SEED."""
    rng = np.random.default_rng(seed)
    prev, out = SEED, []
    for r in range(1, count + 1):
        sig = rng.bytes(96)
        out.append(beacon(r, sig, prev if chained else b""))
        prev = sig
    return out


def as_ref(beacons):
    return [JBeacon(b.round, b.signature, b.previous_sig) for b in beacons]


def table(path):
    con = sqlite3.connect(str(path))
    try:
        return con.execute("SELECT round, data FROM beacons "
                           "ORDER BY round").fetchall()
    finally:
        con.close()


def chain_of(store):
    out, s = [], store
    while True:
        out.append(type(s).__name__)
        if not hasattr(s, "inner"):
            return out
        s = s.inner


@pytest.mark.parametrize("scheme", [CHAINED, UNCHAINED])
def test_new_chain_store_stack_matches_reference(tmp_path, scheme):
    """Decorator order, `.insecure`, the rows written through the stack,
    and the same refusals: a gap, and (chained) a broken link."""
    ours = ST.new_chain_store(str(tmp_path / "ours.db"), Group(scheme),
                              workers=1)
    ref = JST.new_chain_store(str(tmp_path / "ref.db"), Group(scheme),
                              workers=1)
    try:
        assert chain_of(ours) == chain_of(ref) == [
            "CallbackStore", "DiscrepancyStore", "SchemeStore",
            "AppendStore", "SqliteStore"]
        assert type(ours.insecure) is ST.SqliteStore
        assert type(ref.insecure) is JST.SqliteStore
        beacons = seeded_beacons(1, 40, chained=True)
        for store, mk in ((ours, Beacon), (ref, JBeacon)):
            store.put(mk(0, SEED))
            store.put(mk(1, beacons[0].signature, beacons[0].previous_sig))
            store.put_many([mk(b.round, b.signature, b.previous_sig)
                            for b in beacons[1:30]])
        assert table(tmp_path / "ours.db") == table(tmp_path / "ref.db")
        gap = beacons[31]
        errors = []
        for store, mk, err in ((ours, Beacon, ST.StoreError),
                               (ref, JBeacon, JST.StoreError)):
            with pytest.raises(err) as e:
                store.put(mk(gap.round, gap.signature, gap.previous_sig))
            errors.append(str(e.value))
        assert errors[0] == errors[1]
        bad = beacons[30]
        link = []
        for store, mk in ((ours, Beacon), (ref, JBeacon)):
            try:
                store.put_many([mk(bad.round, bad.signature, b"\x00" * 96)])
                link.append("stored")
            except (ST.StoreError, JST.StoreError) as exc:
                link.append(str(exc))
        assert link[0] == link[1]
        assert (link[0] == "stored") == (scheme == UNCHAINED)
        # the insecure base overwrites where the stack refuses
        for store, mk in ((ours, Beacon), (ref, JBeacon)):
            store.insecure.put(mk(5, b"\x01" * 96, b"\x02" * 96))
        assert table(tmp_path / "ours.db") == table(tmp_path / "ref.db")
    finally:
        ours.close()
        ref.close()


def test_callback_order_matches_reference(tmp_path, monkeypatch):
    """Each kind of callback sees what drand_tpu's sees, in the same
    order: per-beacon callbacks every round (a segment in FANOUT_CHUNK
    slices), tail callbacks each commit's last beacon; a raising callback
    is ignored."""
    monkeypatch.setattr(ST.CallbackStore, "FANOUT_CHUNK", 8)
    monkeypatch.setattr(JST.CallbackStore, "FANOUT_CHUNK", 8)
    seen = {}
    for name, mod, mk in (("ours", ST, Beacon), ("ref", JST, JBeacon)):
        store = mod.CallbackStore(mod.SqliteStore(str(tmp_path / name)),
                                  workers=1)
        got = {"each": [], "tail": []}
        store.add_callback("each", lambda b, g=got: g["each"].append(b.round))
        store.add_tail_callback("tail",
                                lambda b, g=got: g["tail"].append(b.round))
        store.add_callback("boom", lambda b: 1 / 0)
        beacons = seeded_beacons(2, 30, beacon=mk)
        store.put(mk(0, SEED))
        store.put_many(beacons[:20])
        store.remove_callback("boom")
        store.put(beacons[20])
        store.put_many(beacons[21:])
        store.put_many([])
        store._pool.shutdown(wait=True)
        store.inner.close()
        seen[name] = got
    assert seen["ours"] == seen["ref"]
    assert seen["ours"]["each"] == list(range(31))
    assert seen["ours"]["tail"] == [0, 20, 21, 30]


def test_discrepancy_latency_matches_reference(tmp_path):
    """Latency (ms) of each put and of each segment's head, and the
    segment sizes, under one fixed clock."""
    seen = {}
    for name, mod, mk in (("ours", ST, Beacon), ("ref", JST, JBeacon)):
        lat, segs = [], []
        store = mod.DiscrepancyStore(
            mod.SqliteStore(str(tmp_path / name)), Group(CHAINED),
            clock=lambda: 1_600_000_123.25,
            on_latency=lambda r, ms, lat=lat: lat.append((r, ms)),
            on_segment=segs.append)
        beacons = seeded_beacons(3, 12, beacon=mk)
        store.put(mk(0, SEED))
        store.put(beacons[0])
        store.put_many(beacons[1:])
        store.put_many([])
        store.close()
        seen[name] = (lat, segs)
    assert seen["ours"] == seen["ref"]
    assert seen["ours"][1] == [11]


@pytest.mark.parametrize("beacon_id", ["", "default", "quicknet-t"])
@pytest.mark.parametrize("scheme", [CHAINED, UNCHAINED,
                                    "bls-unchained-g1-rfc9380"])
def test_info_hash_matches_reference(beacon_id, scheme):
    """The chain hash a follower pins: equal to drand_tpu's for every
    scheme (not hashed) and beacon id (hashed unless the default)."""
    rng = np.random.default_rng(4)
    kw = dict(public_key=rng.bytes(48), period=3, genesis_time=1692803367,
              genesis_seed=rng.bytes(32), scheme_id=scheme,
              beacon_id=beacon_id)
    ours, ref = I.Info(**kw), JI.Info(**kw)
    assert ours.hash() == ref.hash()
    assert ours.hash_hex() == ref.hash_hex()


def test_round_time_matches_reference():
    for period, genesis in ((30, 1_595_431_050), (3, 1_692_803_367),
                            (0.5, 100.0)):
        for now in [genesis - 10, genesis - 0.001, genesis, genesis + 0.5,
                    genesis + period, genesis + 10 * period - 1e-6,
                    genesis + 65536 * period + 7]:
            assert T.current_round(now, period, genesis) == \
                JT.current_round(now, period, genesis)
            assert T.next_round_at(now, period, genesis) == \
                JT.next_round_at(now, period, genesis)
        for r in (-1, 0, 1, 2, 65536, T.MAX_ROUND, T.MAX_ROUND + 1):
            assert T.time_of_round(period, genesis, r) == \
                JT.time_of_round(period, genesis, r)


def test_convert_round_trips_match_reference():
    """ChainInfoPacket, BeaconPacket and SyncChunk bytes equal drand_tpu's,
    and each side decodes the other's packets to the same values."""
    rng = np.random.default_rng(5)
    kw = dict(public_key=rng.bytes(48), period=30, genesis_time=1595431050,
              genesis_seed=rng.bytes(32), scheme_id=UNCHAINED,
              beacon_id="other")
    ours, ref = C.info_to_proto(I.Info(**kw)), JC.info_to_proto(JI.Info(**kw))
    assert ours.SerializeToString() == ref.SerializeToString()
    assert C.info_from_proto(ref) == I.Info(**kw)
    empty = type(ours)()
    assert C.info_from_proto(empty).scheme_id == \
        JC.info_from_proto(empty).scheme_id
    assert C.info_from_proto(empty).beacon_id == \
        JC.info_from_proto(empty).beacon_id
    beacons = seeded_beacons(6, 20)
    for b in beacons[:3]:
        pkt = C.beacon_to_packet(b)
        jpkt = JC.beacon_to_packet(as_ref([b])[0])
        assert pkt.SerializeToString() == jpkt.SerializeToString()
        assert C.packet_to_item(jpkt) == b
        assert C.item_to_packet(b).SerializeToString() == \
            JC.item_to_packet(as_ref([b])[0]).SerializeToString()
    rows = [(b.round, b.signature, b.previous_sig) for b in beacons]
    for chunk in (4, 512):
        items = list(SEG.pack_rows(rows, max_chunk=chunk))
        jitems = list(JSEG.pack_rows(rows, max_chunk=chunk))
        assert len(items) == len(jitems) == -(-20 // chunk)
        for it, jit in zip(items, jitems):
            pkt, jpkt = C.item_to_packet(it), JC.item_to_packet(jit)
            assert pkt.SerializeToString() == jpkt.SerializeToString()
            back, jback = C.packet_to_item(jpkt), JC.packet_to_item(pkt)
            assert isinstance(back, SEG.PackedBeacons)
            assert (back.start_round, back.sigs.tobytes(), back.first_prev,
                    back.chained) == (jback.start_round, jback.sigs.tobytes(),
                                      jback.first_prev, jback.chained)
            assert back.beacons() == it.beacons()
    bad = C.item_to_packet(items[0])
    bad.chunk.count += 1
    for conv in (C, JC):
        with pytest.raises(ValueError, match="malformed sync chunk"):
            conv.packet_to_item(bad)


@pytest.mark.parametrize("beacon_id", ["default", "quicknet"])
def test_metadata_bytes_match_reference(beacon_id):
    ours = NC.make_metadata(beacon_id)
    ref = JNC.make_metadata(beacon_id)
    assert ours.SerializeToString() == ref.SerializeToString()


def files(root) -> dict:
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def published_tip(root) -> int:
    try:
        m = OS.Manifest.from_json((Path(root) / OS.MANIFEST_NAME).read_bytes())
    except (FileNotFoundError, ValueError):
        return 0
    return m.tip if m.segments else 0


def test_publisher_live_drive_matches_reference(tmp_path):
    """A store growing through the full stack with the publisher's live
    drive started: each commit wakes the publish loop, which publishes
    every sealed segment; the directory (objects and manifest) equals
    what drand_tpu's publisher's live drive writes for the same commits,
    after each step."""
    chain_hash = bytes(range(32))
    beacons = seeded_beacons(7, 50)
    sides = {}

    async def run(name, mod, pub_mod, backend, mk):
        store = mod.new_chain_store(str(tmp_path / f"{name}.db"),
                                    Group(CHAINED), workers=1)
        store.put(mk(0, SEED))
        pub = pub_mod.ObjectPublisher(store, backend(str(tmp_path / name)),
                                      chain_hash, CHAINED, segment_rounds=16)
        await pub.start()
        steps = []
        for lo, hi in ((0, 10), (10, 20), (20, 49), (49, 50)):
            store.put_many([mk(b.round, b.signature, b.previous_sig)
                            for b in beacons[lo:hi]])
            want = (hi // 16) * 16
            for _ in range(1000):       # until the manifest on disk shows it
                await asyncio.sleep(0.01)
                if published_tip(tmp_path / name) == want:
                    break
            snap = pub.snapshot()
            steps.append((snap["published_tip"], snap["published_segments"],
                          snap["store_tip"], snap["attached"],
                          files(tmp_path / name)))
        await pub.stop()
        assert pub.snapshot()["attached"] is False
        store.close()
        return steps

    async def main():
        sides["ours"] = await run("ours", ST, OS, OS.FilesystemBackend,
                                  Beacon)
        sides["ref"] = await run("ref", JST, JPUB, JB.FilesystemBackend,
                                 JBeacon)
    asyncio.run(asyncio.wait_for(main(), 60))
    assert sides["ours"] == sides["ref"]
    assert [s[:4] for s in sides["ours"]] == [
        (0, 0, 10, True), (16, 1, 20, True), (48, 3, 49, True),
        (48, 3, 50, True)]
