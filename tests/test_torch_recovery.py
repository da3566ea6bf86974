"""The port's row codec, packed segments, chain store, integrity scan,
repair and `util fsck` on the CPU, held against drand_tpu's on the same
rows and databases.  The tolerance is exact equality: bytes, tables,
reports and verdicts."""

import asyncio
import json
import shutil
import sqlite3
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from drand_tpu.chain import codec as JC
from drand_tpu.chain import recovery as JR
from drand_tpu.chain import segment as JSEG
from drand_tpu.chain import store as JST
from drand_tpu.chain.beacon import Beacon as JBeacon
from drand_tpu.chain.scheme import scheme_by_id as jscheme
from drand_tpu.chain.verify import ChainVerifier as JChainVerifier
from drand_tpu_torch import cli
from drand_tpu_torch import fixtures as TFX
from drand_tpu_torch.chain import codec as C
from drand_tpu_torch.chain import recovery as R
from drand_tpu_torch.chain import segment as SEG
from drand_tpu_torch.chain import store as ST
from drand_tpu_torch.chain.beacon import Beacon, genesis_beacon
from drand_tpu_torch.chain.scheme import scheme_by_id
from drand_tpu_torch.chain.verify import ChainVerifier

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_rows(seed: int, n: int = 64):
    """Seeded (round, sig, prev) rows of mixed shapes: 96- and 48-byte
    signatures, 32-byte genesis seeds, empty and full prevs, a round near
    2^64."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        sig_len = int(rng.choice([0, 32, 48, 96, 300]))
        prev_len = int(rng.choice([0, 32, 48, 96]))
        r = int(rng.integers(0, 2**63)) if i % 7 else 2**64 - 1 - i
        rows.append((r, rng.bytes(sig_len), rng.bytes(prev_len)))
    return rows


def table(path, name):
    con = sqlite3.connect(path)
    try:
        return con.execute(f"SELECT * FROM {name} ORDER BY round").fetchall()
    finally:
        con.close()


# -- codec -------------------------------------------------------------------

@pytest.mark.parametrize("seed", [1, 2, 3])
def test_codec_bytes_match_reference(seed):
    for r, sig, prev in random_rows(seed):
        blob = C.encode_fields(r, sig, prev)
        assert blob == JC.encode_fields(r, sig, prev)
        assert C.decode_fields(blob) == JC.decode_fields(blob) == \
            (r, sig, prev)
        ours, ref = Beacon(r, sig, prev), JBeacon(r, sig, prev)
        assert C.encode_beacon(ours) == JC.encode_beacon(ref)
        assert C.make_encoder("json")(ours) == JC.make_encoder("json")(ref)
        assert ours.to_json() == ref.to_json()
        assert C.decode_fields(ours.to_json()) == (r, sig, prev)
        assert C.decode_beacon(blob).equal(ours)
        assert ours.randomness() == ref.randomness()


def test_codec_errors_match_reference():
    good = C.encode_fields(5, b"\x01" * 96, b"")
    bad = [b"", good[:10], good[:-1], good + b"\x00", b"\x02" + good[1:],
           b"{not json", b'{"round": 1}', bytes([0x01]) + bytes(12)[:5]]
    for blob in bad:
        with pytest.raises(C.CodecError):
            C.decode_fields(blob)
        with pytest.raises(JC.CodecError):
            JC.decode_fields(blob)
    with pytest.raises(C.CodecError):
        C.encode_fields(1, bytes(0x10000), b"")
    with pytest.raises(ValueError):
        C.make_encoder("yaml")
    assert genesis_beacon(b"s" * 32).to_json() == \
        JBeacon(0, b"s" * 32).to_json()


# -- packed segments ---------------------------------------------------------

def mixed_rows():
    """Genesis, a chained run, a break in the linkage, a gap, an unchained
    run, a row of another signature length, single rows."""
    rng = np.random.default_rng(9)
    sig = [rng.bytes(96) for _ in range(40)]
    rows = [(0, rng.bytes(32), b"")]
    rows += [(1, sig[1], rows[0][1])]
    rows += [(r, sig[r], sig[r - 1]) for r in range(2, 12)]
    rows += [(12, sig[12], rng.bytes(96))]                 # broken link
    rows += [(r, sig[r], sig[r - 1]) for r in range(13, 16)]
    rows += [(r, sig[r], b"") for r in range(18, 25)]      # gap, unchained
    rows += [(25, rng.bytes(48), b""), (26, sig[26], b"")]
    rows += [(27, sig[27], sig[26]), (29, sig[29], sig[28])]
    return rows


def items(gen):
    out = []
    for it in gen:
        if hasattr(it, "sigs"):
            out.append(("packed", it.start_round, it.sigs.tobytes(),
                        it.sigs.shape, it.first_prev, it.chained,
                        it.end_round, it.tail_sig, it.rounds().tolist(),
                        [(b.round, b.signature, b.previous_sig)
                         for b in it.beacons()]))
        else:
            out.append(("beacon", it.round, it.signature, it.previous_sig))
    return out


@pytest.mark.parametrize("max_chunk", [2, 4, 512])
def test_pack_rows_matches_reference(max_chunk):
    rows = mixed_rows()
    ours = items(SEG.pack_rows(rows, max_chunk=max_chunk))
    assert ours == items(JSEG.pack_rows(rows, max_chunk=max_chunk))
    assert sum(1 if k[0] == "beacon" else k[3][0] for k in ours) == len(rows)
    if max_chunk == 512:
        assert [k[0] for k in ours] == ["beacon", "packed", "packed",
                                        "packed", "beacon", "beacon",
                                        "beacon", "beacon"]


def test_packed_beacons_truncate_and_anchor():
    sigs = np.random.default_rng(4).integers(0, 256, (6, 96), np.uint8)
    ours = SEG.PackedBeacons(10, sigs, first_prev=b"p" * 96)
    ref = JSEG.PackedBeacons(10, sigs, first_prev=b"p" * 96)
    for a, b in ((ours.truncate(12), ref.truncate(12)), (ours, ref)):
        assert len(a) == len(b) and a.end_round == b.end_round
        assert [(x.round, x.signature, x.previous_sig)
                for x in a.beacons(anchor_sig=b"a" * 96)] == \
            [(x.round, x.signature, x.previous_sig)
             for x in b.beacons(anchor_sig=b"a" * 96)]


# -- store -------------------------------------------------------------------

@pytest.mark.parametrize("codec", ["binary", "json"])
@pytest.mark.parametrize("writer", ["drand_tpu", "port"])
def test_store_reads_what_either_package_wrote(tmp_path, codec, writer):
    """A database written by one package's SqliteStore, in either codec,
    reads the same through both."""
    path = str(tmp_path / "chain.db")
    rows = mixed_rows()
    if writer == "port":
        w = ST.SqliteStore(path, codec=codec)
        w.put(Beacon(*rows[0]))
        w.put_many([Beacon(*r) for r in rows[1:]])
    else:
        w = JST.SqliteStore(path, codec=codec)
        w.put(JBeacon(*rows[0]))
        w.put_many([JBeacon(*r) for r in rows[1:]])
    w.close()
    ours, ref = ST.SqliteStore(path), JST.SqliteStore(path)
    try:
        assert len(ours) == len(ref) == len(rows)
        assert ours.raw_rows(0, 1000) == ref.raw_rows(0, 1000)
        assert ours.read_fields(0, 1000) == ref.read_fields(0, 1000) == rows
        assert ours.read_fields(13, 5) == ref.read_fields(13, 5)
        want = [(b.round, b.signature, b.previous_sig)
                for b in ref.iter_range(5, limit=9)]
        assert [(b.round, b.signature, b.previous_sig)
                for b in ours.iter_range(5, limit=9)] == want
        assert ours.get(12).equal(Beacon(*rows[12]))
        assert ours.last().round == ref.last().round == 29
        cur = ours.cursor()
        assert cur.first().round == 0 and cur.last().round == 29
        assert cur.seek(16) is None and cur.seek(18).round == 18
        assert [b.round for b in cur.iter_from(26)] == [26, 27, 29]
        with pytest.raises(ST.BeaconNotFound):
            ours.get(17)
    finally:
        ours.close()
        ref.close()


def test_corrupt_rows_raise_with_their_round(tmp_path):
    path = str(tmp_path / "chain.db")
    s = ST.SqliteStore(path)
    s.put_many([Beacon(r, bytes([r]) * 96) for r in range(5)])
    con = sqlite3.connect(path)
    with con:
        con.execute("UPDATE beacons SET data = ? WHERE round = 2",
                    (C.encode_fields(2, b"x" * 96, b"")[:20],))
        con.execute("UPDATE beacons SET data = ? WHERE round = 3",
                    (C.encode_fields(7, b"x" * 96, b""),))
    con.close()
    for r in (2, 3):
        with pytest.raises(ST.CorruptRowError) as e:
            s.get(r)
        assert e.value.round == r
        with pytest.raises(JST.CorruptRowError):
            JST.SqliteStore(path).get(r)
    with pytest.raises(ST.CorruptRowError) as e:
        s.read_fields(0, 10)
    assert e.value.round == 2
    s.close()


def test_quarantine_and_truncate_leave_identical_tables(tmp_path):
    rows = mixed_rows()
    paths = {}
    for name, mod, B in (("port", ST, Beacon), ("ref", JST, JBeacon)):
        path = str(tmp_path / f"{name}.db")
        s = mod.SqliteStore(path, codec="binary")
        s.put_many([B(*r) for r in rows])
        assert s.quarantine_rounds([12, 5, 5, 17], "corrupt-row") == 2
        assert s.truncate_after(20, "rollback-past-verified-prefix") == 8
        assert s.quarantine_rounds([], "none") == 0
        paths[name] = (path, s.quarantined(), s.quarantined_rows())
        s.save_to(str(tmp_path / f"{name}-copy.db"))
        s.close()
    assert paths["port"][1:] == paths["ref"][1:]
    for t in ("beacons", "quarantine"):
        assert table(paths["port"][0], t) == table(paths["ref"][0], t)
        assert table(str(tmp_path / "port-copy.db"), t) == \
            table(paths["port"][0], t)


# -- integrity scan ----------------------------------------------------------

def damaged_rows():
    """Genesis and rounds 1-9 of the committed chained segment, damaged:
    round 2's stored prev replaced (a broken link), a byte of round 4's
    signature flipped (so round 5's stored prev no longer matches it),
    round 6's blob torn, round 8 missing."""
    sigs, _, seed = TFX.load_chained_fixture()
    rows = [(0, seed, b"")]
    for r in range(1, 10):
        rows.append((r, bytes(sigs[r - 1]),
                     seed if r == 1 else bytes(sigs[r - 2])))
    rows[2] = (2, rows[2][1], bytes(range(96)))
    flipped = bytearray(rows[4][1])
    flipped[40] ^= 0x01
    rows[4] = (4, bytes(flipped), rows[4][2])
    del rows[8]
    return rows


def write_store(path, rows, torn=(6,)):
    s = JST.SqliteStore(path, codec="binary")
    s.put_many([JBeacon(*r) for r in rows])
    s.close()
    con = sqlite3.connect(path)
    with con:
        for r in torn:
            blob = con.execute("SELECT data FROM beacons WHERE round = ?",
                               (r,)).fetchone()[0]
            con.execute("UPDATE beacons SET data = ? WHERE round = ?",
                        (bytes(blob)[:40], r))
    con.close()


def no_elapsed(d):
    return {k: v for k, v in d.items() if k != "elapsed_s"}


@pytest.fixture(scope="module")
def damaged_store(tmp_path_factory):
    d = tmp_path_factory.mktemp("damaged")
    path = str(d / "chain.db")
    write_store(path, damaged_rows())
    return path


def test_scan_store_bls_matches_reference(damaged_store, tmp_path):
    """The full scan, BLS stage included, with segments of 8 rounds: the
    port's report equals drand_tpu's apart from elapsed_s; then
    repair_store on two copies gives the same summary and tables, and a
    structural rescan of the repaired copy is clean."""
    _, pk_bytes, _ = TFX.load_chained_fixture()
    paths = {k: str(tmp_path / f"{k}.db") for k in ("port", "ref")}
    for p in paths.values():
        shutil.copy(damaged_store, p)
    cv = ChainVerifier(scheme_by_id("pedersen-bls-chained"), pk_bytes,
                       beacon_id="b", device="cpu")
    jcv = JChainVerifier(jscheme("pedersen-bls-chained"), pk_bytes)
    ours_store, ref_store = ST.SqliteStore(paths["port"]), \
        JST.SqliteStore(paths["ref"])
    ours = asyncio.run(R.scan_store(ours_store, cv, beacon_id="b",
                                    segment_rounds=8))
    ref = asyncio.run(JR.scan_store(ref_store, jcv, beacon_id="b",
                                    segment_rounds=8))
    want = no_elapsed(ref.to_dict())
    want["path"] = paths["port"]
    assert no_elapsed(ours.to_dict()) == want
    assert (ours.corrupt, ours.missing, ours.unlinked, ours.bad_sigs,
            ours.verified_tip, ours.scanned, ours.verify_checked) == \
        ([6], [(8, 8)], [2, 5], [4], 1, 9, True)
    assert ours.damaged_rounds == ref.damaged_rounds == [2, 4, 5, 6]
    assert R.repair_store(ours_store, ours) == \
        JR.repair_store(ref_store, ref) == \
        {"quarantined": 4, "truncated": 3, "verified_tip": 1}
    ours_store.close()
    ref_store.close()
    for t in ("beacons", "quarantine"):
        assert table(paths["port"], t) == table(paths["ref"], t)
    again = asyncio.run(R.scan_store(ST.SqliteStore(paths["port"]), None))
    assert again.ok and again.tip_round == again.verified_tip == 1


@pytest.mark.parametrize("segment_rounds", [2, 3, 16384])
def test_structural_scan_matches_reference(damaged_store, segment_rounds):
    ours = asyncio.run(R.scan_store(ST.SqliteStore(damaged_store), None,
                                    segment_rounds=segment_rounds,
                                    read_batch=3))
    ref = asyncio.run(JR.scan_store(JST.SqliteStore(damaged_store), None,
                                    segment_rounds=segment_rounds,
                                    read_batch=3))
    assert no_elapsed(ours.to_dict()) == no_elapsed(ref.to_dict())
    assert not ours.verify_checked and ours.verified_tip == 1


def test_startup_recovery_structural_matches_reference(damaged_store,
                                                        tmp_path):
    """startup_recovery with no verifier: the same report and repair
    summary as drand_tpu's, and a clean store returns no summary."""
    out = {}
    for name, mod, smod in (("port", R, ST), ("ref", JR, JST)):
        path = str(tmp_path / f"{name}.db")
        shutil.copy(damaged_store, path)
        store = smod.SqliteStore(path)
        report, summary = asyncio.run(mod.startup_recovery(store, None))
        clean, none = asyncio.run(mod.startup_recovery(store, None))
        store.close()
        d = no_elapsed(report.to_dict())
        d.pop("path")
        out[name] = (d, summary, clean.ok, none)
    assert out["port"] == out["ref"]
    assert out["port"][1] == {"quarantined": 3, "truncated": 4,
                              "verified_tip": 1}
    assert out["port"][2:] == (True, None)


def test_empty_store_scans_clean(tmp_path):
    ours = asyncio.run(R.scan_store(ST.SqliteStore(str(tmp_path / "e.db"))))
    ref = asyncio.run(JR.scan_store(JST.SqliteStore(str(tmp_path / "f.db"))))
    assert ours.ok and ours.scanned == 0 and ours.verified_tip == -1
    d, e = no_elapsed(ours.to_dict()), no_elapsed(ref.to_dict())
    d.pop("path"), e.pop("path")
    assert d == e


# -- util fsck ---------------------------------------------------------------

def test_fsck_json_matches_reference_scan(damaged_store, tmp_path, capsys):
    """`util fsck --json` prints drand_tpu's structural report (its `--id`
    default, "default", as the beacon id) with "repair": null, exit 1; with
    --repair, drand_tpu's repair summary; then the repaired store exits 0."""
    path = str(tmp_path / "fsck.db")
    shutil.copy(damaged_store, path)
    ref = asyncio.run(JR.scan_store(JST.SqliteStore(path), None,
                                    beacon_id="default"))
    want = no_elapsed(ref.to_dict())
    assert cli.main(["util", "fsck", path, "--json"]) == 1
    got = json.loads(capsys.readouterr().out)
    assert got.pop("repair") is None
    assert no_elapsed(got) == want
    ref_copy = str(tmp_path / "ref.db")
    shutil.copy(damaged_store, ref_copy)
    ref_summary = JR.repair_store(JST.SqliteStore(ref_copy), ref)
    assert cli.main(["util", "fsck", path, "--json", "--repair"]) == 1
    got = json.loads(capsys.readouterr().out)
    assert got["repair"] == ref_summary
    assert table(path, "quarantine") == table(ref_copy, "quarantine")
    assert cli.main(["util", "fsck", path]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("scanned 2 rows (rounds 0..1) in ")
    assert out[1:] == ["chain OK"]


def test_fsck_text_report(damaged_store, tmp_path, capsys):
    path = str(tmp_path / "fsck.db")
    shutil.copy(damaged_store, path)
    assert cli.main(["util", "fsck", path]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[1:] == ["  corrupt: [6]", "  missing: [[8, 8]]",
                       "  unlinked: [2, 5]",
                       "DAMAGE FOUND (verified prefix ends at 1); run "
                       "with --repair to quarantine and roll back"]
    assert cli.main(["util", "fsck", path, "--repair"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == ("repaired: quarantined 3 damaged + 4 rolled-back "
                       "rows; tip now 1 (re-sync the suffix from peers)")
    with pytest.raises(SystemExit, match="no such db"):
        cli.main(["util", "fsck", str(tmp_path / "absent.db")])
    with pytest.raises(SystemExit, match="needs a chain db path"):
        cli.main(["util", "fsck"])


def test_fsck_runs_as_a_module(damaged_store, tmp_path):
    """The entry point a user runs, in a process of its own: exit 1 and
    the structural report on the damaged store; importing the CLI module
    runs nothing."""
    path = str(tmp_path / "fsck.db")
    shutil.copy(damaged_store, path)
    out = subprocess.run(
        [sys.executable, "-m", "drand_tpu_torch.cli", "util", "fsck", path,
         "--json"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 1, out.stderr
    got = json.loads(out.stdout)
    assert (got["corrupt"], got["missing"], got["unlinked"],
            got["bad_sigs"], got["verified_tip"], got["ok"]) == \
        ([6], [[8, 8]], [2, 5], [], 1, False)
    quiet = subprocess.run(
        [sys.executable, "-c", "import drand_tpu_torch.cli"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert quiet.returncode == 0 and quiet.stdout == quiet.stderr == ""
