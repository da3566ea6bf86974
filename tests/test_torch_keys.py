"""The port's key material and signing against drand_tpu's on the same
inputs, with no tolerance: key, group, share and distributed-key files
cross both ways through the two `FileStore`s with byte-equal TOML; the
group hash, the genesis seed and the chain-info hash are equal; identity
self-signatures verify across the packages; `keygen`, `bls_sign`,
`bls_verify` and the threshold `sign_partial`, `verify_partial`,
`recover` and `verify_recovered` give drand_tpu's bytes and verdicts.
"""

import hashlib
import os

import pytest

from drand_tpu import toml_util as JTOML
from drand_tpu.crypto import poly as JP
from drand_tpu.crypto import sign as JS
from drand_tpu.crypto import tbls as JT
from drand_tpu.crypto.bls12381 import curve as JGC
from drand_tpu.key import group as JG
from drand_tpu.key import keys as JK
from drand_tpu.key import store as JST
from drand_tpu_torch import toml_util as TOML
from drand_tpu_torch.crypto import poly as P
from drand_tpu_torch.crypto import sign as S
from drand_tpu_torch.crypto import tbls
from drand_tpu_torch.crypto.bls12381 import curve as GC
from drand_tpu_torch.key import group as G
from drand_tpu_torch.key import keys as K
from drand_tpu_torch.key import store as ST

T, N = 3, 5
SECRET = 98765
MSG = hashlib.sha256(b"round 7").digest()


def _rand(seed: bytes):
    def rand(n: int) -> bytes:
        return b"".join(hashlib.sha512(seed + i.to_bytes(8, "big")).digest()
                        for i in range(-(-n // 64)))[:n]
    return rand


@pytest.fixture(scope="module")
def poly():
    return P.PriPoly.random(T, secret=SECRET, rand=_rand(b"keys"))


@pytest.fixture(scope="module")
def jpoly(poly):
    return JP.PriPoly(poly.coeffs)


@pytest.fixture(scope="module")
def partials(poly):
    return [tbls.sign_partial(s, MSG) for s in poly.shares(N)]


def _group(pairs, scheme="pedersen-bls-chained", beacon_id="default",
           commits=None, mod=G, dist=K.DistPublic):
    nodes = mod.Group.sort_nodes([p.public for p in pairs])
    g = mod.Group(threshold=T, period=3, nodes=nodes,
                  genesis_time=1_700_000_003, catchup_period=1,
                  scheme_id=scheme, beacon_id=beacon_id,
                  public_key=dist(list(commits)) if commits else None)
    return g


def _files(folder):
    out = {}
    for root, _, names in os.walk(folder):
        for name in names:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, folder)] = f.read()
    return out


def test_toml_dumps_and_loads_match_reference():
    doc = {"A": 1, "B": "x\"y\\z", "C": True, "L": ["a", "b"],
           "T": {"K": 2, "S": "v"}, "Arr": [{"x": 1}, {"x": 2, "y": "z"}]}
    assert TOML.dumps(doc) == JTOML.dumps(doc)
    assert TOML.loads(TOML.dumps(doc)) == JTOML.loads(JTOML.dumps(doc)) == doc
    with pytest.raises(TypeError):
        TOML.dumps({"x": object()})


@pytest.mark.parametrize("seed", [b"node0", b"", None])
def test_keygen_matches_reference(seed):
    if seed is None:
        sk, pk = S.keygen()
        assert 0 < sk < GC.R and GC.g1_eq(pk, S.public_key(sk))
        return
    sk, pk = S.keygen(seed)
    jsk, jpk = JS.keygen(seed)
    assert sk == jsk
    assert GC.g1_to_bytes(pk) == JGC.g1_to_bytes(jpk)
    assert GC.g1_to_bytes(S.public_key(sk)) == JGC.g1_to_bytes(
        JS.public_key(sk))


@pytest.mark.parametrize("sk", [1, 2, 0x1234567890ABCDEF, GC.R - 1, 0])
def test_bls_sign_and_verify_match_reference(sk):
    sig = S.bls_sign(sk, MSG)
    assert sig == JS.bls_sign(sk, MSG)
    if sk == 0:
        return                      # infinity: both give the same bytes
    pk = S.public_key(sk)
    jpk = JS.public_key(sk)
    bad = sig[:20] + bytes([sig[20] ^ 1]) + sig[21:]
    for s, m in ((sig, MSG), (sig, MSG[::-1]), (bad, MSG), (sig[:95], MSG),
                 (bytes(96), MSG)):
        assert S.bls_verify(pk, m, s) == JS.bls_verify(jpk, m, s)
    assert S.bls_verify(pk, MSG, sig)


def test_key_files_cross_both_ways_byte_equal(tmp_path):
    """Port files load in drand_tpu, and drand_tpu's in the port; writing
    what was loaded back gives the same bytes."""
    pairs = [K.Pair.generate(f"127.0.0.1:{4000 + i}", seed=b"n%d" % i)
             for i in range(N)]
    poly = P.PriPoly.random(T, secret=SECRET, rand=_rand(b"files"))
    commits = [GC.g1_to_bytes(c) for c in poly.commit().commits]
    group = _group(pairs, commits=commits)
    group.get_genesis_seed()
    share = K.Share(commits, poly.eval(2))
    port = ST.FileStore(str(tmp_path / "port"), "chain-a")
    port.save_key_pair(pairs[0])
    port.save_group(group)
    port.save_share(share)
    port.save_dist_public(share.public())

    ref = JST.FileStore(str(tmp_path / "port"), "chain-a")
    jpair, jgroup = ref.load_key_pair(), ref.load_group()
    jshare, jdist = ref.load_share(), ref.load_dist_public()
    back = JST.FileStore(str(tmp_path / "ref"), "chain-a")
    back.save_key_pair(jpair)
    back.save_group(jgroup)
    back.save_share(jshare)
    back.save_dist_public(jdist)
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    assert jgroup.hash() == group.hash()
    assert jshare.pri_share.value == share.pri_share.value

    again = ST.FileStore(str(tmp_path / "ref"), "chain-a")
    pair2, group2 = again.load_key_pair(), again.load_group()
    share2, dist2 = again.load_share(), again.load_dist_public()
    round_trip = ST.FileStore(str(tmp_path / "again"), "chain-a")
    round_trip.save_key_pair(pair2)
    round_trip.save_group(group2)
    round_trip.save_share(share2)
    round_trip.save_dist_public(dist2)
    assert _files(tmp_path / "again") == _files(tmp_path / "port")
    assert pair2 == pairs[0] and share2 == share
    assert group2.to_toml() == group.to_toml()
    assert ST.FileStore.list_beacon_ids(str(tmp_path / "ref")) == \
        JST.FileStore.list_beacon_ids(str(tmp_path / "ref")) == ["chain-a"]
    assert (again.has_key_pair(), again.has_group(), again.has_share()) == \
        (True, True, True)
    empty = ST.FileStore(str(tmp_path / "empty"))
    assert (empty.has_key_pair(), empty.has_group(), empty.has_share()) == \
        (False, False, False)
    mode = os.stat(os.path.join(port.key_folder, ST.KEY_FILE)).st_mode
    assert mode & 0o777 == 0o600
    assert os.stat(port.key_folder).st_mode & 0o777 == 0o700


@pytest.mark.parametrize("scheme,beacon_id,transition", [
    ("pedersen-bls-chained", "default", 0),
    ("pedersen-bls-unchained", "other", 1_700_000_300)])
def test_group_hash_seed_and_chain_info_match_reference(scheme, beacon_id,
                                                        transition):
    pairs = [K.Pair.generate(f"10.0.0.{i}:443", seed=b"g%d" % i)
             for i in range(N)]
    commits = [GC.g1_to_bytes(GC.g1_mul(GC.G1_GEN, c))
               for c in (11, 22, 33)]
    group = _group(pairs, scheme, beacon_id, commits)
    group.transition_time = transition
    jgroup = JG.Group.from_toml(group.to_toml())
    assert jgroup.to_toml() == group.to_toml()
    assert [n.index for n in group.nodes] == [n.index for n in jgroup.nodes]
    assert group.hash() == jgroup.hash()
    assert group.get_genesis_seed() == jgroup.get_genesis_seed()
    assert group.chain_info().hash() == jgroup.chain_info().hash()
    assert G.Group.from_toml(jgroup.to_toml()).to_toml() == group.to_toml()
    assert group.node(3).key == jgroup.node(3).key
    assert group.find(pairs[1].public).index == \
        jgroup.find(JK.Identity.from_dict(pairs[1].public.to_dict())).index
    assert group.size == N
    assert [G.minimum_threshold(n) for n in (1, 3, 16)] == \
        [JG.minimum_threshold(n) for n in (1, 3, 16)] == [1, 2, 9]


def test_identity_signatures_verify_across_packages():
    mine = K.Pair.generate("127.0.0.1:1234", seed=b"id")
    theirs = JK.Pair.generate("127.0.0.1:1234", seed=b"id")
    assert mine.to_dict() == theirs.to_dict()
    assert JK.Identity.from_dict(mine.public.to_dict()).is_valid_signature()
    assert K.Identity.from_dict(theirs.public.to_dict()).is_valid_signature()
    moved = dict(mine.public.to_dict(), Address="127.0.0.1:9999")
    assert not K.Identity.from_dict(moved).is_valid_signature()
    assert not JK.Identity.from_dict(moved).is_valid_signature()
    junk = dict(mine.public.to_dict(), Key="00" * 48)
    assert not K.Identity.from_dict(junk).is_valid_signature()
    assert not JK.Identity.from_dict(junk).is_valid_signature()


def test_sign_partial_matches_reference(poly, jpoly, partials):
    assert partials == [JT.sign_partial(s, MSG) for s in jpoly.shares(N)]
    assert [tbls.index_of(p) for p in partials] == list(range(N))


def _variants(partials, poly):
    p = partials[1]
    other = JT.sign_partial(JP.PriShare(9, poly.eval(9).value), MSG)
    return {
        "good": partials[2],
        "flipped": p[:30] + bytes([p[30] ^ 1]) + p[31:],
        "other_index": (3).to_bytes(2, "big") + p[2:],
        "index_past_n": other,
        "short": p[:97],
        "one_byte": p[:1],
        "infinity": p[:2] + bytes([0xC0]) + bytes(95),
    }


def test_verify_partial_matches_reference(poly, jpoly, partials):
    pub, jpub = poly.commit(), jpoly.commit()
    for name, part in _variants(partials, poly).items():
        got = tbls.verify_partial(pub, MSG, part)
        assert got == JT.verify_partial(jpub, MSG, part), name
        assert got == (name in ("good", "index_past_n")), name


@pytest.mark.parametrize("case", ["verified", "checked", "malformed_first",
                                  "infinity_unchecked", "too_few"])
def test_recover_matches_reference(poly, jpoly, partials, case):
    pub, jpub = poly.commit(), jpoly.commit()
    v = _variants(partials, poly)
    if case == "verified":
        parts, verified = partials[1:], True
    elif case == "checked":
        parts, verified = [v["flipped"], v["index_past_n"]] + partials, False
    elif case == "malformed_first":
        parts, verified = [v["short"], v["one_byte"], partials[4],
                           partials[0], partials[3]], True
    elif case == "infinity_unchecked":
        # the infinity point decodes: taken as signer 1's, unchecked
        parts, verified = [v["infinity"], partials[0], partials[3]], True
    else:
        parts, verified = partials[:T - 1] + [v["flipped"]], False
    if case == "too_few":
        with pytest.raises(ValueError):
            tbls.recover(pub, MSG, parts, T, N, verified=verified)
        with pytest.raises(ValueError):
            JT.recover(jpub, MSG, parts, T, N, verified=verified)
        return
    sig = tbls.recover(pub, MSG, parts, T, N, verified=verified)
    assert sig == JT.recover(jpub, MSG, parts, T, N, verified=verified)
    if case == "infinity_unchecked":
        assert sig != JS.bls_sign(SECRET, MSG)
        assert not tbls.verify_recovered(pub.commits[0], MSG, sig)
        return
    assert sig == JS.bls_sign(SECRET, MSG)
    assert tbls.verify_recovered(pub.commits[0], MSG, sig)
    assert JT.verify_recovered(jpub.key(), MSG, sig)
    assert not tbls.verify_recovered(pub.commits[0], MSG[::-1], sig)
    assert not JT.verify_recovered(jpub.key(), MSG[::-1], sig)
