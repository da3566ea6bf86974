"""The port's DKG pieces held against drand_tpu on the CPU, at t = 3 and
n = 4-5 unless a test says otherwise: ECIES boxes and Schnorr
signatures cross both ways; bundle hashes and dkg.proto bytes are
equal; both packages' DkgProtocol, fed the same deal, response and
justification bundles, give equal deal verdicts, responses,
complaints, QUAL and DistKeyShares (fresh, with a complaint and its
justification, and a reshare at protocol level); the batched commitment
check on the CPU's plain path is bit-equal to drand_tpu's jitted one
and to the golden model at n = 16, t = 9, with index 65535's wrap and
an identity commitment's trip to the host path pinned; the setup
helpers and the entropy mixer equal drand_tpu's.

Inputs come from seeds (numpy's generator or SHA-512 over a label);
drand_tpu's batched path is forced with its environment switch, as
`tests/test_dkg.py` does, the port's with its constructor argument."""

import hashlib
import os
import stat
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from drand_tpu.crypto import dkg as JDKG
from drand_tpu.crypto import ecies as JE
from drand_tpu.crypto import sign as JS
from drand_tpu.crypto.bls12381 import curve as JC
from drand_tpu.ops import bls as JOB
from drand_tpu_torch.crypto import dkg as DKG
from drand_tpu_torch.crypto import ecies as E
from drand_tpu_torch.crypto import sign as S
from drand_tpu_torch.crypto.bls12381 import curve as C
from drand_tpu_torch.crypto.bls12381.constants import R
from drand_tpu_torch.crypto.poly import PriPoly, PubPoly, recover_secret
from drand_tpu_torch.dispatch import DISPATCH
from drand_tpu_torch.ops import bls as OB

ROOT = Path(__file__).resolve().parents[1]
NONCE = hashlib.sha256(b"test_torch_dkg session").digest()


def scalars(label: bytes, k: int) -> list[int]:
    """k scalars mod r from SHA-512 over label || i."""
    return [int.from_bytes(hashlib.sha512(label + i.to_bytes(4, "big"))
                           .digest(), "big") % R or 1 for i in range(k)]


def keys_and_nodes(n: int, label: bytes = b"dkg node"):
    """n long-term scalars, and each package's node list over them."""
    sks = scalars(label, n)
    pubs = [C.g1_mul(C.G1_GEN, sk) for sk in sks]
    port = [DKG.DkgNode(i, pk, f"127.0.0.1:{9000 + i}")
            for i, pk in enumerate(pubs)]
    ref = [JDKG.DkgNode(i, pk, f"127.0.0.1:{9000 + i}")
           for i, pk in enumerate(pubs)]
    return sks, port, ref


def proto_pair(sk, port_nodes, ref_nodes, t, **kw):
    """The port's and drand_tpu's DkgProtocol for the same node."""
    port = DKG.DkgProtocol(DKG.DkgConfig(
        longterm=sk, new_nodes=port_nodes, threshold=t, nonce=NONCE,
        **kw.get("port", {})), device="cpu",
        force_stacked=kw.get("stacked", False))
    ref = JDKG.DkgProtocol(JDKG.DkgConfig(
        longterm=sk, new_nodes=ref_nodes, threshold=t, nonce=NONCE,
        **kw.get("ref", {})))
    return port, ref


def to_ref(bundle):
    """A port bundle as drand_tpu's dataclass (same fields)."""
    if isinstance(bundle, DKG.DealBundle):
        return JDKG.DealBundle(bundle.dealer_index, list(bundle.commits),
                               [JDKG.Deal(d.share_index, d.encrypted_share)
                                for d in bundle.deals],
                               bundle.session_id, bundle.signature)
    if isinstance(bundle, DKG.ResponseBundle):
        return JDKG.ResponseBundle(bundle.share_index,
                                   [JDKG.Response(r.dealer_index, r.status)
                                    for r in bundle.responses],
                                   bundle.session_id, bundle.signature)
    return JDKG.JustificationBundle(
        bundle.dealer_index, [JDKG.Justification(j.share_index, j.share)
                              for j in bundle.justifications],
        bundle.session_id, bundle.signature)


def to_port(bundle):
    """A drand_tpu bundle as the port's dataclass."""
    if isinstance(bundle, JDKG.DealBundle):
        return DKG.DealBundle(bundle.dealer_index, list(bundle.commits),
                              [DKG.Deal(d.share_index, d.encrypted_share)
                               for d in bundle.deals],
                              bundle.session_id, bundle.signature)
    if isinstance(bundle, JDKG.ResponseBundle):
        return DKG.ResponseBundle(bundle.share_index,
                                  [DKG.Response(r.dealer_index, r.status)
                                   for r in bundle.responses],
                                  bundle.session_id, bundle.signature)
    return DKG.JustificationBundle(
        bundle.dealer_index, [DKG.Justification(j.share_index, j.share)
                              for j in bundle.justifications],
        bundle.session_id, bundle.signature)


def share_bytes(dks):
    return ([C.g1_to_bytes(c) for c in dks.commits],
            dks.pri_share.index, dks.pri_share.value)


# -- ECIES, Schnorr, bundles ----------------------------------------------------

def test_ecies_boxes_cross_both_ways():
    sk = scalars(b"ecies", 1)[0]
    pub = C.g1_mul(C.G1_GEN, sk)
    payload = np.random.default_rng(7).bytes(32)
    assert JE.open_sealed(sk, E.seal(pub, payload)) == payload
    assert E.open_sealed(sk, JE.seal(pub, payload)) == payload
    req, esk = E.encode_request(pub)
    reply = JE.encrypt_reply(sk, JE.decode(req), payload)
    assert E.decrypt_reply(esk, C.g1_to_bytes(pub), reply) == payload
    jreq, jesk = JE.encode_request(pub)
    reply = E.encrypt_reply(sk, E.decode(jreq), payload)
    assert reply.startswith(b'{"box": "')
    assert JE.decrypt_reply(jesk, pub, reply) == payload
    with pytest.raises(Exception):
        E.open_sealed(sk + 1, JE.seal(pub, payload))


def test_schnorr_signatures_cross_both_ways():
    sk = scalars(b"schnorr", 1)[0]
    pub = C.g1_mul(C.G1_GEN, sk)
    msg = hashlib.sha256(b"bundle").digest()
    sig = S.schnorr_sign(sk, msg)
    assert len(sig) == 80 and JS.schnorr_verify(pub, msg, sig)
    jsig = JS.schnorr_sign(sk, msg)
    assert S.schnorr_verify(pub, msg, jsig)
    bad = jsig[:60] + bytes([jsig[60] ^ 1]) + jsig[61:]
    for verify in (S.schnorr_verify, JS.schnorr_verify):
        assert not verify(pub, msg, bad)
        assert not verify(pub, msg + b"x", sig)
        assert not verify(pub, msg, sig[:79])
        assert not verify(pub, msg, sig[:48] + R.to_bytes(32, "big"))


def _bundles(rng):
    deal = DKG.DealBundle(
        3, [C.g1_to_bytes(C.g1_mul(C.G1_GEN, int(x) + 1))
            for x in rng.integers(1, 2**62, 3)],
        [DKG.Deal(i, rng.bytes(128)) for i in (2, 0, 1)], NONCE,
        rng.bytes(80))
    resp = DKG.ResponseBundle(
        1, [DKG.Response(d, bool(s)) for d, s in
            zip((4, 0, 2), rng.integers(0, 2, 3))], NONCE, rng.bytes(80))
    just = DKG.JustificationBundle(
        2, [DKG.Justification(i, int.from_bytes(rng.bytes(31), "big"))
            for i in (3, 1)], NONCE, rng.bytes(80))
    return deal, resp, just


def test_bundle_hashes_and_protos_equal_reference():
    from drand_tpu.core import broadcast as JB
    from drand_tpu_torch.core import broadcast as B
    for bundle in _bundles(np.random.default_rng(11)):
        ref = to_ref(bundle)
        assert bundle.hash() == ref.hash()
        pkt = B.bundle_to_proto(bundle)
        jpkt = JB.bundle_to_proto(ref)
        assert pkt.SerializeToString(deterministic=True) == \
            jpkt.SerializeToString(deterministic=True)
        back = B.bundle_from_proto(type(pkt).FromString(
            jpkt.SerializeToString()))
        assert back == bundle
        jback = JB.bundle_from_proto(type(jpkt).FromString(
            pkt.SerializeToString()))
        assert jback == ref
    with pytest.raises(ValueError):
        B.bundle_from_proto(type(pkt)())


# -- the protocol against drand_tpu's ---------------------------------------------

def _deal_from_poly(sk, didx, nodes, coeffs, bad_for=()):
    """A deal bundle of dealer `didx` for the polynomial `coeffs`, signed
    with sk; the shares of the nodes in bad_for are sealed off by one."""
    poly = PriPoly(coeffs)
    deals = []
    for node in nodes:
        value = (poly.eval(node.index).value + (node.index in bad_for)) % R
        deals.append(DKG.Deal(node.index, E.seal(node.public,
                                                 value.to_bytes(32, "big"))))
    b = DKG.DealBundle(didx, [C.g1_to_bytes(c) for c in
                              poly.commit().commits], deals, NONCE)
    b.signature = S.schnorr_sign(sk, b.hash())
    return b, poly


def _run_both(pairs, deals, justify=None):
    """Feed the same deals to every pair of protocols; each package's
    responses come from its own protocols and are compared, then the
    port's responses go to both sides; returns (port results, ref
    results) of complaints, qual and finalize."""
    for port, ref in pairs:
        for d in deals:
            assert port.receive_deal_bundle(d)
            assert ref.receive_deal_bundle(to_ref(d))
        assert port._check_deals() == ref._check_deals()
    resps = []
    for port, ref in pairs:
        rb, jrb = port.make_response_bundle(), ref.make_response_bundle()
        assert rb.hash() == jrb.hash() and rb.responses == [
            DKG.Response(r.dealer_index, r.status) for r in jrb.responses]
        assert JS.schnorr_verify(C.g1_mul(C.G1_GEN, port.conf.longterm),
                                 rb.hash(), rb.signature)
        resps.append(rb)
    for port, ref in pairs:
        for rb in resps:
            assert port.receive_response_bundle(rb)
            assert ref.receive_response_bundle(to_ref(rb))
        assert port.complaints() == ref.complaints()
    if justify is not None:
        jb = justify()
        for port, ref in pairs:
            assert port.receive_justification_bundle(jb)
            assert ref.receive_justification_bundle(to_ref(jb))
    out = []
    for port, ref in pairs:
        assert port.qual() == ref.qual()
        a, b = port.finalize(), ref.finalize()
        assert (a is None) == (b is None)
        if a is not None:
            assert share_bytes(a) == share_bytes(b)
        out.append(a)
    return out


def test_fresh_ceremony_equals_reference():
    """n = 5, t = 3; the deals are the port's own make_deal_bundle."""
    n, t = 5, 3
    sks, pn, rn = keys_and_nodes(n)
    pairs = [proto_pair(sk, pn, rn, t) for sk in sks]
    deals = [p.make_deal_bundle() for p, _ in pairs]
    shares = _run_both(pairs, deals)
    assert all(p.qual() == list(range(n)) for p, _ in pairs)
    secret = recover_secret([s.pri_share for s in shares[1:1 + t]], t)
    assert C.g1_eq(C.g1_mul(C.G1_GEN, secret), shares[0].commits[0])
    want = sum(p._poly.secret() for p, _ in pairs) % R
    assert secret == want


def test_reference_deals_check_equal_in_the_port():
    """drand_tpu's make_deal_bundle fed to both packages (n = 4)."""
    n, t = 4, 3
    sks, pn, rn = keys_and_nodes(n, b"ref dealers")
    pairs = [proto_pair(sk, pn, rn, t) for sk in sks]
    jdeals = [JDKG.DkgProtocol(JDKG.DkgConfig(
        longterm=sk, new_nodes=rn, threshold=t, nonce=NONCE))
        .make_deal_bundle() for sk in sks]
    _run_both(pairs, [to_port(d) for d in jdeals])


@pytest.mark.parametrize("stacked", [False, True])
def test_complaint_and_justification_equal_reference(stacked):
    """Dealer 2 seals a wrong share to nodes 1 and 3: both complain,
    dealer 2's justification reveals the right shares, it stays in QUAL,
    and nodes 1 and 3 take their share from the justification; node
    1's checks batched (forced) or on the golden model."""
    n, t = 5, 3
    sks, pn, rn = keys_and_nodes(n, b"complaint")
    pairs = [proto_pair(sk, pn, rn, t, stacked=stacked and i == 1)
             for i, sk in enumerate(sks)]
    deals, polys = [], []
    for i, sk in enumerate(sks):
        d, poly = _deal_from_poly(sk, i, pn, scalars(b"poly%d" % i, t),
                                  bad_for=(1, 3) if i == 2 else ())
        deals.append(d)
        polys.append(poly)

    def justify():
        jb = DKG.JustificationBundle(2, [DKG.Justification(
            j, polys[2].eval(j).value) for j in (1, 3)], NONCE)
        jb.signature = S.schnorr_sign(sks[2], jb.hash())
        return jb
    before = len(DISPATCH.records("dkg_justifications"))
    shares = _run_both(pairs, deals, justify)
    # node 1's qual() ran twice (_run_both's check and finalize)
    recs = DISPATCH.records("dkg_justifications")[before:]
    assert [r.n for r in recs] == ([2, 2] if stacked else [])
    assert pairs[0][0].complaints() == {2: {1, 3}}
    assert all(p.qual() == list(range(n)) for p, _ in pairs)
    want = sum(p.secret() for p in polys) % R
    assert recover_secret([s.pri_share for s in shares[:t]], t) == want
    assert recover_secret([s.pri_share for s in shares[2:]], t) == want


def test_bad_justification_drops_dealer_as_reference():
    """A justification revealing a wrong share: dealer 2 leaves QUAL on
    both sides, the batched check at n = 5 rows (forced) included."""
    n, t = 5, 3
    sks, pn, rn = keys_and_nodes(n, b"bad justification")
    pairs = [proto_pair(sk, pn, rn, t, stacked=(i == 0))
             for i, sk in enumerate(sks)]
    deals = [_deal_from_poly(sk, i, pn, scalars(b"bj%d" % i, t),
                             bad_for=(0,) if i == 2 else ())[0]
             for i, sk in enumerate(sks)]

    def justify():
        jb = DKG.JustificationBundle(2, [DKG.Justification(0, 12345)], NONCE)
        jb.signature = S.schnorr_sign(sks[2], jb.hash())
        return jb
    _run_both(pairs, deals, justify)
    assert all(p.qual() == [0, 1, 3, 4] for p, _ in pairs)


def test_reshare_at_protocol_level_equals_reference():
    """tests/test_dkg.py's reshare: a 3-node t = 2 group reshares to
    four nodes (node 0 leaves, two join), t' = 3; the port's deal
    checks batched (forced), drand_tpu's on its host path; the group
    key survives and both packages' new shares are equal; the first
    holder's checks are batched (forced: the new polynomials at its
    index, the old one at each dealer's index)."""
    t, new_t = 2, 3
    sks, pn, rn = keys_and_nodes(3, b"reshare old")
    old_pairs = [proto_pair(sk, pn, rn, t) for sk in sks]
    old = _run_both(old_pairs, [p.make_deal_bundle() for p, _ in old_pairs])
    old_commits = old[0].commits
    jold = [JDKG.DistKeyShare(s.commits, s.pri_share) for s in old]
    new_sks = sks[1:] + scalars(b"reshare new", 2)
    new_pubs = [C.g1_mul(C.G1_GEN, sk) for sk in new_sks]
    pnew = [DKG.DkgNode(i, pk, f"127.0.0.1:{9100 + i}")
            for i, pk in enumerate(new_pubs)]
    rnew = [JDKG.DkgNode(i, pk, f"127.0.0.1:{9100 + i}")
            for i, pk in enumerate(new_pubs)]

    def pair(sk, share, jshare, stacked=False):
        port = DKG.DkgProtocol(DKG.DkgConfig(
            longterm=sk, new_nodes=pnew, threshold=new_t, nonce=NONCE,
            old_nodes=pn, old_threshold=t, share=share,
            public_coeffs=old_commits), device="cpu", force_stacked=stacked)
        ref = JDKG.DkgProtocol(JDKG.DkgConfig(
            longterm=sk, new_nodes=rnew, threshold=new_t, nonce=NONCE,
            old_nodes=rn, old_threshold=t, share=jshare,
            public_coeffs=old_commits))
        return port, ref
    pairs = [pair(sks[0], old[0], jold[0])] + \
        [pair(sk, old[i + 1], jold[i + 1], stacked=(i == 0))
         for i, sk in enumerate(sks[1:])] + \
        [pair(sk, None, None) for sk in new_sks[2:]]
    deals = [d for d in (p.make_deal_bundle() for p, _ in pairs)
             if d is not None]
    assert len(deals) == 3
    for port, ref in pairs:
        for d in deals:
            assert port.receive_deal_bundle(d)
            assert ref.receive_deal_bundle(to_ref(d))
    holders = pairs[1:]
    before = len(DISPATCH.records("dkg_deals"))
    resps = []
    for port, ref in holders:
        assert port._check_deals() == ref._check_deals() == \
            {0: True, 1: True, 2: True}
        resps.append(port.make_response_bundle())
    # two checks of the first holder, each two calls of three rows
    assert [r.n for r in DISPATCH.records("dkg_deals")[before:]] == [3] * 4
    for port, ref in pairs:
        for rb in resps:
            assert port.receive_response_bundle(rb)
            assert ref.receive_response_bundle(to_ref(rb))
    assert pairs[0][0].finalize() is None and pairs[0][1].finalize() is None
    held = []
    for port, ref in holders:
        a, b = port.finalize(), ref.finalize()
        assert share_bytes(a) == share_bytes(b)
        assert C.g1_eq(a.commits[0], old_commits[0])
        held.append(a)
    secret = recover_secret([s.pri_share for s in held[:new_t]], new_t)
    assert C.g1_eq(C.g1_mul(C.G1_GEN, secret), old_commits[0])


def test_reshare_dealer_with_wrong_constant_term_rejected():
    """A reshare dealer whose constant term does not commit to its old
    share: the old polynomial's check (the second batched call) says
    false on both packages."""
    t, new_t = 2, 2
    sks, pn, rn = keys_and_nodes(3, b"reshare wrong")
    old_pairs = [proto_pair(sk, pn, rn, t) for sk in sks]
    old = _run_both(old_pairs, [p.make_deal_bundle() for p, _ in old_pairs])
    kw = dict(old_threshold=t, public_coeffs=old[0].commits)
    port = DKG.DkgProtocol(DKG.DkgConfig(
        longterm=sks[1], new_nodes=pn, threshold=new_t, nonce=NONCE,
        old_nodes=pn, share=old[1], **kw), device="cpu", force_stacked=True)
    ref = JDKG.DkgProtocol(JDKG.DkgConfig(
        longterm=sks[1], new_nodes=rn, threshold=new_t, nonce=NONCE,
        old_nodes=rn, share=JDKG.DistKeyShare(old[1].commits,
                                              old[1].pri_share), **kw))
    deals = []
    for i, s in enumerate(old):
        secret = s.pri_share.value + (i == 2)
        deals.append(_deal_from_poly(sks[i], i, pn, [secret] + scalars(
            b"rw%d" % i, new_t - 1))[0])
    for d in deals:
        assert port.receive_deal_bundle(d)
        assert ref.receive_deal_bundle(to_ref(d))
    got = port._check_deals()
    assert got == ref._check_deals() == {0: True, 1: True, 2: False}


# -- the batched commitment check ------------------------------------------------

def _commit_rows(polys, indices, expected):
    limbs = [OB.g1_rows_to_limbs(p) for p in polys]
    ex, ey, einf = OB.g1_rows_to_limbs(expected)
    return (np.stack([x for x, _, _ in limbs]),
            np.stack([y for _, y, _ in limbs]),
            np.asarray(indices, dtype=np.int32), ex, ey, einf)


def test_commit_checks_bit_equal_reference_jit():
    """n = 4 rows, t = 3, each row its own polynomial and index: the
    stacked Horner's affine limbs and the verdicts equal drand_tpu's
    jitted functions, a swapped commitment and a wrong expected point
    false in their rows only; g1_rows_to_limbs equal."""
    rng = np.random.default_rng(2020)
    t, rows = 3, 4
    polys = [[C.g1_mul(C.G1_GEN, int(x)) for x in rng.integers(1, 2**62, t)]
             for _ in range(rows)]
    indices = [0, 3, 7, 1]
    expected = [PubPoly(p).eval(i) for p, i in zip(polys, indices)]
    polys[1] = [polys[1][0], polys[1][0], polys[1][2]]
    expected[2] = C.g1_mul(C.G1_GEN, 5)
    args = _commit_rows(polys, indices, expected)
    for a, b in zip(OB.g1_rows_to_limbs(polys[0] + [C.G1_INF]),
                    JOB.g1_rows_to_limbs(polys[0] + [JC.G1_INF])):
        np.testing.assert_array_equal(a, b)
    (ax, ay), inf = OB.pubpoly_eval_g1_stacked(
        *(torch.from_numpy(a) for a in args[:3]))
    (jx, jy), jinf = JOB._pubpoly_eval_g1_stacked_jit(*args[:3])
    np.testing.assert_array_equal(ax.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ay.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(inf.numpy(), np.asarray(jinf))
    ok = OB.dkg_commit_checks(*args, device="cpu")
    np.testing.assert_array_equal(ok, JOB.dkg_commit_checks(*args))
    assert ok.tolist() == [True, False, False, True]


def test_forced_deal_checks_equal_reference_forced(monkeypatch):
    """tests/test_dkg.py's parity at n = 4, t = 3: dealer 2 commits to a
    valid but wrong polynomial; the port's batched path (forced by its
    argument) and drand_tpu's (forced by its environment switch) give
    the host path's verdicts on both."""
    n, t = 4, 3
    sks, pn, rn = keys_and_nodes(n, b"forced parity")
    pairs = [proto_pair(sk, pn, rn, t, stacked=True) for sk in sks]
    deals = [p.make_deal_bundle() for p, _ in pairs]
    deals[2].commits[1] = deals[2].commits[0]
    deals[2].signature = S.schnorr_sign(sks[2], deals[2].hash())
    monkeypatch.setenv("DRAND_TPU_DKG_BATCH", "force")
    before = len(DISPATCH.records("dkg_deals"))
    for port, ref in pairs:
        for d in deals:
            assert port.receive_deal_bundle(d)
            assert ref.receive_deal_bundle(to_ref(d))
        got = port._check_deals()
        assert got == ref._check_deals() == \
            {0: True, 1: True, 2: False, 3: True}
        port.force_stacked = False
        assert port._check_deals() == got
    assert [r.n for r in DISPATCH.records("dkg_deals")[before:]] == [n] * n


def test_commit_checks_equal_golden_at_16_9():
    """n = 16 rows, t = 9 (the ceremony's shape on the card) on the CPU's
    plain path: every verdict equals the golden PubPoly.eval comparison,
    two corrupted rows false."""
    t, rows = 9, 16
    rng = np.random.default_rng(169)
    polys = [[C.g1_mul_gen(int(x)) for x in rng.integers(1, 2**62, t)]
             for _ in range(rows)]
    indices = [int(i) for i in rng.integers(0, 16, rows)]
    expected = [PubPoly(p).eval(i) for p, i in zip(polys, indices)]
    polys[5] = polys[6]
    expected[11] = C.g1_mul_gen(11)
    ok = OB.dkg_commit_checks(*_commit_rows(polys, indices, expected),
                              device="cpu")
    golden = [C.g1_eq(PubPoly(p).eval(i), e)
              for p, i, e in zip(polys, indices, expected)]
    assert ok.tolist() == golden
    assert [r for r in range(rows) if not ok[r]] == [5, 11]


def test_index_65535_wraps_as_reference():
    """Index 65535 + 1 keeps its low 16 bits, so the batched Horner
    evaluates at x = 0 (the constant term), as drand_tpu's does; the
    golden model evaluates at 65536 (rows 0 and 1; rows 2 and 3 are
    index 65534, evaluated at 65535 by both)."""
    polys = [[C.g1_mul_gen(k) for k in (11, 22, 33)]] * 4
    expected = [polys[0][0], PubPoly(polys[0]).eval(65535),
                PubPoly(polys[0]).eval(65534), polys[0][0]]
    args = _commit_rows(polys, [65535, 65535, 65534, 65534], expected)
    ok = OB.dkg_commit_checks(*args, device="cpu")
    assert ok.tolist() == [True, False, True, False]
    np.testing.assert_array_equal(ok, JOB.dkg_commit_checks(*args))


def test_identity_commitment_goes_to_host_path():
    """A dealer whose commitments hold the identity (a zero coefficient)
    is checked on the golden model, the others in one batched call of
    n - 1 rows; the verdicts equal the host path's and drand_tpu's."""
    n, t = 4, 3
    sks, pn, rn = keys_and_nodes(n, b"identity")
    pairs = [proto_pair(sk, pn, rn, t, stacked=True) for sk in sks]
    deals = [_deal_from_poly(sk, i, pn, [5 + i, 0 if i == 1 else 9, 7])[0]
             for i, sk in enumerate(sks)]
    assert C.point_is_inf(C.g1_from_bytes(deals[1].commits[1]), C.FP_OPS)
    port, ref = pairs[0]
    for d in deals:
        assert port.receive_deal_bundle(d)
        assert ref.receive_deal_bundle(to_ref(d))
    before = len(DISPATCH.records("dkg_deals"))
    got = port._check_deals()
    assert [r.n for r in DISPATCH.records("dkg_deals")[before:]] == [n - 1]
    assert got == ref._check_deals() == {i: True for i in range(n)}
    port.force_stacked = False
    assert port._check_deals() == got


def test_no_environment_switch_and_no_quiet_cpu():
    """The port's path follows its device and argument only: on the CPU,
    8 rows take the host path even with drand_tpu's switch set, and no
    device named on a CUDA-less host raises."""
    n, t = 8, 2
    sks, pn, _ = keys_and_nodes(n, b"no env")
    env = dict(os.environ, DRAND_TPU_DKG_BATCH="force")
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from drand_tpu_torch.crypto import dkg\n"
        "from drand_tpu_torch.dispatch import DISPATCH\n"
        "p = dkg.DkgProtocol(dkg.DkgConfig(longterm=3, new_nodes=[], "
        "threshold=2, nonce=b''), device='cpu')\n"
        "print(p._stacked(8), p._stacked(10**6), len(DISPATCH))\n"
        % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["False", "False", "0"], out.stderr
    conf = DKG.DkgConfig(longterm=sks[0], new_nodes=pn, threshold=t,
                         nonce=NONCE)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DKG.DkgProtocol(conf)
    p = DKG.DkgProtocol(conf, device="cpu", force_stacked=True)
    assert p._stacked(1) and DKG.STACKED_MIN_ROWS == 8


def test_failing_batched_call_raises_without_fallback(monkeypatch):
    """A batched check that raises propagates out of _check_deals and
    qual(): no verdict is taken from the host path instead."""
    n, t = 4, 3
    sks, pn, rn = keys_and_nodes(n, b"raises")
    port = proto_pair(sks[0], pn, rn, t, stacked=True)[0]
    deals = [_deal_from_poly(sk, i, pn, scalars(b"r%d" % i, t),
                             bad_for=(0,) if i == 1 else ())[0]
             for i, sk in enumerate(sks)]
    for d in deals:
        assert port.receive_deal_bundle(d)

    def broken(*args, **kw):
        raise RuntimeError("CUDA error: an illegal memory access")
    monkeypatch.setattr(OB, "dkg_commit_checks", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        port._check_deals()
    rb = DKG.ResponseBundle(0, [DKG.Response(1, False)], NONCE)
    rb.signature = S.schnorr_sign(sks[0], rb.hash())
    assert port.receive_response_bundle(rb)
    jb = DKG.JustificationBundle(1, [DKG.Justification(0, 7)], NONCE)
    jb.signature = S.schnorr_sign(sks[1], jb.hash())
    assert port.receive_justification_bundle(jb)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        port.qual()


# -- setup helpers, entropy, imports ---------------------------------------------

def test_board_drains_own_bundle_to_a_slow_peer_before_closing():
    """A node whose phase closed still holds its own last bundle in the
    queue to a slower peer, behind echoes: `drain` sends it (bounded by
    its limit when a peer never answers) before `close` abandons the
    rest; `close` alone would have lost it."""
    import asyncio

    from drand_tpu_torch.core.broadcast import EchoBroadcast
    from drand_tpu_torch.key.keys import Identity

    class Stub:
        def __init__(self, peer):
            self.peer = peer

        async def BroadcastDKG(self, req, timeout):
            await asyncio.sleep(self.peer.delay)
            self.peer.got.append(req.dkg.response.share_index)

    class Peer:
        def __init__(self, delay):
            self.delay, self.got = delay, []

    class Peers:
        def __init__(self):
            self.by_addr = {"slow:1": Peer(0.2), "dead:1": Peer(3600)}

        def protocol(self, addr):
            return Stub(self.by_addr[addr])

    class Accepting:
        def receive_response_bundle(self, rb):
            return True

    def bundle(i):
        return DKG.ResponseBundle(share_index=i, responses=[],
                                  session_id=b"s" * 32)

    async def run(drain: bool):
        peers = Peers()
        nodes = [Identity(key=b"", address=a)
                 for a in ("me:1", "slow:1", "dead:1")]
        board = EchoBroadcast(Accepting(), peers, nodes, "me:1")
        for i in range(3):          # two echoes, then our own bundle
            await board.broadcast(bundle(i))
        t0 = asyncio.get_running_loop().time()
        if drain:
            await board.drain(1.0)
        waited = asyncio.get_running_loop().time() - t0
        board.close()
        await asyncio.sleep(0)
        return peers.by_addr["slow:1"].got, waited

    got, waited = asyncio.run(run(True))
    assert got == [0, 1, 2] and 0.5 <= waited < 2.0
    got, _ = asyncio.run(run(False))
    assert got == []


def test_compute_genesis_and_session_nonce_equal_reference():
    from drand_tpu.core import dkg_runner as JR
    from drand_tpu.core import group_setup as JGS
    from drand_tpu.key.group import Group as JGroup
    from drand_tpu_torch.core import dkg_runner as DR
    from drand_tpu_torch.core import group_setup as GS
    from drand_tpu_torch.key.group import Group
    from drand_tpu_torch.key.keys import Pair
    for now, period, timeout, offset in [(1_700_000_000.5, 3, 10, 0),
                                         (1_700_000_001.0, 30, 7.5, 4),
                                         (12.0, 1, 0, 0)]:
        assert GS.compute_genesis(now, period, timeout, offset) == \
            JGS.compute_genesis(now, period, timeout, offset)
    pairs = [Pair.generate(f"127.0.0.1:{7000 + i}", seed=b"g%d" % i)
             for i in range(4)]
    group = Group(threshold=3, period=3, nodes=Group.sort_nodes(
        [p.public for p in pairs]), genesis_time=1_700_000_030,
        catchup_period=1)
    group.get_genesis_seed()
    ref = JGroup.from_toml(group.to_toml())
    assert DR.session_nonce(group) == JR.session_nonce(ref)
    assert GS.hash_secret(b"s") == JGS.hash_secret(b"s")


def test_entropy_mixing_equals_reference(tmp_path):
    from drand_tpu import entropy as JENT
    from drand_tpu_torch import entropy as ENT
    script = tmp_path / "source.sh"
    script.write_text("#!/bin/sh\nprintf 'abcdefghijklmnopqrstuvwxyz0123456789'\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    got = ENT.get_random(ENT.ScriptReader(str(script)), 32, user_only=True)
    assert got == JENT.get_random(JENT.ScriptReader(str(script)), 32,
                                  user_only=True) == b"abcdefghijklmnopqrstuvwxyz012345"
    assert len(ENT.get_random(ENT.ScriptReader(str(script)), 32)) == 32
    assert len(ENT.get_random(None, 16)) == 16
    with pytest.raises(ValueError):
        ENT.ScriptReader(str(script)).read(64)


_DKG_MODULES = ("drand_tpu_torch.crypto.ecies", "drand_tpu_torch.crypto.dkg",
                "drand_tpu_torch.entropy", "drand_tpu_torch.core.group_setup",
                "drand_tpu_torch.core.broadcast",
                "drand_tpu_torch.core.dkg_runner",
                "drand_tpu_torch.core.control", "drand_tpu_torch.ops.bls")


def test_dkg_modules_import_neither_jax_nor_drand_tpu():
    code = ("import importlib, sys\n"
            "for m in sys.argv[1:]:\n"
            "    importlib.import_module(m)\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'drand_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code, *_DKG_MODULES],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
