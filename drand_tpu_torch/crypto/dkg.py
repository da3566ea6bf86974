"""Pedersen distributed key generation with resharing (counterpart of
`drand_tpu/crypto/dkg.py`, kyber's `share/dkg` as drand drives it): a
deal, response and justification state machine over an untrusted
broadcast channel.  The runner (`core/dkg_runner.py`) feeds the bundles
in and moves the phases; this module owns the crypto.

Fresh DKG: every node deals a random secret; the group key is the sum of
the qualified dealers' polynomials.  Resharing: the old group's nodes
deal their share under a fresh polynomial of degree t' - 1, and the new
shares are Lagrange-combined at the old indices, which keeps the group
key.  Bundle shapes and hashes are drand_tpu's (dkg.proto's fields).

The commitment checks of a deal phase (one row a dealer: its polynomial
at our index) and of the justifications (one row a revealed share) run
as one batched call of `ops.bls.dkg_commit_checks` on the protocol's
device when it is a CUDA device and the batch has at least
`STACKED_MIN_ROWS` rows, and on the golden model row by row otherwise;
both give the same verdicts (canonical affine comparison).  A failing
card call raises: it never falls back to the host.  `force_stacked`
takes the batched path at any size and on any device (the CPU runs the
kernels' plain versions).  Each batched call leaves a dispatch record
(`dispatch.py`, seams "dkg_deals" and "dkg_justifications") once it has
returned.
"""

from __future__ import annotations

import hashlib
import secrets
import time
from dataclasses import dataclass

from drand_tpu_torch.crypto import ecies
from drand_tpu_torch.crypto import sign as S
from drand_tpu_torch.crypto.bls12381 import curve as C
from drand_tpu_torch.crypto.bls12381.constants import R
from drand_tpu_torch.crypto.poly import (PriPoly, PriShare, PubPoly,
                                         _lagrange_basis_at_zero)
from drand_tpu_torch.device import resolve
from drand_tpu_torch.dispatch import record_dispatch

# the fewest rows a batched call takes on a card (drand_tpu's threshold)
STACKED_MIN_ROWS = 8


@dataclass(frozen=True)
class DkgNode:
    index: int
    public: tuple      # G1 point
    address: str = ""


@dataclass
class DistKeyShare:
    """The DKG's output (kyber's dkg.DistKeyShare): the public
    commitments and this node's private share."""
    commits: list        # G1 points, commits[0] the group's public key
    pri_share: PriShare

    def public(self) -> PubPoly:
        return PubPoly(self.commits)


@dataclass
class DkgConfig:
    longterm: int                          # our long-term secret scalar
    new_nodes: list[DkgNode]
    threshold: int
    nonce: bytes                           # session id
    old_nodes: list[DkgNode] | None = None     # resharing only
    old_threshold: int = 0
    share: DistKeyShare | None = None          # our old share (reshare dealer)
    public_coeffs: list | None = None          # old group commits (reshare)
    entropy: object = None     # callable n -> bytes for the secret
    # polynomial (the --source entropy), or None: the OS CSPRNG

    @property
    def resharing(self) -> bool:
        return self.old_nodes is not None

    def dealers(self) -> list[DkgNode]:
        return self.old_nodes if self.resharing else self.new_nodes

    def _index_in(self, nodes) -> int | None:
        pub = C.g1_mul(C.G1_GEN, self.longterm)
        for n in nodes:
            if C.g1_eq(n.public, pub):
                return n.index
        return None

    def our_new_index(self) -> int | None:
        return self._index_in(self.new_nodes)

    def our_dealer_index(self) -> int | None:
        return self._index_in(self.dealers())


# ---------------------------------------------------------------------------
# Bundles (dkg.proto's messages in memory)
# ---------------------------------------------------------------------------

@dataclass
class Deal:
    share_index: int
    encrypted_share: bytes


@dataclass
class DealBundle:
    dealer_index: int
    commits: list[bytes]          # compressed G1 commitments
    deals: list[Deal]
    session_id: bytes
    signature: bytes = b""

    def hash(self) -> bytes:
        h = hashlib.sha256()
        h.update(b"deal")
        h.update(self.dealer_index.to_bytes(4, "big"))
        for c in self.commits:
            h.update(c)
        for d in sorted(self.deals, key=lambda d: d.share_index):
            h.update(d.share_index.to_bytes(4, "big"))
            h.update(d.encrypted_share)
        h.update(self.session_id)
        return h.digest()


@dataclass
class Response:
    dealer_index: int
    status: bool


@dataclass
class ResponseBundle:
    share_index: int
    responses: list[Response]
    session_id: bytes
    signature: bytes = b""

    def hash(self) -> bytes:
        h = hashlib.sha256()
        h.update(b"response")
        h.update(self.share_index.to_bytes(4, "big"))
        for r in sorted(self.responses, key=lambda r: r.dealer_index):
            h.update(r.dealer_index.to_bytes(4, "big"))
            h.update(b"\x01" if r.status else b"\x00")
        h.update(self.session_id)
        return h.digest()


@dataclass
class Justification:
    share_index: int
    share: int          # the revealed plaintext share (a scalar)


@dataclass
class JustificationBundle:
    dealer_index: int
    justifications: list[Justification]
    session_id: bytes
    signature: bytes = b""

    def hash(self) -> bytes:
        h = hashlib.sha256()
        h.update(b"justification")
        h.update(self.dealer_index.to_bytes(4, "big"))
        for j in sorted(self.justifications, key=lambda j: j.share_index):
            h.update(j.share_index.to_bytes(4, "big"))
            h.update(j.share.to_bytes(32, "big"))
        h.update(self.session_id)
        return h.digest()


class DkgError(Exception):
    pass


def _has_identity(points) -> bool:
    return any(C.point_is_inf(p, C.FP_OPS) for p in points)


def _commit_checks(seam: str, polys, indices, expected, device):
    """One batched call of `dkg_commit_checks`: row r asserts
    PubPoly(polys[r]).eval(indices[r]) == expected[r] (golden points,
    no identity in polys).  Returns a list of bools; records a dispatch
    once the call has returned."""
    import numpy as np

    from drand_tpu_torch.ops import bls as OB
    t0 = time.perf_counter()
    limbs = [OB.g1_rows_to_limbs(pts) for pts in polys]
    ex, ey, einf = OB.g1_rows_to_limbs(expected)
    ok = OB.dkg_commit_checks(
        np.stack([x for x, _, _ in limbs]), np.stack([y for _, y, _ in limbs]),
        np.asarray(indices, dtype=np.int32), ex, ey, einf, device=device)
    record_dispatch(seam, len(indices), len(indices),
                    time.perf_counter() - t0)
    return [bool(v) for v in ok]


# ---------------------------------------------------------------------------
# The state machine
# ---------------------------------------------------------------------------

class DkgProtocol:
    """One ceremony's state machine.  device: where the batched
    commitment checks run (`device.resolve`: the current CUDA device
    unless one is named); force_stacked: take the batched path at any
    size and on any device."""

    def __init__(self, conf: DkgConfig, device=None,
                 force_stacked: bool = False):
        self.conf = conf
        self.device = resolve(device)
        self.force_stacked = force_stacked
        self.nidx = conf.our_new_index()
        self.didx = conf.our_dealer_index()
        self._poly: PriPoly | None = None
        self.deals: dict[int, DealBundle] = {}
        self.responses: dict[int, ResponseBundle] = {}
        self.justifs: dict[int, JustificationBundle] = {}
        # the decrypted share from each dealer (for our new index)
        self._recv_shares: dict[int, int] = {}
        self._bad_dealers: set[int] = set()

    def _stacked(self, rows: int) -> bool:
        return self.force_stacked or (self.device.type == "cuda"
                                      and rows >= STACKED_MIN_ROWS)

    # -- phase 1: deals -----------------------------------------------------

    def make_deal_bundle(self) -> DealBundle | None:
        """Our deal, or None when we are not a dealer."""
        if self.didx is None:
            return None
        conf = self.conf
        if conf.resharing:
            if conf.share is None:
                return None
            secret = conf.share.pri_share.value
        else:
            secret = None
        self._poly = PriPoly.random(conf.threshold, secret=secret,
                                    rand=conf.entropy)
        commits = [C.g1_to_bytes(c) for c in self._poly.commit().commits]
        deals = [Deal(share_index=node.index, encrypted_share=ecies.seal(
            node.public, self._poly.eval(node.index).value.to_bytes(32, "big")))
            for node in conf.new_nodes]
        bundle = DealBundle(dealer_index=self.didx, commits=commits,
                            deals=deals, session_id=conf.nonce)
        bundle.signature = S.schnorr_sign(conf.longterm, bundle.hash())
        return bundle

    def _dealer_pub(self, index: int):
        for n in self.conf.dealers():
            if n.index == index:
                return n.public
        return None

    def receive_deal_bundle(self, bundle: DealBundle) -> bool:
        """Check the signature and session, and record; True when
        accepted."""
        pub = self._dealer_pub(bundle.dealer_index)
        if pub is None or bundle.session_id != self.conf.nonce:
            return False
        if not S.schnorr_verify(pub, bundle.hash(), bundle.signature):
            return False
        if len(bundle.commits) != self.conf.threshold:
            self._bad_dealers.add(bundle.dealer_index)
            return False
        self.deals[bundle.dealer_index] = bundle
        return True

    # -- phase 2: responses -------------------------------------------------

    def make_response_bundle(self) -> ResponseBundle | None:
        """Decrypt and check every dealer's share for our index (None
        when we hold no new share)."""
        if self.nidx is None:
            return None
        checked = self._check_deals()
        responses = [Response(dealer_index=dealer.index,
                              status=checked.get(dealer.index, False))
                     for dealer in self.conf.dealers()]
        rb = ResponseBundle(share_index=self.nidx, responses=responses,
                            session_id=self.conf.nonce)
        rb.signature = S.schnorr_sign(self.conf.longterm, rb.hash())
        return rb

    def _check_deals(self) -> dict[int, bool]:
        """Every dealer's verdict in one pass: the commitment evaluations
        in one batched call when `_stacked`, on the golden model
        otherwise."""
        out: dict[int, bool] = {}
        pre: dict[int, tuple[int, list]] = {}
        for dealer in self.conf.dealers():
            bundle = self.deals.get(dealer.index)
            p = None if bundle is None else self._predecrypt(bundle)
            if p is None:
                out[dealer.index] = False
            else:
                pre[dealer.index] = p
        if not self._stacked(len(pre)):
            for di, (value, pts) in pre.items():
                out[di] = self._check_deal_host(self.deals[di], value, pts)
            return out
        out.update(self._check_deals_device(pre))
        return out

    def _predecrypt(self, bundle: DealBundle) -> tuple[int, list] | None:
        """The host half of a deal check: exactly one deal for our index,
        its ECIES box opened, the commitments decompressed.  Returns
        (share value, commitment points), or None on a failure."""
        my = [d for d in bundle.deals if d.share_index == self.nidx]
        if len(my) != 1:
            return None
        try:
            value = int.from_bytes(ecies.open_sealed(
                self.conf.longterm, my[0].encrypted_share), "big") % R
            pts = [C.g1_from_bytes(c) for c in bundle.commits]
        except Exception:
            return None
        return value, pts

    def _check_deal_host(self, bundle: DealBundle, value: int,
                         commit_pts: list) -> bool:
        """One deal's commitment check on the golden model."""
        commits = PubPoly(commit_pts)
        if not C.g1_eq(commits.eval(self.nidx), C.g1_mul(C.G1_GEN, value)):
            return False
        if self.conf.resharing:
            # the dealer's constant term commits to its old share
            old = PubPoly(self.conf.public_coeffs)
            if not C.g1_eq(old.eval(bundle.dealer_index), commits.commits[0]):
                return False
        self._recv_shares[bundle.dealer_index] = value
        return True

    def _check_deals_device(self, pre: dict[int, tuple[int, list]]
                            ) -> dict[int, bool]:
        """The dealers' evaluations at our index (and, for a reshare, the
        old polynomial at each dealer's index against its constant term)
        in one batched call each.  A dealer whose commitments contain the
        identity goes to the host path row by row, as in drand_tpu (the
        batched Horner takes affine inputs)."""
        out: dict[int, bool] = {}
        batch: list[int] = []
        for di, (value, pts) in pre.items():
            if _has_identity(pts):
                out[di] = self._check_deal_host(self.deals[di], value, pts)
            else:
                batch.append(di)
        if self.conf.resharing and _has_identity(self.conf.public_coeffs):
            # a degenerate old group polynomial: the host path for all
            for di in batch:
                out[di] = self._check_deal_host(self.deals[di], *pre[di])
            return out
        if not batch:
            return out
        ok = _commit_checks(
            "dkg_deals", [pre[di][1] for di in batch], [self.nidx] * len(batch),
            [C.g1_mul(C.G1_GEN, pre[di][0]) for di in batch], self.device)
        if self.conf.resharing:
            old = _commit_checks(
                "dkg_deals", [self.conf.public_coeffs] * len(batch), batch,
                [pre[di][1][0] for di in batch], self.device)
            ok = [a and b for a, b in zip(ok, old)]
        for di, good in zip(batch, ok):
            out[di] = good
            if good:
                self._recv_shares[di] = pre[di][0]
        return out

    def receive_response_bundle(self, rb: ResponseBundle) -> bool:
        holder = None
        for n in self.conf.new_nodes:
            if n.index == rb.share_index:
                holder = n
        if holder is None or rb.session_id != self.conf.nonce:
            return False
        if not S.schnorr_verify(holder.public, rb.hash(), rb.signature):
            return False
        self.responses[rb.share_index] = rb
        return True

    def complaints(self) -> dict[int, set[int]]:
        """dealer -> the share indices complaining about it."""
        out: dict[int, set[int]] = {}
        # a snapshot: the runner reads this in a worker thread while the
        # event loop may still record a late bundle
        for rb in list(self.responses.values()):
            for r in rb.responses:
                if not r.status:
                    out.setdefault(r.dealer_index, set()).add(rb.share_index)
        return out

    # -- phase 3: justifications -------------------------------------------

    def make_justification_bundle(self) -> JustificationBundle | None:
        """Reveal the plaintext shares that answer complaints against
        us."""
        against = self.complaints().get(self.didx) \
            if self.didx is not None else None
        if not against or self._poly is None:
            return None
        justifs = [Justification(share_index=i,
                                 share=self._poly.eval(i).value)
                   for i in sorted(against)]
        jb = JustificationBundle(dealer_index=self.didx,
                                 justifications=justifs,
                                 session_id=self.conf.nonce)
        jb.signature = S.schnorr_sign(self.conf.longterm, jb.hash())
        return jb

    def receive_justification_bundle(self, jb: JustificationBundle) -> bool:
        pub = self._dealer_pub(jb.dealer_index)
        if pub is None or jb.session_id != self.conf.nonce:
            return False
        if not S.schnorr_verify(pub, jb.hash(), jb.signature):
            return False
        self.justifs[jb.dealer_index] = jb
        return True

    # -- finalization -------------------------------------------------------

    def qual(self) -> list[int]:
        """The qualified dealers: dealt, and no complaint left
        unanswered."""
        complaints = self.complaints()
        # dealers whose justification covers every accuser: the revealed
        # shares still need the commitment check (batched)
        pending: dict[int, JustificationBundle] = {}
        for dealer in sorted(self.deals):
            if dealer in self._bad_dealers:
                continue
            accused = complaints.get(dealer, set())
            jb = self.justifs.get(dealer)
            if accused and jb is not None and accused.issubset(
                    {j.share_index for j in jb.justifications}):
                pending[dealer] = jb
        verified = self._verify_justifications(pending)
        out = []
        for dealer in sorted(self.deals):
            if dealer in self._bad_dealers:
                continue
            if complaints.get(dealer):
                if not verified.get(dealer, False):
                    continue
                # justified: our share from the revealed values
                if self.nidx is not None and dealer not in self._recv_shares:
                    for j in self.justifs[dealer].justifications:
                        if j.share_index == self.nidx:
                            self._recv_shares[dealer] = j.share
            out.append(dealer)
        return out

    def _verify_justifications(self, pending: dict[int, JustificationBundle]
                               ) -> dict[int, bool]:
        """dealer -> every revealed share matches the dealer's
        commitments: one row a justification in one batched call when
        `_stacked`, the golden model otherwise."""
        out: dict[int, bool] = {}
        host: dict[int, JustificationBundle] = {}
        n_rows = sum(len(jb.justifications) for jb in pending.values())
        if self._stacked(n_rows):
            rows: list[tuple[int, Justification, list]] = []
            for dealer, jb in pending.items():
                pts = [C.g1_from_bytes(c) for c in self.deals[dealer].commits]
                if _has_identity(pts):
                    host[dealer] = jb
                    continue
                rows.extend((dealer, j, pts) for j in jb.justifications)
            if rows:
                ok = _commit_checks(
                    "dkg_justifications", [pts for _, _, pts in rows],
                    [j.share_index for _, j, _ in rows],
                    [C.g1_mul(C.G1_GEN, j.share) for _, j, _ in rows],
                    self.device)
                for (dealer, _, _), good in zip(rows, ok):
                    out[dealer] = out.get(dealer, True) and good
        else:
            host = pending
        for dealer, jb in host.items():
            commits = PubPoly([C.g1_from_bytes(c)
                               for c in self.deals[dealer].commits])
            out[dealer] = all(C.g1_eq(commits.eval(j.share_index),
                                      C.g1_mul(C.G1_GEN, j.share))
                              for j in jb.justifications)
        return out

    def finalize(self) -> DistKeyShare | None:
        """The distributed key share (None for a leaving node)."""
        qual = self.qual()
        min_q = self.conf.old_threshold if self.conf.resharing \
            else self.conf.threshold
        if len(qual) < min_q:
            raise DkgError(f"too few qualified dealers: {len(qual)} < {min_q}")
        if self.nidx is None:
            return None
        missing = [d for d in qual if d not in self._recv_shares]
        if missing:
            raise DkgError(f"missing shares from qualified dealers {missing}")

        def dealer_commits(dealer):
            return [C.g1_from_bytes(c) for c in self.deals[dealer].commits]

        if not self.conf.resharing:
            value, commits = 0, None
            for dealer in qual:
                value = (value + self._recv_shares[dealer]) % R
                poly = PubPoly(dealer_commits(dealer))
                commits = poly if commits is None else commits.add(poly)
            return DistKeyShare(commits=commits.commits,
                                pri_share=PriShare(self.nidx, value))

        # resharing: the dealers' contributions Lagrange-combined at the
        # old indices
        lam = _lagrange_basis_at_zero(qual)
        value = sum(lam[d] * self._recv_shares[d] for d in qual) % R
        polys = {d: dealer_commits(d) for d in qual}
        commits = []
        for k in range(self.conf.threshold):
            acc = C.G1_INF
            for dealer in qual:
                acc = C.point_add(acc, C.g1_mul(polys[dealer][k], lam[dealer]),
                                  C.FP_OPS)
            commits.append(acc)
        return DistKeyShare(commits=commits,
                            pri_share=PriShare(self.nidx, value))


def new_nonce() -> bytes:
    return secrets.token_bytes(32)
