"""Scheme-aware beacon verification on the card: `ChainVerifier`
(counterpart of `drand_tpu/chain/verify.py`).

One (scheme, public key) bound to one device.  Every check, the single
beacon included, is a batch of the port's `Verifier` on that device,
padded to `verify.BUCKETS`: the port has no host verify tier, so there is
no small-batch host path.  Linkage of a chained segment (each
previous_sig equals the preceding signature) is checked on the host.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np

from drand_tpu_torch.chain.beacon import Beacon
from drand_tpu_torch.chain.scheme import Scheme
from drand_tpu_torch.crypto.bls12381 import curve as GC
from drand_tpu_torch.verify import Verifier


class ChainVerifier:
    """Verifier bound to one (scheme, distributed public key) and one
    device: the current CUDA device unless `device` names another (the
    tests pass device="cpu"); with no CUDA and no device named it raises.

    `public_key_bytes` is the compressed key: on G1 (48 bytes) for the
    G2-signature schemes, on G2 (96 bytes) for bls-unchained-g1-rfc9380.
    `beacon_id` only labels the verifier."""

    def __init__(self, scheme: Scheme, public_key_bytes: bytes,
                 beacon_id: str = "", device=None):
        self.scheme = scheme
        self.beacon_id = beacon_id
        self.public_key_bytes = public_key_bytes
        if scheme.shape.sig_on_g1:
            pk, ops = GC.g2_from_bytes(public_key_bytes), GC.FP2_OPS
        else:
            pk, ops = GC.g1_from_bytes(public_key_bytes), GC.FP_OPS
        if GC.point_is_inf(pk, ops):
            # no affine form to hand the device
            raise ValueError("public key is the point at infinity")
        self._pk_point = pk
        self._verifier = Verifier(self._pk_point, scheme.shape, device=device)

    @property
    def device(self):
        return self._verifier.device

    def digest_message(self, round_: int, prev_sig: bytes) -> bytes:
        """sha256(prev_sig || be64(round)), or sha256(be64(round)) when the
        scheme decouples the previous signature (drand `chain/verify.go`)."""
        h = hashlib.sha256()
        if not self.scheme.decouple_prev_sig:
            h.update(prev_sig)
        h.update(struct.pack(">Q", round_))
        return h.digest()

    # -- verification -------------------------------------------------------

    def _verify_beacon_async(self, beacon: Beacon):
        """One beacon as a one-row batch on the verifier's device; a
        signature of the wrong length is False with nothing issued."""
        sig = np.frombuffer(beacon.signature, dtype=np.uint8)
        if sig.shape[0] != self.scheme.sig_len:
            return lambda: False
        prev = None
        if not self.scheme.decouple_prev_sig:
            prev = np.frombuffer(beacon.previous_sig, dtype=np.uint8)[None]
        pending = self._verifier.verify_batch_async(
            np.array([beacon.round], dtype=np.uint64), sig[None], prev)
        return lambda: bool(pending()[0])

    def verify_beacon(self, beacon: Beacon) -> bool:
        """Single-beacon check: a one-row batch on the verifier's device
        (padded to the smallest bucket), as the genesis anchor's round."""
        return self._verify_beacon_async(beacon)()

    def verify_beacons_async(self, beacons: list[Beacon]):
        """Issue a batch verify without waiting; returns a zero-arg callable
        that waits and yields bool[B].

        Beacons of irregular shape (a chained beacon whose previous
        signature has another length, as round 1's 32-byte genesis seed;
        a signature of the wrong length) go one by one through the scalar
        path; the regular rest is one batch, issued first.  Every batch is
        issued before any is resolved."""
        if not beacons:
            return lambda: np.zeros(0, dtype=bool)
        sig_len = self.scheme.sig_len
        chained = not self.scheme.decouple_prev_sig
        regular = [i for i, b in enumerate(beacons)
                   if len(b.signature) == sig_len
                   and (not chained or len(b.previous_sig) == sig_len)]
        pending = None
        if regular:
            rounds = np.array([beacons[i].round for i in regular],
                              dtype=np.uint64)
            sigs = np.stack([np.frombuffer(beacons[i].signature, np.uint8)
                             for i in regular])
            prev = None
            if chained:
                prev = np.stack([np.frombuffer(beacons[i].previous_sig,
                                               np.uint8) for i in regular])
            pending = self._verifier.verify_batch_async(rounds, sigs, prev)
        if len(regular) == len(beacons):
            return pending
        taken = set(regular)
        singles = [(i, self._verify_beacon_async(b))
                   for i, b in enumerate(beacons) if i not in taken]

        def resolve():
            out = np.zeros(len(beacons), dtype=bool)
            if pending is not None:
                out[np.asarray(regular)] = pending()
            for i, one in singles:
                out[i] = one()
            return out

        return resolve

    def verify_beacons(self, beacons: list[Beacon]) -> np.ndarray:
        """Batch of arbitrary (round, prev_sig, sig) triples -> bool[B]."""
        return self.verify_beacons_async(beacons)()

    def verify_chain_segment_async(self, beacons: list[Beacon],
                                   anchor_prev_sig: bytes):
        """Issue the verify of a contiguous segment without waiting: the
        linkage (each previous_sig equals the preceding signature, the
        first the anchor) is checked on the host now, the signatures by
        the batch the returned callable resolves."""
        if not beacons:
            return lambda: np.zeros(0, dtype=bool)
        ok_link = np.ones(len(beacons), dtype=bool)
        if not self.scheme.decouple_prev_sig:
            want_prev = anchor_prev_sig
            for i, b in enumerate(beacons):
                ok_link[i] = (b.previous_sig == want_prev)
                want_prev = b.signature
        pending = self.verify_beacons_async(beacons)
        return lambda: pending() & ok_link

    def verify_chain_segment(self, beacons: list[Beacon],
                             anchor_prev_sig: bytes) -> np.ndarray:
        """Contiguous rounds: linkage on the host and signatures on the
        device in one call.  Returns each beacon's validity."""
        return self.verify_chain_segment_async(beacons, anchor_prev_sig)()

    def verify_packed_segment_async(self, packed, anchor_prev_sig: bytes):
        """The columnar form of verify_chain_segment_async: `packed` is a
        chain.segment.PackedBeacons whose signatures stay in their (B,
        sig_len) matrix.  For chained schemes the linkage is structural:
        row i's prev is row i-1's sig and row 0's the caller's anchor (a
        server's advisory first_prev is never used), so the batch checks
        the chain the caller holds; an anchor of another length (round 1's
        genesis seed) puts row 0 alone in a bucket of its own.  Returns a
        zero-arg callable yielding bool[B]."""
        if not len(packed):
            return lambda: np.zeros(0, dtype=bool)
        if packed.sig_len != self.scheme.sig_len:
            return lambda: np.zeros(len(packed), dtype=bool)
        # the scheme, not the packed run's flag, decides the digest
        if self.scheme.decouple_prev_sig:
            return self._verifier.verify_batch_async(
                packed.rounds(), packed.sigs, None)
        anchor = np.frombuffer(anchor_prev_sig, dtype=np.uint8)
        return self._verifier.verify_chain_segment_async(
            packed.start_round, packed.sigs, anchor)
