"""Scheme-aware beacon verification: `ChainVerifier` (counterpart of
`drand_tpu/chain/verify.py`).

One (scheme, public key) bound to one device, with two tiers as in the
reference: small work on the host through the native C++ tier
(`drand_tpu_torch/native`), throughput on the card through the port's
`Verifier`.  `verify_beacon`, every batch of at most `_HOST_VERIFY_MAX`
rows and a larger batch's irregular rows (round 1's 32-byte genesis prev,
a signature of the wrong length) verify on the host; every larger batch
is one `Verifier` batch on the device, padded to `verify.BUCKETS`.
Unlike the reference, a small batch takes the host whether or not a card
batch ran before: the port compiles nothing to amortise, and a card batch
of any size costs a full batch's host issue.  Linkage of a chained
segment (each previous_sig equals the preceding signature) is checked on
the host.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np

from drand_tpu_torch import native
from drand_tpu_torch.chain.beacon import Beacon
from drand_tpu_torch.chain.scheme import Scheme
from drand_tpu_torch.crypto.bls12381 import curve as GC
from drand_tpu_torch.verify import Verifier

# batches of at most this many rows verify on the host (latency path)
_HOST_VERIFY_MAX = 32


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

    def verify_beacon(self, beacon: Beacon) -> bool:
        """Single-beacon check on the host through the native tier: the
        latency path (a live round, a genesis-anchored round 1).  A
        signature or key of the wrong length is false; a library that
        cannot be built raises `native.NativeBuildError`."""
        msg = self.digest_message(beacon.round, beacon.previous_sig)
        shape = self.scheme.shape
        check = native.verify_g1 if shape.sig_on_g1 else native.verify_g2
        return check(self.public_key_bytes, msg, beacon.signature, shape.dst)

    def verify_beacons_async(self, beacons: list[Beacon]):
        """Issue a batch verify without waiting; returns a zero-arg callable
        that waits and yields bool[B].

        A batch of at most _HOST_VERIFY_MAX rows verifies on the host now.
        In a larger one, beacons of irregular shape (a chained beacon whose
        previous signature has another length, as round 1's 32-byte
        genesis seed; a signature of the wrong length) verify on the host,
        after the regular rest is issued as one verify of its own (on the
        device unless it too is small)."""
        if not beacons:
            return lambda: np.zeros(0, dtype=bool)
        if len(beacons) <= _HOST_VERIFY_MAX:
            out = np.array([self.verify_beacon(b) for b in beacons],
                           dtype=bool)
            return lambda: out
        sig_len = self.scheme.sig_len
        chained = not self.scheme.decouple_prev_sig
        regular = [i for i, b in enumerate(beacons)
                   if len(b.signature) == sig_len
                   and (not chained or len(b.previous_sig) == sig_len)]
        if len(regular) < len(beacons):
            pending = self.verify_beacons_async(
                [beacons[i] for i in regular]) if regular else None
            out = np.zeros(len(beacons), dtype=bool)
            taken = set(regular)
            for i, b in enumerate(beacons):
                if i not in taken:
                    out[i] = self.verify_beacon(b)

            def resolve():
                if pending is not None:
                    out[np.asarray(regular)] = pending()
                return out

            return resolve
        rounds = np.array([b.round for b in beacons], dtype=np.uint64)
        sigs = np.stack([np.frombuffer(b.signature, np.uint8)
                         for b in beacons])
        prev = None
        if chained:
            prev = np.stack([np.frombuffer(b.previous_sig, np.uint8)
                             for b in beacons])
        return self._verifier.verify_batch_async(rounds, sigs, prev)

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
        """Contiguous rounds: linkage on the host and signatures by
        `verify_beacons_async` in one call.  Returns each beacon's
        validity."""
        return self.verify_chain_segment_async(beacons, anchor_prev_sig)()

    def verify_packed_segment_async(self, packed, anchor_prev_sig: bytes):
        """The columnar form of verify_chain_segment_async: `packed` is a
        chain.segment.PackedBeacons whose signatures stay in their (B,
        sig_len) matrix.  For chained schemes the linkage is structural:
        row i's prev is row i-1's sig and row 0's the caller's anchor (a
        server's advisory first_prev is never used), so the batch checks
        the chain the caller holds; an anchor of another length (round 1's
        genesis seed) puts row 0 alone in a bucket of its own.  A run of
        at most _HOST_VERIFY_MAX rows verifies on the host, as beacons
        rebuilt on the anchor.  Returns a zero-arg callable yielding
        bool[B]."""
        if not len(packed):
            return lambda: np.zeros(0, dtype=bool)
        if packed.sig_len != self.scheme.sig_len:
            return lambda: np.zeros(len(packed), dtype=bool)
        if len(packed) <= _HOST_VERIFY_MAX:
            return self.verify_chain_segment_async(
                packed.beacons(anchor_sig=anchor_prev_sig), anchor_prev_sig)
        # the scheme, not the packed run's flag, decides the digest
        if self.scheme.decouple_prev_sig:
            return self._verifier.verify_batch_async(
                packed.rounds(), packed.sigs, None)
        anchor = np.frombuffer(anchor_prev_sig, dtype=np.uint8)
        return self._verifier.verify_chain_segment_async(
            packed.start_round, packed.sigs, anchor)
