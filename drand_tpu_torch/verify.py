"""Chain verification on the GPU: the port's entry point.

Counterpart of `drand_tpu/verify.py` for the two G2-signature schemes
(`pedersen-bls-chained`, drand's default, and `pedersen-bls-unchained`)
and the short-signature scheme `bls-unchained-g1-rfc9380` (signatures on
G1, the key on G2: drand's quicknet):
`Verifier.verify_batch(rounds, sigs, prev_sigs) -> bool[B]` digests,
hashes to curve and pairing-checks B rounds in one pass over the batch,
padded to a small set of batch sizes.

Digest rules (drand `chain/verify.go`):
  chained   : msg = sha256(prev_sig || be64(round))
  unchained : msg = sha256(be64(round))
"""

from __future__ import annotations

import time

import numpy as np
import torch

from drand_tpu_torch.chain.scheme import (  # noqa: F401 (re-exported)
    SHAPE_CHAINED, SHAPE_UNCHAINED, SHAPE_UNCHAINED_G1, SchemeShape)
from drand_tpu_torch.device import resolve
from drand_tpu_torch.dispatch import record_dispatch
from drand_tpu_torch.ops import bls as BLS
from drand_tpu_torch.ops.sha256 import sha256

# Batch buckets: a request is padded up to the nearest size (the largest,
# 16384, is the catch-up sync chunk).
BUCKETS = (8, 64, 512, 4096, 16384)


def bucket(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return -(-n // BUCKETS[-1]) * BUCKETS[-1]


def rounds_be8(rounds: np.ndarray) -> np.ndarray:
    """uint64 rounds -> [B, 8] big-endian bytes."""
    return np.asarray(rounds, dtype=">u8").view(np.uint8).reshape(-1, 8)




class Verifier:
    """Batched beacon verifier for one chain (public key + scheme shape).

    `public_key` is a golden-model Jacobian point: on G1 for the
    G2-signature schemes, on G2 for the short-signature scheme
    (`shape.sig_on_g1`).  The verifier runs on the current CUDA device
    unless `device` names another (the tests pass device="cpu"); with no
    CUDA and no device named it raises."""

    def __init__(self, public_key, shape: SchemeShape, device=None):
        limbs = (BLS.g2_affine_limbs(public_key) if shape.sig_on_g1
                 else BLS.g1_affine_limbs(public_key))
        self._init(limbs, shape, device)

    @classmethod
    def from_pk_limbs(cls, pk_limbs, shape: SchemeShape, device=None):
        """Build from the affine public key in int32 canonical Montgomery
        limbs (the state `convert.from_drand_tpu` carries): (x, y), each
        [32], for a G1 key; ((x0, x1), (y0, y1)), each [32], for the G2
        key of a `sig_on_g1` shape."""
        self = cls.__new__(cls)
        self._init(pk_limbs, shape, device)
        return self

    def _init(self, pk_limbs, shape: SchemeShape, device):
        self.shape = shape
        self.device = resolve(device)

        def coord(c):
            if isinstance(c, (tuple, list)) and len(c) == 2:
                raise ValueError("an Fp2 pair where a [32] limb coordinate "
                                 "belongs: a G2 key needs a sig_on_g1 shape")
            t = torch.as_tensor(c, dtype=torch.int32)
            if t.shape != (32,):
                raise ValueError(f"expected a [32] limb coordinate, got "
                                 f"{tuple(t.shape)}")
            return t.to(self.device)

        pk_limbs = tuple(pk_limbs)
        if len(pk_limbs) != 2:
            raise ValueError("expected the affine key (x, y)")
        if shape.sig_on_g1:
            self._pk = tuple(tuple(coord(c) for c in xy) for xy in pk_limbs)
            if any(len(xy) != 2 for xy in self._pk):
                raise ValueError("a G2 key is ((x0, x1), (y0, y1))")
        else:
            self._pk = tuple(coord(c) for c in pk_limbs)

    @property
    def pk_limbs(self):
        return self._pk

    def messages(self, rounds: np.ndarray,
                 prev_sigs: np.ndarray | None) -> np.ndarray:
        be = rounds_be8(rounds)
        if self.shape.chained:
            if prev_sigs is None:
                raise ValueError("chained scheme needs previous signatures")
            return np.concatenate([np.asarray(prev_sigs, np.uint8), be], 1)
        return be

    def verify_batch_async(self, rounds, sigs: np.ndarray,
                           prev_sigs: np.ndarray | None = None):
        """Queue a batched verify without waiting for the device.

        Returns a zero-arg callable that waits and yields bool[B].  The
        call returns once the host has issued the whole batch; the device
        runs behind it, so a caller can prepare the next segment while
        this one computes.  The first call of the resolver records
        ("verify", n, bucket, issue + resolve seconds) in the dispatch
        feed (`dispatch.py`)."""
        rounds = np.asarray(rounds, dtype=np.uint64)
        n = rounds.shape[0]
        if n == 0:
            return lambda: np.zeros(0, dtype=bool)
        msgs = self.messages(rounds, prev_sigs)
        sigs = np.asarray(sigs, dtype=np.uint8)
        if sigs.shape != (n, self.shape.sig_len):
            raise ValueError(f"expected [{n}, {self.shape.sig_len}] "
                             f"signatures, got {sigs.shape}")
        m = bucket(n)
        if m != n:    # pad by repeating the last row
            msgs = np.concatenate([msgs, np.repeat(msgs[-1:], m - n, 0)])
            sigs = np.concatenate([sigs, np.repeat(sigs[-1:], m - n, 0)])
        t0 = time.perf_counter()
        ok = self.verify_on_device(msgs, sigs)
        dispatch_s = time.perf_counter() - t0
        recorded = [False]    # a resolver may be called again: record once

        def resolve_():
            t1 = time.perf_counter()
            out = ok[:n].cpu().numpy()
            if not recorded[0]:
                recorded[0] = True
                # issue plus the wait in .cpu(); the gap the caller leaves
                # before resolving is overlap, not charged here
                record_dispatch("verify", n, m,
                                dispatch_s + (time.perf_counter() - t1))
            return out
        return resolve_

    def verify_on_device(self, msgs: np.ndarray, sigs: np.ndarray,
                         merged=None) -> torch.Tensor:
        """Issue the check of a whole batch, messages [B, L] and signatures
        [B, sig_len] uint8 as they stand (no padding), and return its bool
        [B] tensor on the verifier's device without waiting: sha256 of each
        message, then the scheme's BLS check (`ops/bls.py` verify_g2_sigs
        or verify_g1_sigs), with the Miller executor `merged` chooses
        there."""
        msgs_t = torch.from_numpy(np.ascontiguousarray(msgs)).to(self.device)
        sigs_t = torch.from_numpy(
            np.ascontiguousarray(sigs, dtype=np.uint8)).to(self.device)
        check = (BLS.verify_g1_sigs if self.shape.sig_on_g1
                 else BLS.verify_g2_sigs)
        return check(sha256(msgs_t), sigs_t, self._pk, self.shape.dst,
                     merged=merged)

    def verify_batch(self, rounds, sigs: np.ndarray,
                     prev_sigs: np.ndarray | None = None) -> np.ndarray:
        """rounds: int array [B]; sigs: [B, sig_len] uint8; prev_sigs:
        [B, sig_len] uint8 for a chained scheme.  Returns bool[B]."""
        return self.verify_batch_async(rounds, sigs, prev_sigs)()

    def verify_chain_segment_async(self, start_round: int, sigs: np.ndarray,
                                   anchor_prev_sig: np.ndarray):
        """Queue the verify of a contiguous chained segment [start_round,
        start_round+B) without waiting for the device: the previous
        signature of element i is sigs[i-1], of element 0 the anchor.
        Returns a zero-arg callable that waits and yields bool[B]; every
        batch of the segment is issued when this returns.

        The anchor may have another length than a signature (round 1
        links to the 32-byte genesis seed): that first element's message
        is sha256(anchor || be64(start_round)), of another length than
        the rest, so it goes alone, one row in a bucket of its own on the
        verifier's device, and the rest batches against sigs[0]; both
        batches are issued before either is resolved."""
        sigs = np.asarray(sigs, dtype=np.uint8)
        anchor = np.asarray(anchor_prev_sig, dtype=np.uint8)
        n = sigs.shape[0]
        if n == 0:
            return lambda: np.zeros(0, dtype=bool)
        rounds = np.arange(start_round, start_round + n, dtype=np.uint64)
        if anchor.shape[0] == sigs.shape[1]:
            prev = np.concatenate([anchor[None], sigs[:-1]], 0)
            return self.verify_batch_async(rounds, sigs, prev)
        first = self.verify_batch_async(rounds[:1], sigs[:1], anchor[None])
        rest = self.verify_batch_async(rounds[1:], sigs[1:], sigs[:-1])
        return lambda: np.concatenate([first(), rest()])

    def verify_chain_segment(self, start_round: int, sigs: np.ndarray,
                             anchor_prev_sig: np.ndarray) -> np.ndarray:
        """The blocking form of `verify_chain_segment_async`: bool[B]."""
        return self.verify_chain_segment_async(start_round, sigs,
                                               anchor_prev_sig)()
