"""Chain verification on the GPU: the port's entry point.

Counterpart of `drand_tpu/verify.py` for the two G2-signature schemes
(`pedersen-bls-chained`, drand's default, and `pedersen-bls-unchained`):
`Verifier.verify_batch(rounds, sigs, prev_sigs) -> bool[B]` digests,
hashes to curve and pairing-checks B rounds in one pass over the batch,
padded to a small set of batch sizes.

Digest rules (drand `chain/verify.go`):
  chained   : msg = sha256(prev_sig || be64(round))
  unchained : msg = sha256(be64(round))
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from drand_tpu_torch.crypto.bls12381.constants import DST_G2
from drand_tpu_torch.device import resolve
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


@dataclass(frozen=True)
class SchemeShape:
    """Static wire shape of a scheme."""
    chained: bool          # prev_sig part of the digest
    dst: bytes


SHAPE_CHAINED = SchemeShape(chained=True, dst=DST_G2)
SHAPE_UNCHAINED = SchemeShape(chained=False, dst=DST_G2)


class Verifier:
    """Batched beacon verifier for one chain (public key + scheme shape).

    `public_key` is a golden-model G1 Jacobian point.  The verifier runs
    on the current CUDA device unless `device` names another (the tests
    pass device="cpu"); with no CUDA and no device named it raises."""

    def __init__(self, public_key, shape: SchemeShape, device=None):
        self._init(BLS.g1_affine_limbs(public_key), shape, device)

    @classmethod
    def from_pk_limbs(cls, pk_limbs, shape: SchemeShape, device=None):
        """Build from the affine public key as (x, y) [32] int32 canonical
        Montgomery limbs (the state `convert.from_drand_tpu` carries)."""
        self = cls.__new__(cls)
        self._init(pk_limbs, shape, device)
        return self

    def _init(self, pk_limbs, shape: SchemeShape, device):
        self.shape = shape
        self.device = resolve(device)
        self._pk = tuple(torch.as_tensor(c, dtype=torch.int32).to(self.device)
                         for c in pk_limbs)

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
        this one computes."""
        rounds = np.asarray(rounds, dtype=np.uint64)
        n = rounds.shape[0]
        if n == 0:
            return lambda: np.zeros(0, dtype=bool)
        msgs = self.messages(rounds, prev_sigs)
        sigs = np.asarray(sigs, dtype=np.uint8)
        m = bucket(n)
        if m != n:    # pad by repeating the last row
            msgs = np.concatenate([msgs, np.repeat(msgs[-1:], m - n, 0)])
            sigs = np.concatenate([sigs, np.repeat(sigs[-1:], m - n, 0)])
        msgs_t = torch.from_numpy(np.ascontiguousarray(msgs)).to(self.device)
        sigs_t = torch.from_numpy(np.ascontiguousarray(sigs)).to(self.device)
        ok = BLS.verify_g2_sigs(sha256(msgs_t), sigs_t, self._pk,
                                self.shape.dst)

        def resolve_():
            return ok[:n].cpu().numpy()
        return resolve_

    def verify_batch(self, rounds, sigs: np.ndarray,
                     prev_sigs: np.ndarray | None = None) -> np.ndarray:
        """rounds: int array [B]; sigs: [B, 96] uint8; prev_sigs: [B, 96]
        uint8 for the chained scheme.  Returns bool[B]."""
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
