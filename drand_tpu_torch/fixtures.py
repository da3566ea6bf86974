"""Deterministic fixture keys, the committed chained test segment, the
path of the committed short-signature (G1) fixture, and batch signing on
the device (`sign_batch_g2`)."""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np
import torch

from drand_tpu_torch.crypto.bls12381 import curve as GC
from drand_tpu_torch.crypto.bls12381.constants import DST_G2, R
from drand_tpu_torch.device import resolve
from drand_tpu_torch.ops import curve as DC
from drand_tpu_torch.ops import h2c as DH
from drand_tpu_torch.ops import towers as T
from drand_tpu_torch.ops.sha256 import sha256

TESTDATA = Path(__file__).resolve().parent / "testdata"
CHAINED_FIXTURE = TESTDATA / "chained_65.npz"
# 16384 bls-unchained-g1-rfc9380 signatures of rounds 1..16384, 48 bytes
# each, by fixture_keypair_g2(); the name carries sha256(DST_G1)[:8] and
# sha256(compressed pk)[:8]
G1_FIXTURE = (Path(__file__).resolve().parents[1] / "aot" / "fixtures"
              / "bench_sigs_unchained_g1_16384_5b84a3cd_d7754ef6.npy")


def fixture_keypair(seed: bytes = b"drand-tpu-bench"):
    """The deterministic single-key '1-of-1 group' of drand_tpu's
    fixtures: sk from SHA-512 of the seed, pk = sk * G1 (Jacobian)."""
    sk = int.from_bytes(hashlib.sha512(b"drand-tpu-keygen" + seed).digest(),
                        "big") % R
    sk = sk or 1
    return sk, GC.g1_mul(GC.G1_GEN, sk)


def fixture_keypair_g2(seed: bytes = b"drand-tpu-bench-g1sig"):
    """The deterministic key of the short-signature fixtures: sk from
    SHA-512 of the seed, pk = sk * G2 (Jacobian; signatures on G1)."""
    sk = int.from_bytes(hashlib.sha512(b"drand-tpu-keygen-g2" + seed).digest(),
                        "big") % R
    sk = sk or 1
    return sk, GC.g2_mul_raw(GC.G2_GEN, sk)


def load_chained_fixture():
    """The committed 65-round pedersen-bls-chained segment from round 1:
    (sigs [65, 96] uint8, pk 48-byte compressed G1, genesis seed)."""
    with np.load(CHAINED_FIXTURE) as z:
        return z["sigs"], bytes(z["pk"]), bytes(z["genesis_seed"])


def sign_batch_g2(sk: int, msgs: np.ndarray, device=None) -> np.ndarray:
    """[B, L] uint8 messages -> [B, 96] compressed G2 signatures
    sk * H(sha256(msg)) under DST_G2 (the pedersen-bls-unchained signature
    of a round when msgs are its BE8 round numbers), for 1 <= sk < r:
    hash-to-curve, the scalar ladder and the affine conversion as one
    batch on `device.resolve(device)`, the compression on the host."""
    d = resolve(device)
    m = torch.from_numpy(np.ascontiguousarray(msgs, dtype=np.uint8)).to(d)
    h = DH.hash_to_g2(sha256(m), DST_G2)
    (x, y), _ = DC.point_to_affine(DC.point_mul_const(h, sk, DC.Fp2Ops),
                                   DC.Fp2Ops)
    x, y = tuple(c.cpu() for c in x), tuple(c.cpu() for c in y)
    out = np.empty((m.shape[0], 96), dtype=np.uint8)
    for i in range(m.shape[0]):
        out[i] = np.frombuffer(GC.g2_to_bytes(
            (T.fp2_decode(x, i), T.fp2_decode(y, i), (1, 0))), np.uint8)
    return out
