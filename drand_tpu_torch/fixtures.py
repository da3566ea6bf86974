"""Deterministic fixture keys, the committed chained test segment and the
path of the committed short-signature (G1) fixture."""

from __future__ import annotations

import hashlib
from pathlib import Path

import numpy as np

from drand_tpu_torch.crypto.bls12381 import curve as GC
from drand_tpu_torch.crypto.bls12381.constants import R

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
