"""BLS signatures of the key store and the beacon engine (counterpart of
`drand_tpu/crypto/sign.py`'s `keygen`, `public_key`, `bls_sign`,
`bls_verify`, `schnorr_sign` and `schnorr_verify`, drand
`key.AuthScheme`): keys on G1 (48 bytes compressed), signatures on G2
(96 bytes compressed); the DKG's bundle signatures are Schnorr over G1
(80 bytes), on the golden model.

Signing and verifying go through the native host tier
(`drand_tpu_torch/native`): hash-to-G2, then the one-point G2 linear
combination, and the native two-pairing check; the bytes equal
drand_tpu's golden model.  A library that cannot be built raises
`native.NativeBuildError`.  drand_tpu's G1-signature helpers are not
ported.
"""

from __future__ import annotations

import hashlib
import secrets

from drand_tpu_torch import native
from drand_tpu_torch.crypto.bls12381 import curve as C
from drand_tpu_torch.crypto.bls12381.constants import DST_G2, R

# sk * H(msg) at sk = 0 mod r: the native combination has no compressed
# form for infinity, the golden model's is this one
_G2_INF_BYTES = C.g2_to_bytes(C.G2_INF)


def keygen(seed: bytes | None = None) -> tuple[int, tuple]:
    """(secret scalar, G1 public key); deterministic when seed is given."""
    if seed is None:
        sk = secrets.randbelow(R - 1) + 1
    else:
        sk = int.from_bytes(hashlib.sha512(b"drand-tpu-keygen" + seed)
                            .digest(), "big") % R
        sk = sk or 1
    return sk, C.g1_mul(C.G1_GEN, sk)


def public_key(sk: int) -> tuple:
    return C.g1_mul(C.G1_GEN, sk)


def bls_sign(sk: int, msg: bytes) -> bytes:
    """sigma = sk * H2(msg), the 96-byte compressed G2 signature."""
    h = native.hash_to_g2(msg, DST_G2)
    out = native.g2_lincomb([h], [(sk % R).to_bytes(32, "big")])
    return _G2_INF_BYTES if out is None else out


def bls_verify(pub, msg: bytes, sig: bytes) -> bool:
    """e(g1, sigma) == e(pub, H2(msg)) for pub a G1 point; a signature
    that does not decode or lies outside G2 is false."""
    return native.verify_g2(C.g1_to_bytes(pub), msg, sig, DST_G2)


def _schnorr_challenge(r_bytes: bytes, pub_bytes: bytes, msg: bytes) -> int:
    return int.from_bytes(hashlib.sha512(
        b"drand-tpu-schnorr" + r_bytes + pub_bytes + msg).digest(),
        "big") % R


def schnorr_sign(sk: int, msg: bytes) -> bytes:
    """sig = R compressed (48 bytes) || s (32 bytes big-endian), with
    s = k + sk * h mod r."""
    k = secrets.randbelow(R - 1) + 1
    r_bytes = C.g1_to_bytes(C.g1_mul(C.G1_GEN, k))
    pub_bytes = C.g1_to_bytes(C.g1_mul(C.G1_GEN, sk))
    h = _schnorr_challenge(r_bytes, pub_bytes, msg)
    return r_bytes + ((k + sk * h) % R).to_bytes(32, "big")


def schnorr_verify(pub, msg: bytes, sig: bytes) -> bool:
    """s * G == R + h * pub."""
    if len(sig) != 80:
        return False
    try:
        r_pt = C.g1_from_bytes(sig[:48])
    except ValueError:
        return False
    s = int.from_bytes(sig[48:], "big")
    if s >= R:
        return False
    h = _schnorr_challenge(sig[:48], C.g1_to_bytes(pub), msg)
    rhs = C.point_add(r_pt, C.g1_mul(pub, h), C.FP_OPS)
    return C.g1_eq(C.g1_mul(C.G1_GEN, s), rhs)
