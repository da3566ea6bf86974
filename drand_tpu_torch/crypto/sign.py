"""BLS signatures of the key store and the beacon engine (counterpart of
`drand_tpu/crypto/sign.py`'s `keygen`, `public_key`, `bls_sign` and
`bls_verify`, drand `key.AuthScheme`): keys on G1 (48 bytes
compressed), signatures on G2 (96 bytes compressed).

Signing and verifying go through the native host tier
(`drand_tpu_torch/native`): hash-to-G2, then the one-point G2 linear
combination, and the native two-pairing check; the bytes equal
drand_tpu's golden model.  A library that cannot be built raises
`native.NativeBuildError`.  drand_tpu's Schnorr scheme and its
G1-signature helpers are not ported.
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
