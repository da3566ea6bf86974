"""ECIES over BLS12-381 G1 (counterpart of `drand_tpu/crypto/ecies.py`,
kyber's ecies): the DKG's deal encryption (`seal`, `open_sealed`) and
the private-randomness request and reply pair.

Scheme: an ephemeral key pair (e, E = e*G1); the shared point S = e*PK
(sender) = sk*E (receiver); key = sha256(compressed(S)); AES-256-GCM with
a zero nonce (every key is single-use: a fresh ephemeral a box).  The
boxes are byte-compatible with drand_tpu's both ways.

AES-GCM is the `cryptography` package's, the one implementation the
port keeps (drand_tpu falls back to a pure-Python copy when the package
is missing; the port does not).
"""

from __future__ import annotations

import hashlib
import json
import secrets

from cryptography.hazmat.primitives.ciphers.aead import AESGCM

from drand_tpu_torch.crypto.bls12381 import curve as C
from drand_tpu_torch.crypto.bls12381.constants import R

_NONCE = bytes(12)


def _kdf(shared_point) -> bytes:
    return hashlib.sha256(C.g1_to_bytes(shared_point)).digest()


def _ephemeral() -> int:
    return secrets.randbelow(R - 1) + 1


def seal(recipient_pub, payload: bytes) -> bytes:
    """One-shot seal to a G1 public key: ephemeral public key (48 bytes)
    || AES-GCM box."""
    esk = _ephemeral()
    shared = C.g1_mul(recipient_pub, esk)
    return C.g1_to_bytes(C.g1_mul(C.G1_GEN, esk)) + \
        AESGCM(_kdf(shared)).encrypt(_NONCE, payload, b"")


def open_sealed(secret: int, blob: bytes) -> bytes:
    shared = C.g1_mul(C.g1_from_bytes(blob[:48]), secret)
    return AESGCM(_kdf(shared)).decrypt(_NONCE, blob[48:], b"")


def encode_request(node_public) -> tuple[bytes, int]:
    """Client side: (the wire request, the ephemeral secret)."""
    esk = _ephemeral()
    return C.g1_to_bytes(C.g1_mul(C.G1_GEN, esk)), esk


def decode(request: bytes):
    """Node side: the ephemeral public key of a request."""
    return C.g1_from_bytes(request)


def encrypt_reply(node_secret: int, ephemeral_pub, payload: bytes) -> bytes:
    key = _kdf(C.g1_mul(ephemeral_pub, node_secret))
    sealed = AESGCM(key).encrypt(_NONCE, payload, b"")
    return json.dumps({"box": sealed.hex()}).encode()


def decrypt_reply(ephemeral_secret: int, node_public, reply: bytes) -> bytes:
    """Client side: open the sealed reply with the shared secret."""
    pk = C.g1_from_bytes(node_public) if isinstance(node_public, bytes) \
        else node_public
    key = _kdf(C.g1_mul(pk, ephemeral_secret))
    sealed = bytes.fromhex(json.loads(reply.decode())["box"])
    return AESGCM(key).decrypt(_NONCE, sealed, b"")
