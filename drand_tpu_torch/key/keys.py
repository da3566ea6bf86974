"""Key pairs, identities, shares and distributed public keys (counterpart
of `drand_tpu/key/keys.py`, drand `key/keys.go`).  Identity keys live on
G1 (48 bytes compressed); an identity's self-signature is BLS on G2 over
sha256(address || key)."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from drand_tpu_torch.crypto import sign as S
from drand_tpu_torch.crypto.bls12381 import curve as C
from drand_tpu_torch.crypto.poly import PriShare, PubPoly


@dataclass
class Identity:
    """The public identity of a node."""
    key: bytes                 # compressed G1 public key (48 bytes)
    address: str
    tls: bool = False
    signature: bytes = b""     # BLS self-signature over hash(addr || key)

    def point(self):
        return C.g1_from_bytes(self.key)

    def _auth_msg(self) -> bytes:
        return hashlib.sha256(self.address.encode() + self.key).digest()

    def is_valid_signature(self) -> bool:
        try:
            return S.bls_verify(self.point(), self._auth_msg(),
                                self.signature)
        except Exception:
            return False

    def to_dict(self) -> dict:
        return {"Address": self.address, "Key": self.key.hex(),
                "TLS": self.tls, "Signature": self.signature.hex()}

    @classmethod
    def from_dict(cls, d: dict) -> "Identity":
        return cls(key=bytes.fromhex(d["Key"]), address=d["Address"],
                   tls=bool(d.get("TLS", False)),
                   signature=bytes.fromhex(d.get("Signature", "")))


@dataclass
class Pair:
    """A node's long-term key pair."""
    secret: int
    public: Identity

    @classmethod
    def generate(cls, address: str, tls: bool = False,
                 seed: bytes | None = None) -> "Pair":
        sk, pk = S.keygen(seed)
        pair = cls(secret=sk, public=Identity(key=C.g1_to_bytes(pk),
                                              address=address, tls=tls))
        pair.self_sign()
        return pair

    def self_sign(self) -> None:
        self.public.signature = S.bls_sign(self.secret,
                                           self.public._auth_msg())

    def to_dict(self) -> dict:
        return {"Key": format(self.secret, "064x"),
                "Public": self.public.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "Pair":
        return cls(secret=int(d["Key"], 16),
                   public=Identity.from_dict(d["Public"]))


@dataclass
class DistPublic:
    """The distributed public key: commitments to the group polynomial;
    coefficients[0] is the group's public key."""
    coefficients: list[bytes]  # compressed G1 points

    def key_bytes(self) -> bytes:
        return self.coefficients[0]

    def key_point(self):
        return C.g1_from_bytes(self.coefficients[0])

    def pub_poly(self) -> PubPoly:
        return PubPoly([C.g1_from_bytes(c) for c in self.coefficients])

    def to_list(self) -> list[str]:
        return [c.hex() for c in self.coefficients]

    @classmethod
    def from_list(cls, items: list[str]) -> "DistPublic":
        return cls([bytes.fromhex(x) for x in items])


@dataclass
class Share:
    """A node's output of a DKG: the group commitments and its private
    share."""
    commits: list[bytes]       # compressed G1 commitments
    pri_share: PriShare

    def public(self) -> DistPublic:
        return DistPublic(list(self.commits))

    def share_index(self) -> int:
        return self.pri_share.index

    def to_dict(self) -> dict:
        return {"Commits": [c.hex() for c in self.commits],
                "Index": self.pri_share.index,
                "Share": format(self.pri_share.value, "064x")}

    @classmethod
    def from_dict(cls, d: dict) -> "Share":
        return cls(commits=[bytes.fromhex(c) for c in d["Commits"]],
                   pri_share=PriShare(int(d["Index"]), int(d["Share"], 16)))
