"""Beacon model: one round of the chain and its JSON form (counterpart of
`drand_tpu/chain/beacon.py`, drand `chain/beacon.go`)."""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass

GENESIS_ROUND = 0


@dataclass
class Beacon:
    """One round of the chain.

    round: monotonically increasing round number (genesis = 0);
    signature: the threshold BLS signature over the round digest;
    previous_sig: signature of round - 1 (empty for unchained schemes).
    """
    round: int
    signature: bytes
    previous_sig: bytes = b""

    def randomness(self) -> bytes:
        """sha256(signature): the public random value."""
        return hashlib.sha256(self.signature).digest()

    def to_json(self) -> bytes:
        return json.dumps({
            "round": self.round,
            "signature": self.signature.hex(),
            "previous_sig": self.previous_sig.hex(),
        }, sort_keys=True).encode()

    @classmethod
    def from_json(cls, data: bytes) -> "Beacon":
        d = json.loads(data)
        return cls(round=int(d["round"]),
                   signature=bytes.fromhex(d["signature"]),
                   previous_sig=bytes.fromhex(d.get("previous_sig", "")))

    def equal(self, other: "Beacon") -> bool:
        return (self.round == other.round and self.signature == other.signature
                and self.previous_sig == other.previous_sig)


def genesis_beacon(genesis_seed: bytes) -> Beacon:
    """Round 0, 'signed' with the genesis seed."""
    return Beacon(round=GENESIS_ROUND, signature=genesis_seed, previous_sig=b"")
