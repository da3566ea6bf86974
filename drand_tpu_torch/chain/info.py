"""Chain info, the public description of a chain (counterpart of
`drand_tpu/chain/info.py`, drand `chain/info.go`).

Its hash is the root of trust a follower pins (`--chain-hash`): sha256
over the period (BE32), the genesis time (BE64), the group public key
and the genesis seed, then the beacon id when it is not the default one.
The scheme id is not hashed, as in drand.  `to_json` is drand_tpu's JSON
form (its HTTP `/info`, here what `cli show chain-info` prints); the
port serves no HTTP and reads no JSON form.
"""

from __future__ import annotations

import hashlib
import json
import struct
from dataclasses import dataclass

from drand_tpu_torch.chain.scheme import DEFAULT_SCHEME_ID
from drand_tpu_torch.common import DEFAULT_BEACON_ID, canonical_beacon_id


@dataclass
class Info:
    public_key: bytes          # compressed group public key
    period: int                # seconds
    genesis_time: int          # unix seconds
    genesis_seed: bytes
    scheme_id: str = DEFAULT_SCHEME_ID
    beacon_id: str = DEFAULT_BEACON_ID

    def hash(self) -> bytes:
        h = hashlib.sha256()
        h.update(struct.pack(">I", self.period))
        h.update(struct.pack(">q", self.genesis_time))
        h.update(self.public_key)
        h.update(self.genesis_seed)
        if canonical_beacon_id(self.beacon_id) != DEFAULT_BEACON_ID:
            h.update(self.beacon_id.encode())
        return h.digest()

    def hash_hex(self) -> str:
        return self.hash().hex()

    def to_json(self) -> bytes:
        return json.dumps({
            "public_key": self.public_key.hex(),
            "period": self.period,
            "genesis_time": self.genesis_time,
            "hash": self.hash_hex(),
            "groupHash": self.genesis_seed.hex(),
            "schemeID": self.scheme_id,
            "metadata": {"beaconID": self.beacon_id},
        }, sort_keys=True).encode()
