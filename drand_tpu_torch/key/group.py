"""The group: a network's configuration (counterpart of
`drand_tpu/key/group.py`, drand `key/group.go`): threshold, period,
scheme, beacon id, catch-up period, the nodes sorted by public key,
genesis and transition times, the genesis seed and the distributed public
key; its TOML form, its canonical blake2b-256 hash (the genesis seed of a
fresh group) and its chain info."""

from __future__ import annotations

import hashlib
import struct
from dataclasses import dataclass

from drand_tpu_torch import toml_util
from drand_tpu_torch.chain.info import Info
from drand_tpu_torch.chain.scheme import DEFAULT_SCHEME_ID
from drand_tpu_torch.common import DEFAULT_BEACON_ID, canonical_beacon_id
from drand_tpu_torch.key.keys import DistPublic, Identity


def minimum_threshold(n: int) -> int:
    return n // 2 + 1


@dataclass
class Node(Identity):
    """An identity and its share index."""
    index: int = 0

    def to_dict(self) -> dict:
        d = super().to_dict()
        d["Index"] = self.index
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Node":
        return cls(key=bytes.fromhex(d["Key"]), address=d["Address"],
                   tls=bool(d.get("TLS", False)),
                   signature=bytes.fromhex(d.get("Signature", "")),
                   index=int(d.get("Index", 0)))


def _secs(v) -> int:
    """A TOML duration ("30s") or an integer, in seconds."""
    if isinstance(v, int):
        return v
    return int(str(v).rstrip("smh").split(".")[0]) \
        if str(v).endswith("s") else int(v)


@dataclass
class Group:
    threshold: int
    period: int                      # seconds
    nodes: list[Node]
    genesis_time: int = 0
    genesis_seed: bytes = b""
    transition_time: int = 0
    catchup_period: int = 0
    scheme_id: str = DEFAULT_SCHEME_ID
    beacon_id: str = DEFAULT_BEACON_ID
    public_key: DistPublic | None = None

    @staticmethod
    def sort_nodes(identities: list[Identity]) -> list[Node]:
        """Share indices by the order of the public keys' bytes."""
        ordered = sorted(identities, key=lambda n: (n.key, n.address))
        return [Node(key=i.key, address=i.address, tls=i.tls,
                     signature=i.signature, index=idx)
                for idx, i in enumerate(ordered)]

    def find(self, identity: Identity) -> Node | None:
        for n in self.nodes:
            if n.key == identity.key:
                return n
        return None

    def node(self, index: int) -> Node | None:
        for n in self.nodes:
            if n.index == index:
                return n
        return None

    @property
    def size(self) -> int:
        return len(self.nodes)

    def hash(self) -> bytes:
        """The canonical blake2b-256 group hash."""
        h = hashlib.blake2b(digest_size=32)
        for n in sorted(self.nodes, key=lambda x: x.index):
            h.update(struct.pack("<I", n.index))
            h.update(n.key)
        h.update(struct.pack("<I", self.threshold))
        h.update(struct.pack("<q", self.genesis_time))
        if self.transition_time:
            h.update(struct.pack("<q", self.transition_time))
        if self.public_key is not None:
            for c in self.public_key.coefficients:
                h.update(c)
        if self.scheme_id != DEFAULT_SCHEME_ID:
            h.update(self.scheme_id.encode())
        if canonical_beacon_id(self.beacon_id) != DEFAULT_BEACON_ID:
            h.update(self.beacon_id.encode())
        return h.digest()

    def get_genesis_seed(self) -> bytes:
        """The genesis seed: the group hash, kept once set."""
        if not self.genesis_seed:
            self.genesis_seed = self.hash()
        return self.genesis_seed

    def to_toml(self) -> str:
        doc: dict = {
            "Threshold": self.threshold,
            "Period": f"{self.period}s",
            "CatchupPeriod": f"{self.catchup_period}s",
            "GenesisTime": self.genesis_time,
            "TransitionTime": self.transition_time,
            "GenesisSeed": self.genesis_seed.hex(),
            "SchemeID": self.scheme_id,
            "ID": self.beacon_id,
            "Nodes": [n.to_dict() for n in self.nodes],
        }
        if self.public_key is not None:
            doc["PublicKey"] = {"Coefficients": self.public_key.to_list()}
        return toml_util.dumps(doc)

    @classmethod
    def from_toml(cls, text: str) -> "Group":
        d = toml_util.loads(text)
        pub = None
        if "PublicKey" in d:
            pub = DistPublic.from_list(d["PublicKey"]["Coefficients"])
        return cls(
            threshold=int(d["Threshold"]),
            period=_secs(d["Period"]),
            catchup_period=_secs(d.get("CatchupPeriod", 0)),
            genesis_time=int(d.get("GenesisTime", 0)),
            transition_time=int(d.get("TransitionTime", 0)),
            genesis_seed=bytes.fromhex(d.get("GenesisSeed", "")),
            scheme_id=d.get("SchemeID", DEFAULT_SCHEME_ID),
            beacon_id=d.get("ID", DEFAULT_BEACON_ID),
            nodes=[Node.from_dict(n) for n in d.get("Nodes", [])],
            public_key=pub,
        )

    def chain_info(self) -> Info:
        return Info(public_key=self.public_key.key_bytes(),
                    period=self.period, genesis_time=self.genesis_time,
                    genesis_seed=self.genesis_seed, scheme_id=self.scheme_id,
                    beacon_id=self.beacon_id)
