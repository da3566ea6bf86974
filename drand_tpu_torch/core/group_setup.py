"""DKG group setup (counterpart of `drand_tpu/core/group_setup.py`, drand
`core/group_setup.go`): the leader collects the participants'
identities through SignalDKGParticipant (gated by the setup secret),
builds the group once all have signalled, with genesis = now + 3 x the
DKG timeout + an offset, rounded up to the period, and pushes it to
them (PushDKGInfo); a participant waits for that group.  Secrets compare
by their sha256.  Fresh DKGs only: the reshare branch (a previous group)
is not ported.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging

from drand_tpu_torch.core import convert
from drand_tpu_torch.crypto import sign as S
from drand_tpu_torch.crypto.bls12381 import curve as C
from drand_tpu_torch.key.group import Group
from drand_tpu_torch.key.keys import Identity
from drand_tpu_torch.net.client import make_metadata
from drand_tpu_torch.protogen import drand_pb2

log = logging.getLogger("drand_tpu_torch.dkg")

# one PushDKGInfo call's limit (drand_tpu's)
PUSH_TIMEOUT_S = 10.0


def hash_secret(secret: bytes) -> bytes:
    return hashlib.sha256(secret).digest()


def compute_genesis(now: float, period: int, dkg_timeout: float,
                    beacon_offset: int = 0) -> int:
    """Room for the three DKG phases' timeouts and an operator offset,
    rounded up to a period boundary."""
    t = int(now + 3 * dkg_timeout + beacon_offset) + 1
    rem = t % period
    if rem:
        t += period - rem
    return t


class SetupManager:
    """The leader's side: collect the identities, build the group."""

    def __init__(self, leader_identity: Identity, expected: int,
                 threshold: int, period: int, catchup_period: int,
                 scheme_id: str, beacon_id: str, secret: bytes,
                 dkg_timeout: float, clock, beacon_offset: int = 0):
        self.expected = expected
        self.threshold = threshold
        self.period = period
        self.catchup_period = catchup_period
        self.scheme_id = scheme_id
        self.beacon_id = beacon_id
        self.secret_hash = hash_secret(secret)
        self.dkg_timeout = dkg_timeout
        self.clock = clock
        self.beacon_offset = beacon_offset
        self.identities: dict[bytes, Identity] = {}
        self._quorum = asyncio.Event()
        self.add_identity(leader_identity)

    def add_identity(self, ident: Identity) -> None:
        self.identities[ident.key] = ident
        if len(self.identities) >= self.expected:
            self._quorum.set()

    async def on_signal(self, request) -> None:
        """The SignalDKGParticipant handler."""
        if hash_secret(request.secret_proof) != self.secret_hash:
            raise ValueError("wrong setup secret")
        ident = convert.identity_from_proto(request.node)
        if not ident.is_valid_signature():
            raise ValueError("invalid identity self-signature")
        self.add_identity(ident)
        log.info("setup: %d/%d participants", len(self.identities),
                 self.expected)

    async def wait_group(self, timeout: float) -> Group:
        await asyncio.wait_for(self._quorum.wait(), timeout)
        return self.create_group()

    def create_group(self) -> Group:
        group = Group(
            threshold=self.threshold, period=self.period,
            nodes=Group.sort_nodes(list(self.identities.values())),
            genesis_time=compute_genesis(self.clock.now(), self.period,
                                         self.dkg_timeout,
                                         self.beacon_offset),
            catchup_period=self.catchup_period, scheme_id=self.scheme_id,
            beacon_id=self.beacon_id)
        group.get_genesis_seed()
        return group


class SetupReceiver:
    """A participant's side: wait for the leader's PushDKGInfo."""

    def __init__(self, secret: bytes, leader_key: bytes):
        self.secret_hash = hash_secret(secret)
        self.leader_key = leader_key
        self.group: Group | None = None
        self.dkg_timeout: float = 0
        self._got = asyncio.Event()

    async def on_dkg_info(self, request) -> None:
        if hash_secret(request.secret_proof) != self.secret_hash:
            raise ValueError("wrong setup secret in DKG info")
        group = convert.group_from_proto(request.new_group)
        # the leader's signature over the group hash proves provenance
        if request.signature and not S.bls_verify(
                C.g1_from_bytes(self.leader_key), group.hash(),
                request.signature):
            raise ValueError("bad leader signature on group")
        self.group = group
        self.dkg_timeout = float(request.dkg_timeout or 10)
        self._got.set()

    async def wait_group(self, timeout: float) -> tuple[Group, float]:
        await asyncio.wait_for(self._got.wait(), timeout)
        return self.group, self.dkg_timeout


async def push_dkg_info(peers, group: Group, leader_pair, secret: bytes,
                        dkg_timeout: float, own_address: str) -> None:
    """The leader sends the group to every other participant."""
    pkt = drand_pb2.DKGInfoPacket(
        new_group=convert.group_to_proto(group), secret_proof=secret,
        dkg_timeout=int(dkg_timeout),
        signature=S.bls_sign(leader_pair.secret, group.hash()),
        metadata=make_metadata(group.beacon_id))

    async def send(node):
        await peers.protocol(node.address).PushDKGInfo(
            pkt, timeout=PUSH_TIMEOUT_S)

    results = await asyncio.gather(
        *(send(n) for n in group.nodes if n.address != own_address),
        return_exceptions=True)
    failed = [r for r in results if isinstance(r, Exception)]
    if failed:
        raise RuntimeError(f"PushDKGInfo failed for {len(failed)} nodes: "
                           f"{failed[0]}")
