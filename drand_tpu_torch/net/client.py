"""Per-peer gRPC clients (counterpart of `drand_tpu/net/client.py`, drand
`net/client_grpc.go`): request metadata, one cached channel a peer, and
the SyncChain/Status transport a SyncManager streams from.

`GrpcBeaconNetwork` is also the beacon Handler's transport
(`send_partial`: one attempt under the call timeout) and asks a peer for
its identity (`get_identity`).  Plain TCP channels only (drand_tpu's TLS
trust pools wait for its `net/certs.py`); no retry hub, breakers,
deadline stamp, chaos failpoints, metrics or trace context.
`ControlClient` is the CLI's client of a daemon's Control service on
127.0.0.1.  A grpc.aio channel is bound to the event loop it was first
used in: build, use and close a PeerClients or a ControlClient inside
one loop.
"""

from __future__ import annotations

from dataclasses import dataclass

import grpc.aio

from drand_tpu_torch.chain.segment import WIRE_CHUNK_DEFAULT
from drand_tpu_torch.common import DEFAULT_BEACON_ID, VERSION
from drand_tpu_torch.core import convert
from drand_tpu_torch.net.gateway import DEFAULT_TIMEOUT_S
from drand_tpu_torch.net.rpc import ServiceStub
from drand_tpu_torch.protogen import common_pb2, drand_pb2


@dataclass(frozen=True)
class Peer:
    """A node to sync from: its gRPC address, "host:port"."""
    address: str


def make_metadata(beacon_id: str,
                  chain_hash: bytes = b"") -> common_pb2.Metadata:
    """The Metadata every request and PublicRand answer carries: this
    node's version, the beacon id and, on an answer, the chain hash."""
    return common_pb2.Metadata(
        node_version=common_pb2.NodeVersion(
            major=VERSION.major, minor=VERSION.minor, patch=VERSION.patch),
        beaconID=beacon_id, chain_hash=chain_hash)


class PeerClients:
    """One cached channel a peer address."""

    def __init__(self):
        self._channels: dict[str, grpc.aio.Channel] = {}
        self.timeout_s = DEFAULT_TIMEOUT_S

    def channel(self, address: str) -> grpc.aio.Channel:
        if address not in self._channels:
            self._channels[address] = grpc.aio.insecure_channel(address)
        return self._channels[address]

    def protocol(self, address: str) -> ServiceStub:
        return ServiceStub(self.channel(address), "Protocol")

    def public(self, address: str) -> ServiceStub:
        return ServiceStub(self.channel(address), "Public")

    async def close(self):
        for ch in self._channels.values():
            await ch.close()
        self._channels.clear()


class GrpcBeaconNetwork:
    """The Protocol service as a Handler's and a SyncManager's network:
    `send_partial`, `sync_chain`, `status` and `get_identity` of a peer
    (anything with an `address`)."""

    def __init__(self, peers: PeerClients,
                 beacon_id: str = DEFAULT_BEACON_ID):
        self.peers = peers
        self.beacon_id = beacon_id

    async def sync_chain(self, node, from_round: int):
        """The peer's SyncChain stream from `from_round`, asking for
        chunks of WIRE_CHUNK_DEFAULT rounds: Beacon items from a server
        that sends one a packet (drand's), PackedBeacons from one that
        chunks."""
        stub = self.peers.protocol(node.address)
        req = drand_pb2.SyncRequest(from_round=from_round,
                                    chunk_size=WIRE_CHUNK_DEFAULT,
                                    metadata=make_metadata(self.beacon_id))
        async for pkt in stub.SyncChain(req):
            yield convert.packet_to_item(pkt)

    async def status(self, node) -> dict:
        stub = self.peers.protocol(node.address)
        resp = await stub.Status(
            drand_pb2.StatusRequest(metadata=make_metadata(self.beacon_id)),
            timeout=self.peers.timeout_s)
        return {
            "beacon": {"is_running": resp.beacon.is_running,
                       "is_serving": resp.beacon.is_serving},
            "chain_store": {"last_round": resp.chain_store.last_round,
                            "length": resp.chain_store.length,
                            "is_empty": resp.chain_store.is_empty},
        }

    async def send_partial(self, node, packet) -> None:
        """One PartialBeacon call carrying `packet` (a beacon.chain
        PartialPacket), under the call timeout."""
        req = drand_pb2.PartialBeaconPacket(
            round=packet.round, previous_sig=packet.previous_signature,
            partial_sig=packet.partial_sig,
            metadata=make_metadata(packet.beacon_id))
        await self.peers.protocol(node.address).PartialBeacon(
            req, timeout=self.peers.timeout_s)

    async def get_identity(self, address: str):
        return await self.peers.protocol(address).GetIdentity(
            drand_pb2.IdentityRequest(metadata=make_metadata(self.beacon_id)),
            timeout=self.peers.timeout_s)


class ControlClient:
    """The localhost Control service of a daemon, as the CLI calls it:
    `client.stub.InitDKG(req, timeout=...)`."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        self._channel = grpc.aio.insecure_channel(f"{host}:{port}")
        self.stub = ServiceStub(self._channel, "Control")

    async def close(self):
        await self._channel.close()
