"""Per-peer gRPC clients (counterpart of `drand_tpu/net/client.py`, drand
`net/client_grpc.go`): request metadata, one cached channel a peer, and
the SyncChain/Status transport a SyncManager streams from.

Plain TCP channels only (drand_tpu's TLS trust pools wait for its
`net/certs.py`); no retry hub, breakers, chaos failpoints, metrics or
trace context.  drand_tpu's `send_partial` and `ControlClient` belong to
a daemon, which the port does not have yet.  A grpc.aio channel is bound
to the event loop it was first used in: build, use and close a
PeerClients inside one loop.
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


def make_metadata(beacon_id: str) -> common_pb2.Metadata:
    """The Metadata every request carries: this node's version and the
    beacon id."""
    return common_pb2.Metadata(
        node_version=common_pb2.NodeVersion(
            major=VERSION.major, minor=VERSION.minor, patch=VERSION.patch),
        beaconID=beacon_id)


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
    """The Protocol service as a SyncManager's network: `sync_chain` and
    `status` of a peer (anything with an `address`)."""

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
