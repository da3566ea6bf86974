"""The gRPC services of a node (counterpart of `drand_tpu/core/services.py`):
the Protocol service (GetIdentity, PartialBeacon, SyncChain, Status and
the DKG's SignalDKGParticipant, PushDKGInfo, BroadcastDKG) and the
Public one (PublicRand, PublicRandStream, ChainInfo), over processes
keyed by beacon id (`core.process.ServingProcess` or `BeaconProcess`).

A request is routed by its metadata's beacon id (empty: the default
one), else by its chain hash through the map of chain hashes a daemon
keeps (`DrandDaemon.register_chain_hash`); no match answers NOT_FOUND.  drand_tpu's deadline shedding of late partials
(resilience), PrivateRand and Home are not ported: they answer
UNIMPLEMENTED.
"""

from __future__ import annotations

import grpc

from drand_tpu_torch.chain.segment import WIRE_CHUNK_DEFAULT
from drand_tpu_torch.common import canonical_beacon_id
from drand_tpu_torch.core import convert
from drand_tpu_torch.net.client import make_metadata
from drand_tpu_torch.protogen import drand_pb2


class _Demux:
    def __init__(self, processes: dict, chain_hashes: dict | None = None):
        """processes: beacon id -> process; chain_hashes: hex chain hash
        -> beacon id."""
        self.processes = processes
        self.chain_hashes = {} if chain_hashes is None else chain_hashes

    async def _process(self, request, context):
        md = getattr(request, "metadata", None)
        bid = canonical_beacon_id(md.beaconID if md is not None else "")
        bp = self.processes.get(bid)
        if bp is None and md is not None and md.chain_hash:
            bp = self.processes.get(
                self.chain_hashes.get(md.chain_hash.hex(), ""))
        if bp is None:
            await context.abort(grpc.StatusCode.NOT_FOUND,
                                f"no beacon process for id {bid!r}")
        return bp


def status_response(bp) -> drand_pb2.StatusResponse:
    """A process's status as the Protocol and Control services answer
    it."""
    st = bp.status()
    resp = drand_pb2.StatusResponse()
    resp.beacon.is_running = st["is_running"]
    resp.beacon.is_serving = st["is_serving"]
    resp.chain_store.is_empty = st["is_empty"]
    resp.chain_store.last_round = st["last_round"]
    resp.chain_store.length = st["length"]
    return resp


class ProtocolService(_Demux):
    async def GetIdentity(self, request, context):
        bp = await self._process(request, context)
        ident = (bp.keypair or bp.load_keypair()).public
        return drand_pb2.IdentityResponse(
            address=ident.address, key=ident.key, tls=ident.tls,
            signature=ident.signature,
            metadata=make_metadata(bp.beacon_id))

    async def PartialBeacon(self, request, context):
        bp = await self._process(request, context)
        await bp.process_partial(request.round, request.previous_sig,
                                 request.partial_sig)
        return drand_pb2.Empty()

    async def SyncChain(self, request, context):
        """The stored rounds from `from_round`, then the live tail; a
        client that asks for chunks (chunk_size > 0) gets packed runs of
        at most min(chunk_size, WIRE_CHUNK_DEFAULT) rounds, any other one
        a packet a beacon."""
        bp = await self._process(request, context)
        chunk = min(int(request.chunk_size), WIRE_CHUNK_DEFAULT)
        async for item in bp.sync_chain_source(request.from_round,
                                               chunk_size=chunk):
            yield convert.item_to_packet(item)

    async def Status(self, request, context):
        return status_response(await self._process(request, context))

    async def SignalDKGParticipant(self, request, context):
        bp = await self._process(request, context)
        if bp.setup_manager is None:
            await context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                                "no DKG setup in progress")
        await bp.setup_manager.on_signal(request)
        return drand_pb2.Empty()

    async def PushDKGInfo(self, request, context):
        bp = await self._process(request, context)
        if bp.setup_receiver is None:
            await context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                                "not expecting DKG info")
        await bp.setup_receiver.on_dkg_info(request)
        return drand_pb2.Empty()

    async def BroadcastDKG(self, request, context):
        bp = await self._process(request, context)
        if bp.dkg_board is None:
            await context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                                "no DKG in progress")
        await bp.dkg_board.on_incoming(request.dkg)
        return drand_pb2.Empty()


def _rand_response(bp, beacon) -> drand_pb2.PublicRandResponse:
    return drand_pb2.PublicRandResponse(
        round=beacon.round, signature=beacon.signature,
        previous_signature=beacon.previous_sig,
        randomness=beacon.randomness(),
        metadata=make_metadata(bp.beacon_id, bp.chain_info().hash()))


class PublicService(_Demux):
    async def PublicRand(self, request, context):
        """The beacon of `round`, or the tip when it is 0."""
        bp = await self._process(request, context)
        store = bp._store
        try:
            beacon = store.get(request.round) if request.round \
                else store.last()
        except Exception:
            await context.abort(grpc.StatusCode.NOT_FOUND,
                                f"no beacon for round {request.round}")
        return _rand_response(bp, beacon)

    async def PublicRandStream(self, request, context):
        """The stored beacons from `round` (none when it is 0), then each
        beacon stored later."""
        bp = await self._process(request, context)
        q = bp.subscribe_live()
        try:
            if request.round:
                for beacon in bp._store.iter_range(request.round):
                    yield _rand_response(bp, beacon)
            while True:
                yield _rand_response(bp, await q.get())
        finally:
            bp.unsubscribe_live(q)

    async def ChainInfo(self, request, context):
        bp = await self._process(request, context)
        return convert.info_to_proto(bp.chain_info())
