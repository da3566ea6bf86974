"""The gRPC services a follower calls (counterpart of
`drand_tpu/core/services.py` `ProtocolService.SyncChain`, `.Status` and
`PublicService.ChainInfo`), over serving processes keyed by beacon id.

A request is routed by its metadata's beacon id (empty: the default
one), else by its chain hash; no match answers NOT_FOUND.  drand_tpu's
other RPCs (partials, DKG, PublicRand, PublicRandStream, PrivateRand,
Home) need a beacon engine the port does not have yet: they answer
UNIMPLEMENTED.
"""

from __future__ import annotations

import grpc

from drand_tpu_torch.chain.segment import WIRE_CHUNK_DEFAULT
from drand_tpu_torch.common import canonical_beacon_id
from drand_tpu_torch.core import convert
from drand_tpu_torch.protogen import drand_pb2


class _Demux:
    def __init__(self, processes: dict):
        """processes: beacon id -> ServingProcess."""
        self.processes = processes

    async def _process(self, request, context):
        md = getattr(request, "metadata", None)
        bid = canonical_beacon_id(md.beaconID if md is not None else "")
        bp = self.processes.get(bid)
        if bp is None and md is not None and md.chain_hash:
            bp = next((p for p in self.processes.values()
                       if p.chain_info().hash() == md.chain_hash), None)
        if bp is None:
            await context.abort(grpc.StatusCode.NOT_FOUND,
                                f"no beacon process for id {bid!r}")
        return bp


class ProtocolService(_Demux):
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
        bp = await self._process(request, context)
        st = bp.status()
        resp = drand_pb2.StatusResponse()
        resp.beacon.is_running = st["is_running"]
        resp.beacon.is_serving = st["is_serving"]
        resp.chain_store.is_empty = st["is_empty"]
        resp.chain_store.last_round = st["last_round"]
        resp.chain_store.length = st["length"]
        return resp


class PublicService(_Demux):
    async def ChainInfo(self, request, context):
        bp = await self._process(request, context)
        return convert.info_to_proto(bp.chain_info())
