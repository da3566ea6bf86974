"""The Control service: the localhost operator plane behind the CLI
(counterpart of `drand_tpu/core/control.py`, drand
`core/drand_beacon_control.go` through the daemon's demux).

Served: PingPong, Status, InitDKG (a fresh DKG, `core/dkg_runner.py`),
Share, PublicKey, GroupFile and ChainInfo.  drand_tpu's InitReshare,
LoadBeacon, StartFollowChain, StartCheckChain, BackupDatabase,
RemoteStatus, Shutdown, ListSchemes, ListBeaconIDs and PrivateKey are
not ported: they answer UNIMPLEMENTED.
"""

from __future__ import annotations

import logging

import grpc

from drand_tpu_torch.common import DEFAULT_BEACON_ID
from drand_tpu_torch.core import convert
from drand_tpu_torch.core.services import _Demux, status_response
from drand_tpu_torch.net.client import make_metadata
from drand_tpu_torch.protogen import drand_pb2

log = logging.getLogger("drand_tpu_torch.core")


class ControlService(_Demux):
    def __init__(self, daemon):
        super().__init__(daemon.processes, daemon.chain_hashes)
        self.daemon = daemon

    async def PingPong(self, request, context):
        return drand_pb2.Pong(metadata=make_metadata(DEFAULT_BEACON_ID))

    async def Status(self, request, context):
        return status_response(await self._process(request, context))

    async def Share(self, request, context):
        bp = await self._process(request, context)
        if bp.share is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "no share")
        return drand_pb2.ShareResponse(
            index=bp.share.share_index(),
            share=bp.share.public().key_bytes(),
            metadata=make_metadata(bp.beacon_id))

    async def PublicKey(self, request, context):
        bp = await self._process(request, context)
        pair = bp.keypair or bp.load_keypair()
        return drand_pb2.PublicKeyResponse(
            pubKey=pair.public.key, metadata=make_metadata(bp.beacon_id))

    async def ChainInfo(self, request, context):
        bp = await self._process(request, context)
        if bp.info is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "no group")
        return convert.info_to_proto(bp.chain_info())

    async def GroupFile(self, request, context):
        bp = await self._process(request, context)
        if bp.group is None:
            await context.abort(grpc.StatusCode.NOT_FOUND, "no group")
        return convert.group_to_proto(bp.group)

    async def InitDKG(self, request, context):
        """Run a fresh DKG to its end; answers the new group."""
        bp = await self._process(request, context)
        from drand_tpu_torch.core.dkg_runner import run_init_dkg
        try:
            group = await run_init_dkg(self.daemon, bp, request)
        except Exception as exc:
            log.exception("InitDKG failed")
            await context.abort(grpc.StatusCode.INTERNAL,
                                f"dkg failed: {exc}")
        return convert.group_to_proto(group)
