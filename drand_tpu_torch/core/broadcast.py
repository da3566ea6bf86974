"""Echo broadcast of DKG packets (counterpart of
`drand_tpu/core/broadcast.py`, drand `core/broadcast.go`): a best-effort
reliable broadcast.  On first sight of a packet that the protocol
accepts, it is echoed once to every peer (dedup on the packet's digest);
signatures are checked by the protocol before acceptance; each peer has
its own bounded queue drained by one sender task.

The board joins three forms of a bundle: the `DkgProtocol`'s, the
dkg.proto packet and the Protocol.BroadcastDKG call.  Each send is one
attempt under `SEND_BUDGET_S`, as the port's `send_partial` is one
attempt under its call timeout; the echo overlay re-delivers through
other peers.  drand_tpu's resilience hub (retries and breakers), its
`dkg.fanout` failpoint and its `QUEUE_DROPPED` counter are not ported: a
packet dropped on a full queue is logged only.  Before a ceremony
closes its board it waits, at most `SEND_BUDGET_S`, for its queues to
drain (`drain`), where drand_tpu abandons them at once: with one attempt
a send, a node's own last bundle would otherwise be lost to a slower
peer.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging

from drand_tpu_torch.crypto import dkg as dkgm
from drand_tpu_torch.net.client import make_metadata
from drand_tpu_torch.protogen import dkg_pb2, drand_pb2

log = logging.getLogger("drand_tpu_torch.dkg")


# -- wire conversion --------------------------------------------------------

def bundle_to_proto(b) -> dkg_pb2.Packet:
    pkt = dkg_pb2.Packet()
    if isinstance(b, dkgm.DealBundle):
        d = pkt.deal
        d.dealer_index = b.dealer_index
        d.commits.extend(b.commits)
        for deal in b.deals:
            d.deals.append(dkg_pb2.Deal(share_index=deal.share_index,
                                        encrypted_share=deal.encrypted_share))
        d.session_id = b.session_id
        d.signature = b.signature
    elif isinstance(b, dkgm.ResponseBundle):
        r = pkt.response
        r.share_index = b.share_index
        for resp in b.responses:
            r.responses.append(dkg_pb2.Response(dealer_index=resp.dealer_index,
                                                status=resp.status))
        r.session_id = b.session_id
        r.signature = b.signature
    elif isinstance(b, dkgm.JustificationBundle):
        j = pkt.justification
        j.dealer_index = b.dealer_index
        for ju in b.justifications:
            j.justifications.append(dkg_pb2.Justification(
                share_index=ju.share_index,
                share=ju.share.to_bytes(32, "big")))
        j.session_id = b.session_id
        j.signature = b.signature
    else:
        raise TypeError(type(b))
    return pkt


def bundle_from_proto(pkt: dkg_pb2.Packet):
    kind = pkt.WhichOneof("Bundle")
    if kind == "deal":
        d = pkt.deal
        return dkgm.DealBundle(
            dealer_index=d.dealer_index, commits=list(d.commits),
            deals=[dkgm.Deal(share_index=x.share_index,
                             encrypted_share=x.encrypted_share)
                   for x in d.deals],
            session_id=d.session_id, signature=d.signature)
    if kind == "response":
        r = pkt.response
        return dkgm.ResponseBundle(
            share_index=r.share_index,
            responses=[dkgm.Response(dealer_index=x.dealer_index,
                                     status=x.status) for x in r.responses],
            session_id=r.session_id, signature=r.signature)
    if kind == "justification":
        j = pkt.justification
        return dkgm.JustificationBundle(
            dealer_index=j.dealer_index,
            justifications=[dkgm.Justification(
                share_index=x.share_index,
                share=int.from_bytes(x.share, "big"))
                for x in j.justifications],
            session_id=j.session_id, signature=j.signature)
    raise ValueError("empty dkg packet")


class EchoBroadcast:
    """The DKG board: our bundles out, the peers' in, each accepted
    packet echoed once."""

    # one send's limit: an echo that has not landed in 10 s is outrun by
    # the protocol's own phase timeout
    SEND_BUDGET_S = 10.0
    # a peer's queue depth: a phase makes at most n bundles, each echoed
    # once; a slower peer sheds echoes rather than growing memory
    QUEUE_CAP = 256

    def __init__(self, protocol: "dkgm.DkgProtocol", peers, nodes,
                 own_address: str, beacon_id: str = "default"):
        """peers: net.client.PeerClients; nodes: the identities to fan
        out to (our own address is left out)."""
        self.protocol = protocol
        self.peers = peers
        self.own_address = own_address
        self.nodes = [n for n in nodes if n.address != own_address]
        self.beacon_id = beacon_id
        self._seen: set[bytes] = set()
        self.fresh = asyncio.Event()     # set when a new bundle lands
        self._queues: dict[str, asyncio.Queue] = {}
        self._senders: dict[str, asyncio.Task] = {}
        self._closed = False

    async def broadcast(self, bundle) -> None:
        """Send our own bundle to every peer (and accept it here)."""
        self._accept(bundle)
        self._fanout(bundle_to_proto(bundle))

    async def on_incoming(self, pkt: dkg_pb2.Packet) -> None:
        """The BroadcastDKG entry: dedup, check, deliver, echo once."""
        digest = hashlib.sha256(
            pkt.SerializeToString(deterministic=True)).digest()
        if digest in self._seen:
            return
        self._seen.add(digest)
        try:
            bundle = bundle_from_proto(pkt)
        except Exception:
            return
        if self._accept(bundle):
            self._fanout(pkt)

    def _accept(self, bundle) -> bool:
        p = self.protocol
        if isinstance(bundle, dkgm.DealBundle):
            ok = p.receive_deal_bundle(bundle)
        elif isinstance(bundle, dkgm.ResponseBundle):
            ok = p.receive_response_bundle(bundle)
        else:
            ok = p.receive_justification_bundle(bundle)
        if ok:
            self.fresh.set()
        return ok

    def _fanout(self, pkt: dkg_pb2.Packet) -> None:
        req = drand_pb2.DKGPacket(dkg=pkt,
                                  metadata=make_metadata(self.beacon_id))
        for node in self.nodes:
            self._enqueue(node, req)

    def _enqueue(self, node, req) -> None:
        if self._closed:
            return
        q = self._queues.get(node.address)
        if q is None:
            q = asyncio.Queue(maxsize=self.QUEUE_CAP)
            self._queues[node.address] = q
            self._senders[node.address] = \
                asyncio.get_running_loop().create_task(self._sender(node, q))
        try:
            q.put_nowait(req)
        except asyncio.QueueFull:
            log.debug("dkg fanout queue to %s full, packet dropped",
                      node.address)

    async def _sender(self, node, q: asyncio.Queue) -> None:
        """Drain one peer's queue in order; a slow peer never blocks the
        others or the broadcasting task."""
        while True:
            req = await q.get()
            try:
                await self._send_one(node, req)
            finally:
                q.task_done()

    async def _send_one(self, node, req) -> None:
        try:
            await self.peers.protocol(node.address).BroadcastDKG(
                req, timeout=self.SEND_BUDGET_S)
        except Exception as exc:
            log.debug("dkg fanout to %s failed: %s", node.address, exc)

    async def drain(self, limit: float) -> None:
        """Wait, at most `limit` seconds, until every peer's queue is
        sent.  A node whose phase closed may still hold its own last
        bundle in a queue behind echoes to a slower peer, and no other
        node has it to echo: closing at once would leave that peer's
        phase to time out."""
        joins = [asyncio.ensure_future(q.join())
                 for q in self._queues.values()]
        if joins:
            _, pending = await asyncio.wait(joins, timeout=limit)
            for j in pending:
                j.cancel()

    def close(self) -> None:
        """Stop the sender tasks; echoes still queued are abandoned."""
        self._closed = True
        for t in self._senders.values():
            t.cancel()
        self._senders.clear()
        self._queues.clear()
