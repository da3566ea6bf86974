"""Wire <-> model converters (counterpart of `drand_tpu/core/convert.py`,
drand `key/group.go`'s proto round trip and `chain/convert.go`):
identities, groups, chain info and beacons.

Both shapes of a SyncChain stream item: a BeaconPacket a beacon (what a
drand server sends), or a BeaconPacket carrying a SyncChunk, a run of
rounds with its signatures in one row-major blob (what a chunk-capable
server sends a client that asked for chunks).
"""

from __future__ import annotations

import numpy as np

from drand_tpu_torch.chain.beacon import Beacon
from drand_tpu_torch.chain.info import Info
from drand_tpu_torch.chain.scheme import DEFAULT_SCHEME_ID
from drand_tpu_torch.chain.segment import PackedBeacons
from drand_tpu_torch.common import DEFAULT_BEACON_ID
from drand_tpu_torch.key.group import Group, Node
from drand_tpu_torch.key.keys import DistPublic, Identity
from drand_tpu_torch.protogen import drand_pb2


def identity_to_proto(ident: Identity) -> drand_pb2.Identity:
    return drand_pb2.Identity(address=ident.address, key=ident.key,
                              tls=ident.tls, signature=ident.signature)


def identity_from_proto(p) -> Identity:
    return Identity(key=p.key, address=p.address, tls=p.tls,
                    signature=p.signature)


def group_to_proto(group: Group) -> drand_pb2.GroupPacket:
    pkt = drand_pb2.GroupPacket(
        threshold=group.threshold, period=group.period,
        genesis_time=group.genesis_time,
        transition_time=group.transition_time,
        genesis_seed=group.genesis_seed,
        catchup_period=group.catchup_period, schemeID=group.scheme_id)
    pkt.metadata.beaconID = group.beacon_id
    for n in sorted(group.nodes, key=lambda x: x.index):
        pkt.nodes.append(drand_pb2.Node(public=identity_to_proto(n),
                                        index=n.index))
    if group.public_key is not None:
        pkt.dist_key.extend(group.public_key.coefficients)
    return pkt


def group_from_proto(pkt: drand_pb2.GroupPacket) -> Group:
    nodes = [Node(key=n.public.key, address=n.public.address,
                  tls=n.public.tls, signature=n.public.signature,
                  index=n.index) for n in pkt.nodes]
    public = DistPublic(list(pkt.dist_key)) if pkt.dist_key else None
    return Group(
        threshold=pkt.threshold, period=pkt.period, nodes=nodes,
        genesis_time=pkt.genesis_time, genesis_seed=pkt.genesis_seed,
        transition_time=pkt.transition_time,
        catchup_period=pkt.catchup_period,
        scheme_id=pkt.schemeID or DEFAULT_SCHEME_ID,
        beacon_id=pkt.metadata.beaconID or DEFAULT_BEACON_ID,
        public_key=public)


def info_to_proto(info: Info) -> drand_pb2.ChainInfoPacket:
    pkt = drand_pb2.ChainInfoPacket(
        public_key=info.public_key, period=info.period,
        genesis_time=info.genesis_time, hash=info.hash(),
        groupHash=info.genesis_seed, schemeID=info.scheme_id)
    pkt.metadata.beaconID = info.beacon_id
    return pkt


def info_from_proto(pkt) -> Info:
    return Info(public_key=pkt.public_key, period=pkt.period,
                genesis_time=pkt.genesis_time, genesis_seed=pkt.groupHash,
                scheme_id=pkt.schemeID or DEFAULT_SCHEME_ID,
                beacon_id=pkt.metadata.beaconID or DEFAULT_BEACON_ID)


def beacon_to_packet(b: Beacon) -> drand_pb2.BeaconPacket:
    return drand_pb2.BeaconPacket(previous_sig=b.previous_sig,
                                  round=b.round, signature=b.signature)


def beacon_from_packet(p) -> Beacon:
    return Beacon(round=p.round, signature=p.signature,
                  previous_sig=p.previous_sig)


def packed_to_packet(packed: PackedBeacons) -> drand_pb2.BeaconPacket:
    """A PackedBeacons run as a BeaconPacket carrying a SyncChunk."""
    pkt = drand_pb2.BeaconPacket()
    pkt.chunk.start_round = packed.start_round
    pkt.chunk.count = len(packed)
    pkt.chunk.sig_len = packed.sig_len
    pkt.chunk.signatures = packed.sigs.tobytes()
    pkt.chunk.first_previous_sig = packed.first_prev
    pkt.chunk.chained = packed.chained
    return pkt


def item_to_packet(item) -> drand_pb2.BeaconPacket:
    """A SyncChain stream item (Beacon or PackedBeacons) in its wire form."""
    if isinstance(item, PackedBeacons):
        return packed_to_packet(item)
    return beacon_to_packet(item)


def packet_to_item(pkt):
    """A BeaconPacket as a Beacon, or as a PackedBeacons when it carries a
    chunk; a chunk whose blob is not count x sig_len bytes raises
    ValueError before any reshape."""
    if pkt.HasField("chunk"):
        c = pkt.chunk
        if c.count == 0 or c.sig_len == 0 or \
                len(c.signatures) != c.count * c.sig_len:
            raise ValueError(
                f"malformed sync chunk: count={c.count} sig_len={c.sig_len} "
                f"blob={len(c.signatures)}")
        sigs = np.frombuffer(c.signatures, dtype=np.uint8).reshape(
            c.count, c.sig_len)
        return PackedBeacons(start_round=c.start_round, sigs=sigs,
                             first_prev=c.first_previous_sig,
                             chained=c.chained)
    return beacon_from_packet(pkt)
