"""A fresh DKG end to end (counterpart of `drand_tpu/core/dkg_runner.py`,
drand `core/drand_beacon_control.go` runDKG with its fast-sync phaser
and `core/drand_beacon.go` WaitDKG): the leader's or a participant's
setup, the ceremony over the echo broadcast, and the harvest: the
group with its distributed key and this node's share saved, and the
beacon engine built and started for genesis.

The ceremony's commitment checks run on the daemon's device
(`Config.device`: the card unless "cpu"), see `crypto/dkg.py`, in a
worker thread: the event loop goes on taking the peers' bundles (a
BroadcastDKG call is one attempt of at most 10 s, and a process's first
card call can take longer).
drand_tpu's reshare (`run_init_reshare`), its DKG state metrics, phase
histograms and tracing spans are not ported.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
from dataclasses import dataclass, field

from drand_tpu_torch.core import convert
from drand_tpu_torch.core.broadcast import EchoBroadcast
from drand_tpu_torch.core.group_setup import (SetupManager, SetupReceiver,
                                              push_dkg_info)
from drand_tpu_torch.crypto import dkg as dkgm
from drand_tpu_torch.crypto.bls12381 import curve as C
from drand_tpu_torch.key.group import Group
from drand_tpu_torch.key.keys import DistPublic, Share
from drand_tpu_torch.net.client import make_metadata
from drand_tpu_torch.protogen import drand_pb2

log = logging.getLogger("drand_tpu_torch.dkg")

# the leader's identity and the participant's signal: one call each
SETUP_CALL_TIMEOUT_S = 10.0
# a DKG phase's timeout when InitDKG names none (drand's default)
DEFAULT_DKG_TIMEOUT_S = 10.0


def session_nonce(group: Group) -> bytes:
    """The session id every participant derives from the group it was
    given, so bundles cannot be replayed across ceremonies."""
    return hashlib.sha256(b"drand-dkg-session" + group.hash()).digest()


def _dkg_nodes(group: Group) -> list[dkgm.DkgNode]:
    return [dkgm.DkgNode(index=n.index, public=C.g1_from_bytes(n.key),
                         address=n.address)
            for n in sorted(group.nodes, key=lambda x: x.index)]


@dataclass
class PhaseOutcome:
    """How one phase closed."""
    phase: str           # deal | response | justification
    outcome: str         # complete | timeout
    have: int            # bundles in hand when the phase closed
    want: int            # bundles the fast-sync path waited for
    duration_s: float

    def to_dict(self) -> dict:
        return {"phase": self.phase, "outcome": self.outcome,
                "have": self.have, "want": self.want,
                "duration_s": round(self.duration_s, 6)}


@dataclass
class CeremonyStatus:
    """One ceremony as it runs and after (`BeaconProcess.dkg_status`)."""
    beacon_id: str
    n_nodes: int = 0
    threshold: int = 0
    state: str = "in_progress"   # in_progress | done | failed
    phases: list[PhaseOutcome] = field(default_factory=list)
    qual: list[int] = field(default_factory=list)
    error: str = ""

    def to_dict(self) -> dict:
        return {"beacon_id": self.beacon_id,
                "n_nodes": self.n_nodes, "threshold": self.threshold,
                "state": self.state,
                "phases": [p.to_dict() for p in self.phases],
                "qual": list(self.qual), "error": self.error}


async def _wait_phase(board, phase: str, have, want: int,
                      timeout: float) -> PhaseOutcome:
    """The fast-sync phaser: the phase closes as soon as all expected
    bundles are in, else at its timeout."""
    loop = asyncio.get_running_loop()
    start = loop.time()
    deadline = start + timeout
    outcome = "complete"
    while have() < want:
        remaining = deadline - loop.time()
        if remaining <= 0:
            outcome = "timeout"
            break
        board.fresh.clear()
        if have() >= want:      # landed between the check and the clear
            break
        try:
            await asyncio.wait_for(board.fresh.wait(), remaining)
        except asyncio.TimeoutError:
            outcome = "timeout"
            break
    res = PhaseOutcome(phase=phase, outcome=outcome, have=have(),
                       want=want, duration_s=loop.time() - start)
    if outcome == "timeout":
        log.warning("dkg %s phase timed out with %d/%d bundles",
                    phase, res.have, res.want)
    return res


def extract_entropy(request):
    """The request's EntropyInfo as a callable n -> bytes, or None: the
    user script's output XOR-mixed with the OS CSPRNG unless userOnly."""
    ei = getattr(request, "entropy", None)
    if ei is None or not ei.script:
        return None
    from drand_tpu_torch import entropy as ent
    reader = ent.ScriptReader(ei.script)
    user_only = bool(ei.userOnly)
    return lambda n: ent.get_random(reader, n, user_only)


async def run_ceremony(bp, group: Group, dkg_timeout: float, entropy=None):
    """One fresh ceremony over the echo broadcast.  Returns this node's
    key.Share, or None when too few dealers qualified for it."""
    new_nodes = _dkg_nodes(group)
    conf = dkgm.DkgConfig(longterm=bp.keypair.secret, new_nodes=new_nodes,
                          threshold=group.threshold,
                          nonce=session_nonce(group), entropy=entropy)
    status = CeremonyStatus(beacon_id=bp.beacon_id,
                            n_nodes=len(new_nodes),
                            threshold=group.threshold)
    bp.dkg_status = status
    protocol = dkgm.DkgProtocol(conf, device=bp.config.device)
    board = EchoBroadcast(protocol, bp.peers, group.nodes,
                          bp.keypair.public.address, bp.beacon_id)
    bp.dkg_board = board
    n = len(new_nodes)
    try:
        deal = protocol.make_deal_bundle()
        if deal is not None:
            await board.broadcast(deal)
        status.phases.append(await _wait_phase(
            board, "deal", lambda: len(protocol.deals), n, dkg_timeout))
        # the deal checks (the card call) run off the event loop, which
        # goes on taking the peers' responses meanwhile
        resp = await asyncio.to_thread(protocol.make_response_bundle)
        if resp is not None:
            await board.broadcast(resp)
        status.phases.append(await _wait_phase(
            board, "response", lambda: len(protocol.responses), n,
            dkg_timeout))
        # justifications only when someone complained, and only from the
        # accused dealers that dealt (one gone before the deal phase can
        # never answer)
        complaints = protocol.complaints()
        if complaints:
            jb = protocol.make_justification_bundle()
            if jb is not None:
                await board.broadcast(jb)
            accused = {d for d in complaints if d in protocol.deals}
            status.phases.append(await _wait_phase(
                board, "justification",
                lambda: sum(1 for d in accused if d in protocol.justifs),
                len(accused), dkg_timeout))
        status.qual, result = await asyncio.to_thread(
            lambda: (protocol.qual(), protocol.finalize()))
        await board.drain(board.SEND_BUDGET_S)
    except BaseException as exc:
        status.state = "failed"
        status.error = repr(exc)
        raise
    finally:
        board.close()
        bp.dkg_board = None
    if result is None:
        status.state = "failed"
        status.error = f"below threshold: qual={status.qual!r}"
        return None
    status.state = "done"
    return Share(commits=[C.g1_to_bytes(c) for c in result.commits],
                 pri_share=result.pri_share)


def _harvest(bp, group: Group, share: Share | None) -> Group:
    """The distributed key into the group; the group and share saved and
    the engine built over them."""
    if share is not None:
        group.public_key = DistPublic(list(share.commits))
    bp.set_group(group, share)
    return group


async def run_init_dkg(daemon, bp, request) -> Group:
    """The Control service's InitDKG: the leader's or a participant's
    path by `request.info.leader`, then the ceremony, the harvest and
    the engine's start for genesis."""
    info = request.info
    bp.load_keypair()
    secret = info.secret
    timeout = float(info.timeout or DEFAULT_DKG_TIMEOUT_S)
    if info.leader:
        manager = SetupManager(
            leader_identity=bp.keypair.public, expected=info.nodes,
            threshold=info.threshold, period=request.beacon_period or 30,
            catchup_period=request.catchup_period,
            scheme_id=request.schemeID or "pedersen-bls-chained",
            beacon_id=bp.beacon_id, secret=secret, dkg_timeout=timeout,
            clock=daemon.config.clock, beacon_offset=info.beacon_offset)
        bp.setup_manager = manager
        try:
            group = await manager.wait_group(timeout * 6 + 60)
            await push_dkg_info(bp.peers, group, bp.keypair, secret,
                                timeout, bp.keypair.public.address)
        finally:
            bp.setup_manager = None
    else:
        leader_stub = bp.peers.protocol(info.leader_address)
        md = make_metadata(bp.beacon_id)
        leader = await leader_stub.GetIdentity(
            drand_pb2.IdentityRequest(metadata=md),
            timeout=SETUP_CALL_TIMEOUT_S)
        receiver = SetupReceiver(secret, leader.key)
        bp.setup_receiver = receiver
        try:
            await leader_stub.SignalDKGParticipant(
                drand_pb2.SignalDKGPacket(
                    node=convert.identity_to_proto(bp.keypair.public),
                    secret_proof=secret, metadata=md),
                timeout=SETUP_CALL_TIMEOUT_S)
            group, timeout = await receiver.wait_group(timeout * 6 + 60)
        finally:
            bp.setup_receiver = None
    share = await run_ceremony(bp, group, timeout,
                               entropy=extract_entropy(request))
    group = _harvest(bp, group, share)
    daemon.register_chain_hash(bp)
    await bp.start(catchup=False)
    return group
