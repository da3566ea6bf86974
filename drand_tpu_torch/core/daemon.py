"""The daemon (counterpart of `drand_tpu/core/daemon.py`, drand
`core/drand_daemon.go`): beacon processes by beacon id, chain hashes to
beacon ids, the private gRPC gateway (the Protocol and Public services),
the localhost control listener (the Control service, when
`Config.control_port` is set) and the beacons loaded from the
multibeacon folder.

drand_tpu's public HTTP, metrics, health watchdog, consistency prober,
TLS, resilience hub and chaos arming are not ported.
"""

from __future__ import annotations

import logging

import torch

from drand_tpu_torch.core.config import Config
from drand_tpu_torch.core.process import BeaconProcess
from drand_tpu_torch.core.services import ProtocolService, PublicService
from drand_tpu_torch.device import resolve
from drand_tpu_torch.key.store import FileStore
from drand_tpu_torch.net.client import PeerClients
from drand_tpu_torch.net.gateway import ControlListener, PrivateGateway

log = logging.getLogger("drand_tpu_torch.core")


class DrandDaemon:
    def __init__(self, config: Config | None = None):
        self.config = config or Config()
        self.processes: dict[str, BeaconProcess] = {}
        self.chain_hashes: dict[str, str] = {}      # hex hash -> beacon id
        self.peers = PeerClients()
        self.protocol_service = ProtocolService(self.processes,
                                                self.chain_hashes)
        self.public_service = PublicService(self.processes, self.chain_hashes)
        self.private_gateway: PrivateGateway | None = None
        self.control_listener: ControlListener | None = None

    async def start(self) -> None:
        """Take the configured device (a node without its card fails here,
        and the card's first use is paid before any ceremony or round),
        bind and start the private gateway, then the control listener
        when the configuration names a control port."""
        dev = resolve(self.config.device)
        if dev.type == "cuda":
            torch.zeros(1, device=dev)
        self.private_gateway = PrivateGateway(
            self.config.private_listen, self.protocol_service,
            self.public_service)
        await self.private_gateway.start()
        if self.config.control_port is not None:
            from drand_tpu_torch.core.control import ControlService
            self.control_listener = ControlListener(
                ControlService(self), self.config.control_port)
            await self.control_listener.start()
        log.info("daemon up: private=%s", self.private_addr())

    def private_addr(self) -> str:
        host = self.config.private_listen.rsplit(":", 1)[0]
        return f"{host}:{self.private_gateway.port}"

    async def stop(self) -> None:
        for bp in self.processes.values():
            bp.stop()
        if self.control_listener is not None:
            await self.control_listener.stop()
            self.control_listener = None
        if self.private_gateway is not None:
            await self.private_gateway.stop()
            self.private_gateway = None
        await self.peers.close()

    def instantiate(self, beacon_id: str) -> BeaconProcess:
        bp = BeaconProcess(beacon_id, self.config,
                           FileStore(self.config.folder, beacon_id),
                           peers=self.peers)
        self.processes[beacon_id] = bp
        return bp

    def register_chain_hash(self, bp: BeaconProcess) -> None:
        """Route requests that name `bp`'s chain by its hash."""
        self.chain_hashes[bp.chain_info().hash().hex()] = bp.beacon_id

    async def load_beacons_from_disk(self) -> list[str]:
        """Every beacon folder with a group: load it and start its engine
        (catch-up start: genesis may have passed); a folder with a key
        pair alone waits for a DKG."""
        loaded = []
        for beacon_id in FileStore.list_beacon_ids(self.config.folder):
            bp = self.instantiate(beacon_id)
            if bp.load():
                self.register_chain_hash(bp)
                await bp.start(catchup=True)
                loaded.append(beacon_id)
            else:
                log.info("beacon %s: key pair only, waiting for a DKG",
                         beacon_id)
        return loaded
