"""The gRPC servers of a node (counterpart of `drand_tpu/net/gateway.py`,
drand `net/gateway.go`, `net/control.go`): `PrivateGateway`, the
Protocol and Public services its peers call, and `ControlListener`, the
Control service on 127.0.0.1 for the operator's CLI, each behind the
node-version gate.  Plain TCP only: drand_tpu's TLS certificates and its
metrics service are not ported."""

from __future__ import annotations

import grpc.aio

from drand_tpu_torch.net.rpc import service_handler

# the default call timeout (drand `net/client_grpc.go`)
DEFAULT_TIMEOUT_S = 60.0


def _server():
    return grpc.aio.server(options=[
        ("grpc.max_send_message_length", 32 * 1024 * 1024),
        ("grpc.max_receive_message_length", 32 * 1024 * 1024),
    ])


class PrivateGateway:
    """Protocol and Public services on `bind_addr` ("host:port"; port 0
    picks a free one, read back from `.port`).  Build, start and stop it
    inside one event loop."""

    def __init__(self, bind_addr: str, protocol_impl, public_impl):
        self.bind_addr = bind_addr
        self.server = _server()
        self.server.add_generic_rpc_handlers((
            service_handler("Protocol", protocol_impl),
            service_handler("Public", public_impl)))
        self.port = self.server.add_insecure_port(bind_addr)

    async def start(self):
        await self.server.start()

    async def stop(self):
        await self.server.stop(0)


class ControlListener:
    """The Control service on `host`:`port` (127.0.0.1 unless named;
    port 0 picks a free one, read back from `.port`).  Build, start and
    stop it inside one event loop."""

    def __init__(self, control_impl, port: int, host: str = "127.0.0.1"):
        self.server = _server()
        self.server.add_generic_rpc_handlers(
            (service_handler("Control", control_impl),))
        self.port = self.server.add_insecure_port(f"{host}:{port}")

    async def start(self):
        await self.server.start()

    async def stop(self):
        await self.server.stop(0)
