"""gRPC plumbing from the service descriptors (counterpart of
`drand_tpu/net/rpc.py`): servicers and client stubs are derived from
`drand.proto`'s service descriptors, with no generated `*_pb2_grpc`
module.  drand_tpu's server tracing span is not ported."""

from __future__ import annotations

import grpc
from google.protobuf import message_factory

from drand_tpu_torch.common import VERSION
from drand_tpu_torch.protogen import drand_pb2

_SERVICES = drand_pb2.DESCRIPTOR.services_by_name
_VERSION_ERR = "incompatible node version"


def _methods(service_name: str):
    for m in _SERVICES[service_name].methods:
        yield (m.name, message_factory.GetMessageClass(m.input_type),
               message_factory.GetMessageClass(m.output_type),
               m.server_streaming)


def _version_ok(req) -> bool:
    """A request whose metadata carries a node version must match this
    node's major.minor; a request without one passes (drand's
    NodeVersionValidator)."""
    try:
        md = getattr(req, "metadata", None)
        if md is None or not md.HasField("node_version"):
            return True
        v = md.node_version
    except Exception:
        return True
    return v.major == VERSION.major and v.minor == VERSION.minor


def _with_version_check(fn, streaming: bool):
    if streaming:
        async def stream_wrapped(req, ctx):
            if not _version_ok(req):
                await ctx.abort(grpc.StatusCode.FAILED_PRECONDITION,
                                _VERSION_ERR)
            async for item in fn(req, ctx):
                yield item
        return stream_wrapped

    async def unary_wrapped(req, ctx):
        if not _version_ok(req):
            await ctx.abort(grpc.StatusCode.FAILED_PRECONDITION, _VERSION_ERR)
        return await fn(req, ctx)
    return unary_wrapped


def service_handler(service_name: str, impl) -> grpc.GenericRpcHandler:
    """A generic handler for `impl`, an object with async methods named
    after the service's RPCs (a missing one answers UNIMPLEMENTED), each
    behind the node-version gate."""
    handlers = {}
    for name, req_cls, _resp, streaming in _methods(service_name):
        fn = getattr(impl, name, None)
        if fn is None:
            continue
        fn = _with_version_check(fn, streaming)
        make = (grpc.unary_stream_rpc_method_handler if streaming
                else grpc.unary_unary_rpc_method_handler)
        handlers[name] = make(
            fn, request_deserializer=req_cls.FromString,
            response_serializer=lambda m: m.SerializeToString())
    return grpc.method_handlers_generic_handler(
        f"drand.{service_name}", handlers)


class ServiceStub:
    """Client stub over a grpc.aio channel, its methods resolved on
    attribute access: `stub.SyncChain(req)`."""

    def __init__(self, channel, service_name: str):
        self._channel = channel
        self._service = service_name
        self._cache = {}
        self._meta = {n: (req, resp, stream)
                      for n, req, resp, stream in _methods(service_name)}

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self._meta:
            raise AttributeError(f"{self._service} has no RPC {name}")
        if name not in self._cache:
            _req, resp_cls, streaming = self._meta[name]
            path = f"/drand.{self._service}/{name}"
            make = (self._channel.unary_stream if streaming
                    else self._channel.unary_unary)
            self._cache[name] = make(
                path, request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=resp_cls.FromString)
        return self._cache[name]
