"""drand's gRPC wire for the port (counterpart of the parts of
`drand_tpu/net/` a node, a follower and the CLI need):

  rpc.py      servicers and client stubs built from the service
              descriptors, and the node-version gate
  client.py   request metadata, cached per-peer channels, the
              SyncChain/Status transport a SyncManager streams from,
              and the CLI's `ControlClient`
  gateway.py  the servers hosting the Protocol and Public services and,
              on 127.0.0.1, the Control service

These modules need `grpc` and `protobuf`; nothing imports them when the
package loads.
"""
