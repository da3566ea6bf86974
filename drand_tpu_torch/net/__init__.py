"""drand's gRPC wire for the port (counterpart of the parts of
`drand_tpu/net/` a follower and the peer it follows need):

  rpc.py      servicers and client stubs built from the service
              descriptors, and the node-version gate
  client.py   request metadata, cached per-peer channels, the
              SyncChain/Status transport a SyncManager streams from
  gateway.py  the server hosting the Protocol and Public services

These modules need `grpc` and `protobuf`; nothing imports them when the
package loads.
"""
