"""Serving and following a chain over drand's gRPC wire (counterpart of
the parts of `drand_tpu/core/` a follower and the peer it follows need):

  convert.py   wire <-> model converters (chain info, beacons, chunks)
  process.py   `ServingProcess`, one chain store and its `Info` served
  services.py  the Protocol (SyncChain, Status) and Public (ChainInfo)
               services over serving processes
  follow.py    `chain_info_from_peers` and `follow_chain`

These modules need `grpc` and `protobuf`; nothing imports them when the
package loads.
"""
