"""A node's chains over drand's gRPC wire (counterpart of the parts of
`drand_tpu/core/` a beacon node and a follower need):

  config.py    `Config`, a daemon's folder, listen address, clock, device
  daemon.py    `DrandDaemon`, the private gateway and the beacons on disk
  process.py   `ServingProcess` (one chain store served) and
               `BeaconProcess` (its key material and beacon engine)
  services.py  the Protocol and Public services over the processes
  convert.py   wire <-> model converters (chain info, beacons, chunks)
  follow.py    `chain_info_from_peers`, `follow_chain`, `check_chain`

These modules need `grpc` and `protobuf` (config.py excepted); nothing
imports them when the package loads.
"""
