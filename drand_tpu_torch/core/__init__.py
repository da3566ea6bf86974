"""A node's chains over drand's gRPC wire (counterpart of the parts of
`drand_tpu/core/` a beacon node, its DKG and a follower need):

  config.py       `Config`, a daemon's folder, listen address, control
                  port, DKG timeout, clock, device
  daemon.py       `DrandDaemon`, the private gateway, the control
                  listener and the beacons on disk
  process.py      `ServingProcess` (one chain store served) and
                  `BeaconProcess` (its key material, beacon engine and
                  DKG state)
  services.py     the Protocol and Public services over the processes
  control.py      the Control service (the CLI's, on 127.0.0.1)
  dkg_runner.py   a fresh DKG end to end: setup, ceremony, harvest
  group_setup.py  the leader's collection of participants, the group
  broadcast.py    the DKG's echo broadcast and its wire form
  convert.py      wire <-> model converters (identities, groups, chain
                  info, beacons, chunks)
  follow.py       `chain_info_from_peers`, `follow_chain`, `check_chain`

These modules need `grpc` and `protobuf` (config.py excepted); nothing
imports them when the package loads.
"""
