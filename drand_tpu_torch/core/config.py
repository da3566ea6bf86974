"""A daemon's configuration (counterpart of the part of
`drand_tpu/core/config.py` a beacon node and its DKG need): the base
folder, the private listen address, the localhost control port (0: a
free one; None: no control service), the clock, and the device the engine checks partials and verifies chains on
and the DKG checks commitments on (None: the current CUDA device;
"cpu": the host tier).  drand_tpu's other fields (public HTTP, TLS,
metrics, the health cadence, private randomness, objectsync, callbacks
and `daemon.toml`) are not ported."""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from drand_tpu_torch.beacon.clock import Clock, SystemClock
from drand_tpu_torch.common import MULTIBEACON_FOLDER


@dataclass
class Config:
    folder: str = os.path.expanduser("~/.drand")
    private_listen: str = "0.0.0.0:0"        # node-to-node gRPC bind
    control_port: int | None = None          # localhost Control service
    clock: Clock = field(default_factory=SystemClock)
    device: str | None = None

    @property
    def multibeacon_folder(self) -> str:
        return os.path.join(self.folder, MULTIBEACON_FOLDER)
