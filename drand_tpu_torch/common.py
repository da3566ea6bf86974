"""Beacon ids and the node version the wire metadata carries (the port's
copy of what it needs of `drand_tpu/common/__init__.py`, drand
`common/beacon.go`, `common/version.go`), and the folder that holds one
subfolder a beacon id under a node's base folder."""

from __future__ import annotations

from dataclasses import dataclass

DEFAULT_BEACON_ID = "default"
MULTIBEACON_FOLDER = "multibeacon"


def canonical_beacon_id(beacon_id: str | None) -> str:
    """An empty or missing id is the default one."""
    return beacon_id if beacon_id else DEFAULT_BEACON_ID


@dataclass(frozen=True)
class Version:
    major: int = 0
    minor: int = 1
    patch: int = 0

    def __str__(self) -> str:
        return f"{self.major}.{self.minor}.{self.patch}"


VERSION = Version()
