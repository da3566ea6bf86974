"""Chain model of the port: beacons, schemes, the store's read-and-repair
side, the integrity scan and `ChainVerifier` (`chain/verify.py`).

Counterpart of `drand_tpu/chain/`.  The package itself imports only the
beacon model, so the structural scan and `util fsck` load no kernel
module; `ChainVerifier` is imported from `drand_tpu_torch.chain.verify`.
"""

from drand_tpu_torch.chain.beacon import GENESIS_ROUND, Beacon, genesis_beacon

__all__ = ["Beacon", "GENESIS_ROUND", "genesis_beacon"]
