"""The signer-key table of a group epoch (counterpart of
`drand_tpu/beacon/signer_table.py`).

For a fixed group the public polynomial evaluated at share index i is a
constant, so the table evaluates it once for each of the n indices by
the golden model and keeps the results as canonical affine Montgomery
limbs, placed once on the backend's device, for a gather at batch time
in place of the in-batch Horner ladder.  A reshare or group transition
that changes the commitments makes a new table at the next epoch.
Indices outside [0, n) take the live `PubPoly.eval`: the table changes
the cost of a verdict, never the verdict.
"""

from __future__ import annotations

import hashlib
import logging

import numpy as np
import torch

from drand_tpu_torch.crypto.bls12381 import curve as GC
from drand_tpu_torch.ops.bls import signer_table_arrays
from drand_tpu_torch.ops.field import FP

log = logging.getLogger("drand_tpu_torch.beacon")


def poly_key(pub_poly) -> bytes:
    """Identity of a public polynomial: the hash of its commitments' wire
    bytes.  Two polynomials with the same commitments are the same group
    key material."""
    h = hashlib.sha256()
    for c in pub_poly.commits:
        h.update(GC.g1_to_bytes(c))
    return h.digest()


class SignerKeyTable:
    """The n evaluations of one group epoch's public polynomial, as
    tensors (tx [n, 32] int32, ty [n, 32] int32, tinf [n] bool) on
    `device` (the CPU when None)."""

    def __init__(self, pub_poly, n: int, epoch: int = 0, device=None):
        self.pub_poly = pub_poly
        self.n = n
        self.threshold = pub_poly.threshold
        self.epoch = epoch
        self.device = torch.device("cpu" if device is None else device)
        self.key = poly_key(pub_poly)
        self.tx, self.ty, self.tinf = (
            a.to(self.device) for a in signer_table_arrays(pub_poly, n))

    # -- lookups ------------------------------------------------------------

    def contains(self, index: int) -> bool:
        return 0 <= index < self.n

    def contains_all(self, indices) -> bool:
        a = np.asarray(indices)
        return bool(a.size == 0 or ((a >= 0) & (a < self.n)).all())

    def eval(self, index: int):
        """Golden-model evaluation at `index`: the table's affine point for
        a table index, the live Horner evaluation for any other."""
        if self.contains(index) and not bool(self.tinf[index]):
            return (FP.from_limbs_host(self.tx[index].cpu().numpy()),
                    FP.from_limbs_host(self.ty[index].cpu().numpy()), 1)
        return self.pub_poly.eval(index)

    def arrays(self):
        """(tx, ty, tinf) on the table's device."""
        return self.tx, self.ty, self.tinf

    # -- epoch management ----------------------------------------------------

    def matches(self, pub_poly) -> bool:
        return poly_key(pub_poly) == self.key

    def update(self, pub_poly, n: int | None = None) -> "SignerKeyTable":
        """A table valid for `pub_poly`: self when the key material and n
        are unchanged, else a table rebuilt at epoch + 1 on the same
        device (stale evaluations would verify an old group's partials
        against the new group's keys)."""
        n = self.n if n is None else n
        if n == self.n and self.matches(pub_poly):
            return self
        log.info("signer-key table rebuilt (epoch %d -> %d, n=%d)",
                 self.epoch, self.epoch + 1, n)
        return SignerKeyTable(pub_poly, n, epoch=self.epoch + 1,
                              device=self.device)
