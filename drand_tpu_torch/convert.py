"""Carry `drand_tpu`'s verifier state over to the port.

The state is plain arrays, so the carry-over is a checked conversion, not
an import of `drand_tpu`: canonical Montgomery affine limbs are a unique
representation, and the port keeps the same layout.
"""

from __future__ import annotations

import numpy as np
import torch

from drand_tpu_torch.crypto.bls12381.constants import P
from drand_tpu_torch.ops.field import N_LIMBS, limbs_to_int


def _limbs(a) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.shape[-1:] != (N_LIMBS,) or not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(f"expected [..., {N_LIMBS}] integer limbs, "
                         f"got {arr.shape} {arr.dtype}")
    if arr.size and (arr.min() < 0 or arr.max() >= 4096):
        raise ValueError("limbs out of [0, 4096)")
    for row in arr.reshape(-1, N_LIMBS):
        if limbs_to_int(row) >= P:
            raise ValueError("limb vector is not a canonical Fp element")
    return torch.from_numpy(arr.astype(np.int32))


def _coord(a) -> torch.Tensor:
    """One affine key coordinate: exactly [32] limbs."""
    t = _limbs(a)
    if t.shape != (N_LIMBS,):
        raise ValueError(f"expected a [{N_LIMBS}] key coordinate, got "
                         f"{tuple(t.shape)}")
    return t


def _is_fp2(c) -> bool:
    return isinstance(c, (tuple, list)) and len(c) == 2


def from_drand_tpu(state):
    """Convert `drand_tpu` verifier state to CPU tensors of the port.

    state, one of:
      - a G1 key, the `Verifier._pk` of a G2-signature scheme: (x, y),
        each an array of [32] int32 canonical Montgomery affine limbs
        (`ops/bls.py` `_const_g1_affine`);
      - a G2 key, the `Verifier._pk` of `SHAPE_UNCHAINED_G1`: a pair of
        Fp2 pairs ((x0, x1), (y0, y1)), each element [32]
        (`_const_g2_affine`), told apart by its nesting: a G1 coordinate
        must be one [32] array, so a G2 coordinate never passes as one;
      - the signer table (tx [n, 32], ty [n, 32], tinf [n] bool) of
        `signer_table_arrays`.
    Returns the same nesting as torch tensors."""
    state = tuple(state)
    if len(state) == 2 and all(_is_fp2(c) for c in state):
        return tuple(tuple(_coord(v) for v in c) for c in state)
    if len(state) == 2:
        if any(_is_fp2(c) for c in state):
            raise ValueError("a key is (x, y) or ((x0, x1), (y0, y1))")
        return tuple(_coord(c) for c in state)
    if len(state) == 3:
        tx, ty, tinf = state
        tinf = np.asarray(tinf)
        if tinf.dtype != np.bool_ or tinf.shape != np.asarray(tx).shape[:-1]:
            raise ValueError("tinf must be bool [n] matching tx")
        return _limbs(tx), _limbs(ty), torch.from_numpy(tinf.copy())
    raise ValueError("expected the (x, y) or ((x0, x1), (y0, y1)) public "
                     "key or the (tx, ty, tinf) table")
