"""Shamir secret sharing polynomials over the BLS12-381 scalar field.

Counterpart of `drand_tpu/crypto/poly.py` (kyber's `share.PriPoly`,
`share.PubPoly`, `share.PriShare`), on the port's golden model.  Same
conventions: the share with index i is the polynomial evaluated at
x = i + 1, and the commitments live in G1 (the key group).
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass
from typing import Sequence

from drand_tpu_torch.crypto.bls12381 import curve as C
from drand_tpu_torch.crypto.bls12381.constants import R


def rand_scalar() -> int:
    return secrets.randbelow(R - 1) + 1


@dataclass(frozen=True)
class PriShare:
    """A private share: the polynomial evaluated at x = index + 1."""
    index: int
    value: int  # scalar mod R


class PriPoly:
    """Secret-sharing polynomial of degree threshold - 1 over Z_r."""

    def __init__(self, coeffs: Sequence[int]):
        self.coeffs = [c % R for c in coeffs]

    @classmethod
    def random(cls, threshold: int, secret: int | None = None,
               rand=None) -> "PriPoly":
        """rand: optional callable n_bytes -> bytes supplying the entropy,
        read once for every coefficient, 48 bytes a scalar (which keeps
        the mod-R bias below 2^-126).  Default: the OS CSPRNG."""
        if rand is None:
            coeffs = [rand_scalar() for _ in range(threshold)]
        else:
            buf = rand(48 * threshold)
            if len(buf) < 48 * threshold:
                raise ValueError("entropy source returned too few bytes")
            coeffs = [int.from_bytes(buf[i * 48:(i + 1) * 48], "big") % R
                      for i in range(threshold)]
        if secret is not None:
            coeffs[0] = secret % R
        return cls(coeffs)

    @property
    def threshold(self) -> int:
        return len(self.coeffs)

    def secret(self) -> int:
        return self.coeffs[0]

    def eval(self, index: int) -> PriShare:
        x = (index + 1) % R
        acc = 0
        for c in reversed(self.coeffs):
            acc = (acc * x + c) % R
        return PriShare(index, acc)

    def shares(self, n: int) -> list[PriShare]:
        return [self.eval(i) for i in range(n)]

    def commit(self) -> "PubPoly":
        return PubPoly([C.g1_mul(C.G1_GEN, c) for c in self.coeffs])


class PubPoly:
    """Public commitments to a PriPoly: commits[j] = a_j * G1."""

    def __init__(self, commits: Sequence):
        self.commits = list(commits)

    @property
    def threshold(self) -> int:
        return len(self.commits)

    def add(self, other: "PubPoly") -> "PubPoly":
        assert self.threshold == other.threshold
        return PubPoly([C.point_add(a, b, C.FP_OPS)
                        for a, b in zip(self.commits, other.commits)])

    def eval(self, index: int):
        """Horner evaluation in the exponent at x = index + 1."""
        x = (index + 1) % R
        acc = C.G1_INF
        for commit in reversed(self.commits):
            acc = C.point_add(C.g1_mul(acc, x), commit, C.FP_OPS)
        return acc


def _lagrange_basis_at_zero(indices: Sequence[int]) -> dict[int, int]:
    """lambda_i for interpolation at 0; the x-coordinates are index + 1
    (mod R).  The denominator's inverse is Python's modular inverse, the
    value drand_tpu's Fermat power den^(R-2) gives, at a fraction of its
    host time (the recovery of 1024 rounds takes 9216 of them)."""
    lambdas = {}
    for i in indices:
        xi = (i + 1) % R
        num, den = 1, 1
        for j in indices:
            if j == i:
                continue
            xj = (j + 1) % R
            num = num * xj % R
            den = den * ((xj - xi) % R) % R
        lambdas[i] = num * pow(den, -1, R) % R
    return lambdas


def recover_secret(shares: Sequence[PriShare], threshold: int) -> int:
    """Lagrange-interpolate the secret from the first `threshold` of at
    least as many private shares."""
    if len(shares) < threshold:
        raise ValueError(f"need {threshold} shares, got {len(shares)}")
    subset = shares[:threshold]
    lambdas = _lagrange_basis_at_zero([s.index for s in subset])
    return sum(s.value * lambdas[s.index] for s in subset) % R
