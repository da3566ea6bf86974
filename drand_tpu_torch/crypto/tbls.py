"""Threshold BLS on G2 (counterpart of `drand_tpu/crypto/tbls.py`, kyber's
`tbls` as drand uses it): the wire form of a partial signature,
BE16(signer index) followed by the 96-byte compressed G2 signature; a
partial's signing, its check against the public polynomial, the
Lagrange recovery of the group signature and its check.

Signing and the checks go through the native host tier (`crypto/sign.py`,
`native.verify_partial`, which evaluates the polynomial at the index);
recovery decodes each signature with the golden model, as drand_tpu does,
and combines the first t in-group ones with `native.g2_lincomb`, or with
the golden model where the native combination rejects a point."""

from __future__ import annotations

from drand_tpu_torch import native
from drand_tpu_torch.crypto import sign as S
from drand_tpu_torch.crypto.bls12381 import curve as C
from drand_tpu_torch.crypto.bls12381.constants import DST_G2
from drand_tpu_torch.crypto.poly import PriShare, _lagrange_basis_at_zero

INDEX_LEN = 2


def index_of(partial: bytes) -> int:
    """The signer index of a partial signature."""
    if len(partial) < INDEX_LEN:
        raise ValueError("partial too short")
    return int.from_bytes(partial[:INDEX_LEN], "big")


def sig_of(partial: bytes) -> bytes:
    return partial[INDEX_LEN:]


def sign_partial(share: PriShare, msg: bytes) -> bytes:
    """BE16(index) || compressed(share.value * H2(msg))."""
    return share.index.to_bytes(INDEX_LEN, "big") + S.bls_sign(share.value,
                                                                msg)


def _commits48(pub_poly) -> list[bytes]:
    return [C.g1_to_bytes(c) for c in pub_poly.commits]


def verify_partial(pub_poly, msg: bytes, partial: bytes) -> bool:
    """One partial against the public polynomial evaluated at its index."""
    return native.verify_partial(_commits48(pub_poly), msg, partial, DST_G2)


def recover(pub_poly, msg: bytes, partials: list[bytes], threshold: int,
            n: int, verified: bool = False) -> bytes:
    """The group signature from at least t partials: of those whose
    signature decodes and whose index is below n (each checked first
    unless `verified`), an index's latest, until t indices are held; the
    t smallest indices combine at 0.  ValueError when fewer than t
    qualify."""
    commits48 = None if verified else _commits48(pub_poly)
    points: dict[int, bytes] = {}
    for partial in partials:
        try:
            idx, sig = index_of(partial), sig_of(partial)
            C.g2_from_bytes(sig)
        except ValueError:
            continue
        if idx >= n:
            continue
        if not verified and not native.verify_partial(commits48, msg,
                                                      partial, DST_G2):
            continue
        points[idx] = sig
        if len(points) >= threshold:
            break
    if len(points) < threshold:
        raise ValueError(f"not enough valid partials: "
                         f"{len(points)}/{threshold}")
    indices = sorted(points)[:threshold]
    basis = _lagrange_basis_at_zero(indices)
    out = native.g2_lincomb([points[i] for i in indices],
                            [basis[i].to_bytes(32, "big") for i in indices])
    if out is not None:
        return out
    acc = C.G2_INF
    for i in indices:
        acc = C.point_add(acc, C.point_mul(C.g2_from_bytes(points[i]),
                                           basis[i], C.FP2_OPS), C.FP2_OPS)
    return C.g2_to_bytes(acc)


def verify_recovered(pub_key, msg: bytes, sig: bytes) -> bool:
    """The recovered signature against the group public key (a G1
    point)."""
    return S.bls_verify(pub_key, msg, sig)
