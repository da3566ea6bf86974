"""Beacon scheme registry (counterpart of `drand_tpu/chain/scheme.py`,
drand `common/scheme/scheme.go`): each scheme carries the port's
`SchemeShape`, which fixes the digest rule, the signature group and the
DST of its batched check (`verify.Verifier`).  It imports no torch, so
the key files, groups and the CLI's control-port commands load without
it."""

from __future__ import annotations

from dataclasses import dataclass

from drand_tpu_torch.crypto.bls12381.constants import DST_G1, DST_G2


@dataclass(frozen=True)
class SchemeShape:
    """Static wire shape of a scheme."""
    chained: bool          # prev_sig part of the digest
    sig_on_g1: bool        # short signatures on G1, the key on G2
    dst: bytes

    @property
    def sig_len(self) -> int:
        return 48 if self.sig_on_g1 else 96


SHAPE_CHAINED = SchemeShape(chained=True, sig_on_g1=False, dst=DST_G2)
SHAPE_UNCHAINED = SchemeShape(chained=False, sig_on_g1=False, dst=DST_G2)
SHAPE_UNCHAINED_G1 = SchemeShape(chained=False, sig_on_g1=True, dst=DST_G1)

DEFAULT_SCHEME_ID = "pedersen-bls-chained"
UNCHAINED_SCHEME_ID = "pedersen-bls-unchained"
SHORT_SIG_SCHEME_ID = "bls-unchained-g1-rfc9380"


@dataclass(frozen=True)
class Scheme:
    id: str
    decouple_prev_sig: bool   # unchained: round-only digest, no prev-sig link
    shape: SchemeShape

    @property
    def sig_len(self) -> int:
        return self.shape.sig_len

    @property
    def sig_group(self) -> str:
        return "G1" if self.shape.sig_on_g1 else "G2"


_REGISTRY = {
    DEFAULT_SCHEME_ID: Scheme(DEFAULT_SCHEME_ID, False, SHAPE_CHAINED),
    UNCHAINED_SCHEME_ID: Scheme(UNCHAINED_SCHEME_ID, True, SHAPE_UNCHAINED),
    SHORT_SIG_SCHEME_ID: Scheme(SHORT_SIG_SCHEME_ID, True, SHAPE_UNCHAINED_G1),
}


class UnknownSchemeError(ValueError):
    pass


def scheme_by_id(scheme_id: str | None) -> Scheme:
    """Lookup by id; an empty id is the default scheme."""
    sid = scheme_id or DEFAULT_SCHEME_ID
    try:
        return _REGISTRY[sid]
    except KeyError:
        raise UnknownSchemeError(f"unknown scheme id {sid!r}") from None


def list_schemes() -> list[str]:
    return list(_REGISTRY)
