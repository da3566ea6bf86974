"""Batched hash-to-curve for BLS12-381 G1 and G2 in PyTorch (branchless
SSWU).

Counterpart of `drand_tpu/ops/h2c.py` for the suites
BLS12381G2_XMD:SHA-256_SSWU_RO_ (drand's G2 signature suite) and
BLS12381G1_XMD:SHA-256_SSWU_RO_ (the short-signature scheme
bls-unchained-g1-rfc9380): RFC 9380 expand_message_xmd, hash_to_field, the
inversion-free simplified SWU map with sqrt_ratio (one body over Fp or
Fp2 through an adapter namespace), the 3-isogeny (G2) or 11-isogeny (G1)
evaluated into Jacobian coordinates, and cofactor clearing
(Budroni-Pintore on G2, h_eff = 1 - x on G1), all masked selects over the
batch.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from drand_tpu_torch.crypto.bls12381 import fp as GF
from drand_tpu_torch.crypto.bls12381.constants import (DST_G1, DST_G2,
                                                       ISO1_X_DEN, ISO1_X_NUM,
                                                       ISO1_Y_DEN, ISO1_Y_NUM,
                                                       ISO3_S, ISO3_V, ISO3_W,
                                                       ISO3_X0, SSWU_G1_A,
                                                       SSWU_G1_B, SSWU_G1_Z,
                                                       SSWU_G2_A, SSWU_G2_B,
                                                       SSWU_G2_Z, X)
from drand_tpu_torch.ops import curve as DC
from drand_tpu_torch.ops import towers as T
from drand_tpu_torch.ops.field import FP, N_LIMBS
from drand_tpu_torch.ops.sha256 import sha256

# ---------------------------------------------------------------------------
# expand_message_xmd (fixed-shape, batched)
# ---------------------------------------------------------------------------


def _const_u8(data: bytes, batch, device):
    a = torch.tensor(list(data), dtype=torch.uint8, device=device)
    return a.expand(tuple(batch) + a.shape)


def expand_message_xmd(msg: torch.Tensor, dst: bytes,
                       len_in_bytes: int) -> torch.Tensor:
    """msg [..., L] uint8 -> [..., len_in_bytes] uint8 (RFC 9380 5.3.1)."""
    if len(dst) > 255:
        dst = hashlib.sha256(b"H2C-OVERSIZE-DST-" + dst).digest()
    ell = (len_in_bytes + 31) // 32
    if ell > 255:
        raise ValueError("expand_message_xmd: len_in_bytes too large")
    batch, d = msg.shape[:-1], msg.device
    dst_prime = dst + bytes([len(dst)])
    b0 = sha256(torch.cat([
        _const_u8(bytes(64), batch, d), msg.to(torch.uint8),
        _const_u8(len_in_bytes.to_bytes(2, "big") + b"\x00", batch, d),
        _const_u8(dst_prime, batch, d)], -1))
    bi = sha256(torch.cat(
        [b0, _const_u8(b"\x01", batch, d), _const_u8(dst_prime, batch, d)], -1))
    out = [bi]
    for i in range(2, ell + 1):
        bi = sha256(torch.cat([b0 ^ bi, _const_u8(bytes([i]), batch, d),
                               _const_u8(dst_prime, batch, d)], -1))
        out.append(bi)
    return torch.cat(out, -1)[..., :len_in_bytes]


# ---------------------------------------------------------------------------
# Big-endian bytes -> Fp (Montgomery) via 512-bit reduction
# ---------------------------------------------------------------------------

def _be_bytes_to_limbs(u8: torch.Tensor) -> torch.Tensor:
    """[..., nbytes] big-endian uint8 -> [..., 32] canonical 12-bit limbs
    of the value mod 2^384 (nbytes <= 48).  Byte indices past the end are
    clipped and their bytes masked to 0."""
    nbytes = u8.shape[-1]
    lsb = u8.flip(-1).to(torch.int32)               # little-endian bytes
    i = np.arange(N_LIMBS)
    k = (12 * i) // 8
    s = torch.as_tensor((12 * i) % 8, dtype=torch.int32, device=u8.device)
    k0 = torch.as_tensor(np.clip(k, 0, nbytes - 1), device=u8.device)
    k1 = torch.as_tensor(np.clip(k + 1, 0, nbytes - 1), device=u8.device)
    ok0 = torch.as_tensor(k < nbytes, device=u8.device)
    ok1 = torch.as_tensor(k + 1 < nbytes, device=u8.device)
    b0 = torch.where(ok0, lsb[..., k0], 0)
    b1 = torch.where(ok1, lsb[..., k1], 0)
    return ((b0 >> s) | (b1 << (8 - s))) & 0xFFF


def bytes_be_to_fp_mont(u8: torch.Tensor) -> torch.Tensor:
    """[..., 64] big-endian uint8 -> Montgomery Fp of (int mod p)."""
    lo = _be_bytes_to_limbs(u8[..., 16:])          # low 48 bytes
    hi = _be_bytes_to_limbs(u8[..., :16])          # top 16 bytes
    return FP.reduce_wide(lo, hi)


# ---------------------------------------------------------------------------
# SSWU map, one body over Fp (G1) or Fp2 (G2) through an adapter namespace
# ---------------------------------------------------------------------------

class _FpAdapter:
    """Fp as the field of the G1 suite's map (E1')."""
    products = staticmethod(FP.products)
    add = staticmethod(T.fp_add)
    neg = staticmethod(T.fp_neg)
    select = staticmethod(T.fp_select)
    sgn0 = staticmethod(T.fp_sgn0)
    is_zero = staticmethod(FP.is_zero)
    sqrt_ratio = staticmethod(T.make_fp_sqrt_ratio(SSWU_G1_Z))
    # A', B', Z, -B and Z*A' (the x1 denominator where tv2 == 0), and one
    consts = tuple(T.fp_const(c) for c in (
        SSWU_G1_A, SSWU_G1_B, SSWU_G1_Z, GF.fp_neg(SSWU_G1_B),
        GF.fp_mul(SSWU_G1_Z, SSWU_G1_A))) + (T.FP_ONE,)

    @staticmethod
    def batch(u):
        return u.shape[:-1], u.device

    @staticmethod
    def broadcast(c, shape, device):
        return T.fp_broadcast(c, shape, device)


class _Fp2Adapter:
    """Fp2 as the field of the G2 suite's map (E2')."""
    products = staticmethod(T.fp2_products)
    add = staticmethod(T.fp2_add)
    neg = staticmethod(T.fp2_neg)
    select = staticmethod(T.fp2_select)
    sgn0 = staticmethod(T.fp2_sgn0)
    is_zero = staticmethod(T.fp2_is_zero)
    sqrt_ratio = staticmethod(T.make_fp2_sqrt_ratio(SSWU_G2_Z))
    consts = tuple(T.fp2_const(c) for c in (
        SSWU_G2_A, SSWU_G2_B, SSWU_G2_Z, GF.fp2_neg(SSWU_G2_B),
        GF.fp2_mul(SSWU_G2_Z, SSWU_G2_A))) + (T.FP2_ONE,)

    @staticmethod
    def batch(u):
        return u[0].shape[:-1], u[0].device

    @staticmethod
    def broadcast(c, shape, device):
        return T.fp2_broadcast(c, shape, device)


def _map_to_curve_sswu(u, A):
    """Branchless, inversion-free simplified SWU on E': y^2 = x^3 + A' x +
    B' over A's field.  Returns ((xn, xd), y): the E' x coordinate as a
    fraction plus the exact affine y (RFC 9380 F.2)."""
    shape, d = A.batch(u)
    a, b, z, nb, za, one = (A.broadcast(c, shape, d) for c in A.consts)

    (uu,) = A.products([(u, u)])
    (tv1,) = A.products([(z, uu)])                  # Z u^2
    (tv1sq,) = A.products([(tv1, tv1)])
    tv2 = A.add(tv1sq, tv1)                         # Z^2 u^4 + Z u^2
    (xnt,) = A.products([(nb, A.add(tv2, one))])
    (xdt,) = A.products([(a, tv2)])
    exc = A.is_zero(tv2)
    xn = A.select(exc, b, xnt)
    xd = A.select(exc, za, xdt)
    # g(x1) = (xn^3 + A xn xd^2 + B xd^3) / xd^3
    xd2, xn2 = A.products([(xd, xd), (xn, xn)])
    xd3, xn3, axn = A.products([(xd2, xd), (xn2, xn), (a, xn)])
    gxn_t, bxd3 = A.products([(axn, xd2), (b, xd3)])
    gxn = A.add(A.add(xn3, gxn_t), bxd3)
    y1, is_sq = A.sqrt_ratio(gxn, xd3)
    # non-square branch: x2 = tv1 * x1 and y2 = tv1 u y1
    (tu,) = A.products([(tv1, u)])
    xn2_, y2 = A.products([(tv1, xn), (tu, y1)])
    xn = A.select(is_sq, xn, xn2_)
    y = A.select(is_sq, y1, y2)
    flip = A.sgn0(u) != A.sgn0(y)
    y = A.select(flip, A.neg(y), y)
    return ((xn, xd), y)


def _iso3_jacobian(xfrac, y):
    """3-isogeny E2' -> E2 in compact Velu form with Jacobian Z := dn*pd
    (no inversion; kernel points land on Z == 0):
        X_j = s^2 pd (pn dn^2 + v dn pd^2 + w pd^3)
        Y_j = s^3 y pd^3 (dn^3 - v dn pd^2 - 2w pd^3)"""
    pn, pd = xfrac
    shape, d = pn[0].shape[:-1], pn[0].device

    def bc(c):
        return T.fp2_broadcast(T.fp2_const(c), shape, d)

    v, w = bc(ISO3_V), bc(ISO3_W)
    s2 = bc(GF.fp2_sqr(ISO3_S))
    s3 = bc(GF.fp2_mul(GF.fp2_sqr(ISO3_S), ISO3_S))
    dn = T.fp2_sub(pn, T.fp2_mul(bc(ISO3_X0), pd))
    dn2, pd2, zj, vdn = T.fp2_products(
        [(dn, dn), (pd, pd), (dn, pd), (v, dn)])
    dn3, pd3, pndn2, vdnpd2, s2pd = T.fp2_products(
        [(dn2, dn), (pd2, pd), (pn, dn2), (vdn, pd2), (s2, pd)])
    wpd3, ypd3 = T.fp2_products([(w, pd3), (y, pd3)])
    xin = T.fp2_add(T.fp2_add(pndn2, vdnpd2), wpd3)
    yin = T.fp2_sub(T.fp2_sub(dn3, vdnpd2), T.fp2_add(wpd3, wpd3))
    xj, s3ypd3 = T.fp2_products([(s2pd, xin), (s3, ypd3)])
    (yj,) = T.fp2_products([(s3ypd3, yin)])
    return (xj, yj, zj)


# the 11-isogeny's four polynomials: (index, Montgomery constant) of each
# nonzero coefficient, ascending powers
_ISO1 = tuple(tuple((i, T.fp_const(c)) for i, c in enumerate(coeffs) if c)
              for coeffs in (ISO1_X_NUM, ISO1_X_DEN, ISO1_Y_NUM, ISO1_Y_DEN))


def _iso1_jacobian(xfrac, y):
    """11-isogeny E1' -> E1 evaluated homogeneously on the SSWU fraction x
    = pn/pd: with the shared basis b_i = pn^i pd^(15-i) every map
    polynomial evaluates as H(poly) = pd^15 poly(x), so the pd factors
    cancel in X_aff = Hxn/Hxd, Y_aff = y Hyn/Hyd.  Jacobian Z := Hxd*Hyd
    gives X_j = Hxn Hxd Hyd^2, Y_j = y Hyn Hxd^3 Hyd^2 with no inversion;
    a kernel point (Hxd == 0 or Hyd == 0) lands on infinity."""
    pn, pd = xfrac
    shape, d = pn.shape[:-1], pn.device

    def powers(x):
        """[None, x, x^2, ..., x^15], in stacked doubling stages."""
        p = [None, x]
        for lvl in (1, 2, 4):
            sq = FP.products([(p[k], p[k]) for k in range(lvl, 2 * lvl)])
            od = FP.products([(s, x) for s in sq])
            for i in range(lvl):
                p.append(sq[i])
                p.append(od[i])
        return p

    pnp, pdp = powers(pn), powers(pd)
    basis = FP.products([(pnp[i], pdp[15 - i]) for i in range(1, 15)])
    basis = [pdp[15]] + basis + [pnp[15]]          # b_0 .. b_15

    def hpoly(terms):
        prods = FP.products([(T.fp_broadcast(c, shape, d), basis[i])
                             for i, c in terms])
        acc = prods[0]
        for t in prods[1:]:
            acc = T.fp_add(acc, t)
        return acc

    hxn, hxd, hyn, hyd = (hpoly(terms) for terms in _ISO1)
    z, yd2 = FP.products([(hxd, hyd), (hyd, hyd)])
    xd2, yyn = FP.products([(hxd, hxd), (y, hyn)])
    xnxd, xd3 = FP.products([(hxn, hxd), (xd2, hxd)])
    xj, t = FP.products([(xnxd, yd2), (yyn, xd3)])
    (yj,) = FP.products([(t, yd2)])
    return (xj, yj, z)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def hash_to_field_fp2(msg: torch.Tensor, dst: bytes, count: int = 2):
    data = expand_message_xmd(msg, dst, count * 2 * 64)
    out = []
    for i in range(count):
        c0 = bytes_be_to_fp_mont(data[..., (2 * i) * 64:(2 * i + 1) * 64])
        c1 = bytes_be_to_fp_mont(data[..., (2 * i + 1) * 64:(2 * i + 2) * 64])
        out.append((c0, c1))
    return out


def hash_to_field_fp(msg: torch.Tensor, dst: bytes, count: int = 2):
    data = expand_message_xmd(msg, dst, count * 64)
    return [bytes_be_to_fp_mont(data[..., i * 64:(i + 1) * 64])
            for i in range(count)]


def hash_to_g2(msg: torch.Tensor, dst: bytes = DST_G2):
    """[..., L] uint8 messages -> batched Jacobian G2 subgroup points.

    Both hash_to_field draws run the SSWU map and the 3-isogeny as ONE
    stacked pass on a doubled leading axis; the pair is added on E2 and
    cofactor-cleared."""
    u0, u1 = hash_to_field_fp2(msg, dst, 2)
    u = (torch.stack([u0[0], u1[0]], 0), torch.stack([u0[1], u1[1]], 0))
    qx, qy = _map_to_curve_sswu(u, _Fp2Adapter)
    xj, yj, zj = _iso3_jacobian(qx, qy)
    q0 = tuple((c[0][0], c[1][0]) for c in (xj, yj, zj))
    q1 = tuple((c[0][1], c[1][1]) for c in (xj, yj, zj))
    r = DC.point_add(q0, q1, DC.Fp2Ops)
    return DC.g2_clear_cofactor(r)


def hash_to_g1(msg: torch.Tensor, dst: bytes = DST_G1):
    """[..., L] uint8 messages -> batched Jacobian G1 subgroup points.

    Both draws run the SSWU map and the 11-isogeny as one stacked pass;
    the pair is added on E1 and multiplied by the RFC 9380 effective
    cofactor h_eff = 1 - x (not the full h1: both land in G1, but only
    1 - x gives the standard suite's point)."""
    u0, u1 = hash_to_field_fp(msg, dst, 2)
    qx, qy = _map_to_curve_sswu(torch.stack([u0, u1], 0), _FpAdapter)
    xj, yj, zj = _iso1_jacobian(qx, qy)
    r = DC.point_add((xj[0], yj[0], zj[0]), (xj[1], yj[1], zj[1]), DC.FpOps)
    return DC.point_mul_const(r, 1 - X, DC.FpOps)
