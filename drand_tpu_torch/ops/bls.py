"""Batched BLS12-381 signature verification in PyTorch, for both scheme
shapes: signatures on G2 with keys on G1 (drand's pedersen-bls schemes)
and signatures on G1 with keys on G2 (the short-signature scheme
bls-unchained-g1-rfc9380).

Counterpart of `drand_tpu/ops/bls.py` (g2_decompress, g1_decompress,
verify_g2_sigs, verify_g1_sigs): compressed-point deserialization, the
subgroup check, hash-to-curve, a shared 2-pair Miller loop (either
executor) and one final exponentiation per element, batched over the
round axis.
"""

from __future__ import annotations

import torch

from drand_tpu_torch.crypto.bls12381 import curve as GC
from drand_tpu_torch.crypto.bls12381.constants import P
from drand_tpu_torch.ops import curve as DC
from drand_tpu_torch.ops import h2c as DH
from drand_tpu_torch.ops import pairing as DP
from drand_tpu_torch.ops import towers as T
from drand_tpu_torch.ops.field import FP, host, int_to_limbs

_HALF_P_PLUS1 = host(int_to_limbs((P - 1) // 2 + 1))
_P_LIMBS = host(int_to_limbs(P))


def _fp_gt_half(a_canon):
    """a > (p-1)/2 on canonical limbs."""
    return FP._lex_ge(a_canon, _HALF_P_PLUS1)


def _fp2_gt_half(a_mont):
    """ZCash Fp2 sign rule: lexicographic, c1 most significant."""
    c0c, c1c = FP.from_mont(a_mont[0]), FP.from_mont(a_mont[1])
    return torch.where(FP.is_zero(c1c), _fp_gt_half(c0c), _fp_gt_half(c1c))


def _split_flags(first_byte):
    return (first_byte >> 7) & 1, (first_byte >> 6) & 1, (first_byte >> 5) & 1


def g2_decompress(sig_bytes: torch.Tensor):
    """[..., 96] uint8 compressed G2 -> ((x, y) affine Fp2, inf, valid).

    valid covers: compression flag set, x coordinates canonical (< p), and
    x on the twist (y^2 = x^3 + 4(1+u) solvable).  Subgroup membership is
    checked separately (g2_in_subgroup)."""
    b = sig_bytes.to(torch.uint8)
    comp, inf, sign = _split_flags(b[..., 0].to(torch.int32))
    first = b[..., :1] & 0x1F
    x1_limbs = DH._be_bytes_to_limbs(torch.cat([first, b[..., 1:48]], -1))
    x0_limbs = DH._be_bytes_to_limbs(b[..., 48:96])
    canon = (~FP._lex_ge(x1_limbs, _P_LIMBS)) & (~FP._lex_ge(x0_limbs, _P_LIMBS))
    zero_hi = torch.zeros_like(x1_limbs)
    x = (FP.reduce_wide(x0_limbs, zero_hi), FP.reduce_wide(x1_limbs, zero_hi))
    b_g2 = T.fp2_broadcast(T.fp2_const((4, 4)), x[0].shape[:-1], x[0].device)
    y2 = T.fp2_add(T.fp2_mul(T.fp2_sqr(x), x), b_g2)
    y, on_curve = T.fp2_sqrt_cand(y2)
    flip = _fp2_gt_half(y) != (sign > 0)
    y = T.fp2_select(flip, T.fp2_neg(y), y)
    valid = (comp > 0) & canon & (on_curve | (inf > 0))
    return (x, y), inf > 0, valid


def g1_decompress(sig_bytes: torch.Tensor):
    """[..., 48] uint8 compressed G1 -> ((x, y) affine Fp, inf, valid).

    valid covers: compression flag set, x canonical (< p), and x on the
    curve (y^2 = x^3 + 4 solvable) or the infinity flag set.  Subgroup
    membership is checked separately (g1_in_subgroup)."""
    b = sig_bytes.to(torch.uint8)
    comp, inf, sign = _split_flags(b[..., 0].to(torch.int32))
    first = b[..., :1] & 0x1F
    x_limbs = DH._be_bytes_to_limbs(torch.cat([first, b[..., 1:48]], -1))
    canon = ~FP._lex_ge(x_limbs, _P_LIMBS)
    x = FP.reduce_wide(x_limbs, torch.zeros_like(x_limbs))
    four = T.fp_broadcast(DC._B_G1, x.shape[:-1], x.device)
    y2 = T.fp_add(T.fp_mul(T.fp_sqr(x), x), four)
    y = T.fp_sqrt_cand(y2)
    on_curve = FP.eq(T.fp_sqr(y), y2)
    flip = _fp_gt_half(FP.from_mont(y)) != (sign > 0)
    y = T.fp_select(flip, T.fp_neg(y), y)
    valid = (comp > 0) & canon & (on_curve | (inf > 0))
    return (x, y), inf > 0, valid


def g1_affine_limbs(pt_jac):
    """Golden G1 Jacobian point -> (x, y) [32] int32 canonical Montgomery
    affine limbs (CPU tensors)."""
    aff = GC.g1_affine(pt_jac)
    return (host(FP.to_mont_host(aff[0])), host(FP.to_mont_host(aff[1])))


def g2_affine_limbs(pt_jac):
    """Golden G2 Jacobian point -> ((x0, x1), (y0, y1)) [32] int32
    canonical Montgomery affine limbs (CPU tensors)."""
    aff = GC.g2_affine(pt_jac)
    return (T.fp2_const(aff[0]), T.fp2_const(aff[1]))


_NEG_G1_GEN = g1_affine_limbs(GC.g1_neg(GC.G1_GEN))
_G2_GEN = g2_affine_limbs(GC.G2_GEN)


def verify_g2_sigs(msgs: torch.Tensor, sig_bytes: torch.Tensor, pk_aff,
                   dst: bytes, merged=None):
    """Batched BLS verify, signatures on G2.

    msgs [B, L] uint8 (digested round messages), sig_bytes [B, 96] uint8,
    pk_aff = (x, y) [32] int32 affine G1 limbs on the batch's device.
    Checks e(-g1, sigma) * e(pk, H(m)) == 1 plus deserialization validity
    and G2 subgroup membership.  merged chooses the Miller executor as
    `pairing.pairing_check_pairs` takes it (None: the merged one, as for
    any two pairs)."""
    shape, d = msgs.shape[:-1], msgs.device
    (sx, sy), s_inf, s_valid = g2_decompress(sig_bytes)
    sig_jac = (sx, sy, T.fp2_broadcast(T.FP2_ONE, shape, d))
    in_sub = DC.g2_in_subgroup(sig_jac)

    h_jac = DH.hash_to_g2(msgs, dst)
    (hx, hy), h_inf = DC.point_to_affine(h_jac, DC.Fp2Ops)

    p1 = tuple(T.fp_broadcast(c, shape, d) for c in _NEG_G1_GEN)
    p2 = tuple(T.fp_broadcast(c, shape, d) for c in pk_aff)
    ok = DP.pairing_check_pairs([(p1, (sx, sy)), (p2, (hx, hy))],
                                active=[~s_inf, ~h_inf], merged=merged)
    return ok & s_valid & ~s_inf & in_sub


def verify_g1_sigs(msgs: torch.Tensor, sig_bytes: torch.Tensor, pk_g2_aff,
                   dst: bytes, merged=None):
    """Batched BLS verify, signatures on G1 and the key on G2.

    msgs [B, L] uint8 (digested round messages), sig_bytes [B, 48] uint8,
    pk_g2_aff = ((x0, x1), (y0, y1)) [32] int32 affine G2 limbs on the
    batch's device.  Checks e(-sigma, g2) * e(H(m), pk) == 1 plus
    deserialization validity and G1 subgroup membership; pair 0 is
    inactive where sigma is at infinity, pair 1 where H(m) is.  merged
    as in `verify_g2_sigs`."""
    shape, d = msgs.shape[:-1], msgs.device
    (sx, sy), s_inf, s_valid = g1_decompress(sig_bytes)
    sig_jac = (sx, sy, T.fp_broadcast(T.FP_ONE, shape, d))
    in_sub = DC.g1_in_subgroup(sig_jac)

    h_jac = DH.hash_to_g1(msgs, dst)
    (hx, hy), h_inf = DC.point_to_affine(h_jac, DC.FpOps)

    q1 = tuple(T.fp2_broadcast(c, shape, d) for c in _G2_GEN)
    q2 = tuple(T.fp2_broadcast(c, shape, d) for c in pk_g2_aff)
    ok = DP.pairing_check_pairs([((sx, T.fp_neg(sy)), q1), ((hx, hy), q2)],
                                active=[~s_inf, ~h_inf], merged=merged)
    return ok & s_valid & ~s_inf & in_sub
