"""Batched BLS12-381 signature verification in PyTorch, for both scheme
shapes: signatures on G2 with keys on G1 (drand's pedersen-bls schemes)
and signatures on G1 with keys on G2 (the short-signature scheme
bls-unchained-g1-rfc9380).

Counterpart of `drand_tpu/ops/bls.py` (g2_decompress, g1_decompress,
verify_g2_sigs, verify_g1_sigs): compressed-point deserialization, the
subgroup check, hash-to-curve, a shared 2-pair Miller loop (either
executor) and one final exponentiation per element, batched over the
round axis.  Also its threshold half: the public polynomial evaluated in
the exponent (`pubpoly_eval_g1`), the signer-key table
(`signer_table_arrays`) and the batched partial-signature checks
(`verify_partial_g2_sigs*`), every one on a 1-D batch of rows; and the
DKG's batched commitment checks, one polynomial a row
(`pubpoly_eval_g1_stacked`, `g1_rows_to_limbs`, `dkg_commit_checks`).
"""

from __future__ import annotations

import numpy as np
import torch

from drand_tpu_torch.crypto.bls12381 import curve as GC
from drand_tpu_torch.crypto.bls12381.constants import P
from drand_tpu_torch.device import resolve
from drand_tpu_torch.ops import curve as DC
from drand_tpu_torch.ops import h2c as DH
from drand_tpu_torch.ops import pairing as DP
from drand_tpu_torch.ops import towers as T
from drand_tpu_torch.ops.field import FP, N_LIMBS, host, int_to_limbs

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


def _sig_rows(sig_bytes: torch.Tensor):
    """Compressed G2 signatures [B, 96] -> ((x, y) affine, inf, valid,
    in the subgroup)."""
    (sx, sy), s_inf, s_valid = g2_decompress(sig_bytes)
    one = T.fp2_broadcast(T.FP2_ONE, s_inf.shape, s_inf.device)
    return (sx, sy), s_inf, s_valid, DC.g2_in_subgroup((sx, sy, one))


def _hash_rows(msgs: torch.Tensor, dst: bytes):
    """Digests [B, L] -> (H(m) affine, inf)."""
    return DC.point_to_affine(DH.hash_to_g2(msgs, dst), DC.Fp2Ops)


def _g2_pairs_ok(sig_aff, s_inf, pk_aff, h_aff, h_off, merged=None):
    """e(-g1, sigma) * e(pk, H(m)) == 1 in every row: pair 0 inactive
    where sigma is at infinity, pair 1 where `h_off` (H(m) or the key at
    infinity).  pk_aff = (x, y): [32] limbs broadcast over the batch, or
    [B, 32] limbs, one key a row."""
    shape, d = s_inf.shape, s_inf.device
    p1 = tuple(T.fp_broadcast(c, shape, d) for c in _NEG_G1_GEN)
    p2 = tuple(T.fp_broadcast(c, shape, d) if c.ndim == 1 else c
               for c in pk_aff)
    return DP.pairing_check_pairs([(p1, sig_aff), (p2, h_aff)],
                                  active=[~s_inf, ~h_off], merged=merged)


def verify_g2_sigs(msgs: torch.Tensor, sig_bytes: torch.Tensor, pk_aff,
                   dst: bytes, merged=None):
    """Batched BLS verify, signatures on G2.

    msgs [B, L] uint8 (digested round messages), sig_bytes [B, 96] uint8,
    pk_aff = (x, y) affine G1 limbs on the batch's device: [32] each for
    one key over the batch, or [B, 32] each for a key a row.  Checks
    e(-g1, sigma) * e(pk, H(m)) == 1 plus deserialization validity and
    G2 subgroup membership.  merged chooses the Miller executor as
    `pairing.pairing_check_pairs` takes it (None: the merged one, as for
    any two pairs)."""
    sig_aff, s_inf, s_valid, in_sub = _sig_rows(sig_bytes)
    h_aff, h_inf = _hash_rows(msgs, dst)
    ok = _g2_pairs_ok(sig_aff, s_inf, pk_aff, h_aff, h_inf, merged)
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


# ---------------------------------------------------------------------------
# Threshold BLS: batched partial-signature verification
# ---------------------------------------------------------------------------

def pubpoly_eval_g1(commits, indices: torch.Tensor):
    """Horner in the exponent: the public polynomial at x = index + 1 in
    every row (kyber's `share.PubPoly.Eval`).  commits: the t (x, y)
    affine G1 limb pairs ([32] each) on the device of `indices`, int32
    [B] share indices.  The t - 1 steps are 16-bit ladders over the bits
    of index + 1 (wire indices are < 2^16; as in drand_tpu, 65535 + 1
    keeps only its low 16 bits).  Returns Jacobian G1 points [B]."""
    shape, d = indices.shape, indices.device
    x = (indices + 1).to(torch.int32)
    bits = (x[..., None] >> torch.arange(15, -1, -1, device=d,
                                         dtype=torch.int32)) & 1
    one = T.fp_broadcast(T.FP_ONE, shape, d)
    acc = None
    for cx, cy in reversed(commits):
        cm = (T.fp_broadcast(cx, shape, d), T.fp_broadcast(cy, shape, d), one)
        if acc is None:
            acc = cm
        else:
            acc = DC.point_mul_bits(acc, bits, DC.FpOps)
            acc = DC.point_add(acc, cm, DC.FpOps)
    return acc


def g1_rows_to_limbs(points):
    """Golden G1 Jacobian points -> (x [n, 32] int32, y [n, 32] int32,
    inf [n] bool) canonical Montgomery affine numpy arrays (zeros where
    infinite): the unique representation, so limb equality is point
    equality."""
    n = len(points)
    tx = np.zeros((n, N_LIMBS), dtype=np.int32)
    ty = np.zeros((n, N_LIMBS), dtype=np.int32)
    tinf = np.zeros((n,), dtype=bool)
    for i, pt in enumerate(points):
        if GC.point_is_inf(pt, GC.FP_OPS):
            tinf[i] = True
            continue
        ax, ay = GC.g1_affine(pt)
        tx[i] = FP.to_mont_host(ax)
        ty[i] = FP.to_mont_host(ay)
    return tx, ty, tinf


def signer_table_arrays(pub_poly, n: int):
    """The signer-key table of a group: the public polynomial evaluated at
    every share index 0..n-1 by the golden model, as canonical affine
    Montgomery limbs (tx [n, 32] int32, ty [n, 32] int32, tinf [n] bool,
    CPU tensors).  Canonical affine limbs are unique, so a gather from
    this table gives the Miller loop the same limbs as the in-batch
    `pubpoly_eval_g1` and its affine conversion."""
    return tuple(torch.from_numpy(a) for a in g1_rows_to_limbs(
        [pub_poly.eval(i) for i in range(n)]))


def _tabled_verify_core(h_aff, h_inf, sig_bytes, indices, table):
    """The tail of the tabled partial checks: each row's hash point
    (already gathered), signature decompression and subgroup check, the
    key gathered from the table at the row's signer index, and the 2-pair
    check.  h_aff, h_inf [B]; sig_bytes [B, 96]; indices int32 [B];
    table = (tx, ty, tinf) on the batch's device.  Returns bool [B],
    equal to `verify_partial_g2_sigs` for indices in [0, n)."""
    tx, ty, tinf = table
    n = tx.shape[0]
    sig_aff, s_inf, s_valid, in_sub = _sig_rows(sig_bytes)
    idx_ok = (indices >= 0) & (indices < n)
    safe = indices.clamp(0, n - 1).long()
    p_inf = tinf[safe] | ~idx_ok
    ok = _g2_pairs_ok(sig_aff, s_inf, (tx[safe], ty[safe]), h_aff,
                      h_inf | p_inf)
    return ok & s_valid & ~s_inf & in_sub & ~p_inf & idx_ok


def _gather_rows(h_aff, h_inf, rows: torch.Tensor):
    return (tuple(tuple(c[rows] for c in xy) for xy in h_aff), h_inf[rows])


def verify_partial_g2_sigs_shared(round_msgs, sig_bytes, indices, table,
                                  dst: bytes):
    """Rounds-major tabled partial check: every signer of a round signs
    the same digest, so hash-to-curve runs once a round.  round_msgs
    [R, L] uint8, sig_bytes [R, S, 96], indices int32 [R, S], table =
    (tx, ty, tinf).  The R x S partials run as R*S rows, each gathering
    its round's hash point; returns bool [R, S]."""
    R, S = indices.shape
    h_aff, h_inf = _hash_rows(round_msgs, dst)                   # [R]
    rnd = torch.arange(R, device=indices.device).repeat_interleave(S)
    ok = _tabled_verify_core(*_gather_rows(h_aff, h_inf, rnd),
                             sig_bytes.reshape(R * S, 96),
                             indices.reshape(R * S), table)
    return ok.reshape(R, S)


def verify_partial_g2_sigs_tabled(umsgs, mmap, sig_bytes, indices, table,
                                  dst: bytes):
    """Arrival-order tabled partial check: the batch's distinct messages
    umsgs [U, L] hash once each, and row i takes the hash point of
    umsgs[mmap[i]].  mmap int [B], sig_bytes [B, 96], indices int32 [B],
    table = (tx, ty, tinf).  Returns bool [B]."""
    h_aff, h_inf = _hash_rows(umsgs, dst)                        # [U]
    return _tabled_verify_core(*_gather_rows(h_aff, h_inf, mmap.long()),
                               sig_bytes, indices, table)


def verify_partial_g2_sigs(msgs, sig_bytes, indices, commits, dst: bytes):
    """Partial check without the table: each row's key is the public
    polynomial evaluated in the batch (`pubpoly_eval_g1`) at its signer
    index, any index.  msgs [B, L] uint8, sig_bytes [B, 96], indices
    int32 [B], commits the t (x, y) affine G1 limb pairs.  Returns bool
    [B]."""
    pk_aff, p_inf = DC.point_to_affine(pubpoly_eval_g1(commits, indices),
                                       DC.FpOps)
    sig_aff, s_inf, s_valid, in_sub = _sig_rows(sig_bytes)
    h_aff, h_inf = _hash_rows(msgs, dst)
    ok = _g2_pairs_ok(sig_aff, s_inf, pk_aff, h_aff, h_inf | p_inf)
    return ok & s_valid & ~s_inf & in_sub & ~p_inf


# ---------------------------------------------------------------------------
# DKG: batched commitment checks, one polynomial a row
# ---------------------------------------------------------------------------

def pubpoly_eval_g1_stacked(ctx: torch.Tensor, cty: torch.Tensor,
                            indices: torch.Tensor):
    """Row-stacked Horner in the exponent: row r evaluates its own
    polynomial (ctx[r], cty[r]) at x = indices[r] + 1, the shape of the
    DKG's deal and justification checks, where every dealer commits to
    a different polynomial (`pubpoly_eval_g1` evaluates one polynomial
    at many indices).

    ctx, cty: [rows, t, 32] int32 canonical Montgomery affine commitment
    coordinates, none at infinity (callers send identity commitments to
    the host path); indices: int32 [rows] share indices, all on one
    device.  The t - 1 steps are 16-bit ladders over the bits of index +
    1, taken as drand_tpu takes them (65535 + 1 keeps only its low 16
    bits).  Returns ((ax, ay), inf): canonical Montgomery affine limbs
    [rows, 32] and the infinity mask [rows]."""
    rows, t = ctx.shape[0], ctx.shape[1]
    d = ctx.device
    x = (indices + 1).to(torch.int32)
    bits = (x[:, None] >> torch.arange(15, -1, -1, device=d,
                                       dtype=torch.int32)) & 1
    one = T.fp_broadcast(T.FP_ONE, (rows,), d)
    # coefficient-major, highest degree first: cmx[j] is row-contiguous
    cmx = ctx.flip(1).transpose(0, 1).contiguous()
    cmy = cty.flip(1).transpose(0, 1).contiguous()
    acc = (cmx[0], cmy[0], one)
    for j in range(1, t):
        acc = DC.point_mul_bits(acc, bits, DC.FpOps)
        acc = DC.point_add(acc, (cmx[j], cmy[j], one), DC.FpOps)
    return DC.point_to_affine(acc, DC.FpOps)


def dkg_commit_checks(ctx, cty, indices, ex, ey, einf, device=None):
    """Batched DKG commitment checks: row r asserts poly_r(indices[r] +
    1) == expected_r.

    ctx, cty [rows, t, 32] int32 (see `pubpoly_eval_g1_stacked`),
    indices int32 [rows], ex, ey [rows, 32] int32 and einf bool [rows]:
    the expected points in the same representation; numpy arrays or
    tensors, moved to `device` (`device.resolve`: the current CUDA device
    unless one is named).  Returns bool [rows] numpy verdicts, read back
    with one `.cpu()`.  Canonical affine limbs are unique, so a verdict
    is bit-identical to the golden `g1_eq(PubPoly(commits).eval(i),
    expected)`."""
    dev = resolve(device)

    def on(a, dtype):
        if not torch.is_tensor(a):
            a = torch.from_numpy(np.ascontiguousarray(a))
        return a.to(dev, dtype)
    (ax, ay), inf = pubpoly_eval_g1_stacked(
        on(ctx, torch.int32), on(cty, torch.int32), on(indices, torch.int32))
    e_inf = on(einf, torch.bool)
    eq = FP.eq(ax, on(ex, torch.int32)) & FP.eq(ay, on(ey, torch.int32))
    ok = (inf & e_inf) | (~inf & ~e_inf & eq)
    return ok.cpu().numpy()
