"""Optimal ate pairing on BLS12-381 (pure-Python golden model).

The port's own copy of `drand_tpu/crypto/bls12381/pairing.py`, which the
port may not import: `chip_smoke.py` holds the card's pairing checks
against it.  The pairing computed here is e(P, Q)^3 for the reduced
optimal-ate e -- the cube comes from the denominators-cleared hard-part
exponent 3*(p^4-p^2+1)/r.  Since gcd(3, r) = 1 this is itself a
non-degenerate bilinear pairing, and the port's device pairing computes
the same power.  Affine line steps (one Fp2 inversion each), lines scaled
by w^3 into sparse Fp12 elements, and the hard part through its base-p
decomposition, re-verified as an integer identity at import time below.
"""

from . import fp as F
from .constants import P, R, X

# ---------------------------------------------------------------------------
# Hard-part exponent decomposition: lambda_i coefficients (highest degree
# first) of 3*(p^4-p^2+1)/r in base p, as polynomials in the BLS parameter x.
# Derived with sympy; verified as exact integers here.
# ---------------------------------------------------------------------------

_L0 = [1, -2, 0, 2, -1, 3]      # x^5 - 2x^4 + 2x^2 - x + 3
_L1 = [1, -2, 0, 2, -1]         # x^4 - 2x^3 + 2x - 1
_L2 = [1, -2, 1, 0]             # x^3 - 2x^2 + x
_L3 = [1, -2, 1]                # x^2 - 2x + 1


def _poly_eval(coeffs, v):
    acc = 0
    for c in coeffs:
        acc = acc * v + c
    return acc


_E_HARD3 = 3 * (P**4 - P**2 + 1) // R
assert 3 * (P**4 - P**2 + 1) % R == 0
assert (_poly_eval(_L0, X) + _poly_eval(_L1, X) * P + _poly_eval(_L2, X) * P**2
        + _poly_eval(_L3, X) * P**3) == _E_HARD3, "hard-part decomposition broken"

_X_ABS = -X  # positive 64-bit loop counter
_X_BITS = bin(_X_ABS)[2:]


# ---------------------------------------------------------------------------
# Miller loop
# ---------------------------------------------------------------------------

def _line_sparse(lam, xt, yt, xp, yp):
    """Line through twisted point T=(xt,yt) slope lam (Fp2), evaluated at
    P=(xp,yp) in G1, pre-multiplied by w^3.  Result is a sparse Fp12 element
    with nonzero Fp2 slots c0[0], c0[1], c1[1]:
        (lam*xt - yt)  +  (-lam*xp) * w^2  +  yp * w^3.
    """
    a = F.fp2_sub(F.fp2_mul(lam, xt), yt)
    b = F.fp2_mul_fp(F.fp2_neg(lam), xp)
    c = (yp, 0)
    return ((a, b, F.FP2_ZERO), (F.FP2_ZERO, c, F.FP2_ZERO))


def _dbl_step(t, xp, yp):
    """Affine doubling of T (Fp2) + line eval.  Returns (2T, line)."""
    xt, yt = t
    lam = F.fp2_mul(F.fp2_mul_fp(F.fp2_sqr(xt), 3), F.fp2_inv(F.fp2_add(yt, yt)))
    x3 = F.fp2_sub(F.fp2_sqr(lam), F.fp2_add(xt, xt))
    y3 = F.fp2_sub(F.fp2_mul(lam, F.fp2_sub(xt, x3)), yt)
    return (x3, y3), _line_sparse(lam, xt, yt, xp, yp)


def _add_step(t, q, xp, yp):
    """Affine addition T + Q + line eval.  Returns (T+Q, line)."""
    xt, yt = t
    xq, yq = q
    lam = F.fp2_mul(F.fp2_sub(yt, yq), F.fp2_inv(F.fp2_sub(xt, xq)))
    x3 = F.fp2_sub(F.fp2_sub(F.fp2_sqr(lam), xt), xq)
    y3 = F.fp2_sub(F.fp2_mul(lam, F.fp2_sub(xt, x3)), yt)
    return (x3, y3), _line_sparse(lam, xt, yt, xp, yp)


def multi_miller_loop(pairs):
    """Product of Miller loops over [(P_aff, Q_aff)] with shared squarings."""
    xs = [(p, q) for (p, q) in pairs]
    ts = [q for (_, q) in xs]
    f = F.FP12_ONE
    for bit in _X_BITS[1:]:
        f = F.fp12_sqr(f)
        for i, (pa, qa) in enumerate(xs):
            ts[i], line = _dbl_step(ts[i], pa[0], pa[1])
            f = F.fp12_mul(f, line)
        if bit == "1":
            for i, (pa, qa) in enumerate(xs):
                ts[i], line = _add_step(ts[i], qa, pa[0], pa[1])
                f = F.fp12_mul(f, line)
    return F.fp12_conj(f)


# ---------------------------------------------------------------------------
# Final exponentiation
# ---------------------------------------------------------------------------

def _pow_x(f):
    """f^|x| by square-and-multiply, then conjugate (x < 0).  Assumes f is
    unitary (true after the easy part), so inverse == conjugate."""
    out = F.FP12_ONE
    for bit in _X_BITS:
        out = F.fp12_sqr(out)
        if bit == "1":
            out = F.fp12_mul(out, f)
    return F.fp12_conj(out)


def _pow_small(f, e):
    """f^e for small |e|, unitary f."""
    if e < 0:
        return F.fp12_conj(_pow_small(f, -e))
    out = F.FP12_ONE
    base = f
    while e:
        if e & 1:
            out = F.fp12_mul(out, base)
        base = F.fp12_sqr(base)
        e >>= 1
    return out


def _poly_pow(powers, coeffs):
    """prod powers[k]^coeffs[deg-k]: powers[k] = f^(x^k), coeffs high-first."""
    out = F.FP12_ONE
    deg = len(coeffs) - 1
    for i, c in enumerate(coeffs):
        if c:
            out = F.fp12_mul(out, _pow_small(powers[deg - i], c))
    return out


def final_exp(f):
    """f^((p^6-1)(p^2+1)) then hard part f^(3(p^4-p^2+1)/r)."""
    # easy part
    f = F.fp12_mul(F.fp12_conj(f), F.fp12_inv(f))       # f^(p^6-1), now unitary
    f = F.fp12_mul(F.fp12_frob_n(f, 2), f)              # f^(p^2+1)
    # hard part via x-power chain
    g = [f]
    for _ in range(5):
        g.append(_pow_x(g[-1]))                         # g[k] = f^(x^k)
    part0 = _poly_pow(g, _L0)
    part1 = F.fp12_frob_n(_poly_pow(g, _L1), 1)
    part2 = F.fp12_frob_n(_poly_pow(g, _L2), 2)
    part3 = F.fp12_frob_n(_poly_pow(g, _L3), 3)
    return F.fp12_mul(F.fp12_mul(part0, part1), F.fp12_mul(part2, part3))


# ---------------------------------------------------------------------------
# Pairing API
# ---------------------------------------------------------------------------

def pairing_check(pairs):
    """True iff prod e(P_i, Q_i) == 1.  One shared final exponentiation."""
    from .curve import FP2_OPS, FP_OPS, point_is_inf, point_to_affine
    live = []
    for p_jac, q_jac in pairs:
        if point_is_inf(p_jac, FP_OPS) or point_is_inf(q_jac, FP2_OPS):
            continue
        live.append((point_to_affine(p_jac, FP_OPS), point_to_affine(q_jac, FP2_OPS)))
    if not live:
        return True
    return final_exp(multi_miller_loop(live)) == F.FP12_ONE
