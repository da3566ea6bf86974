"""The CUDA kernels' arithmetic, compiled for the host, against the plain
PyTorch versions.

`drand_tpu_torch/csrc/field_arith.cuh`, `tower_arith.cuh` and
`curve_arith.cuh` hold the per-element (per-thread) arithmetic of kernels
K1-K16 as `__host__ __device__` functions; `csrc/field_host.cpp` wraps it in plain C
loops that split the work as the kernels do.  This test builds that shim
with g++ into a temporary shared library (no CUDA, no torch headers) and
holds every kernel's arithmetic against its plain PyTorch version bit for
bit: K1-K4 (`Field._*_plain`) for Fp and Fr on random and edge inputs, K3
at the edge of its input contract, the 32-bit carry-chain product and
square of K1 and K4 (`field_arith32.cuh`, its carry flag emulated) on
edge values, K4's programs (whole addition chains) against
`Field._pow_addchain_plain` and `pow`; K5/K6 (`towers._fp2_*_plain`) on
random values plus 0, 1 and p-1, each as its two lanes (K6's product on
the 32-bit carry chains, also on raw p-1, x1 = 0 and x0 = x1); K13
(`flat12._flat_mul_plain`) through each of its instances, dense (its
Karatsuba phases in both orders, half sums wrapping past p) and sparse,
with the all-(p-1) stored-coefficient operand and 0, 1, p-1 in every
slot; K14
(`flat12._flat_cyclo_sqr_plain`) on random canonical rows, not only
unitary ones; K7/K8 (`towers._fp2_sqr_chain_mul_plain`), K7 as its two
lanes; K9/K10 (the `ops/curve.py` formulas under `Fp2PlainOps`) on random
coordinates with the doubling, cancelling and infinite cases among them,
K9 as its chain of n doublings and K10 as its addition, each split into
level shares; K11/K12
(`pairing._miller_*_iter_plain`), their steps split into shares, with
active and inactive pairs, and against f^2 (or f) times the two lines
one after the other;
K15/K16 (`flat12._flat_conj_plain`, `_flat_frob_plain`), K15 as its
eight-lane groups with the warp's ballots built lane by lane, on
coefficients whose borrow crosses lanes, K16 as its twelve warps, each
term by its constant's class (the classes found from the constants' words
against a classification made here, and every class at every place of a
made-up table); K17/K20
(`flat12._flat_sqr_plain`, `_line_merge_plain`) with the all-(p-1) and
zero operands, K17 as its class loop folding into the output rows on 33
rows; K18/K19 (`pairing._dbl_step_plain`, `_add_step_plain`) on
K-stacked rows, K18 as K11's doubling shares and K19 as K12's addition
shares, each level's shares in the kernel's order and reversed, with Z =
1 and Z = 0 rows (K19 also T = Q and T = -Q, where H = 0), and against
K11's and K12's T' and lines; K21/K22 (`Field.add`, `Field.sub`) at 0, 1
and m-1.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from drand_tpu_torch.crypto.bls12381.constants import P
from drand_tpu_torch.ops import curve as C
from drand_tpu_torch.ops import flat12 as F
from drand_tpu_torch.ops import pairing as PR
from drand_tpu_torch.ops import towers as T
from drand_tpu_torch.ops.field import (FP, FR, addchain_plan, chain_program,
                                       int_to_limbs, int_to_words)

CSRC = Path(__file__).resolve().parents[1] / "drand_tpu_torch" / "csrc"
FIELDS = {"fp": FP, "fr": FR}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is needed to build the host harness")
    out = tmp_path_factory.mktemp("harness") / "libfield_host.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-Wall", "-Werror", "-shared",
                    "-fPIC", "-o", str(out), str(CSRC / "field_host.cpp")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(out))
    P_, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.dth_mont_mul.argtypes = [P_, P_, P_, LL, P_]
    lib.dth_mont_sqr.argtypes = [P_, P_, LL, P_]
    lib.dth_fp_pow_chain.argtypes = [P_, P_, P_, LL, P_, I, P_, P_]
    lib.dth_mont_reduce.argtypes = [P_, P_, LL, P_]
    lib.dth_sqr_chain_mul.argtypes = [P_, P_, P_, LL, I, P_]
    lib.dth_fp2_products.argtypes = [P_, P_, P_, LL, I, I, P_]
    lib.dth_fp2_sqrs.argtypes = [P_, P_, LL, I, I, P_]
    lib.dth_flat_mul.argtypes = [P_, P_, P_, LL, P_, I, I, P_]
    lib.dth_cyclo_sqr.argtypes = [P_, P_, LL, I, I, P_]
    lib.dth_fp2_sqr_chain_mul.argtypes = [P_, P_, P_, LL, I, I, P_]
    lib.dth_fp2_sqr5_mul.argtypes = [P_, P_, P_, LL, P_]
    lib.dth_flat_conj.argtypes = [P_, P_, LL, P_]
    lib.dth_flat_frob.argtypes = [P_, P_, LL, P_, P_]
    lib.dth_frob_classes.argtypes = [P_, P_, P_]
    lib.dth_g2_point_dbl.argtypes = [P_, P_, LL, I, I, P_]
    lib.dth_g2_point_add.argtypes = [P_, P_, P_, LL, I, I, P_, P_]
    lib.dth_miller_dbl_iter.argtypes = [P_] * 6 + [LL, I, P_, P_]
    lib.dth_miller_add_iter.argtypes = [P_] * 7 + [LL, I, P_, P_]
    lib.dth_flat_sqr.argtypes = [P_, P_, LL, P_]
    lib.dth_line_merge.argtypes = [P_, P_, P_, LL, P_]
    lib.dth_g2_dbl_line.argtypes = [P_, P_, P_, LL, I, P_]
    lib.dth_g2_add_line.argtypes = [P_, P_, P_, LL, I, P_]
    lib.dth_add.argtypes = [P_, P_, P_, LL, P_]
    lib.dth_sub.argtypes = [P_, P_, P_, LL, P_]
    for fn in (lib.dth_mont_mul, lib.dth_mont_sqr,
               lib.dth_fp_pow_chain, lib.dth_mont_reduce,
               lib.dth_sqr_chain_mul, lib.dth_fp2_products, lib.dth_fp2_sqrs,
               lib.dth_flat_mul, lib.dth_cyclo_sqr, lib.dth_fp2_sqr_chain_mul,
               lib.dth_fp2_sqr5_mul, lib.dth_flat_conj, lib.dth_flat_frob,
               lib.dth_frob_classes,
               lib.dth_g2_point_dbl, lib.dth_g2_point_add,
               lib.dth_miller_dbl_iter, lib.dth_miller_add_iter,
               lib.dth_flat_sqr, lib.dth_line_merge, lib.dth_g2_dbl_line,
               lib.dth_g2_add_line, lib.dth_add, lib.dth_sub):
        fn.restype = None
    return lib


def _elements(F, n=40, seed=0):
    rng = np.random.default_rng(seed)
    m = F.modulus
    vals = [0, 1, 2, m - 1, m - 2, (m - 1) // 2] + [
        int.from_bytes(rng.bytes(48), "little") % m for _ in range(n)]
    return np.ascontiguousarray(F.encode(vals))


def _wide_at_contract(F, seed=0):
    """Wide values up to the K3 contract's top, (2 - 2^-9) 2^384 m - 1, in
    normalized limbs and in non-normalized ones (a 1 borrowed from every
    non-zero upper limb: limbs up to 8191)."""
    rng = np.random.default_rng(seed)
    R = 1 << 384
    top = 2 * R * F.modulus - ((R * F.modulus) >> 9) - 1
    vals = [0, 1, top, top - 1, F.modulus * R, F.modulus * R - 1, R - 1] + [
        int.from_bytes(rng.bytes(96), "little") % top for _ in range(25)]
    w = np.stack([int_to_limbs(v, 64) for v in vals])
    w2 = w.copy()
    for i in range(1, 64):
        nz = w2[:, i] > 0
        w2[nz, i] -= 1
        w2[nz, i - 1] += 4096
    assert w2.max() < 1 << 14
    return vals, np.ascontiguousarray(np.concatenate([w, w2]).astype(np.int32))


def _ptr(a):
    return a.ctypes.data


@pytest.mark.parametrize("name", ["fp", "fr"])
def test_mont_mul_and_sqr(host_lib, name):
    F = FIELDS[name]
    a = _elements(F, seed=1)
    b = np.ascontiguousarray(_elements(F, seed=2)[::-1])
    out = np.empty_like(a)
    host_lib.dth_mont_mul(_ptr(a), _ptr(b), _ptr(out), len(a),
                          _ptr(F.kernel_arg))
    want = F._mont_mul_plain(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_array_equal(out, want)
    host_lib.dth_mont_sqr(_ptr(a), _ptr(out), len(a), _ptr(F.kernel_arg))
    np.testing.assert_array_equal(
        out, F._mont_sqr_plain(torch.as_tensor(a)).numpy())


@pytest.mark.parametrize("name", ["fp", "fr"])
def test_mont_reduce_at_contract(host_lib, name):
    F = FIELDS[name]
    vals, w = _wide_at_contract(F, seed=3)
    out = np.empty((len(w), 32), np.int32)
    host_lib.dth_mont_reduce(_ptr(w), _ptr(out), len(w), _ptr(F.kernel_arg))
    np.testing.assert_array_equal(
        out, F._mont_reduce_plain(torch.as_tensor(w)).numpy())
    rinv = pow(1 << 384, -1, F.modulus)
    want = [int_to_limbs(v * rinv % F.modulus) for v in vals * 2]
    np.testing.assert_array_equal(out, np.stack(want))


@pytest.mark.parametrize("name", ["fp", "fr"])
@pytest.mark.parametrize("k", [1, 4, 5, 9, 63])
def test_sqr_chain_mul(host_lib, name, k):
    F = FIELDS[name]
    a = _elements(F, n=20, seed=4)
    t = np.ascontiguousarray(_elements(F, n=20, seed=5)[::-1])
    out = np.empty_like(a)
    for tt in (None, t):
        host_lib.dth_sqr_chain_mul(_ptr(a), None if tt is None else _ptr(tt),
                                   _ptr(out), len(a), k, _ptr(F.kernel_arg))
        want = F._sqr_chain_mul_plain(
            torch.as_tensor(a), k, None if tt is None else torch.as_tensor(tt))
        np.testing.assert_array_equal(out, want.numpy())


def _edge32(F):
    """Values that stress 32-bit carry chains: 0, 1, 2, m-1, m-2, (m-1)/2,
    R mod m, words of all ones below m, m minus powers of two."""
    m = F.modulus
    vals = [0, 1, 2, m - 1, m - 2, (m - 1) // 2, (1 << 384) % m,
            (1 << 32) - 1, (1 << 64) - 1, (1 << 352) - 1,
            (1 << (m.bit_length() - 1)) - 1, m - (1 << 32), m - (1 << 200)]
    return [v % m for v in vals]


@pytest.mark.parametrize("name", ["fp", "fr"])
@pytest.mark.parametrize("op", ["mul", "wide", "sqr"])
def test_carry_chain_mul_and_sqr(host_lib, name, op):
    """field_arith32.cuh's product (K1) with every pair of edge values and
    random ones, and its triangular square (K2, K4's square) on edge and
    random values, against the plain versions; K1 also with a first
    operand of any 384 bits (2^384 - 1 among them, Field.reduce_wide's
    halves of a wide value) against canonical second ones."""
    F = FIELDS[name]
    edge = F.encode(_edge32(F))
    rand = _elements(F, n=60, seed=48)
    if op in ("mul", "wide"):
        a = np.concatenate([np.repeat(edge, len(edge), 0), rand])
        b = np.concatenate([np.tile(edge, (len(edge), 1)), rand[::-1]])
        if op == "wide":
            rng = np.random.default_rng(50)
            a = rng.integers(0, 4096, size=a.shape, dtype=np.int32)
            a[:len(edge)] = 4095
            b[-2:] = np.stack([F.R2.numpy(), F.R3.numpy()])
        a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
        out = np.empty_like(a)
        host_lib.dth_mont_mul(_ptr(a), _ptr(b), _ptr(out), len(a),
                              _ptr(F.kernel_arg))
        want = F._mont_mul_plain(torch.as_tensor(a), torch.as_tensor(b))
    else:
        a = np.ascontiguousarray(np.concatenate([edge, rand]))
        out = np.empty_like(a)
        host_lib.dth_mont_sqr(_ptr(a), _ptr(out), len(a), _ptr(F.kernel_arg))
        want = F._mont_sqr_plain(torch.as_tensor(a))
    np.testing.assert_array_equal(out, want.numpy())


_REPUNIT_EXP = (((1 << 110) - 1) << 24) | 0b101100111010110110000111


@pytest.mark.parametrize("name,which", [("fp", "m-2"), ("fp", "(m+1)/4"),
                                        ("fr", "m-2"), ("fp", "repunit"),
                                        ("fr", "repunit")])
def test_fp_pow_chain(host_lib, name, which):
    """K4's program of a whole addition chain (the odd table, repunit
    builds and every step in one run) on 0, 1, m-1 and random rows,
    against the plan's plain steps and pow."""
    F = FIELDS[name]
    m = F.modulus
    e = {"m-2": m - 2, "(m+1)/4": (m + 1) // 4, "repunit": _REPUNIT_EXP}[which]
    ops, build, _, _, used_odd = addchain_plan(e)
    codes, n_slots, e_prog = chain_program(ops, build, used_odd)
    assert e_prog == e
    a = _elements(F, n=14, seed=49)
    steps = np.asarray(codes, np.int32)
    scratch = np.zeros(n_slots * 12 * len(a), np.uint32)
    out = np.empty_like(a)
    host_lib.dth_fp_pow_chain(_ptr(a), None, _ptr(out), len(a), _ptr(steps),
                              len(steps), _ptr(scratch), _ptr(F.kernel_arg))
    want = F._pow_addchain_plain(torch.as_tensor(a), ops, build, used_odd)
    np.testing.assert_array_equal(out, want.numpy())
    assert [F.from_limbs_host(r) for r in out] == \
        [pow(F.from_limbs_host(r), e, m) for r in a]


def _fp_rows(shape, seed):
    """Canonical Fp limbs of `shape` + (32,): 0, 1, p-1, then random."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    vals = [0, 1, P - 1] + [int.from_bytes(rng.bytes(48), "little") % P
                            for _ in range(n - 3)]
    return np.ascontiguousarray(FP.encode(vals[:n]).reshape(shape + (32,)))


def _fp2_list(st):
    return T._fp2_unstack(torch.as_tensor(st))


@pytest.mark.parametrize("n", [1, 4, 9])
def test_fp2_products_and_sqrs(host_lib, n):
    """K5/K6 on [n, 2, rows, 32] stacks: coordinates 0, 1, p-1 and random
    values meet each other across the pairs."""
    x = _fp_rows((n, 2, 7), seed=6)
    y = np.ascontiguousarray(_fp_rows((n, 2, 7), seed=7)[:, ::-1])
    out = np.empty_like(x)
    host_lib.dth_fp2_products(_ptr(x), _ptr(y), _ptr(out), 7, n, 0,
                              _ptr(FP.kernel_arg))
    want = T._fp2_products_plain(list(zip(_fp2_list(x), _fp2_list(y))))
    np.testing.assert_array_equal(out, T._fp2_stack(want).numpy())
    host_lib.dth_fp2_sqrs(_ptr(x), _ptr(out), 7, n, 0, _ptr(FP.kernel_arg))
    want = T._fp2_sqrs_plain(_fp2_list(x))
    np.testing.assert_array_equal(out, T._fp2_stack(want).numpy())


def _max_flat():
    """Every stored coefficient p - 1: the largest convolution values."""
    row = np.asarray([((P - 1) >> (12 * i)) & 0xFFF for i in range(32)],
                     np.int32)
    return np.tile(row, (12, 1))


@pytest.mark.parametrize("reverse", [0, 1])
@pytest.mark.parametrize("n", [1, 2, 5])
def test_fp2_products_lanes(host_lib, n, reverse):
    """K5's two lanes a pair-row (half h of the product on lane h,
    fp2_half), in the kernel's order and in reverse, on n pairs whose
    coordinates hold 0, 1, p-1 against each other and random values,
    against the plain products."""
    rows = 11
    x = _fp_rows((n, 2, rows), seed=70 + n)
    y = np.ascontiguousarray(_fp_rows((n, 2, rows), seed=71 + n)[:, ::-1])
    edge = FP.encode([0, 1, P - 1])
    for r in range(9):                    # every pair of 0, 1, p-1
        x[0, :, r] = edge[r // 3]
        y[0, :, r] = edge[r % 3]
    x[0, 1, 9], y[0, 0, 10] = edge[2], edge[1]
    out = np.empty_like(x)
    host_lib.dth_fp2_products(_ptr(x), _ptr(y), _ptr(out), rows, n, reverse,
                              _ptr(FP.kernel_arg))
    want = T._fp2_products_plain(list(zip(_fp2_list(x), _fp2_list(y))))
    np.testing.assert_array_equal(out, T._fp2_stack(want).numpy())


def _raw(vals):
    """Stored limbs of the values themselves (not their Montgomery forms):
    raw p - 1 is the largest stored value."""
    return np.stack([int_to_limbs(v) for v in vals]).astype(np.int32)


@pytest.mark.parametrize("reverse", [0, 1])
@pytest.mark.parametrize("n", [1, 4, 8])
def test_fp2_sqrs_lanes(host_lib, n, reverse):
    """K6's two lanes a row (half h of the square on lane h,
    fp2_sqr_lane32 on the 32-bit carry chains), in the kernel's order and
    in reverse, at the path's n = 1, 4 and 8: item 0's rows hold every
    pair of 0, 1, p-1 (Montgomery and raw), x1 = 0 and x0 = x1 on random
    x0, and the all-(p-1) row; the other items random, against the plain
    squares."""
    rows = 40
    x = _fp_rows((n, 2, rows), seed=90 + n)
    edge = np.concatenate([FP.encode([0, 1, P - 1]), _raw([1, P - 1])])
    for r in range(25):                   # every pair of the five
        x[0, 0, r], x[0, 1, r] = edge[r // 5], edge[r % 5]
    x[0, 1, 25:29] = 0                    # x1 = 0
    x[0, 1, 29:33] = x[0, 0, 29:33]       # x0 = x1
    x[0, :, 33] = _raw([P - 1])[0]
    out = np.empty_like(x)
    host_lib.dth_fp2_sqrs(_ptr(x), _ptr(out), rows, n, reverse,
                          _ptr(FP.kernel_arg))
    want = T._fp2_sqrs_plain(_fp2_list(x))
    np.testing.assert_array_equal(out, T._fp2_stack(want).numpy())


# b's powers: dense and LINE_IDX (the paths'), and other sparse sets
FLAT_B_IDX = [tuple(range(12)), (0, 2, 3, 6, 8, 9), (1, 4, 11), (11,),
              (0, 5, 6, 11)]


@pytest.mark.parametrize("b_idx", FLAT_B_IDX)
def test_flat_mul(host_lib, b_idx):
    """K13 dense, on the Miller loop's sparse line layout, and on odd
    sparse layouts: rows 0 and 1 hold the all-(p-1) operand on one and on
    both sides; rows 2-10 one of 0, 1, p-1 in every slot of a and one in
    every slot of b (all nine pairings), rows 11-16 slots cycling through
    the three at two strides, so every slot meets every value on both
    sides; the rest random."""
    J = len(b_idx)
    a = _fp_rows((21, 12), seed=8)
    b = _fp_rows((21, J), seed=9)
    a[0] = a[1] = _max_flat()
    b[1] = _max_flat()[:J]
    edge = FP.encode([0, 1, P - 1])
    for r in range(9):
        a[2 + r], b[2 + r] = edge[r // 3], edge[r % 3]
    for r in range(6):
        a[11 + r] = edge[(np.arange(12) + r) % 3]
        b[11 + r] = edge[(2 * np.arange(J) + r // 2) % 3]
    out = np.empty_like(a)
    idx = np.asarray(b_idx, np.int32)
    host_lib.dth_flat_mul(_ptr(a), _ptr(b), _ptr(out), len(a), _ptr(idx), J,
                          0, _ptr(FP.kernel_arg))
    np.testing.assert_array_equal(
        out, F._flat_mul_plain(torch.as_tensor(a), torch.as_tensor(b),
                               b_idx).numpy())


@pytest.mark.parametrize("reverse", [0, 1])
def test_flat_mul_karatsuba(host_lib, reverse):
    """K13's dense instance, one Karatsuba level on the w^6 split in three
    phases (P0 and P1, the half sums in place, the middle product), each
    phase's classes in the kernel's order and in reverse (a class that
    read what another writes in its phase would fail), on random rows and
    on rows whose half sums a_j + a_(j+6), b_j + b_(j+6) wrap past p or
    land just below it, against the plain product."""
    a = _fp_rows((10, 12), seed=80)
    b = _fp_rows((10, 12), seed=81)
    wrap = FP.encode([P - 1, 1, (P + 1) // 2, (P + 1) // 2, P - 1, P - 1,
                      P - 2, 1])
    for r, (lo, hi) in enumerate(((0, 1), (2, 3), (4, 5), (6, 7))):
        a[r, :6], a[r, 6:] = wrap[lo], wrap[hi]       # sums p, p+1, 2p-2, p-1
        b[r, :6], b[r, 6:] = wrap[hi], wrap[lo]
    a[4], b[5] = _max_flat(), _max_flat()
    out = np.empty_like(a)
    idx = np.arange(12, dtype=np.int32)
    host_lib.dth_flat_mul(_ptr(a), _ptr(b), _ptr(out), len(a), _ptr(idx), 12,
                          reverse, _ptr(FP.kernel_arg))
    np.testing.assert_array_equal(
        out, F._flat_mul_plain(torch.as_tensor(a), torch.as_tensor(b)).numpy())


@pytest.mark.parametrize("k", [1, 2, 3, 9, 16, 32])
def test_cyclo_sqr(host_lib, k):
    """K14's chain of k squares (the run lengths of the final
    exponentiation's ladder), its shares in the kernel's order and in
    reverse, on random canonical rows (not unitary: the kernel must
    compute the plain version's function everywhere) and on the
    all-(p-1) row, against k plain squares."""
    a = _fp_rows((9, 12), seed=10)
    a[0] = _max_flat()
    out = np.empty_like(a)
    want = torch.as_tensor(a)
    for _ in range(k):
        want = F._flat_cyclo_sqr_plain(want)
    for reverse in (0, 1):
        host_lib.dth_cyclo_sqr(_ptr(a), _ptr(out), len(a), k, reverse,
                               _ptr(FP.kernel_arg))
        np.testing.assert_array_equal(out, want.numpy())


@pytest.mark.parametrize("k", [0, 1, 5, 13])
def test_fp2_sqr_chain_mul(host_lib, k):
    """K7 with and without t (x^(2^k) * t, x^(2^k)), its lanes in the
    kernel's order and in reverse; K8 = K7 at k = 5."""
    x = _fp_rows((2, 9), seed=20)
    t = np.ascontiguousarray(_fp_rows((2, 9), seed=21)[:, ::-1])
    out = np.empty_like(x)
    for tt in ((None, t) if k else (t,)):
        want = T._fp2_sqr_chain_mul_plain(
            torch.as_tensor(x), k, None if tt is None else torch.as_tensor(tt))
        for reverse in (0, 1):
            host_lib.dth_fp2_sqr_chain_mul(
                _ptr(x), None if tt is None else _ptr(tt), _ptr(out), 9, k,
                reverse, _ptr(FP.kernel_arg))
            np.testing.assert_array_equal(out, want.numpy())
    if k == 5:
        host_lib.dth_fp2_sqr5_mul(_ptr(x), _ptr(t), _ptr(out), 9,
                                  _ptr(FP.kernel_arg))
        np.testing.assert_array_equal(out, T._fp2_sqr_chain_mul_plain(
            torch.as_tensor(x), 5, torch.as_tensor(t)).numpy())


@pytest.mark.parametrize("reverse", [0, 1])
@pytest.mark.parametrize("k", [1, 2, 5, 6, 13, 63])
def test_fp2_sqr_chain_lanes(host_lib, k, reverse):
    """K7's two-lane chain (half h of each square and of the product on
    lane h, the halves swapped after each square) at the chain lengths of
    the path's addition chains and at k = 63, with and without t, its
    lanes in the kernel's order and in reverse (a lane that read the
    half its partner writes in the same step would fail), on 0, 1, p-1
    and random coordinates, against the plain chain."""
    x = _fp_rows((2, 12), seed=60 + k)
    x[:, 3] = x[:, 4]                     # a = b
    t = np.ascontiguousarray(_fp_rows((2, 12), seed=61 + k)[:, ::-1])
    out = np.empty_like(x)
    for tt in (None, t):
        host_lib.dth_fp2_sqr_chain_mul(
            _ptr(x), None if tt is None else _ptr(tt), _ptr(out), 12, k,
            reverse, _ptr(FP.kernel_arg))
        want = T._fp2_sqr_chain_mul_plain(
            torch.as_tensor(x), k, None if tt is None else torch.as_tensor(tt))
        np.testing.assert_array_equal(out, want.numpy())


@pytest.mark.parametrize("n", [1, 2, 3])
def test_flat_conj_and_frob(host_lib, n):
    """K15 and K16 on random canonical rows and the all-(p-1) row."""
    a = _fp_rows((7, 12), seed=22)
    a[0] = _max_flat()
    out = np.empty_like(a)
    host_lib.dth_flat_frob(_ptr(a), _ptr(out), len(a),
                           _ptr(F._FROB_WORDS[n]), _ptr(FP.kernel_arg))
    np.testing.assert_array_equal(
        out, F._flat_frob_plain(torch.as_tensor(a), n).numpy())
    host_lib.dth_flat_conj(_ptr(a), _ptr(out), len(a), _ptr(FP.kernel_arg))
    np.testing.assert_array_equal(
        out, F._flat_conj_plain(torch.as_tensor(a)).numpy())


_FROB_CLASS = {"zero": 0, "one": 1, "neg": 2, "mul": 3}   # dt::FrobClass


def _frob_class_words():
    """The words of 0, one (R mod p) and minus one in Montgomery form, by
    class name."""
    return {"zero": int_to_words(0), "one": int_to_words(FP.R_int),
            "neg": int_to_words((P - FP.R_int) % P)}


def _classify(words):
    """A constant's class from its 6 words, as K16's entry point sorts it."""
    for name, w in _frob_class_words().items():
        if np.array_equal(np.asarray(words, np.uint64), w.astype(np.uint64)):
            return name
    return "mul"


@pytest.mark.parametrize("n", [1, 2, 3])
def test_flat_frob_classes(host_lib, n):
    """K16's classes of the 24 constants of f^(p^n), found from their
    words, equal a classification made here: 17, 8 and 12 general
    products at n = 1, 2, 3; at n = 2 every matrix diagonal, slot 0 the
    identity and slot 3 its negation."""
    consts = F._FROB_WORDS[n]
    cls = np.empty(24, np.int32)
    host_lib.dth_frob_classes(_ptr(consts), _ptr(FP.kernel_arg), _ptr(cls))
    want = [_classify(consts[s, q]) for s in range(6) for q in range(4)]
    assert cls.tolist() == [_FROB_CLASS[c] for c in want]
    assert want.count("mul") == {1: 17, 2: 8, 3: 12}[n]
    if n == 2:
        table = np.array(want).reshape(6, 4)
        assert (table[:, 1] == "zero").all() and (table[:, 2] == "zero").all()
        assert list(table[0]) == ["one", "zero", "zero", "one"]
        assert list(table[3]) == ["neg", "zero", "zero", "neg"]


@pytest.mark.parametrize("n", [1, 2, 3])
def test_flat_frob_warps(host_lib, n):
    """K16 as its twelve warps (an output coefficient each, every term by
    its constant's class) on random rows, zero rows and all-(p-1) rows,
    against its plain version."""
    a = _fp_rows((9, 12), seed=60 + n)
    a[1] = a[4] = 0
    a[2] = a[7] = _max_flat()
    out = np.empty_like(a)
    host_lib.dth_flat_frob(_ptr(a), _ptr(out), len(a),
                           _ptr(F._FROB_WORDS[n]), _ptr(FP.kernel_arg))
    np.testing.assert_array_equal(
        out, F._flat_frob_plain(torch.as_tensor(a), n).numpy())


@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_flat_frob_every_class_everywhere(host_lib, shift):
    """K16 on made-up tables in which constant (s, q) has class (4s + q +
    shift) mod 4, so over the four shifts every class stands at every
    place of the 6 x 4 table (a general constant random): its output
    against the plain products by the same constants, summed by
    Field.add."""
    rng = np.random.default_rng(64 + shift)
    named = _frob_class_words()
    consts = np.zeros((6, 4, 6), np.uint64)
    limbs = np.zeros((4, 6, 32), np.int32)
    for s in range(6):
        for q in range(4):
            name = list(_FROB_CLASS)[(4 * s + q + shift) % 4]
            v = (int.from_bytes(rng.bytes(48), "little") % P if name == "mul"
                 else sum(int(w) << (64 * i)
                          for i, w in enumerate(named[name])))
            consts[s, q] = int_to_words(v)
            limbs[q, s] = int_to_limbs(v)
    cls = np.empty(24, np.int32)
    host_lib.dth_frob_classes(_ptr(consts), _ptr(FP.kernel_arg), _ptr(cls))
    assert cls.tolist() == [(4 * s + q + shift) % 4
                            for s in range(6) for q in range(4)]
    a = _fp_rows((5, 12), seed=68 + shift)
    a[1] = 0
    a[2] = _max_flat()
    out = np.empty_like(a)
    host_lib.dth_flat_frob(_ptr(a), _ptr(out), len(a), _ptr(consts),
                           _ptr(FP.kernel_arg))
    ta = torch.as_tensor(a)
    lo, hi = ta[:, :6], ta[:, 6:]
    A, B, C, D = (torch.as_tensor(limbs[q]).expand(lo.shape) for q in range(4))
    mul = FP._mont_mul_plain
    want = torch.cat([FP.add(mul(lo, A), mul(hi, B)),
                      FP.add(mul(lo, C), mul(hi, D))], -2)
    np.testing.assert_array_equal(out, want.numpy())


def _conj_edges():
    """Stored coefficients for K15's limb-level negation: 0, 1, 2, p-1
    (raw: p - a is 1) and their Montgomery forms; coefficients whose
    chunks above a borrowing chunk equal p's (chunk 0 above p's chunk 0,
    chunks 1-6 equal p's, chunk 7 below: the borrow crosses six lanes;
    the same from chunk 0 into chunk 4 and from chunk 2 into chunk 7);
    one whose chunks equal p's but the lowest, which is below; one zero
    but for its top chunk; and the all-(p-1) coefficient."""
    mask = (1 << 48) - 1
    c = [(P >> (48 * j)) & mask for j in range(8)]

    def from_chunks(ch):
        v = sum(x << (48 * j) for j, x in enumerate(ch))
        assert v < P
        return v

    cross = [from_chunks([c[0] + 1] + c[1:7] + [c[7] - 1]),
             from_chunks([c[0] + 1] + c[1:4] + [c[4] - 1] + c[5:]),
             from_chunks(c[:2] + [c[2] + 5] + c[3:7] + [c[7] - 1]),
             from_chunks([c[0] - 7] + c[1:]),
             from_chunks([0] * 7 + [c[7] - 1])]
    return np.concatenate([_raw([0, 1, 2, P - 1] + cross),
                           FP.encode([1, 2, P - 1])])


def test_flat_conj_lanes(host_lib):
    """K15's lanes, eight a coefficient and a warp's three masks built
    lane by lane as the kernel's ballots give them: every edge coefficient
    (_conj_edges) in odd and even slots, rows whose coefficients are all
    zero, all p-1 or all one edge value, then random rows, against the
    plain conjugation."""
    edges = _conj_edges()
    E = len(edges)
    rows = E + 2 * E + 3 + 4
    a = _fp_rows((rows, 12), seed=23)
    for r in range(E):                    # each edge in every slot
        a[r] = edges[(np.arange(12) + r) % E]
    for r in range(E):                    # rows of one edge value
        a[E + r] = edges[r]
    for r in range(E):                    # odd slots only
        a[2 * E + r, 1::2] = edges[r]
    a[3 * E] = 0
    a[3 * E + 1] = _max_flat()
    a[3 * E + 2, ::2] = 0
    out = np.empty_like(a)
    host_lib.dth_flat_conj(_ptr(a), _ptr(out), rows, _ptr(FP.kernel_arg))
    want = F._flat_conj_plain(torch.as_tensor(a)).numpy()
    np.testing.assert_array_equal(out, want)
    assert (out[3 * E] == 0).all()


def _g2_cases(seed):
    """[6, rows, 32] point pairs (p1, p2) over random coordinates: rows 0-5
    random, then p2 = p1 (doubling), p2 = -p1 (cancels), p2 = p1 with its
    coordinates scaled by (l^2, l^3, l) (the same point), p1 infinite,
    p2 infinite, both infinite."""
    p1 = _fp_rows((6, 12), seed=seed)
    p2 = _fp_rows((6, 12), seed=seed + 1)
    t1 = torch.as_tensor(p1)
    pt = C.g2_unpack(t1)
    p2[:, 6] = p1[:, 6]
    neg = C.g2_pack((pt[0], T.fp2_neg(pt[1]), pt[2])).numpy()
    p2[:, 7] = neg[:, 7]
    lam = T._fp2_unstack(torch.as_tensor(_fp_rows((1, 2, 12), seed=seed + 2)))[0]
    l2 = C.Fp2PlainOps.sqr(lam)
    l3 = C.Fp2PlainOps.mul(l2, lam)
    scaled = C.g2_pack(tuple(C.Fp2PlainOps.mul(c, s)
                             for c, s in zip(pt, (l2, l3, lam)))).numpy()
    p2[:, 8] = scaled[:, 8]
    p1[4:, 9] = 0
    p2[4:, 10] = 0
    p1[4:, 11] = p2[4:, 11] = 0
    return p1, p2


def test_g2_point_dbl_and_add(host_lib):
    """K9 and K10 (with and without the doubling) against the formulas of
    ops/curve.py under Fp2PlainOps, special cases included."""
    p1, p2 = _g2_cases(seed=23)
    out = np.empty_like(p1)
    rows = p1.shape[1]
    host_lib.dth_g2_point_dbl(_ptr(p1), _ptr(out), rows, 1, 0,
                              _ptr(FP.kernel_arg))
    want = C._point_double_formula(C.g2_unpack(torch.as_tensor(p1)),
                                   C.Fp2PlainOps)
    np.testing.assert_array_equal(out, C.g2_pack(want).numpy())
    for with_double in (False, True):
        host_lib.dth_g2_point_add(_ptr(p1), _ptr(p2), _ptr(out), rows,
                                  int(with_double), 0, _ptr(FP.kernel_one),
                                  _ptr(FP.kernel_arg))
        want = C._point_add_formula(C.g2_unpack(torch.as_tensor(p1)),
                                    C.g2_unpack(torch.as_tensor(p2)),
                                    C.Fp2PlainOps, with_double)
        np.testing.assert_array_equal(out, C.g2_pack(want).numpy())


@pytest.mark.parametrize("seed", [46, 47])
@pytest.mark.parametrize("reverse", [0, 1])
@pytest.mark.parametrize("with_double", [False, True])
def test_g2_point_add_shares(host_lib, with_double, reverse, seed):
    """K10's level shares, in the kernel's order and in reverse (a share
    that read what another share of its level writes would fail), with
    and without the doubling, on the _g2_cases rows (P1 = P2, P2 = -P1,
    the same point under another Z, either or both points infinite) and
    on the pairs swapped, against the formula of ops/curve.py under
    Fp2PlainOps."""
    p1, p2 = _g2_cases(seed=seed)
    rows = p1.shape[1]
    out = np.empty_like(p1)
    for a, b in ((p1, p2), (p2, p1)):
        host_lib.dth_g2_point_add(_ptr(a), _ptr(b), _ptr(out), rows,
                                  int(with_double), reverse,
                                  _ptr(FP.kernel_one), _ptr(FP.kernel_arg))
        want = C._point_add_formula(C.g2_unpack(torch.as_tensor(a)),
                                    C.g2_unpack(torch.as_tensor(b)),
                                    C.Fp2PlainOps, with_double)
        np.testing.assert_array_equal(out, C.g2_pack(want).numpy())
    # the row P1 = P2 doubles only with the doubling (without it h = 0,
    # so Z = 0)
    np.testing.assert_array_equal(out[4:, 6] == 0, not with_double)


@pytest.mark.parametrize("reverse", [0, 1])
@pytest.mark.parametrize("n", [1, 2, 3, 9, 32])
def test_g2_point_dbl_chain(host_lib, n, reverse):
    """K9's chain of n doublings split into its level shares, run in the
    kernel's order and in reverse, on the _g2_cases rows (infinite ones
    among them), against n plain doublings."""
    for p in _g2_cases(seed=45):
        out = np.empty_like(p)
        host_lib.dth_g2_point_dbl(_ptr(p), _ptr(out), p.shape[1], n, reverse,
                                  _ptr(FP.kernel_arg))
        pt = C.g2_unpack(torch.as_tensor(p))
        for _ in range(n):
            pt = C._point_double_formula(pt, C.Fp2PlainOps)
        np.testing.assert_array_equal(out, C.g2_pack(pt).numpy())
        inf = (p[4:] == 0).all(axis=(0, 2))
        assert inf.any() and (out[4:, inf] == 0).all()


@pytest.mark.parametrize("reverse", [0, 1])
def test_miller_iterations(host_lib, reverse):
    """K11 and K12 on random rows, the shares of each phase (K11's split
    doubling step, the product classes) in the kernel's order and in
    reverse: f, T (Z = 1 in row 0, as at the loop's start), P, Q, and
    masks with every active/inactive combination; against their plain
    versions (the lines merged first, as drand_tpu does), and f' against
    f^2 (K11) or f (K12) times the two masked lines one after the other,
    as the kernels multiply them."""
    rows = 8
    f = _fp_rows((rows, 12), seed=24)
    f[1] = _max_flat()
    Ts = _fp_rows((rows, 2, 6), seed=25)
    Ts[0, :, 4] = FP.one_mont.numpy()
    Ts[0, :, 5] = 0
    P = _fp_rows((rows, 2, 2), seed=26)
    Q = _fp_rows((rows, 2, 4), seed=27)
    masks = np.array([[1, 1], [1, 0], [0, 1], [0, 0]] * 2, np.int32)
    fo, To = np.empty_like(f), np.empty_like(Ts)
    tf, tT, tP, tQ, tm = map(torch.as_tensor, (f, Ts, P, Q, masks))

    def lines_one_by_one(g, lines):
        one = PR.line_one(tm.shape[:-1], tm.device)
        for k in range(2):
            lk = tuple((x[0][k], x[1][k]) for x in lines)
            lk = PR.line_to_flat(PR.line_select(tm[:, k] != 0, lk, one))
            g = F._flat_mul_plain(g, lk, F.LINE_IDX)
        return g

    X0, X1, Y0, Y1, Z0, Z1 = PR._pair_major(tT)
    Tj = ((X0, X1), (Y0, Y1), (Z0, Z1))
    xp, yp = PR._pair_major(tP)
    host_lib.dth_miller_dbl_iter(_ptr(f), _ptr(Ts), _ptr(P), _ptr(masks),
                                 _ptr(fo), _ptr(To), rows, reverse,
                                 _ptr(FP.kernel_one), _ptr(FP.kernel_arg))
    wf, wT = PR._miller_dbl_iter_plain(tf, tT, tP, tm)
    np.testing.assert_array_equal(fo, wf.numpy())
    np.testing.assert_array_equal(To, wT.numpy())
    _, lines = PR._dbl_step_plain(Tj, xp, yp)
    np.testing.assert_array_equal(
        fo, lines_one_by_one(F._flat_mul_plain(tf, tf), lines).numpy())
    host_lib.dth_miller_add_iter(_ptr(f), _ptr(Ts), _ptr(Q), _ptr(P),
                                 _ptr(masks), _ptr(fo), _ptr(To), rows,
                                 reverse, _ptr(FP.kernel_one),
                                 _ptr(FP.kernel_arg))
    wf, wT = PR._miller_add_iter_plain(tf, tT, tQ, tP, tm)
    np.testing.assert_array_equal(fo, wf.numpy())
    np.testing.assert_array_equal(To, wT.numpy())
    xq0, xq1, yq0, yq1 = PR._pair_major(tQ)
    _, lines = PR._add_step_plain(Tj, ((xq0, xq1), (yq0, yq1)), xp, yp)
    np.testing.assert_array_equal(fo, lines_one_by_one(tf, lines).numpy())


def test_flat_sqr(host_lib):
    """K17's class loop (each coefficient folded into the output rows as
    it is reduced) on 33 rows, a count that is not a multiple of the
    kernel's 32-row block: random rows, the all-(p-1) row and the zero
    row, against its plain version and the general product K13."""
    a = _fp_rows((33, 12), seed=40)
    a[0] = _max_flat()
    a[1] = 0
    out = np.empty_like(a)
    host_lib.dth_flat_sqr(_ptr(a), _ptr(out), len(a), _ptr(FP.kernel_arg))
    ta = torch.as_tensor(a)
    np.testing.assert_array_equal(out, F._flat_sqr_plain(ta).numpy())
    prod = np.empty_like(a)
    idx = np.arange(12, dtype=np.int32)
    host_lib.dth_flat_mul(_ptr(a), _ptr(a), _ptr(prod), len(a), _ptr(idx),
                          12, 0, _ptr(FP.kernel_arg))
    np.testing.assert_array_equal(out, prod)


def test_line_merge(host_lib):
    """K20 on random lines with the all-(p-1) line on one and on both
    sides and a zero line, against its plain version."""
    l1 = _fp_rows((7, 6), seed=41)
    l2 = _fp_rows((7, 6), seed=42)
    l1[0] = l1[1] = _max_flat()[:6]
    l2[1] = _max_flat()[:6]
    l2[2] = 0
    out = np.empty((7, 12, 32), np.int32)
    host_lib.dth_line_merge(_ptr(l1), _ptr(l2), _ptr(out), len(l1),
                            _ptr(FP.kernel_arg))
    np.testing.assert_array_equal(out, F._line_merge_plain(
        torch.as_tensor(l1), torch.as_tensor(l2)).numpy())


@pytest.mark.parametrize("add", [False, True])
def test_g2_line_steps(host_lib, add):
    """K18 (doubling) and K19 (mixed addition) on K = 3 pairs stacked on
    the leading axis of 5 rows each (Z = 1 in the first row of each pair,
    as at the loop's start), against the step formulas."""
    width = 12 if add else 8
    x = _fp_rows((3, 5, width), seed=43 + add)
    x[:, 0, 4] = FP.one_mont.numpy()
    x[:, 0, 5] = 0
    to = np.empty((3, 5, 6, 32), np.int32)
    lo = np.empty_like(to)
    if add:
        host_lib.dth_g2_add_line(_ptr(x), _ptr(to), _ptr(lo), 15, 0,
                                 _ptr(FP.kernel_arg))
    else:
        host_lib.dth_g2_dbl_line(_ptr(x), _ptr(to), _ptr(lo), 15, 0,
                                 _ptr(FP.kernel_arg))
    c = [torch.as_tensor(x[..., i, :]) for i in range(width)]
    Tj = ((c[0], c[1]), (c[2], c[3]), (c[4], c[5]))
    if add:
        Tn, L = PR._add_step_plain(Tj, ((c[6], c[7]), (c[8], c[9])), c[10],
                                   c[11])
    else:
        Tn, L = PR._dbl_step_plain(Tj, c[6], c[7])
    np.testing.assert_array_equal(
        to, torch.stack([v for xy in Tn for v in xy], -2).numpy())
    np.testing.assert_array_equal(
        lo, torch.stack([v for xy in L for v in xy], -2).numpy())


def _dbl_line_rows(seed):
    """K = 3 pairs stacked on 6 rows each, [3, 6, 8, 32] (X0 X1 Y0 Y1 Z0
    Z1 xp yp): Z = 1 in row 0 (as at the loop's start), Z = 0 (infinity)
    in row 1, 0, 1, p-1 among the coordinates, random elsewhere."""
    x = _fp_rows((3, 6, 8), seed=seed)
    x[:, 0, 4] = FP.one_mont.numpy()
    x[:, 0, 5] = 0
    x[:, 1, 4:6] = 0
    return x


def _dbl_step_plain_rows(x):
    """_dbl_step_plain on rows [..., 8, 32]: (T', the line triple), each
    [..., 6, 32]."""
    c = [torch.as_tensor(x[..., i, :]) for i in range(8)]
    Tn, L = PR._dbl_step_plain(((c[0], c[1]), (c[2], c[3]), (c[4], c[5])),
                               c[6], c[7])
    return tuple(torch.stack([v for xy in o for v in xy], -2).numpy()
                 for o in (Tn, L))


@pytest.mark.parametrize("reverse", [0, 1])
def test_g2_dbl_line_shares(host_lib, reverse):
    """K18 as K11's doubling shares on the kernel's row buffer (P staged
    beside T, T' over T, the unmasked line triple), the shares of each
    level in the kernel's order and reversed, on K = 3 stacked pairs with
    Z = 1 and Z = 0 rows, against _dbl_step_plain."""
    x = _dbl_line_rows(seed=70 + reverse)
    to = np.empty((3, 6, 6, 32), np.int32)
    lo = np.empty_like(to)
    host_lib.dth_g2_dbl_line(_ptr(x), _ptr(to), _ptr(lo), 18, reverse,
                             _ptr(FP.kernel_arg))
    want_t, want_l = _dbl_step_plain_rows(x)
    np.testing.assert_array_equal(to, want_t)
    np.testing.assert_array_equal(lo, want_l)
    assert (to[:, 1, 4:6] == 0).all()             # 2 * infinity = infinity


def test_dbl_shares_agree_across_executors(host_lib):
    """One share body, two executors: on the same T and P (two pairs a
    row, every pair mask), K11's T' equals K18's, and K11's f' equals f^2
    times the two pairs' K18 lines, masked and made flat, one after the
    other (as test_miller_iterations holds f' to the plain lines)."""
    rows = 6
    f = _fp_rows((rows, 12), seed=72)
    x = _dbl_line_rows(seed=73)[:2].transpose(1, 0, 2, 3)   # [rows, 2, 8]
    Ts = np.ascontiguousarray(x[:, :, :6])
    Pp = np.ascontiguousarray(x[:, :, 6:])
    masks = np.array([[1, 1], [1, 0], [0, 1], [0, 0], [1, 1], [0, 1]],
                     np.int32)
    fo, To = np.empty_like(f), np.empty_like(Ts)
    host_lib.dth_miller_dbl_iter(_ptr(f), _ptr(Ts), _ptr(Pp), _ptr(masks),
                                 _ptr(fo), _ptr(To), rows, 0,
                                 _ptr(FP.kernel_one), _ptr(FP.kernel_arg))
    xs = np.ascontiguousarray(x.transpose(1, 0, 2, 3))      # [2, rows, 8]
    to = np.empty((2, rows, 6, 32), np.int32)
    lo = np.empty_like(to)
    host_lib.dth_g2_dbl_line(_ptr(xs), _ptr(to), _ptr(lo), 2 * rows, 0,
                             _ptr(FP.kernel_arg))
    np.testing.assert_array_equal(To, to.transpose(1, 0, 2, 3))
    tm = torch.as_tensor(masks)
    g = F._flat_mul_plain(torch.as_tensor(f), torch.as_tensor(f))
    one = PR.line_one(tm.shape[:-1], tm.device)
    for k in range(2):
        lk = torch.as_tensor(lo[k])
        lk = tuple((lk[:, 2 * i], lk[:, 2 * i + 1]) for i in range(3))
        lk = PR.line_to_flat(PR.line_select(tm[:, k] != 0, lk, one))
        g = F._flat_mul_plain(g, lk, F.LINE_IDX)
    np.testing.assert_array_equal(fo, g.numpy())


def _add_line_rows(seed):
    """K = 3 pairs stacked on 8 rows each, [3, 8, 12, 32] (X0 X1 Y0 Y1 Z0
    Z1 xq0 xq1 yq0 yq1 xp yp): Z = 1 in row 0 (the loop's start), Z = 0
    (infinity) in row 1, T = Q and T = -Q in affine form (Z = 1, so H = 0)
    in rows 2 and 3, 0, 1, p-1 among the coordinates, random elsewhere."""
    x = _fp_rows((3, 8, 12), seed=seed)
    x[:, 0, 4] = FP.one_mont.numpy()
    x[:, 0, 5] = 0
    x[:, 1, 4:6] = 0
    for row, sign in ((2, 1), (3, -1)):
        x[:, row, 0:2] = x[:, row, 6:8]
        x[:, row, 2:4] = (x[:, row, 8:10] if sign > 0 else
                          FP.neg(torch.as_tensor(x[:, row, 8:10])).numpy())
        x[:, row, 4] = FP.one_mont.numpy()
        x[:, row, 5] = 0
    return x


def _add_step_plain_rows(x):
    """_add_step_plain on rows [..., 12, 32]: (T', the line triple), each
    [..., 6, 32]."""
    c = [torch.as_tensor(x[..., i, :]) for i in range(12)]
    Tn, L = PR._add_step_plain(((c[0], c[1]), (c[2], c[3]), (c[4], c[5])),
                               ((c[6], c[7]), (c[8], c[9])), c[10], c[11])
    return tuple(torch.stack([v for xy in o for v in xy], -2).numpy()
                 for o in (Tn, L))


@pytest.mark.parametrize("reverse", [0, 1])
def test_g2_add_line_shares(host_lib, reverse):
    """K19 as K12's addition shares on the kernel's row buffer (P staged
    beside T and Q, T' where no later share reads, the unmasked line
    triple), the shares of each level in the kernel's order and reversed,
    on K = 3 stacked pairs with Z = 1, Z = 0, T = Q and T = -Q rows (H =
    0), against _add_step_plain."""
    x = _add_line_rows(seed=74 + reverse)
    to = np.empty((3, 8, 6, 32), np.int32)
    lo = np.empty_like(to)
    host_lib.dth_g2_add_line(_ptr(x), _ptr(to), _ptr(lo), 24, reverse,
                             _ptr(FP.kernel_arg))
    want_t, want_l = _add_step_plain_rows(x)
    np.testing.assert_array_equal(to, want_t)
    np.testing.assert_array_equal(lo, want_l)
    assert (to[:, 2:4, 4:6] == 0).all()           # H = 0: Z' = 0


def test_add_shares_agree_across_executors(host_lib):
    """One share body, two executors: on the same T, Q and P (two pairs a
    row, every pair mask), K12's T' equals K19's where the pair is active
    and T where it is not, and K12's f' equals f times the two pairs'
    K19 lines, masked and made flat, one after the other."""
    rows = 8
    f = _fp_rows((rows, 12), seed=76)
    x = _add_line_rows(seed=77)[:2].transpose(1, 0, 2, 3)   # [rows, 2, 12]
    Ts = np.ascontiguousarray(x[:, :, :6])
    Q = np.ascontiguousarray(x[:, :, 6:10])
    Pp = np.ascontiguousarray(x[:, :, 10:])
    masks = np.array([[1, 1], [1, 0], [0, 1], [0, 0]] * 2, np.int32)
    fo, To = np.empty_like(f), np.empty_like(Ts)
    host_lib.dth_miller_add_iter(_ptr(f), _ptr(Ts), _ptr(Q), _ptr(Pp),
                                 _ptr(masks), _ptr(fo), _ptr(To), rows, 0,
                                 _ptr(FP.kernel_one), _ptr(FP.kernel_arg))
    xs = np.ascontiguousarray(x.transpose(1, 0, 2, 3))      # [2, rows, 12]
    to = np.empty((2, rows, 6, 32), np.int32)
    lo = np.empty_like(to)
    host_lib.dth_g2_add_line(_ptr(xs), _ptr(to), _ptr(lo), 2 * rows, 0,
                             _ptr(FP.kernel_arg))
    active = masks.astype(bool)[..., None, None]
    np.testing.assert_array_equal(
        To, np.where(active, to.transpose(1, 0, 2, 3), Ts))
    tm = torch.as_tensor(masks)
    g = torch.as_tensor(f)
    one = PR.line_one(tm.shape[:-1], tm.device)
    for k in range(2):
        lk = torch.as_tensor(lo[k])
        lk = tuple((lk[:, 2 * i], lk[:, 2 * i + 1]) for i in range(3))
        lk = PR.line_to_flat(PR.line_select(tm[:, k] != 0, lk, one))
        g = F._flat_mul_plain(g, lk, F.LINE_IDX)
    np.testing.assert_array_equal(fo, g.numpy())


@pytest.mark.parametrize("name", ["fp", "fr"])
def test_add_and_sub(host_lib, name):
    """K21 and K22 with 0, 1, 2, m-1, m-2 and (m-1)/2 meeting each other
    and random values, against Field.add and Field.sub."""
    F_ = FIELDS[name]
    a = _elements(F_, n=20, seed=44)
    b = np.ascontiguousarray(np.concatenate([a[:6][::-1], a[6:]]))
    a, b = np.repeat(a, 6, 0), np.tile(b, (6, 1))
    out = np.empty_like(a)
    host_lib.dth_add(_ptr(a), _ptr(b), _ptr(out), len(a), _ptr(F_.kernel_arg))
    np.testing.assert_array_equal(
        out, F_.add(torch.as_tensor(a), torch.as_tensor(b)).numpy())
    host_lib.dth_sub(_ptr(a), _ptr(b), _ptr(out), len(a), _ptr(F_.kernel_arg))
    np.testing.assert_array_equal(
        out, F_.sub(torch.as_tensor(a), torch.as_tensor(b)).numpy())
