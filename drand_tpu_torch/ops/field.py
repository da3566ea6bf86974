"""Batched big-integer Montgomery arithmetic in PyTorch (int32 limbs).

Counterpart of `drand_tpu/ops/field.py`, with the same representation so
the two are compared limb for limb: a field element is `[..., 32]` int32,
32 little-endian limbs of 12 bits, value = sum(limb[i] << (12*i)).
Canonical elements have every limb in [0, 4096) and value in [0, modulus).
The Montgomery radix is R = 2^384.

Four operations run as hand-written CUDA kernels on a GPU tensor
(`ops/kernels.py`, sources in `csrc/`): the Montgomery multiply (K1), the
Montgomery square (K2), the reduction of a wide value (K3) and the
exponent executors' squaring chains (K4: a whole addition chain, so a
Fermat inversion, in one launch, or one step of the window); the Fp2, G2, Miller
and flat Fp12 kernels (K5-K16) are dispatched from `ops/towers.py`,
`ops/curve.py`, `ops/pairing.py` and `ops/flat12.py`.  Beside each kernel
sits
its plain PyTorch version (`_*_plain`), transcribed from the XLA path of
`drand_tpu/ops/field.py`; a CPU tensor takes the plain version, a CUDA
tensor the kernel.  Every output of the four is canonical, so kernel and
plain version agree bit for bit.

Everything else here (add, sub, neg, comparisons, the stacked helpers) is
plain tensor code on whatever device its inputs live on.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as TF

from drand_tpu_torch.ops import kernels as K

LIMB_BITS = 12
N_LIMBS = 32
LIMB_MASK = (1 << LIMB_BITS) - 1
TOTAL_BITS = LIMB_BITS * N_LIMBS  # 384; R = 2^384

I32 = torch.int32


# ---------------------------------------------------------------------------
# Host-side limb packing and static plans
# ---------------------------------------------------------------------------

def int_to_limbs(x: int, n: int = N_LIMBS) -> np.ndarray:
    """Python int -> [n] int32 limb array (little-endian, 12-bit limbs)."""
    if not 0 <= x < (1 << (LIMB_BITS * n)):
        raise ValueError("value out of limb range")
    return np.array([(x >> (LIMB_BITS * i)) & LIMB_MASK for i in range(n)],
                    dtype=np.int32)


def int_to_words(x: int) -> np.ndarray:
    """Non-negative int < 2^384 -> the kernels' 6 little-endian 64-bit
    words."""
    return np.array([(x >> (64 * i)) & (2 ** 64 - 1) for i in range(6)],
                    dtype=np.uint64)


def limbs_to_int(limbs) -> int:
    out = 0
    for i, l in enumerate(np.asarray(limbs).tolist()):
        out += int(l) << (LIMB_BITS * i)
    return out


def tail_segments(bits: str):
    """MSB-first bit string -> [(zero_run_len, has_set_bit)] segments, the
    static shape of every double-and-add ladder over a sparse constant."""
    segs, i, n = [], 0, len(bits)
    while i < n:
        j = i
        while j < n and bits[j] == "0":
            j += 1
        segs.append((j - i, j < n))
        i = j + 1
    return segs


def segmented_ladder(segments, state, dbl_fn, add_fn, run_fn=None):
    """Run a static ladder: each zero run doubles only, each set bit
    doubles then adds.  `state` is any value `dbl_fn`/`add_fn` accept.
    With `run_fn`, every run of n > 0 doublings in a row (a zero run and
    the doubling of the set bit after it) is one `run_fn(state, n)`."""
    for run, has_one in segments:
        n = run + has_one
        if run_fn is not None and n:
            state = run_fn(state, n)
        else:
            for _ in range(n):
                state = dbl_fn(state)
        if has_one:
            state = add_fn(state)
    return state


def _repunit_plan(lengths, seeds):
    """Steps (new, src, shift) building repunit powers a^(2^l - 1) by
    recursive halving: r_new = r_src^(2^shift) * r_shift."""
    have = set(seeds)
    steps = []

    def build_to(l):
        if l in have:
            return
        lo, hi = l // 2, l - l // 2
        build_to(hi)
        build_to(lo)
        steps.append((l, hi, lo))
        have.add(l)

    for l in sorted(lengths):
        build_to(l)
    return steps


@functools.lru_cache(maxsize=None)
def addchain_plan(e: int, w: int = 5, run_min: int = 99):
    """Compile a static exponent into an addition chain (sliding w-bit
    windows over an odd-power table, 1-runs of length >= run_min lifted to
    repunit powers).  Same planner as `drand_tpu.ops.field.addchain_plan`.

    Returns (ops, build, n_sqr, n_mul, used_odd); the plan is checked by
    replaying it on integers."""
    if e < 1 or w < 2:
        raise ValueError("addchain_plan needs e >= 1 and w >= 2")
    bits = bin(e)[2:]
    n = len(bits)
    ops = []
    i = 0
    pend = 0
    first = True
    used_odd = False
    rep_lens = set()
    while i < n:
        if bits[i] == "0":
            pend += 1
            i += 1
            continue
        j = i
        while j < n and bits[j] == "1":
            j += 1
        run = j - i
        if run >= run_min:
            rep_lens.add(run)
            if first:
                ops.append(("init_rep", run))
                first = False
            else:
                ops.append(("sqrmul_rep", pend + run, run))
            pend = 0
            i = j
        else:
            j2 = min(i + w, n)
            while bits[j2 - 1] == "0":
                j2 -= 1
            v = int(bits[i:j2], 2)
            used_odd = True
            if first:
                ops.append(("init_odd", v))
                first = False
            else:
                ops.append(("sqrmul_odd", pend + (j2 - i), v))
            pend = 0
            i = j2
    if pend:
        ops.append(("sqr", pend))
    seeds = set(range(1, w + 1)) if used_odd else {1}
    build = _repunit_plan(rep_lens, seeds)

    if _plan_exponent(ops, build) != e:
        raise AssertionError("addchain plan does not reproduce the exponent")

    n_sqr = sum(op[1] for op in ops if op[0] in
                ("sqrmul_rep", "sqrmul_odd", "sqr"))
    n_sqr += sum(shift for _, _, shift in build)
    n_mul = sum(1 for op in ops if op[0].startswith("sqrmul"))
    n_mul += len(build)
    if used_odd:
        n_sqr += 1
        n_mul += (1 << (w - 1)) - 1
    return tuple(ops), tuple(build), n_sqr, n_mul, used_odd


def _plan_exponent(ops, build) -> int:
    """The exponent an `addchain_plan` computes, by replaying it on
    integers (a length no build step makes is a seed, 2^l - 1)."""
    reps: dict = {}

    def rep(l):
        return reps.get(l, (1 << l) - 1)

    for new, src, shift in build:
        reps[new] = (rep(src) << shift) + rep(shift)
    acc = 0
    for op in ops:
        if op[0] == "init_rep":
            acc = rep(op[1])
        elif op[0] == "init_odd":
            acc = op[1]
        elif op[0] == "sqrmul_rep":
            acc = (acc << op[1]) + rep(op[2])
        elif op[0] == "sqrmul_odd":
            acc = (acc << op[1]) + op[2]
        else:
            acc <<= op[1]
    return acc


def _chain_table(ops, build, used_odd: bool):
    """(need, seed_lens) of an `addchain_plan`: the odd table runs a^1,
    a^3, ..., a^need, and the repunits a^(2^l - 1) of the lengths
    seed_lens (2..5) are its entries."""
    seed_lens = set()
    for _, src, shift in build:
        seed_lens.update(x for x in (src, shift) if 2 <= x <= 5)
    for op in ops:
        if op[0] in ("init_rep", "sqrmul_rep") and 2 <= op[-1] <= 5:
            seed_lens.add(op[-1])
    if not used_odd:
        return 1, set()
    need = max([op[2] for op in ops if op[0] == "sqrmul_odd"] +
               [op[1] for op in ops if op[0] == "init_odd"] +
               [(1 << l) - 1 for l in seed_lens] + [1])
    return need, seed_lens


@functools.lru_cache(maxsize=None)
def chain_program(ops, build, used_odd: bool):
    """Compile an `addchain_plan` into K4's program (`kernels.chain_code`
    steps, run on one row by one thread): the odd table a, a^2, a^3, ...,
    a^need into scratch slots, the repunit builds, then the plan's steps
    on the running value.  Returns (codes, scratch slots, the exponent).
    Raises ValueError for a plan the kernel cannot take: more table and
    repunit entries than its scratch slots, or a run of squares longer
    than a step holds."""
    need, seed_lens = _chain_table(ops, build, used_odd)
    slots: dict = {}

    def slot(key):
        return slots.setdefault(key, len(slots))

    SQRMUL, LOAD, STORE = K.CHAIN_SQRMUL, K.CHAIN_LOAD, K.CHAIN_STORE
    prog = [(STORE, 0, slot(1))]
    if used_odd:
        prog += [(SQRMUL, 1, K.CHAIN_NONE), (STORE, 0, slot("a2")),
                 (LOAD, 0, slot(1))]
        for v in range(3, need + 1, 2):
            prog += [(SQRMUL, 0, slot("a2")), (STORE, 0, slot(v))]
    reps = {1: slot(1)}
    reps.update({l: slot((1 << l) - 1) for l in seed_lens})
    for new, src, shift in build:
        reps[new] = slot(("rep", new))
        prog += [(LOAD, 0, reps[src]), (SQRMUL, shift, reps[shift]),
                 (STORE, 0, reps[new])]
    for op in ops:
        if op[0] == "init_rep":
            prog.append((LOAD, 0, reps[op[1]]))
        elif op[0] == "init_odd":
            prog.append((LOAD, 0, slot(op[1])))
        elif op[0] == "sqrmul_rep":
            prog.append((SQRMUL, op[1], reps[op[2]]))
        elif op[0] == "sqrmul_odd":
            prog.append((SQRMUL, op[1], slot(op[2])))
        else:
            prog.append((SQRMUL, op[1], K.CHAIN_NONE))
    if len(slots) > K.CHAIN_SLOTS:
        raise ValueError(f"chain_program: the plan needs {len(slots)} scratch "
                         f"slots, K4 has {K.CHAIN_SLOTS}")
    codes = tuple(K.chain_code(*step) for step in prog)
    return codes, len(slots), _plan_exponent(ops, build)


# ---------------------------------------------------------------------------
# Device placement of host constants
# ---------------------------------------------------------------------------

_DEV_CONSTS: dict = {}


def dev(const: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A constant tensor on `device`, copied there once and memoized (the
    memo keeps the source alive, so its id is never reused)."""
    device = torch.device(device)
    if const.device == device:
        return const
    key = (id(const), str(device))
    hit = _DEV_CONSTS.get(key)
    if hit is None:
        hit = (const, const.to(device))
        _DEV_CONSTS[key] = hit
    return hit[1]


def host(arr) -> torch.Tensor:
    """numpy int array -> CPU int32 tensor (module-level constants)."""
    return torch.as_tensor(np.asarray(arr, dtype=np.int32))


# ---------------------------------------------------------------------------
# Limb helpers (modulus-independent)
# ---------------------------------------------------------------------------

def _carry_pass(z: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One value-preserving carry pass; also returns the carry out of the
    top limb.  `>>` is arithmetic, so negative limbs carry exactly."""
    c = z >> LIMB_BITS
    z = z & LIMB_MASK
    z[..., 1:].add_(c[..., :-1])
    return z, c[..., -1]


def _carry_cheap(z: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """Value-preserving partial carry: after 3 passes every limb is <= 4097
    for column sums < 2^31 (the carry out of the top limb is dropped)."""
    for _ in range(passes):
        z, _ = _carry_pass(z)
    return z


def _carry(z: torch.Tensor) -> torch.Tensor:
    """Exact carry normalization into [0, 2^12) (mod 2^(12*width))."""
    return _carry_overflow(z)[0]


_POW2 = torch.tensor([1 << i for i in range(32)], dtype=torch.int64)
_BITS = torch.arange(32, dtype=torch.int64)


def _lookahead(g: torch.Tensor, p: torch.Tensor):
    """Carry-lookahead over (generate, propagate) limb flags, g and p
    disjoint: the carry INTO each limb as int32 [..., width] and the carry
    out of the top limb as bool[...].

    The flags of 32 limbs pack into the bits of one int64, generate as
    (1, 1) and propagate as (0, 1) operand bits; one integer addition then
    resolves every carry chain of the chunk at once (the carry into bit i
    is bit i of sum ^ a ^ b), chunk after chunk for wider values.  The
    result equals the Kogge-Stone prefix of the XLA path."""
    width = g.shape[-1]
    pow2, bits = dev(_POW2, g.device), dev(_BITS, g.device)
    parts, carry = [], 0
    for s in range(0, width, 32):
        w = min(32, width - s)
        gm = (g[..., s:s + w] * pow2[:w]).sum(-1)
        am = gm | (p[..., s:s + w] * pow2[:w]).sum(-1)
        c = (gm + am + carry) ^ gm ^ am
        parts.append(((c[..., None] >> bits[:w]) & 1).to(I32))
        carry = (c >> w) & 1
    cin = parts[0] if len(parts) == 1 else torch.cat(parts, -1)
    return cin, carry.bool()


def _carry_overflow(z: torch.Tensor, cheap_passes: int = 3):
    """Exact carry normalization plus the carry OUT of the top limb as a
    bool[...] -- whether the true sum reached 2^(12*width).

    cheap_passes must leave every limb <= 4096 (pending carries in
    {0, 1}): 3 covers any 2^31-bounded column sums, 2 a sum of at most
    three 12-bit-limb operands.  Then limbs equal to 4096 generate a carry,
    limbs equal to 4095 propagate one, resolved by `_lookahead`."""
    ov = torch.zeros(z.shape[:-1], dtype=torch.bool, device=z.device)
    for _ in range(cheap_passes):
        z, c = _carry_pass(z)
        ov = ov | (c > 0)
    cin, cout = _lookahead((z >> LIMB_BITS) > 0, z == LIMB_MASK)
    return (z + cin) & LIMB_MASK, ov | cout


_BROADCAST_LIMIT = 1 << 18   # elements of the [..., 63, 32] product


def _poly_mul_var(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook column sums of two [..., 32] limb vectors -> [..., 63]
    (not carried; each column fits int32 by the 12-bit limb bound).

    Small stacks take one broadcast product over the 63 sliding windows
    of b (four tensor ops); large ones accumulate the 32 shifted rows one
    at a time, so the biggest live tensor is the [..., 63] result -- the
    broadcast form of a flat Fp12 product at 16384 rows would need 19 GB.
    Both sum the same integers exactly."""
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a = a.expand(shape)
    b = b.expand(shape)
    rows = int(np.prod(shape[:-1], dtype=np.int64))
    if rows * (2 * N_LIMBS - 1) * N_LIMBS <= _BROADCAST_LIMIT:
        # window k holds b[k-31 .. k]; pairing it with a reversed gives
        # sum_i a[i] * b[k-i]
        win = TF.pad(b, (N_LIMBS - 1, N_LIMBS - 1)).unfold(-1, N_LIMBS, 1)
        return (win * a.flip(-1)[..., None, :]).sum(-1, dtype=I32)
    out = torch.zeros(shape[:-1] + (2 * N_LIMBS - 1,), dtype=I32,
                      device=a.device)
    for i in range(N_LIMBS):
        out[..., i:i + N_LIMBS].add_(a[..., i:i + 1] * b)
    return out


def _toeplitz_full(const_limbs: np.ndarray) -> np.ndarray:
    """[32, 63] matrix T with T[i, k] = const[k-i] (0 outside)."""
    t = np.zeros((N_LIMBS, 2 * N_LIMBS - 1), dtype=np.int32)
    for i in range(N_LIMBS):
        t[i, i:i + N_LIMBS] = const_limbs
    return t


def _mul_const(x: torch.Tensor, toep: torch.Tensor) -> torch.Tensor:
    """Column sums of x (limbs) times a constant via its Toeplitz matrix."""
    return (x[..., :, None] * dev(toep, x.device)).sum(-2, dtype=I32)


def as_limbs(x) -> torch.Tensor:
    return x if x.dtype == I32 else x.to(I32)


# ---------------------------------------------------------------------------
# Field context
# ---------------------------------------------------------------------------

class Field:
    """Montgomery-form modular arithmetic for one odd modulus < 2^381.

    Holds host constants only; every operation runs on the device of the
    tensors it is given."""

    def __init__(self, modulus: int, name: str = "field"):
        if modulus % 2 != 1 or modulus.bit_length() > 381:
            raise ValueError("modulus must be odd and below 2^381")
        self.modulus = modulus
        self.name = name
        R = 1 << TOTAL_BITS
        self.R2_int = R * R % modulus
        self.R_int = R % modulus
        pprime = (-pow(modulus, -1, R)) % R

        self.MOD = host(int_to_limbs(modulus))
        self.MODP1 = host(int_to_limbs(modulus + 1))
        self.NEG_MOD = {k: host(int_to_limbs(R - k * modulus))
                        for k in (1, 2, 4, 8) if k * modulus < R}
        self.PPRIME_TOEP = host(_toeplitz_full(int_to_limbs(pprime))[:, :N_LIMBS])
        self.MOD_TOEP = host(_toeplitz_full(int_to_limbs(modulus)))
        self.ONE_VEC = host(int_to_limbs(1))

        self.zero = host(np.zeros(N_LIMBS, np.int32))
        self.one_mont = host(int_to_limbs(self.R_int))
        self.R2 = host(int_to_limbs(self.R2_int))
        self.R3 = host(int_to_limbs(R * R * R % modulus))
        self.Rinv_int = pow(R, -1, modulus)
        # the kernels' modulus argument: 6 little-endian 64-bit words and
        # -m^-1 mod 2^64
        words = [(modulus >> (64 * i)) & (2 ** 64 - 1) for i in range(6)]
        ninv = (-pow(modulus, -1, 1 << 64)) % (1 << 64)
        self.kernel_arg = np.array(words + [ninv], dtype=np.uint64)
        self.kernel_one = int_to_words(self.R_int)     # Montgomery one

    def c(self, const: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return dev(const, like.device)

    # -- host conversions ---------------------------------------------------

    def to_mont_host(self, x: int) -> np.ndarray:
        return int_to_limbs(x * (1 << TOTAL_BITS) % self.modulus)

    def from_limbs_host(self, limbs, mont: bool = True) -> int:
        v = limbs_to_int(limbs)
        if mont:
            v = v * self.Rinv_int % self.modulus
        return v % self.modulus

    def encode(self, xs) -> np.ndarray:
        """List of ints -> [len, 32] Montgomery-form limbs (numpy)."""
        return np.stack([self.to_mont_host(x % self.modulus) for x in xs])

    # -- comparisons --------------------------------------------------------

    def _lex_ge(self, a: torch.Tensor, const: torch.Tensor) -> torch.Tensor:
        """a >= const for canonical limb vectors; returns bool[...]."""
        c = dev(const, a.device)
        eqr = (a == c).flip(-1)
        gtr = (a > c).flip(-1)
        cp = torch.cumprod(eqr.to(I32), dim=-1, dtype=I32).bool()
        higher_eq = torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], -1)
        return (gtr & higher_eq).any(-1) | cp[..., -1]

    def eq(self, a, b):
        return (a == b).all(-1)

    def is_zero(self, a):
        return (a == 0).all(-1)

    # -- core ops -----------------------------------------------------------

    def add(self, a, b):
        """(a + b) mod m: the sum and its m-subtracted twin share one
        stacked carry chain; the twin's carry-out is the a+b >= m test."""
        raw = a + b
        st = torch.stack(torch.broadcast_tensors(
            raw, raw + self.c(self.NEG_MOD[1], raw)), 0)
        c, ov = _carry_overflow(st, 2)
        return torch.where(ov[1][..., None], c[1], c[0])

    def _cond_sub_full(self, s):
        """Reduce canonical s < 2*modulus into [0, modulus)."""
        d, ge = _carry_overflow(s + self.c(self.NEG_MOD[1], s), 2)
        return torch.where(ge[..., None], d, s)

    def neg(self, b):
        """(-b) mod m for canonical b."""
        comp = LIMB_MASK - b
        s = _carry(self.c(self.MODP1, b) + comp) & LIMB_MASK
        return torch.where(self.is_zero(b)[..., None], torch.zeros_like(b), s)

    def sub(self, a, b):
        """(a - b) mod m via the limb complement, one stacked carry chain
        whose second lane's carry-out is the a >= b test."""
        comp = a + (LIMB_MASK - b)
        st = torch.stack(torch.broadcast_tensors(
            comp + self.c(self.MODP1, comp), comp + self.c(self.ONE_VEC, comp)), 0)
        c, ov = _carry_overflow(st, 2)
        return torch.where(ov[1][..., None], c[1], c[0])

    def mul_small(self, a, c: int):
        """a * c for a static tiny scalar 1 <= c <= 8."""
        if not 1 <= c <= 8:
            raise ValueError("mul_small takes 1 <= c <= 8")
        s = _carry(a * c)
        for k in (4, 2, 1):
            if k < c and k in self.NEG_MOD:
                s = self._cond_sub_k(s, k)
        return s

    def _cond_sub_k(self, s, k):
        d, ge = _carry_overflow(s + self.c(self.NEG_MOD[k], s), 2)
        return torch.where(ge[..., None], d, s)

    def reduce_small_multiple(self, r, bound: int):
        """Reduce r < bound*modulus (exact-carried) into [0, modulus)."""
        if bound > 16:
            raise ValueError("reduce_small_multiple takes bound <= 16")
        for k in (8, 4, 2, 1):
            if k < bound:
                r = self._cond_sub_k(r, k)
        return r

    def _cond_sub_upto2(self, r):
        """Reduce canonical r < 3*modulus into [0, modulus)."""
        st = torch.stack(torch.broadcast_tensors(
            r, r + self.c(self.NEG_MOD[1], r), r + self.c(self.NEG_MOD[2], r)), 0)
        c, ov = _carry_overflow(st, 2)
        return torch.where(ov[2][..., None], c[2],
                           torch.where(ov[1][..., None], c[1], c[0]))

    # -- the four kernel operations: dispatch + plain versions --------------

    def mont_mul(self, a, b):
        """Montgomery product a*b*2^-384 mod m, canonical in/out (K1)."""
        a, b = torch.broadcast_tensors(as_limbs(a), as_limbs(b))
        if a.device.type == "cpu":
            return self._mont_mul_plain(a, b)
        return K.mont_mul(a.contiguous(), b.contiguous(), self)

    def sqr(self, a):
        """Montgomery square, canonical in/out (K2)."""
        a = as_limbs(a)
        if a.device.type == "cpu":
            return self._mont_sqr_plain(a)
        return K.mont_sqr(a.contiguous(), self)

    def mont_reduce(self, t):
        """t * 2^-384 mod m for a [..., 64] wide limb value (K3).

        Contract (shared by the kernel): limbs in [0, 2^14) and value
        T < (2 - 2^-9) * 2^384 * m; output canonical.  The plain Fp2 and
        flat Fp12 products (`towers._fp2_products_plain`,
        `flat12._flat_mul_plain`) reduce through its plain version and stay
        far inside it: a flat Fp12 convolution sums <= 12 products of
        canonical operands (T < 1.22 * 2^384 * p), an Fp2 product adds at
        most 3 p^2 (T < 0.31 * 2^384 * p).  On a GPU those products are
        kernels of their own (K5, K13), so the verify path no longer
        launches K3."""
        t = as_limbs(t)
        if t.device.type == "cpu":
            return self._mont_reduce_plain(t)
        return K.mont_reduce(t.contiguous(), self)

    def sqr_chain_mul(self, res, k: int, t=None):
        """res^(2^k) * t, or res^(2^k) when t is None; canonical (K4).
        k >= 1 without t, k >= 0 with t; k = 4 is the window step."""
        if k == 0:
            if t is None:
                raise ValueError("sqr_chain_mul with k == 0 needs t")
            return self.mont_mul(res, t)
        res = as_limbs(res)
        if t is not None:
            res, t = torch.broadcast_tensors(res, as_limbs(t))
        if res.device.type == "cpu":
            return self._sqr_chain_mul_plain(res, k, t)
        return K.sqr_chain_mul(res.contiguous(), k,
                               None if t is None else t.contiguous(), self)

    def _mont_mul_plain(self, a, b):
        t = _carry_cheap(TF.pad(_poly_mul_var(a, b), (0, 1)))
        return self._mont_reduce_plain(t)

    def _mont_sqr_plain(self, a):
        return self._mont_mul_plain(a, a)

    def _mont_reduce_plain(self, t):
        m = _carry_cheap(_mul_const(t[..., :N_LIMBS], self.PPRIME_TOEP))
        u_cols = _mul_const(m, self.MOD_TOEP)
        u = _carry(TF.pad(u_cols, (0, 1)) + t)
        return self._cond_sub_upto2(u[..., N_LIMBS:])

    def _sqr_chain_mul_plain(self, res, k: int, t=None):
        for _ in range(k):
            res = self._mont_sqr_plain(res)
        return res if t is None else self._mont_mul_plain(res, t)

    # -- exponentiation -----------------------------------------------------

    def pow_const(self, a, e: int):
        """a^e (Montgomery in/out) for a static exponent.

        The executor `drand_tpu`'s Pallas path takes: for exponents of 64
        bits and more an addition chain when the planner says it costs
        fewer Montgomery operations, else the 4-bit fixed window whose
        step res^16 * t is one K4 launch."""
        a = as_limbs(a)
        one = self.c(self.one_mont, a).expand(a.shape)
        if e == 0:
            return one.clone()
        if e < 16:
            res = a
            for bit in bin(e)[3:]:
                res = self.sqr(res)
                if bit == "1":
                    res = self.mont_mul(res, a)
            return res
        if e >= (1 << 64):
            ops, build, n_sqr, n_mul, used_odd = addchain_plan(e)
            nd = len(f"{e:x}")
            if n_sqr + n_mul < 5 * (nd - 1) + 15:
                return self._pow_addchain(a, ops, build, used_odd)
        digits = [int(ch, 16) for ch in f"{e:x}"]
        tab = [one, a]
        for _ in range(14):
            tab.append(self.mont_mul(tab[-1], a))
        res = tab[digits[0]]
        for d in digits[1:]:
            res = self.sqr_chain_mul(res, 4, tab[d])
        return res

    def _pow_addchain(self, a, ops, build, used_odd: bool):
        """Execute an `addchain_plan`: on a GPU tensor the whole plan is
        one K4 launch (`chain_program`), on the CPU its plain steps."""
        a = as_limbs(a)
        if a.device.type == "cpu":
            return self._pow_addchain_plain(a, ops, build, used_odd)
        codes, n_slots, e = chain_program(tuple(ops), tuple(build),
                                          bool(used_odd))
        return K.pow_chain(a.contiguous(), codes, n_slots, e, self)

    def _pow_addchain_plain(self, a, ops, build, used_odd: bool):
        """The plan step by step in the plain versions: res^(2^k) (* t)
        for each step, the odd table of products over a^2."""
        def sqr_n(x, k):
            return x if k == 0 else self._sqr_chain_mul_plain(x, k)

        need, seed_lens = _chain_table(ops, build, used_odd)
        tab = {}
        if used_odd:
            tab[1] = a
            a2 = self._mont_sqr_plain(a)
            for v in range(3, need + 1, 2):
                tab[v] = self._mont_mul_plain(tab[v - 2], a2)
        reps = {1: a}
        for l in seed_lens:
            reps[l] = tab[(1 << l) - 1]
        for new, src, shift in build:
            reps[new] = self._sqr_chain_mul_plain(reps[src], shift,
                                                  reps[shift])
        res = None
        for op in ops:
            if op[0] == "init_rep":
                res = reps[op[1]]
            elif op[0] == "init_odd":
                res = tab[op[1]]
            elif op[0] == "sqrmul_rep":
                res = self._sqr_chain_mul_plain(res, op[1], reps[op[2]])
            elif op[0] == "sqrmul_odd":
                res = self._sqr_chain_mul_plain(res, op[1], tab[op[2]])
            else:
                res = sqr_n(res, op[1])
        return res

    def inv(self, a):
        """a^-1 via Fermat (Montgomery in/out); inv(0) = 0."""
        return self.pow_const(a, self.modulus - 2)

    # -- stacked ops ----------------------------------------------------------

    @staticmethod
    def _common(arrs):
        return [as_limbs(a) for a in torch.broadcast_tensors(*arrs)]

    def _stack2(self, pairs):
        flat = self._common([p[0] for p in pairs] + [p[1] for p in pairs])
        n = len(pairs)
        return torch.stack(flat[:n], 0), torch.stack(flat[n:], 0)

    def products(self, pairs):
        """[(a, b), ...] -> [a*b mod m, ...] via ONE stacked mont_mul."""
        if len(pairs) == 1:
            return [self.mont_mul(pairs[0][0], pairs[0][1])]
        out = self.mont_mul(*self._stack2(pairs))
        return list(out.unbind(0))

    def sums(self, pairs):
        if len(pairs) == 1:
            return [self.add(pairs[0][0], pairs[0][1])]
        return list(self.add(*self._stack2(pairs)).unbind(0))

    def diffs(self, pairs):
        if len(pairs) == 1:
            return [self.sub(pairs[0][0], pairs[0][1])]
        return list(self.sub(*self._stack2(pairs)).unbind(0))

    def negs(self, arrs):
        if len(arrs) == 1:
            return [self.neg(arrs[0])]
        return list(self.neg(torch.stack(self._common(arrs), 0)).unbind(0))

    def select(self, mask, a, b):
        return torch.where(mask[..., None], a, b)

    # -- Montgomery domain conversions --------------------------------------

    def to_mont(self, x):
        return self.mont_mul(x, self.c(self.R2, x))

    def from_mont(self, x):
        return self.mont_mul(x, self.c(self.ONE_VEC, x))

    def reduce_wide(self, lo, hi):
        """Montgomery form of hi * 2^384 + lo (canonical limb vectors):
        mont_mul(hi, R^3) + mont_mul(lo, R^2)."""
        m_hi = self.mont_mul(hi, self.c(self.R3, hi))
        m_lo = self.mont_mul(lo, self.c(self.R2, lo))
        return self.add(m_hi, m_lo)


from drand_tpu_torch.crypto.bls12381.constants import P as _P, R as _R  # noqa: E402

FP = Field(_P, "fp")
FR = Field(_R, "fr")
