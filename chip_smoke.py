"""Smoke run of the PyTorch/CUDA port on one GPU: build, slice, kernel parity.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  device  card name and power limit (nvidia-smi), torch and CUDA versions
  build   nvcc build of the kernels in drand_tpu_torch/csrc, its seconds
  build   also each redesigned kernel's registers, local memory, shared
          memory and resident blocks per SM (cudaFuncGetAttributes and
          cudaOccupancyMaxActiveBlocksPerMultiprocessor, on a line of its
          own): K1, K4, K5, K6, K7, K13 (its dense instance), K9, K10,
          K11, K12, K14, K15, K16, K17, K18, K19, K20
  slice   drand_tpu_torch.verify.Verifier (drand_tpu's merged Miller
          executor) on the committed 16384-round pedersen-bls-unchained
          segment (all true; one flipped byte gives exactly one false;
          K14 launched at most 31 times, one chain of squares a run of
          the final exponentiation's ladder, K9 19 times, one chain of
          doublings a run of the three |x| ladders and one for [2]Q, and
          K11 63 times) and on the
          committed pedersen-bls-chained segment from round 1 (rounds
          1-65 against the genesis seed, the irregular anchor: round 1 in
          a bucket of its own; K4 launched twice, one addition chain
          for each of the batch's two Fermat inversions, and K1 22
          times), with the launches of every kernel during
          the 16384-round batch, in total and by call (the key each
          wrapper in ops/kernels.py documents), and the calls of the
          chained run; then the device kernels one more such batch
          launches in all (torch.profiler) and their summed durations
  trio    the same 16384-round segment and flipped batch with drand_tpu's
          trio Miller executor (profiling.trio_batch_async: the verify
          path with merged=False): every verdict equal to the default's;
          and pairing_check_pairs at K = 1 and K = 3 pairs on 4096 rows
          tiled from 64 rows of distinct golden-model pairs, some
          inactive, some with product 1: every verdict equal to the
          golden pairing_check of its row
  g1      the short-signature scheme bls-unchained-g1-rfc9380 (signatures
          on G1, the key on G2) through Verifier(pk, SHAPE_UNCHAINED_G1)
          on the committed 16384-round G1 fixture: fixture_keypair_g2()
          and DST_G1 must hash to the two hashes in the fixture's name;
          all rounds true; one flipped byte gives exactly its row false;
          the infinity flag, x >= p and an on-curve point outside G1 (the
          port's golden model, [r]P != O) each false in exactly their
          rows; the trio executor's verdicts on that batch equal the
          default's; the first batch's wall and issue time and the next
          one's, and the device kernels of one more profiled batch, their
          busy time and each path kernel's device ms, bound and loss; and
          the launches, device kernels and busy time of one G1 |x| ladder
          on the batch's points (the batch runs three: no G1 point kernel)
  recovery  the port's ChainVerifier, chain store and integrity scan
          (drand_tpu_torch.chain) over sqlite stores built under build/:
          the genesis seed and rounds 1-65536 of pedersen-bls-unchained
          (the committed 16384 rounds, then the sync fixture's 49152), all
          by fixture_keypair(), through startup_recovery: clean, 65537
          rows, verified_tip 65536, four dispatch records of n = bucket =
          16384, each segment launching exactly what the slice phase's
          batch launched; a copy with round 40000's signature flipped,
          round 50000's blob torn and round 60000 deleted: `python -m
          drand_tpu_torch.cli util fsck <copy> --json` exits 1 with the
          structural lists, then startup_recovery gives bad_sigs [40000],
          corrupt [50000], missing [[60000, 60000]], verified_tip 39999,
          the repair leaves the tip at 39999 and a rescan is clean; the
          chained fixture's store (round 1 on the genesis anchor, round
          30's signature flipped, round 50's link broken): bad_sigs [30],
          unlinked [31, 50], every other verdict the slice phase's; a
          16384-round bls-unchained-g1-rfc9380 store, the key as G2 bytes:
          clean, its segment launching what the g1 batch launched; walls,
          rounds per second and the dispatch records
  partials  t-of-n partial verification and Lagrange recovery through the
          port's DeviceBackend (drand_tpu_torch.beacon.crypto_backend) on
          a group of n = 16, t = 9 (secret 424242, the other coefficients
          from a SHA-512 stream over a fixed seed), rounds 1-1024 of
          pedersen-bls-unchained: each share's signatures and the
          secret's made on the card (fixtures.sign_batch_g2), the
          secret's all true through Verifier(commits[0]); the 1024 x 16
          partials in one "rounds" dispatch at bucket 1024, all true, then
          with a flipped byte (round 512, signer 5), a valid signature
          under another signer's index, the infinity flag and a 95-byte
          partial exactly those four false, every partial a table hit;
          index 16 (outside the table) in one row sends the call through
          the flat verify_partials at bucket 16384, keys evaluated in the
          batch, only that row differing; 16 concurrent
          AsyncPartialVerifier.verify calls of one round in one
          "partials" dispatch of n = bucket = 16, one distinct message;
          recover_rounds over the 1024 rounds, t partials a round from
          rotating signers, byte-equal to the secret's signatures and
          true through the Verifier, recover of one round equal, a round
          of t - 1 partials raising ValueError; each call's launches,
          walls and issue times, partials and recoveries per second, the
          device kernels and busy time of one more rounds verify and
          recover_rounds, and the dispatch records

Each run of the slice, trio, g1, recovery and partials phases must launch
every kernel of its path and no other, and never call the plain limb
convolution `_poly_mul_var`: the default batch all but the trio kernels (flat_sqr,
g2_dbl_line, g2_add_line) and those off the G2 paths (mont_sqr,
mont_reduce, fp2_sqr5_mul, line_merge, add, sub); the trio batch all but
the merged iterations and those off the G2 paths; a pairing check the trio
kernels, flat_mul, flat_conj, flat_frob, cyclo_sqr and the final
exponentiation's inversion (mont_mul, sqr_chain_mul, fp2_products); a G1
batch mont_mul, mont_sqr, sqr_chain_mul, fp2_products, the merged
iterations, flat_mul, cyclo_sqr, flat_conj and flat_frob (the trio G1
batch the trio kernels in place of the merged iterations); a recovery scan
the default batch's kernels (the G1 store's, the G1 batch's); a partials
verify the default batch's (with mont_sqr where the keys are evaluated in
the batch), and signing and recovery mont_mul, sqr_chain_mul,
fp2_products, fp2_sqrs, fp2_sqr_chain_mul, g2_point_dbl and g2_point_add.

  parity  every kernel against its plain PyTorch version on the card, bit
          for bit, at every call the batches above made, the G1,
          recovery and partials ones included (g2_point_dbl
          and cyclo_sqr at each of their chain lengths) and at fixed
          cases: 16384 rows for Fp and Fr (sqr_chain_mul, whose path
          calls are whole addition chains held against the plan's plain
          steps, also at the single steps k = 1, 4, 5, 9, 13, 63 with and
          without t and on the chains of r - 2, (p + 1) / 4 and the G1
          map's (p - 3) / 4;
          mont_mul also on 100 rows, a ragged block, and with first
          operands of any 384 bits against R^2 and R^3, as
          Field.reduce_wide gives it; mont_reduce also at
          the stacks
          [2, 16384, 64] and [16, 2, 16384, 64] the composite products
          gave it), fp2_products and fp2_sqrs at n = 9, fp2_products
          also at n = 1-5 on 16384 and on a ragged 100 rows, fp2_sqrs
          also at n = 1, 4 and 8 on 16384, 33 and 1 rows with every pair
          of 0, 1, p-1 (Montgomery and raw), x1 = 0 and x0 = x1 among
          them, flat_mul
          dense and sparse on all-(p-1) coefficients, and on 16384, 100
          and 8 rows with all-(p-1) and zero operands on both sides of
          every 32-row block edge (also on three other sparse layouts),
          cyclo_sqr on unitary rows
          at k = 1 and 32 and on a ragged last block,
          fp2_sqr_chain_mul at k = 1, 5, 13 and 63 and, on a ragged 100
          rows, at every (k, t given) of the default batch,
          fp2_sqr5_mul, the G2 point kernels with doubling, cancelling
          and infinite rows (g2_point_dbl also at n = 1 and 9 on a ragged
          last block; g2_point_add, with and without the doubling, also on
          100, 64 and 8 rows, its doubling, cancelling, rescaled and
          infinite rows on both sides of every 32-row block edge), the Miller
          iterations with every active/inactive pair mask (also on a
          ragged last block),
          flat_conj also on 16384, 33 and 1 rows holding in every slot
          the coefficients whose borrow crosses lanes (chunks equal to
          p's above a borrowing one), 0, 1, p-1, with zero and
          all-(p-1) rows, flat_frob at n = 1, 2, 3 (also on 16384, 33
          and 1 rows with zero and all-(p-1) rows), flat_sqr and line_merge
          on all-(p-1) and zero rows (flat_sqr also on 1, 31 and 33 rows:
          ragged blocks), g2_dbl_line and g2_add_line on three stacked
          pairs with Z = 1 and Z = 0 rows (both also on 1, 31 and 33 rows;
          g2_add_line also with T = Q and T = -Q rows in affine form, where
          H = 0, on those and on three stacked pairs), add and sub at 0, 1,
          m-1 and on
          all-(m-1) and
          zero rows; on random values plus 0, 1, m-1 (mont_reduce: wide
          values up to the top of its input contract, in limbs up to
          2^14 - 1); then the device time of kernel and plain version at
          the path's most common call (flat_mul also at the trio path's):
          the summed durations of the device
          kernels a call launches (torch.profiler), so host time between
          launches does not count (CUDA events behind a device sleep
          where the profiler saw none; each timing row names its timer)

then a {"kernels": [...]} line, each kernel also with path_ms (its device
ms in one more profiled batch of its path: the trio batch for flat_sqr,
g2_dbl_line and g2_add_line, the default one for the others),
bound_ms_batch (its bound summed over every call that path's batch made)
and loss_ms (the difference), path_ms and loss_ms null where none of up
to four profiled sessions saw every launch of the kernel, and, for
flat_frob, flat_sqr, g2_dbl_line, g2_add_line and line_merge, "code":
registers, local memory and blocks per
SM (kernel_attrs), stack frame and spill stores (ptxas) and SASS
instructions (cuobjdump); and, last, {"ok": true, "device": ...}.
Any mismatch or error exits non-zero before the last line.  It imports
nothing of JAX or drand_tpu.  Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import collections
import hashlib
import json
import math
import os
import random
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH = 16384
FIXTURE = os.path.join(HERE, "aot", "fixtures",
                       "bench_sigs_unchained_16384_d6a762f2_ff8a2cc7.npy")
# rounds 16385-65536 of the same chain and key ([49152, 96])
SYNC_FIXTURE = os.path.join(HERE, "aot", "fixtures",
                            "bench_sync_sigs_65536_d6a762f2_ff8a2cc7.npy")
STORE_ROUNDS = 4 * BATCH
# H100 SXM peaks: HBM bytes/s (NVIDIA data sheet) and 32-bit integer
# multiply-adds/s: 64 per clock per SM, half the float32 FMA rate, x 132
# SMs x 1.98 GHz boost clock.  One multiply-add is two operations.
PEAK_BYTES = 3.35e12
PEAK_MULADDS = 64 * 132 * 1.98e9
# 32-bit multiply-adds per element, the fewest the function needs on
# twelve 32-bit words: a word product has a low and a high half (2), a
# REDC quotient word a low half only (1)
MULADDS_WIDE = 2 * 144                    # a 12x12-word product
MULADDS_TRI = 2 * (66 + 12)               # a triangular 12-word square
MULADDS_REDC = MULADDS_WIDE + 12          # K3: 144 products, 12 quotients
MULADDS_MUL = MULADDS_WIDE + MULADDS_REDC              # K1: 588
MULADDS_SQR = MULADDS_TRI + MULADDS_REDC               # K2: 456
MULADDS_FP2_MUL = 4 * MULADDS_WIDE + 2 * MULADDS_REDC  # K5
MULADDS_FP2_SQR = 2 * MULADDS_TRI + MULADDS_WIDE + 2 * MULADDS_REDC  # K6
# K9/K10 and the Miller steps: (Fp2 squares, Fp2 products, Fp products)
G2_DBL = (5, 2, 0)
G2_ADD = (5, 11, 0)
MILLER_DBL_STEP = (6, 5, 4)
MILLER_ADD_STEP = (4, 10, 4)
LINE_IDX = (0, 2, 3, 6, 8, 9)
# kernels no G2 verify path launches: K2 (its only calls there were the
# two Fermat inversions' a^2, now inside K4's one launch an inversion; the
# G1 path's squares launch it), K3 (its
# callers were the composite products, now K5, K6, K13, K14), K8
# (fp2_pow_const takes the addition chain of K7 steps on both of the
# path's exponents, as drand_tpu does on its chip), K20 (K11 and K12 multiply f by their two lines one after the
# other; as in drand_tpu, nothing calls it alone) and K21/K22 (drand_tpu's Field.add
# and sub stay in XLA and never call their kernels; the port's keep their
# torch path)
OFF_PATH = ("mont_sqr", "mont_reduce", "fp2_sqr5_mul", "line_merge", "add",
            "sub")
# the kernels whose code statistics the kernels line gives, by their name
# in ptxas's and cuobjdump's output
CODE_STATS = {"flat_frob": "k_flat_frob", "flat_sqr": "k_flat_sqr",
              "g2_dbl_line": "k_g2_dbl_line", "g2_add_line": "k_g2_add_line",
              "line_merge": "k_line_merge"}
# kernels of the trio Miller executor only, and of the merged one only
TRIO = ("flat_sqr", "g2_dbl_line", "g2_add_line")
MERGED = ("miller_dbl_iter", "miller_add_iter")
# the kernels of a pairing check alone: the trio Miller loop and the final
# exponentiation, whose one Fp12 inversion takes K5 and K1 around one K4
# launch (the Fermat inversion of an Fp2 norm)
PAIRING = TRIO + ("flat_mul", "flat_conj", "flat_frob", "cyclo_sqr",
                  "mont_mul", "sqr_chain_mul", "fp2_products")
# the kernels of the short-signature (G1) verify path: no kernel serves G1
# points (as in drand_tpu), so its decompression, subgroup check, SSWU map,
# 11-isogeny and h_eff ladder are K1 products and K2 squares, its square
# roots ((p + 1)/4, the map's (p - 3)/4) and inversion K4 chains; then the
# Miller loop and the final exponentiation, whose Fp12 inversion takes K5
G1_PATH = ("mont_mul", "mont_sqr", "sqr_chain_mul", "fp2_products",
           "miller_dbl_iter", "miller_add_iter", "flat_mul", "cyclo_sqr",
           "flat_conj", "flat_frob")
G1_TRIO_PATH = tuple(n for n in G1_PATH if n not in MERGED) + TRIO
# sha256(DST_G1)[:8] and sha256(compressed key)[:8] in the committed G1
# fixture's name
G1_FIXTURE_HASHES = ("5b84a3cd", "d7754ef6")
# the partials phase's group (bench.py's n = 16, t = 9, secret 424242) and
# rounds; the other t - 1 coefficients from a SHA-512 stream over the seed
PARTIALS_N, PARTIALS_T, PARTIALS_ROUNDS = 16, 9, 1024
GROUP_SECRET = 424242
GROUP_SEED = b"drand_tpu_torch partials group"
# the kernels of G2 work without a pairing: signing (hash-to-curve, the
# scalar ladder, the affine conversion) and recovery (decompression, the
# per-row ladder, the tree sum, the affine conversion)
G2_CURVE = ("mont_mul", "sqr_chain_mul", "fp2_products", "fp2_sqrs",
            "fp2_sqr_chain_mul", "g2_point_dbl", "g2_point_add")


def muladds_fp2(sqrs: int, muls: int, fp_muls: int) -> int:
    return (sqrs * MULADDS_FP2_SQR + muls * MULADDS_FP2_MUL
            + fp_muls * MULADDS_MUL)


def muladds_flat(b_idx, a_idx=tuple(range(12))) -> int:
    """A flat Fp12 product of a on the w-powers a_idx by b on b_idx as
    schoolbook, one REDC per power the product reaches (K13's work on a
    sparse b; K20's with both on LINE_IDX)."""
    coeffs = len({i + j for i in a_idx for j in b_idx})
    return len(a_idx) * len(b_idx) * MULADDS_WIDE + coeffs * MULADDS_REDC


# K13 dense: the least the function needs of one Karatsuba level on the
# w^6 split, 108 products and 23 REDCs (P0, P1 and the middle product
# combined wide before reducing; the schoolbook takes 144 and 23, the
# kernel's phases 108 and 33)
MULADDS_FLAT_KARATSUBA = 108 * MULADDS_WIDE + 23 * MULADDS_REDC
# K17: 66 general and 12 triangular products, 23 REDCs
MULADDS_FLAT_SQR = 66 * MULADDS_WIDE + 12 * MULADDS_TRI + 23 * MULADDS_REDC
MULADDS_LINE_MERGE = muladds_flat(LINE_IDX, LINE_IDX)
# f times the two lines of K11/K12: one sparse product after the other
MULADDS_LINES = 2 * muladds_flat(LINE_IDX)


_FROB_PRODUCTS = {}


def frob_products(n: int) -> int:
    """The Montgomery products a row of f^(p^n) needs: its constants
    (flat12._FROB[n]) other than 0, one and minus one, whose terms K16
    takes without a product."""
    if n not in _FROB_PRODUCTS:
        import torch

        from drand_tpu_torch.ops import flat12 as FL
        from drand_tpu_torch.ops.field import FP
        one = FP.one_mont
        special = (torch.zeros_like(one), one, FP.neg(one))
        _FROB_PRODUCTS[n] = sum(
            not any(torch.equal(c[s], x) for x in special)
            for c in FL._FROB[n] for s in range(6))
    return _FROB_PRODUCTS[n]


def off_subgroup_g1() -> bytes:
    """A compressed G1 point on the curve but outside the r-subgroup, from
    the port's golden model: the first x >= 1 with x^3 + 4 a square whose
    point has [r]P != O."""
    from drand_tpu_torch.crypto.bls12381 import curve as GC
    from drand_tpu_torch.crypto.bls12381 import fp as GF
    from drand_tpu_torch.crypto.bls12381.constants import P, R
    x = 1
    while True:
        y = GF.fp_sqrt((pow(x, 3, P) + 4) % P)
        if y is not None and not GC.point_is_inf(
                GC.point_mul((x, y, 1), R, GC.FP_OPS), GC.FP_OPS):
            return GC.g1_to_bytes((x, y, 1))
        x += 1


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps: int, min_kernels: int = 1):
    """(mean device milliseconds per call, the timer): the summed
    durations of the device kernels that `reps` calls launch
    (torch.profiler), after a warm-up.  The profiler now and then loses
    some or all of a session's events, so a session that saw fewer than
    `min_kernels` kernels is taken again, up to five sessions, and the
    one that saw the most counts.  Where none saw a kernel, CUDA events
    around the calls time them instead, queued behind a device sleep so
    that the host's issue time between launches does not count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from drand_tpu_torch.profiling import device_kernels
    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kern = device_kernels(prof)
        if len(kern) > len(best):
            best = kern
        if len(best) >= min_kernels:
            break
    if best:
        return sum(d for _, d in best) * 1e3 / reps, "profiler"
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)           # ~25 ms at the boost clock
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, "events"


def work(name: str, call: tuple):
    """(bytes moved, 32-bit multiply-adds) of one launch for `call`, a key
    of `Kernel.calls` (the key each wrapper in ops/kernels.py documents)."""
    if name == "flat_sqr":
        return 24 * 128 * math.prod(call[:-2]), \
            MULADDS_FLAT_SQR * math.prod(call[:-2])
    if name == "line_merge":
        rows = math.prod(call[:-2])
        return 24 * 128 * rows, MULADDS_LINE_MERGE * rows
    if name in ("g2_dbl_line", "g2_add_line"):
        rows, width = math.prod(call[:-2]), call[-2]
        step = MILLER_DBL_STEP if name == "g2_dbl_line" else MILLER_ADD_STEP
        return (width + 12) * 128 * rows, muladds_fp2(*step) * rows
    if name in ("add", "sub"):
        return 384 * math.prod(call[1][:-1]), 0
    if name == "fp2_sqr_chain_mul":
        (shape, k, with_t), rows = call, math.prod(call[0][1:-1])
        return ((768 if with_t else 512) * rows,
                muladds_fp2(k, int(with_t), 0) * rows)
    if name == "fp2_sqr5_mul":
        rows = math.prod(call[1:-1])
        return 768 * rows, muladds_fp2(5, 1, 0) * rows
    if name == "g2_point_dbl":
        (shape, n), rows = call, math.prod(call[0][1:-1])
        return 12 * 128 * rows, n * muladds_fp2(*G2_DBL) * rows
    if name == "g2_point_add":
        (shape, with_double), rows = call, math.prod(call[0][1:-1])
        ops = muladds_fp2(*G2_ADD) + (muladds_fp2(*G2_DBL) if with_double
                                      else 0)
        return 18 * 128 * rows, ops * rows
    if name in ("miller_dbl_iter", "miller_add_iter"):
        rows = math.prod(call[:-2])
        if name == "miller_dbl_iter":
            nbytes = (12 + 12 + 4 + 12 + 12) * 128 + 8
            ops = (MULADDS_FLAT_SQR + MULADDS_LINES
                   + 2 * muladds_fp2(*MILLER_DBL_STEP))
        else:
            nbytes = (12 + 12 + 8 + 4 + 12 + 12) * 128 + 8
            ops = MULADDS_LINES + 2 * muladds_fp2(*MILLER_ADD_STEP)
        return nbytes * rows, ops * rows
    if name == "flat_conj":
        return 24 * 128 * math.prod(call[:-2]), 0
    if name == "flat_frob":
        rows = math.prod(call[0][:-2])
        return 24 * 128 * rows, frob_products(call[1]) * MULADDS_MUL * rows
    if name in ("fp2_products", "fp2_sqrs"):
        items = call[1] * math.prod(call[0][:-1])
        if name == "fp2_products":
            return 768 * items, MULADDS_FP2_MUL * items
        return 512 * items, MULADDS_FP2_SQR * items
    if name == "flat_mul":
        rows, b_idx = math.prod(call[0][:-2]), call[1]
        ops = (MULADDS_FLAT_KARATSUBA if tuple(b_idx) == tuple(range(12))
               else muladds_flat(b_idx))
        return (24 + len(b_idx)) * 128 * rows, ops * rows
    if name == "cyclo_sqr":
        (shape, k), rows = call, math.prod(call[0][:-2])
        return 24 * 128 * rows, k * 9 * MULADDS_FP2_SQR * rows
    n = math.prod(call[1][:-1])
    if name == "sqr_chain_mul" and call[2] == "pow":
        # a whole addition chain: the squares and products its program
        # runs, each row read and written once, and each scratch slot
        # written and read once
        from drand_tpu_torch.ops import kernels as K
        from drand_tpu_torch.ops.field import addchain_plan, chain_program
        plan = addchain_plan(call[3])
        codes, n_slots, _ = chain_program(plan[0], plan[1], plan[4])
        sqrs, muls = K.chain_work(codes)
        return ((256 + 96 * n_slots) * n,
                (sqrs * MULADDS_SQR + muls * MULADDS_MUL) * n)
    if name == "mont_mul":
        return 384 * n, MULADDS_MUL * n
    if name == "mont_sqr":
        return 256 * n, MULADDS_SQR * n
    if name == "mont_reduce":
        return 384 * n, MULADDS_REDC * n
    k, with_t = call[2], call[3]
    return ((384 if with_t else 256) * n,
            (k * MULADDS_SQR + (MULADDS_MUL if with_t else 0)) * n)


def bound_ms(nbytes: float, muladds: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, muladds / PEAK_MULADDS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def kernel_of(device_name: str):
    """The port's kernel (a key of ops/kernels.py KERNELS) that a device
    kernel of a profile is, from its demangled name, or None for torch's
    own.  K11/K12 and K21/K22 are the two instances of one template; K7
    and K8 share one kernel (K8 has no caller on a path), and K4's kernel
    is k_fp_pow_chain."""
    m = re.search(r"::k_(\w+)(?:<([^>]*)>)?\(", device_name)
    if not m:
        return None
    base, arg = m.groups()
    pairs = {"miller_iter": ("miller_dbl_iter", "miller_add_iter"),
             "add_sub": ("add", "sub")}
    if base in pairs:
        return pairs[base][arg == "true"]
    return "sqr_chain_mul" if base == "fp_pow_chain" else base


def profile_kernels(fn, want: dict, tries: int = 4):
    """(kernels, complete): (name, seconds) of every device kernel that
    fn() launches (torch.profiler), and the set of the port's kernels
    whose every launch the session saw, `want` holding the launches fn()
    makes of each.  A session now and then loses events, so one is taken
    again while any kernel falls short, up to `tries`; the session with
    the most complete kernels, then the most events, counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from drand_tpu_torch.profiling import device_kernels
    best, complete = [], set()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = device_kernels(prof)
        seen = collections.Counter(kernel_of(name) for name, _ in kern)
        full = {name for name, n in want.items() if seen[name] == n}
        if (len(full), len(kern)) > (len(complete), len(best)):
            best, complete = kern, full
        if len(complete) == len(want):
            break
    return best, complete


def recovery_phase(work_dir, drive, check_path, sigs, sigs_c, pk_bytes,
                   seed, launches, default_path, sigs1, pk2, g1_launches,
                   ok_c, chained):
    """The `recovery` phase: the port's ChainVerifier, chain store,
    integrity scan and `util fsck` over stores built in `work_dir`.
    Returns (its report line, the calls by kernel of each driven run)."""
    import asyncio
    import sqlite3

    import numpy as np
    import torch

    from drand_tpu_torch import dispatch as DSP
    from drand_tpu_torch.chain import codec as CODEC
    from drand_tpu_torch.chain.beacon import Beacon
    from drand_tpu_torch.chain.recovery import scan_store, startup_recovery
    from drand_tpu_torch.chain.scheme import scheme_by_id
    from drand_tpu_torch.chain.store import SqliteStore
    from drand_tpu_torch.chain.verify import ChainVerifier
    from drand_tpu_torch.crypto.bls12381 import curve as GC
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.verify import bucket

    out, all_calls = {"phase": "recovery"}, []

    def check_segments(what, segs, want):
        """Every segment padded to the largest bucket launched exactly
        what one batch of that size launches."""
        full = [s for s in segs if bucket(s[1]) == BATCH]
        bad = [(s[0], s[1]) for s in full if s[2] != want]
        if not full or bad:
            fail(f"{what}: segments {bad} launched other counts than one "
                 f"{BATCH}-round batch ({len(full)} full segments)")
        return len(full)

    def scan(what, store, cv, path, fn=scan_store):
        """fn(store, cv) driven once: (report, summary, seconds, segments,
        dispatch records), the launches checked against `path`; each
        segment the scan hands `cv` is (start round, rounds, the launches
        of its issue, where all of them happen)."""
        DSP.DISPATCH.clear()
        segs = []
        inner = cv.verify_packed_segment_async

        def counted(packed, anchor):
            before = K.launch_counts()
            pending = inner(packed, anchor)
            after = K.launch_counts()
            segs.append((packed.start_round, len(packed),
                         {n: after[n] - before[n] for n in after}))
            return pending
        cv.verify_packed_segment_async = counted
        res, secs, counts, calls, n_conv = drive(
            lambda: asyncio.run(fn(store, cv)))
        del cv.verify_packed_segment_async
        check_path(what, counts, n_conv, path)
        all_calls.append(calls)
        report, summary = res if isinstance(res, tuple) else (res, None)
        return report, summary, secs, segs, DSP.DISPATCH.records("verify")

    def rows_of(recs):
        return [[r.n, r.bucket] for r in recs]

    # 1. the full-width store: the genesis seed, then rounds 1-65536 of
    # pedersen-bls-unchained (the committed 16384 rounds and the sync
    # fixture's 49152 after them), all by fixture_keypair()
    sync = np.load(SYNC_FIXTURE)
    if sync.shape != (STORE_ROUNDS - BATCH, 96):
        fail(f"unexpected sync fixture shape {sync.shape}")
    all_sigs = np.concatenate([sigs, sync])
    t0 = time.perf_counter()
    path = os.path.join(work_dir, "unchained.db")
    store = SqliteStore(path)
    store.put_many([Beacon(0, seed)] + [
        Beacon(r, all_sigs[r - 1].tobytes())
        for r in range(1, STORE_ROUNDS + 1)])
    out["store_build_s"] = time.perf_counter() - t0
    cv = ChainVerifier(scheme_by_id("pedersen-bls-unchained"), pk_bytes)

    # 2. the clean scan through startup_recovery
    rep, summary, secs, segs, recs = scan(
        "recovery clean scan", store, cv, default_path, startup_recovery)
    if not (rep.ok and rep.verify_checked and summary is None
            and rep.scanned == STORE_ROUNDS + 1
            and rep.verified_tip == STORE_ROUNDS and not rep.bad_sigs):
        fail(f"clean store: {rep.to_dict()}, repair {summary}")
    if rows_of(recs) != [[BATCH, BATCH]] * 4:
        fail(f"clean store: dispatch records {rows_of(recs)}, not four "
             f"of n = bucket = {BATCH}")
    check_segments("clean scan", segs, launches)
    out["clean"] = {"rounds": STORE_ROUNDS, "scanned": rep.scanned,
                    "verified_tip": rep.verified_tip, "wall_s": secs,
                    "report_elapsed_s": rep.elapsed_s,
                    "rounds_per_s": STORE_ROUNDS / secs,
                    "segments": len(segs),
                    "segment_launches_equal_slice_batch": True,
                    "dispatch": [r.to_dict() for r in recs]}

    # 3. damage on a copy: round 40000's signature flipped (the row still
    # decodes), round 50000's blob torn, round 60000 deleted
    copy = os.path.join(work_dir, "damaged.db")
    store.save_to(copy)
    con = sqlite3.connect(copy)
    with con:
        blob = bytearray(con.execute(
            "SELECT data FROM beacons WHERE round = 40000").fetchone()[0])
        blob[13 + 40] ^= 0x01
        if CODEC.decode_fields(bytes(blob))[0] != 40000:
            fail("the flipped row of round 40000 no longer decodes")
        con.execute("UPDATE beacons SET data = ? WHERE round = 40000",
                    (bytes(blob),))
        con.execute("UPDATE beacons SET data = substr(data, 1, 50) "
                    "WHERE round = 50000")
        con.execute("DELETE FROM beacons WHERE round = 60000")
    con.close()
    fsck = subprocess.run(
        [sys.executable, "-m", "drand_tpu_torch.cli", "util", "fsck", copy,
         "--json"], cwd=HERE, capture_output=True, text=True, timeout=300)
    try:
        fsck_report = json.loads(fsck.stdout)
    except ValueError:
        fsck_report = {}
    want = {"corrupt": [50000], "missing": [[60000, 60000]],
            "unlinked": [], "bad_sigs": [], "verify_checked": False,
            "repair": None}
    if fsck.returncode != 1 or \
            {k: fsck_report.get(k) for k in want} != want:
        fail(f"util fsck on the damaged copy: exit {fsck.returncode}, "
             f"{fsck.stdout.strip()[:400]} {fsck.stderr.strip()[-400:]}")
    damaged = SqliteStore(copy)
    rep, summary, secs, segs, recs = scan(
        "recovery damaged scan", damaged, cv, default_path,
        startup_recovery)
    got = (rep.bad_sigs, rep.corrupt, rep.missing, rep.unlinked,
           rep.verified_tip)
    if got != ([40000], [50000], [(60000, 60000)], [], 39999):
        fail(f"damaged store: {rep.to_dict()}")
    if (rep.corrupt, [list(m) for m in rep.missing], rep.unlinked) != \
            (fsck_report["corrupt"], fsck_report["missing"],
             fsck_report["unlinked"]):
        fail("util fsck's structural lists differ from the BLS scan's")
    n_full = check_segments("damaged scan", segs, launches)
    tip = damaged.last().round
    if summary is None or summary["verified_tip"] != 39999 or tip != 39999:
        fail(f"repair: {summary}, tip {tip}")
    out["damaged"] = {"report": {k: v for k, v in rep.to_dict().items()
                                 if k != "path"},
                      "wall_s": secs, "repair": summary, "tip_after": tip,
                      "fsck_exit": fsck.returncode,
                      "fsck_structural_equal": True,
                      "full_segments_equal_slice_batch": n_full,
                      "dispatch": rows_of(recs)}
    rep, _, secs, segs, recs = scan("recovery rescan", damaged, cv,
                                    default_path)
    if not (rep.ok and rep.verify_checked and rep.verified_tip == 39999):
        fail(f"rescan of the repaired copy: {rep.to_dict()}")
    check_segments("rescan", segs, launches)
    out["rescan"] = {"scanned": rep.scanned, "wall_s": secs,
                     "dispatch": rows_of(recs)}
    damaged.close()
    store.close()

    # 4. the chained store: the genesis seed, rounds 1-65 of the committed
    # chained segment, round 30's signature flipped (round 31's stored prev
    # then fails its link) and round 50's stored prev replaced
    path = os.path.join(work_dir, "chained.db")
    cstore = SqliteStore(path)
    rows = [Beacon(0, seed)] + [
        Beacon(r, sigs_c[r - 1].tobytes(),
               seed if r == 1 else sigs_c[r - 2].tobytes())
        for r in range(1, sigs_c.shape[0] + 1)]
    flipped = bytearray(rows[30].signature)
    flipped[40] ^= 0x01
    rows[30].signature = bytes(flipped)
    rows[50].previous_sig = hashlib.sha512(b"broken link").digest() + \
        bytes(32)
    cstore.put_many(rows)
    cv_c = ChainVerifier(scheme_by_id("pedersen-bls-chained"), pk_bytes)
    rep, _, secs, segs, recs = scan("recovery chained store", cstore, cv_c,
                                    default_path)
    # every round the scan verified other than round 30 is true in the
    # slice phase's verdicts on this fixture; round 30's flipped signature
    # is false through the slice phase's Verifier
    checked = [r for r in range(1, 66) if r not in (31, 50)]
    flip_ok = chained.verify_chain_segment(
        30, np.frombuffer(bytes(flipped), np.uint8)[None], sigs_c[28])
    if (rep.bad_sigs, rep.unlinked, rep.corrupt, rep.missing,
            rep.verified_tip) != ([30], [31, 50], [], [], 29) or \
            not all(ok_c[r - 1] for r in checked) or flip_ok.tolist() != \
            [False] or segs[0][:2] != (1, 30) or \
            rows_of(recs)[0] != [1, 8]:
        fail(f"chained store: {rep.to_dict()}, segments "
             f"{[s[:2] for s in segs]}, records {rows_of(recs)}")
    out["chained"] = {"report": {k: v for k, v in rep.to_dict().items()
                                 if k != "path"},
                      "wall_s": secs, "genesis_anchor_record": [1, 8],
                      "verdicts_equal_slice": True,
                      "dispatch": rows_of(recs)}
    cstore.close()

    # 5. a bls-unchained-g1-rfc9380 store: the genesis seed and the G1
    # fixture's 16384 rounds, the key as compressed G2 bytes
    path = os.path.join(work_dir, "g1.db")
    gstore = SqliteStore(path)
    gstore.put_many([Beacon(0, seed)] + [
        Beacon(r, sigs1[r - 1].tobytes()) for r in range(1, BATCH + 1)])
    cv_g = ChainVerifier(scheme_by_id("bls-unchained-g1-rfc9380"),
                         GC.g2_to_bytes(pk2))
    rep, _, secs, segs, recs = scan("recovery g1 store", gstore, cv_g,
                                    G1_PATH)
    if not (rep.ok and rep.verified_tip == BATCH) or \
            rows_of(recs) != [[BATCH, BATCH]]:
        fail(f"G1 store: {rep.to_dict()}, records {rows_of(recs)}")
    check_segments("g1 store", segs, g1_launches)
    out["g1"] = {"rounds": BATCH, "wall_s": secs,
                 "rounds_per_s": BATCH / secs,
                 "segment_launches_equal_g1_batch": True,
                 "dispatch": [r.to_dict() for r in recs]}
    gstore.close()
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    return out, all_calls


def sha512_stream(seed: bytes):
    """n -> n bytes of SHA-512(seed || BE8(block)) blocks: the group's
    deterministic coefficient source."""
    def rand(n: int) -> bytes:
        out = b"".join(hashlib.sha512(seed + i.to_bytes(8, "big")).digest()
                       for i in range(-(-n // 64)))
        return out[:n]
    return rand


def partials_phase(default_path):
    """The `partials` phase: t-of-n partial verification and Lagrange
    recovery through the port's DeviceBackend, on a group of n = 16, t =
    9 (secret 424242, the other coefficients from a SHA-512 stream) over
    rounds 1-1024 of pedersen-bls-unchained, every signature made on the
    card.  Returns (its report line, the calls by kernel of each driven
    run)."""
    import asyncio

    import numpy as np
    import torch

    from drand_tpu_torch import dispatch as DSP
    from drand_tpu_torch import fixtures as FX
    from drand_tpu_torch import verify as V
    from drand_tpu_torch.beacon.crypto_backend import (AsyncPartialVerifier,
                                                       DeviceBackend)
    from drand_tpu_torch.crypto import tbls
    from drand_tpu_torch.crypto.bls12381.constants import DST_G2
    from drand_tpu_torch.crypto.poly import PriPoly
    from drand_tpu_torch.ops import bls as BLS

    t, n, R = PARTIALS_T, PARTIALS_N, PARTIALS_ROUNDS
    out, all_calls = {"phase": "partials", "n": n, "t": t, "rounds": R}, []
    launches, calls_of = {}, {}

    def run(what, fn, path):
        res, secs, counts, calls, n_conv = drive(fn)
        check_path(f"partials {what}", counts, n_conv, path)
        all_calls.append(calls)
        launches.setdefault(what, {k: v for k, v in counts.items() if v})
        calls_of.setdefault(what, calls)
        return res, secs, counts

    def kernel_rows(what, fn):
        """(device kernels, busy seconds, each port kernel's launches,
        device ms, bound summed over its calls and loss) of one more
        profiled run of `what`; ms and loss null where no session saw
        every launch of the kernel."""
        kern, complete = profile_kernels(fn, launches[what])
        ms = collections.Counter()
        for dev_name, d in kern:
            name = kernel_of(dev_name)
            if name is not None:
                ms[name] += d * 1e3
        rows = {}
        for name, count in launches[what].items():
            bound = sum(k * bound_ms(*work(name, call))[0]
                        for call, k in calls_of[what][name].items())
            path = ms[name] if name in complete else None
            rows[name] = {"launches": count, "path_ms": path,
                          "bound_ms_batch": bound,
                          "loss_ms": None if path is None else path - bound}
        return len(kern), sum(d for _, d in kern), rows

    def records():
        return [[r.seam, r.n, r.bucket, r.device_s]
                for r in DSP.DISPATCH.records()]

    def issue_wall(fn):
        """(seconds until fn() returns without waiting for the device,
        seconds until the device is done)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t0

    poly = PriPoly.random(t, secret=GROUP_SECRET,
                          rand=sha512_stream(GROUP_SEED))
    shares = poly.shares(n)
    pub = poly.commit()
    rounds = np.arange(1, R + 1, dtype=np.uint64)
    be8 = V.rounds_be8(rounds)
    verifier = V.Verifier(pub.commits[0], V.SHAPE_UNCHAINED)
    msgs = [hashlib.sha256(m.tobytes()).digest()
            for m in verifier.messages(rounds, None)]

    # 1. signing on the card: each share's signatures of the 1024 rounds,
    # then the group secret's (the expected group signatures)
    sigs, sign_s = [], []
    for share in shares:
        res, secs, _ = run("sign", lambda: FX.sign_batch_g2(share.value, be8),
                           G2_CURVE)
        sigs.append(res)
        sign_s.append(secs)
    gsig, gsign_s, _ = run("sign", lambda: FX.sign_batch_g2(poly.secret(),
                                                           be8), G2_CURVE)
    ok_g, group_verify_s, _ = run("group verify",
                                  lambda: verifier.verify_batch(rounds, gsig),
                                  default_path)
    if not ok_g.all():
        fail(f"group signatures: {int(ok_g.sum())}/{R} verify true")
    by_round = [[s.index.to_bytes(2, "big") + sigs[j][r].tobytes()
                 for j, s in enumerate(shares)] for r in range(R)]

    # 2. rounds-major verification: 1024 rounds x 16 signers in one
    # "rounds" dispatch
    be = DeviceBackend(pub, t, n)
    DSP.DISPATCH.clear()
    ok, rounds_s, _ = run("rounds verify",
                          lambda: be.verify_partials_rounds(msgs, by_round),
                          default_path)
    if not all(all(row) for row in ok):
        fail(f"rounds verify: {sum(map(sum, ok))}/{R * n} true")
    rec_rounds = records()
    if [r[:3] for r in rec_rounds] != [["rounds", R, R]]:
        fail(f"rounds verify: dispatch records {rec_rounds}")
    t0 = time.perf_counter()
    be.verify_partials_rounds(msgs, by_round)
    rounds_next_s = time.perf_counter() - t0
    # the same check issued through ops/bls.py, the backend's packing left
    # out: how long the host takes to issue it
    packed = [torch.from_numpy(a).cuda() for a in (
        np.stack([np.frombuffer(m, np.uint8) for m in msgs]),
        np.stack(sigs, 1), np.tile(np.arange(n, dtype=np.int32), (R, 1)))]
    rounds_issue = issue_wall(lambda: BLS.verify_partial_g2_sigs_shared(
        *packed, be.table.arrays(), DST_G2))
    del packed

    # four negative rows: a flipped byte (round 512, signer 5), a valid
    # signature under another signer's index, the infinity flag, 95 bytes
    bad = [list(row) for row in by_round]
    g = bad[512][5]
    bad[512][5] = g[:10] + bytes([g[10] ^ 1]) + g[11:]
    bad[100][3] = (3).to_bytes(2, "big") + tbls.sig_of(by_round[100][4])
    bad[200][7] = (7).to_bytes(2, "big") + bytes([0xC0]) + bytes(95)
    bad[300][9] = by_round[300][9][:95]
    negatives = {"flipped_byte": [512, 5], "other_signer": [100, 3],
                 "infinity_flag": [200, 7], "partial_95_bytes": [300, 9]}
    t0 = time.perf_counter()
    ok_bad = be.verify_partials_rounds(msgs, bad)
    bad_s = time.perf_counter() - t0
    false_at = sorted([r, j] for r in range(R) for j in range(n)
                      if not ok_bad[r][j])
    if false_at != sorted(negatives.values()):
        fail(f"rounds verify negatives: false at {false_at[:10]}")
    stats_tabled = dict(be.stats)
    if stats_tabled["table_fallbacks"] or \
            stats_tabled["table_hits"] != 3 * R * n:
        fail(f"rounds verify: stats {stats_tabled}")

    # 3. an index outside the table sends the whole call through the flat
    # verify_partials at bucket 16384, keys from the in-batch Horner
    out_idx = [700, 2]
    unt = [list(row) for row in by_round]
    unt[700][2] = (16).to_bytes(2, "big") + tbls.sig_of(by_round[700][2])
    DSP.DISPATCH.clear()
    ok_u, untabled_s, _ = run(
        "untabled verify", lambda: be.verify_partials_rounds(msgs, unt),
        default_path + ["mont_sqr"])
    rec_untabled = records()
    diff = sorted([r, j] for r in range(R) for j in range(n)
                  if ok_u[r][j] != ok[r][j])
    if diff != [out_idx] or ok_u[700][2] or \
            [r[:3] for r in rec_untabled] != [["partials", R * n, R * n]]:
        fail(f"untabled verify: verdicts differ at {diff[:10]}, records "
             f"{rec_untabled}")
    if be.stats["table_fallbacks"] != 2 * R * n:
        fail(f"untabled verify: stats {be.stats}")

    # 4. a live burst: 16 concurrent partials of one round coalesce into
    # one "partials" dispatch of one distinct message
    async def burst():
        verifier_ = AsyncPartialVerifier(be, max_delay=0.05)
        oks = await asyncio.gather(*[verifier_.verify(msgs[0], p)
                                     for p in by_round[0]])
        verifier_.stop()
        return oks

    DSP.DISPATCH.clear()
    distinct = be.stats["distinct_messages"]
    oks, burst_s, _ = run("burst", lambda: asyncio.run(burst()),
                          default_path)
    rec_burst = records()
    if oks != [True] * n or [r[:3] for r in rec_burst] != \
            [["partials", n, n]] or \
            be.stats["distinct_messages"] - distinct != 1:
        fail(f"burst: verdicts {oks}, records {rec_burst}, stats {be.stats}")

    # 5. recovery: t partials a round, the signers rotating with the
    # round, so the Lagrange bases differ from round to round
    parts_t = [[by_round[r][(r + j) % n] for j in range(t)]
               for r in range(R)]
    full, recover_s, _ = run("recover_rounds",
                             lambda: be.recover_rounds(msgs, parts_t),
                             G2_CURVE)
    want = [gsig[r].tobytes() for r in range(R)]
    if full != want:
        fail(f"recover_rounds: {sum(a != b for a, b in zip(full, want))} "
             f"of {R} differ from the secret's signatures")
    ok_full = verifier.verify_batch(
        rounds, np.stack([np.frombuffer(f, np.uint8) for f in full]))
    if not ok_full.all():
        fail(f"recovered signatures: {int(ok_full.sum())}/{R} verify true")
    t0 = time.perf_counter()
    be.recover_rounds(msgs, parts_t)
    recover_next_s = time.perf_counter() - t0
    points = [be._round_points(p, "") for p in parts_t]
    recover_issue = issue_wall(lambda: be._recover_msm(
        np.stack([np.stack(s) for s, _ in points]), [b for _, b in points]))
    one, recover_one_s, _ = run("recover", lambda: be.recover(
        msgs[5], by_round[5][7:] + by_round[5][:7]), G2_CURVE)
    if one != want[5]:
        fail("recover: round 6 differs from the secret's signature")
    try:
        be.recover_rounds(msgs[:2], [parts_t[0], by_round[1][:t - 1]])
        fail("recover_rounds took a round of t - 1 partials")
    except ValueError:
        pass

    # the device kernels of one more rounds verify and recover_rounds
    rounds_dev, rounds_busy, rounds_rows = kernel_rows(
        "rounds verify", lambda: be.verify_partials_rounds(msgs, by_round))
    recover_dev, recover_busy, recover_rows = kernel_rows(
        "recover_rounds", lambda: be.recover_rounds(msgs, parts_t))
    out.update({
        "group_secret": GROUP_SECRET, "group_seed": GROUP_SEED.decode(),
        "group_verify_all_true": True, "rounds_all_true": True,
        "negatives_false_only": negatives,
        "untabled_differs_only_at": out_idx,
        "burst_all_true": True, "recovered_equal_secret_sigs": True,
        "recovered_verify_true": True, "recover_one_equal": True,
        "recover_short_round_raises": True,
        "sign_s": sign_s, "group_sign_s": gsign_s,
        "group_verify_s": group_verify_s,
        "rounds_verify_wall_s": rounds_s,
        "rounds_verify_next_wall_s": rounds_next_s,
        "rounds_negatives_wall_s": bad_s,
        "rounds_check_issue_s": rounds_issue[0],
        "rounds_check_wall_s": rounds_issue[1],
        "recover_msm_issue_s": recover_issue[0],
        "recover_msm_wall_s": recover_issue[1],
        "untabled_wall_s": untabled_s, "burst_wall_s": burst_s,
        "recover_rounds_wall_s": recover_s,
        "recover_rounds_next_wall_s": recover_next_s,
        "recover_wall_s": recover_one_s,
        "partials_per_s": R * n / rounds_next_s,
        "recoveries_per_s": R / recover_next_s,
        "rounds_verify_device_kernels": rounds_dev,
        "rounds_verify_busy_s": rounds_busy,
        "rounds_verify_idle_share": 1.0 - rounds_busy / rounds_next_s,
        "rounds_verify_kernels": rounds_rows,
        "recover_rounds_device_kernels": recover_dev,
        "recover_rounds_busy_s": recover_busy,
        "recover_rounds_idle_share": 1.0 - recover_busy / recover_next_s,
        "recover_rounds_kernels": recover_rows,
        "launches": launches,
        "dispatch": {"rounds": rec_rounds, "untabled": rec_untabled,
                     "burst": rec_burst},
        "stats": dict(be.stats),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    return out, all_calls


# the plain limb convolution, counted wherever the port calls it while
# `drive` runs
_CONV = {"calls": 0, "plain": None}


def _counted_poly_mul_var(a, b):
    _CONV["calls"] += 1
    return _CONV["plain"](a, b)


def drive(fn):
    """fn() with every launch count at 0 just before it; returns (its
    result, seconds, launches, calls by kernel, _poly_mul_var calls),
    the counts read just after it."""
    import torch

    from drand_tpu_torch.ops import field as FLD
    from drand_tpu_torch.ops import flat12 as FL
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops import towers as TW
    torch.cuda.synchronize()
    _CONV["calls"], _CONV["plain"] = 0, FLD._poly_mul_var
    for mod in (FLD, TW, FL):
        mod._poly_mul_var = _counted_poly_mul_var
    K.reset_launches()
    try:
        t0 = time.perf_counter()
        out = fn()
        seconds = time.perf_counter() - t0
    finally:
        for mod in (FLD, TW, FL):
            mod._poly_mul_var = _CONV["plain"]
    counts = K.launch_counts()
    calls = {name: collections.Counter(k.calls)
             for name, k in K.KERNELS.items()}
    return out, seconds, counts, calls, _CONV["calls"]


def check_path(what, counts, n_conv, path):
    """Fail unless the run launched every kernel of `path` and no other,
    and never ran the plain limb convolution."""
    missed = [name for name in path if not counts[name]]
    extra = [name for name, n in counts.items() if n and name not in path]
    if missed or extra or n_conv:
        fail(f"{what}: kernels of the path not launched {missed}, "
             f"launched off the path {extra}, _poly_mul_var {n_conv} "
             f"calls; launches {counts}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    from drand_tpu_torch import fixtures as FX
    from drand_tpu_torch import kernel_bench as KB
    from drand_tpu_torch import verify as V
    from drand_tpu_torch.profiling import trio_batch_async
    from drand_tpu_torch.crypto.bls12381 import curve as GC
    from drand_tpu_torch.crypto.bls12381 import pairing as GP
    from drand_tpu_torch.crypto.bls12381.constants import DST_G1, P
    from drand_tpu_torch.crypto.bls12381.constants import X as BLS_X
    from drand_tpu_torch.ops import bls as BLS
    from drand_tpu_torch.ops import field as FLD
    from drand_tpu_torch.ops import flat12 as FL
    from drand_tpu_torch.ops import curve as DC
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops import pairing as PR
    from drand_tpu_torch.ops import towers as TW
    from drand_tpu_torch.ops.field import FP, FR, int_to_limbs
    from drand_tpu_torch.ops.pairing import LINE_IDX

    report = {}
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(smi, flush=True)
    report["device"] = {
        "phase": "device", "nvidia_smi": smi,
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(report["device"])

    # -- build ---------------------------------------------------------------
    info = K.build()
    regs = [ln.strip() for ln in info["log"].splitlines()
            if "registers" in ln or "spill" in ln or ln.startswith("== ")]
    report["build"] = {"phase": "build", "seconds": info["seconds"],
                       "dir": os.path.relpath(info["dir"], HERE),
                       "ptxas": regs}
    emit(report["build"])
    report["occupancy"] = {"phase": "occupancy", **{
        name: K.kernel_attrs(name)
        for name in ("mont_mul", "sqr_chain_mul", "fp2_products",
                     "fp2_sqrs", "fp2_sqr_chain_mul", "flat_mul",
                     "g2_point_dbl", "g2_point_add", "miller_dbl_iter",
                     "miller_add_iter", "cyclo_sqr", "flat_conj",
                     "flat_frob", "flat_sqr", "g2_dbl_line", "g2_add_line",
                     "line_merge")}}
    emit(report["occupancy"])

    def pairing_rows(k_pairs: int, n: int):
        """Pairs for pairing_check_pairs at K = k_pairs on n rows, tiled
        from 64 rows of distinct golden-model pairs a G1, b G2 (random
        a, b): for K = 1 the pair, inactive in every other row; for K = 3
        either (P, Q), (-P, Q) and a third pair, or (a G1, b G2),
        (c G1, d G2) and (-(ab + cd) G1, G2), under a cycle of every
        active/inactive mask.  Returns (pairs, active masks, the golden
        pairing_check of every row's active pairs)."""
        grng = random.Random(7 + k_pairs)
        sc = [(grng.randrange(1, GC.R), grng.randrange(1, GC.R))
              for _ in range(65)]
        base = [(GC.g1_mul(GC.G1_GEN, a), GC.g2_mul_raw(GC.G2_GEN, b))
                for a, b in sc]
        rows, masks = [], []
        for i in range(64):
            if k_pairs == 1:
                rows.append([base[i]])
                masks.append([i % 2 == 1])
                continue
            if i % 2 == 0:
                p, q = base[i]
                rows.append([(p, q), (GC.g1_neg(p), q), base[i + 1]])
            else:
                (a, b), (c, d) = sc[i], sc[i + 1]
                rows.append([base[i], base[i + 1],
                             (GC.g1_mul(GC.G1_GEN, -(a * b + c * d) % GC.R),
                              GC.G2_GEN)])
            m = (i // 2) % 8
            masks.append([bool(m & 4), bool(m & 2), bool(m & 1)])
        want = np.array([GP.pairing_check(
            [pq for pq, on in zip(r, ms) if on])
            for r, ms in zip(rows, masks)])
        reps = n // 64

        def coord(vals):
            return torch.from_numpy(np.tile(FP.encode(vals), (reps, 1))).to(dev)

        pairs = []
        for k in range(k_pairs):
            ps = [GC.g1_affine(r[k][0]) for r in rows]
            qs = [GC.g2_affine(r[k][1]) for r in rows]
            pairs.append(((coord([p[0] for p in ps]),
                           coord([p[1] for p in ps])),
                          ((coord([q[0][0] for q in qs]),
                            coord([q[0][1] for q in qs])),
                           (coord([q[1][0] for q in qs]),
                            coord([q[1][1] for q in qs])))))
        active = [torch.tensor([m[k] for m in masks] * reps, device=dev)
                  for k in range(k_pairs)]
        return pairs, active, np.tile(want, reps)

    # -- slice ---------------------------------------------------------------
    _sk, pk = FX.fixture_keypair()
    sigs_c, pk_bytes, seed = FX.load_chained_fixture()
    if GC.g1_to_bytes(pk) != pk_bytes:
        fail("fixture_keypair does not rebuild the committed public key")
    verifier = V.Verifier(pk, V.SHAPE_UNCHAINED)
    sigs = np.load(FIXTURE)
    if sigs.shape != (BATCH, 96):
        fail(f"unexpected fixture shape {sigs.shape}")
    rounds = np.arange(1, BATCH + 1, dtype=np.uint64)

    t_dispatch = [0.0]

    def default_batch():
        t0 = time.perf_counter()
        resolve = verifier.verify_batch_async(rounds, sigs)
        t_dispatch[0] = time.perf_counter() - t0
        return resolve()

    ok, t_batch, launches, path_calls, n_conv = drive(default_batch)
    if not ok.all():
        fail(f"valid 16384-round segment: {int(ok.sum())}/{BATCH} true")
    default_path = [name for name in K.KERNELS if name not in OFF_PATH + TRIO]
    check_path("default batch", launches, n_conv, default_path)
    if launches["cyclo_sqr"] > 31 or launches["miller_dbl_iter"] != 63 or \
            launches["g2_point_dbl"] != 19 or \
            launches["sqr_chain_mul"] != 2 or launches["mont_mul"] != 22:
        fail(f"default batch: cyclo_sqr launched {launches['cyclo_sqr']} "
             f"times (at most 31: one a run of squares), g2_point_dbl "
             f"{launches['g2_point_dbl']} (19: one a run of doublings), "
             f"miller_dbl_iter {launches['miller_dbl_iter']} (63), "
             f"sqr_chain_mul {launches['sqr_chain_mul']} (2: one a Fermat "
             f"inversion), mont_mul {launches['mont_mul']} (22)")

    bad = sigs.copy()
    flip_at = 4321
    bad[flip_at, 40] ^= 0x01
    t1 = time.perf_counter()
    ok_bad = verifier.verify_batch(rounds, bad)
    t_bad = time.perf_counter() - t1
    if ok_bad[flip_at] or int((~ok_bad).sum()) != 1:
        fail(f"flipped byte: {int((~ok_bad).sum())} false, "
             f"flipped row {bool(ok_bad[flip_at])}")

    # every device kernel of one more default batch, torch's own included
    batch_kernels, batch_complete = profile_kernels(
        lambda: verifier.verify_batch(rounds, sigs),
        {name: launches[name] for name in K.KERNELS if name not in TRIO})

    chained = V.Verifier(pk, V.SHAPE_CHAINED)
    ok_c, t_chain, chain_launches, chain_calls, n_conv = drive(
        lambda: chained.verify_chain_segment(
            1, sigs_c, np.frombuffer(seed, np.uint8)))
    if not ok_c.all() or ok_c.shape != (65,):
        fail(f"chained segment: {int(ok_c.sum())}/{ok_c.shape[0]} true")
    check_path("chained segment", chain_launches, n_conv, default_path)

    report["slice"] = {
        "phase": "slice", "rounds": BATCH, "all_true": True,
        "flipped_row_false_only": True, "chained_rounds_1_65_true": True,
        "batch_wall_s": t_batch, "dispatch_s": t_dispatch[0],
        "flipped_batch_wall_s": t_bad, "chained_65_wall_s": t_chain,
        "launches": launches,
        "batch_device_kernels": len(batch_kernels),
        "batch_busy_s": sum(d for _, d in batch_kernels),
        "batch_profile_short": sorted(set(K.KERNELS) - set(TRIO)
                                      - batch_complete),
        "off_path": {"mont_sqr": "0 launches: its only calls were the "
                                 "two inversions' a^2, now inside K4's "
                                 "one launch an inversion (the G1 path "
                                 "launches it: g1 phase)",
                     "mont_reduce": "0 launches: the composite products "
                                    "that reduced through it are K5, K6, "
                                    "K13, K14",
                     "fp2_sqr5_mul": "0 launches: both of the path's Fp2 "
                                     "exponents take the addition chain "
                                     "(K7 steps)",
                     "line_merge": "0 launches: K11 and K12 multiply "
                                   "f by the two lines one after the "
                                   "other; nothing calls it alone, as in "
                                   "drand_tpu",
                     "add": "0 launches: Field.add keeps its torch path, "
                            "as drand_tpu's stays in XLA",
                     "sub": "0 launches: as add",
                     "trio": "0 launches of flat_sqr, g2_dbl_line, "
                             "g2_add_line: the default executor is the "
                             "merged one"},
        "poly_mul_var_calls": n_conv,
        "calls": {name: sorted(c.items()) for name, c in path_calls.items()},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    emit(report["slice"])

    # -- trio ----------------------------------------------------------------
    ok_t, t_trio, trio_launches, trio_calls, n_conv = drive(
        lambda: trio_batch_async(verifier, rounds, sigs)())
    if not np.array_equal(ok_t, ok):
        fail(f"trio executor: {int((ok_t != ok).sum())} verdicts differ "
             f"from the default's")
    check_path("trio batch", trio_launches, n_conv,
               [name for name in K.KERNELS if name not in OFF_PATH + MERGED])
    t1 = time.perf_counter()
    ok_t_bad = trio_batch_async(verifier, rounds, bad)()
    t_trio_bad = time.perf_counter() - t1
    if not np.array_equal(ok_t_bad, ok_bad):
        fail("trio executor: the flipped batch's verdicts differ from the "
             "default's")
    # the trio kernels' device time in one more trio batch
    trio_kernels, trio_complete = profile_kernels(
        lambda: trio_batch_async(verifier, rounds, sigs)(),
        {name: trio_launches[name] for name in TRIO})

    golden = {}
    pairing_calls = {name: collections.Counter() for name in K.KERNELS}
    for k_pairs in (1, 3):
        pairs, active, want = pairing_rows(k_pairs, 4096)
        got, t_k, k_launches, k_calls, n_conv = drive(
            lambda: PR.pairing_check_pairs(pairs, active).cpu().numpy())
        if not np.array_equal(got, want):
            fail(f"K = {k_pairs}: {int((got != want).sum())} verdicts differ "
                 f"from the golden pairing_check")
        check_path(f"K = {k_pairs} pairing check", k_launches, n_conv,
                   PAIRING)
        golden[k_pairs] = {"rows": int(want.size),
                           "true": int(want.sum()), "wall_s": t_k,
                           "launches": {n: v for n, v in k_launches.items()
                                        if v}}
        for name, cnt in k_calls.items():
            pairing_calls[name].update(cnt)
        del pairs, active

    report["trio"] = {
        "phase": "trio", "rounds": BATCH, "verdicts_equal_default": True,
        "flipped_verdicts_equal_default": True,
        "batch_wall_s": t_trio, "flipped_batch_wall_s": t_trio_bad,
        "launches": trio_launches,
        "batch_device_kernels": len(trio_kernels),
        "batch_busy_s": sum(d for _, d in trio_kernels),
        "batch_profile_short": sorted(set(TRIO) - trio_complete),
        "pairing_checks": golden,
        "calls": {name: sorted(c.items()) for name, c in trio_calls.items()},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    emit(report["trio"])

    # -- g1 ------------------------------------------------------------------
    _sk2, pk2 = FX.fixture_keypair_g2()
    g1_hashes = (hashlib.sha256(DST_G1).hexdigest()[:8],
                 hashlib.sha256(GC.g2_to_bytes(pk2)).hexdigest()[:8])
    if g1_hashes != G1_FIXTURE_HASHES or \
            not FX.G1_FIXTURE.name.endswith("_%s_%s.npy" % g1_hashes):
        fail(f"fixture_keypair_g2 and DST_G1 hash to {g1_hashes}, not the "
             f"committed G1 fixture's {G1_FIXTURE_HASHES}")
    sigs1 = np.load(FX.G1_FIXTURE)
    if sigs1.shape != (BATCH, 48):
        fail(f"unexpected G1 fixture shape {sigs1.shape}")
    verifier1 = V.Verifier(pk2, V.SHAPE_UNCHAINED_G1)
    g1_issue = [0.0]

    def g1_batch(batch=sigs1):
        t0 = time.perf_counter()
        resolve = verifier1.verify_batch_async(rounds, batch)
        g1_issue[0] = time.perf_counter() - t0
        return resolve()

    ok1, t_g1, g1_launches, g1_calls, n_conv = drive(g1_batch)
    g1_first_issue = g1_issue[0]
    if not ok1.all():
        fail(f"valid 16384-round G1 segment: {int(ok1.sum())}/{BATCH} true")
    check_path("g1 batch", g1_launches, n_conv, G1_PATH)
    t1 = time.perf_counter()
    ok1 = g1_batch()
    t_g1_next, g1_next_issue = time.perf_counter() - t1, g1_issue[0]
    if not ok1.all():
        fail("valid 16384-round G1 segment, second batch: "
             f"{int(ok1.sum())}/{BATCH} true")
    bad1 = sigs1.copy()
    bad1[flip_at, 20] ^= 0x01
    t1 = time.perf_counter()
    ok1_bad = g1_batch(bad1)
    t_g1_bad = time.perf_counter() - t1
    if ok1_bad[flip_at] or int((~ok1_bad).sum()) != 1:
        fail(f"G1 flipped byte: {int((~ok1_bad).sum())} false, flipped "
             f"row {bool(ok1_bad[flip_at])}")
    # the negative controls, each in a row of its own
    x_ge_p = bytearray(P.to_bytes(48, "big"))
    x_ge_p[0] |= 0x80
    controls = {"infinity_flag": (11, bytes([0xC0]) + bytes(47)),
                "x_ge_p": (2222, bytes(x_ge_p)),
                "off_subgroup": (15000, off_subgroup_g1())}
    neg1 = sigs1.copy()
    for at, row in controls.values():
        neg1[at] = np.frombuffer(row, np.uint8)
    ok1_neg = g1_batch(neg1)
    false_rows = sorted(int(i) for i in np.flatnonzero(~ok1_neg))
    if false_rows != sorted(at for at, _ in controls.values()):
        fail(f"G1 negative controls {controls.keys()}: false rows "
             f"{false_rows[:10]}")
    ok1_t, t_g1_trio, g1_trio_launches, g1_trio_calls, n_conv = drive(
        lambda: trio_batch_async(verifier1, rounds, neg1)())
    if not np.array_equal(ok1_t, ok1_neg):
        fail(f"G1 trio executor: {int((ok1_t != ok1_neg).sum())} verdicts "
             f"differ from the default's")
    check_path("g1 trio batch", g1_trio_launches, n_conv, G1_TRIO_PATH)
    # every device kernel of one more default G1 batch
    g1_kernels, g1_complete = profile_kernels(
        lambda: verifier1.verify_batch(rounds, sigs1),
        {name: g1_launches[name] for name in G1_PATH})
    g1_busy = sum(d for _, d in g1_kernels)
    # one G1 |x| ladder on the batch's signature points: the subgroup check
    # runs two, hash_to_g1's h_eff = 1 - x one more, all in the FpOps
    # formulas (no G1 point kernel)
    (gx, gy), _, _ = BLS.g1_decompress(torch.from_numpy(sigs1).to(dev))
    g1_pt = (gx, gy, TW.fp_broadcast(TW.FP_ONE, gx.shape[:-1], dev))

    def x_ladder():
        return DC.point_mul_const(g1_pt, -BLS_X, DC.FpOps)

    _, t_ladder, ladder_launches, _, _ = drive(x_ladder)
    ladder_kernels, _ = profile_kernels(
        x_ladder, {n: ladder_launches[n] for n in ("mont_mul", "mont_sqr")})
    g1_ms = collections.Counter()
    for dev_name, d in g1_kernels:
        name = kernel_of(dev_name)
        if name is not None:
            g1_ms[name] += d * 1e3
    g1_kernel_rows = {}
    for name in G1_PATH:
        bound = sum(n * bound_ms(*work(name, call))[0]
                    for call, n in g1_calls[name].items())
        path = g1_ms[name] if name in g1_complete else None
        g1_kernel_rows[name] = {
            "launches": g1_launches[name], "path_ms": path,
            "bound_ms_batch": bound,
            "loss_ms": None if path is None else path - bound}
    report["g1"] = {
        "phase": "g1", "scheme": "bls-unchained-g1-rfc9380",
        "rounds": BATCH, "fixture": os.path.relpath(FX.G1_FIXTURE, HERE),
        "fixture_hashes": g1_hashes, "all_true": True,
        "flipped_row_false_only": True,
        "controls_false_only": {k: at for k, (at, _) in controls.items()},
        "trio_verdicts_equal_default": True,
        "first_batch_wall_s": t_g1, "first_batch_issue_s": g1_first_issue,
        "next_batch_wall_s": t_g1_next, "next_batch_issue_s": g1_next_issue,
        "flipped_batch_wall_s": t_g1_bad, "trio_batch_wall_s": t_g1_trio,
        "launches": g1_launches, "trio_launches": g1_trio_launches,
        "batch_device_kernels": len(g1_kernels), "batch_busy_s": g1_busy,
        "idle_share": 1.0 - g1_busy / t_g1_next,
        "ours_s": sum(g1_ms.values()) / 1e3,
        "batch_profile_short": sorted(set(G1_PATH) - g1_complete),
        "x_ladder": {"wall_s": t_ladder,
                     "launches": {n: v for n, v in ladder_launches.items()
                                  if v},
                     "device_kernels": len(ladder_kernels),
                     "busy_s": sum(d for _, d in ladder_kernels)},
        "kernels": g1_kernel_rows,
        "poly_mul_var_calls": n_conv,
        "calls": {name: sorted(c.items()) for name, c in g1_calls.items()},
        "trio_calls": {name: sorted(c.items())
                       for name, c in g1_trio_calls.items()},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    emit({k: v for k, v in report["g1"].items()
          if k not in ("calls", "trio_calls")})

    # -- recovery ------------------------------------------------------------
    rec_dir = tempfile.mkdtemp(prefix="recovery-",
                               dir=os.path.join(HERE, "build"))
    try:
        report["recovery"], recovery_calls = recovery_phase(
            rec_dir, drive, check_path, sigs, sigs_c, pk_bytes, seed,
            launches, default_path, sigs1, pk2, g1_launches, ok_c,
            chained)
    finally:
        shutil.rmtree(rec_dir, ignore_errors=True)
    emit(report["recovery"])

    # -- partials ------------------------------------------------------------
    report["partials"], partials_calls = partials_phase(default_path)
    emit(report["partials"])

    # every call the runs made, for the parity phase
    all_calls = {name: set(path_calls[name]) | set(chain_calls[name])
                 | set(trio_calls[name]) | set(pairing_calls[name])
                 | set(g1_calls[name]) | set(g1_trio_calls[name])
                 | set().union(*(c[name] for c in recovery_calls))
                 | set().union(*(c[name] for c in partials_calls))
                 for name in K.KERNELS}

    # -- parity --------------------------------------------------------------
    rng = np.random.default_rng(2024)
    fields = {F.name: F for F in (FP, FR)}

    def field_rows(F, shape):
        """Canonical elements: 0, 1, m-1 and 61 random values, then
        random limbs below 2^379 (Fp) or 2^250 (Fr)."""
        n = math.prod(shape[:-1])
        m = F.modulus
        vals = [0, 1, m - 1] + [int.from_bytes(rng.bytes(48), "little") % m
                                for _ in range(61)]
        head = F.encode(vals)[:n]
        body = rng.integers(0, 4096, size=(n - len(head), 32), dtype=np.int32)
        body[:, 31] &= 0x7F
        if F is FR:
            body[:, 21:] = 0
            body[:, 20] &= 0x3FF
        arr = np.concatenate([head, body]).reshape(shape)
        return torch.from_numpy(arr).to(dev)

    def wide_rows(F, shape):
        """Wide values at the K3 contract, value below (2 - 2^-9) R m:
        0, 1, the top, m R - 1 and random values, then random limbs up to
        the top's highest limb; every row's value is then spread over
        limbs up to 2^14 - 1 by borrowing 0-3 from each upper limb into
        the one below."""
        n = math.prod(shape[:-1])
        R = 1 << 384
        top = 2 * R * F.modulus - ((R * F.modulus) >> 9) - 1
        vals = [0, 1, top, top // 2, F.modulus * R - 1]
        vals += [int.from_bytes(rng.bytes(96), "little") % top
                 for _ in range(59)]
        head = np.stack([int_to_limbs(v, 64) for v in vals])
        hi = (top.bit_length() - 1) // 12
        body = rng.integers(0, 4096, size=(n, 64), dtype=np.int32)
        body[:, hi] = rng.integers(0, max(top >> (12 * hi), 1), size=n)
        body[:, hi + 1:] = 0
        w = np.concatenate([head, head, body])[:n]
        b = np.minimum(rng.integers(0, 4, size=w.shape, dtype=np.int32), w)
        b[:, 0] = 0
        b[:len(head)] = 0            # the head once as normalized limbs
        w = w - b
        w[:, :-1] += 4096 * b[:, 1:]
        if w.max() >= 1 << 14 or w.min() < 0:
            fail("wide_rows built limbs outside [0, 2^14)")
        return torch.from_numpy(np.ascontiguousarray(w.reshape(shape))).to(dev)

    def max_flat(shape):
        """Flat Fp12 rows whose every stored coefficient is p - 1: the
        largest convolution values (drand_tpu's round-4 offset bug)."""
        row = torch.tensor([((P - 1) >> (12 * i)) & 0xFFF for i in range(32)],
                           dtype=torch.int32, device=dev)
        return row.expand(shape).contiguous()

    def unitary_rows(shape):
        """Unitary flat Fp12 rows, f^((p^6 - 1)(p^2 + 1)) of random f,
        made on the card by the port's own flat ops."""
        f = field_rows(FP, shape)
        f = FL.flat_mul(FL.flat_conj(f), FL.flat_inv(f))
        return FL.flat_mul(FL.flat_frob(f, 2), f)

    def g2_pair(shape):
        """[6, rows, 32] point pairs over random coordinates, with the
        special cases in the six rows on both sides of every 32-row block
        edge (K10's blocks; the first six rows when there is no edge), in
        turn: p2 = p1 (the doubling case), p2 = -p1 (cancels), p2 = p1
        under another Z (l^2 X, l^3 Y, l Z: the same point), p1
        infinite, p2 infinite, both infinite."""
        rows = shape[1]
        p1, p2 = field_rows(FP, shape), field_rows(FP, shape)
        at = [r for e in range(32, rows, 32) for r in range(e - 3, e + 3)
              if r < rows] or list(range(min(rows, 6)))
        by = [torch.tensor(at[c::6], device=dev, dtype=torch.long)
              for c in range(6)]
        p2[:, by[0]] = p1[:, by[0]]
        p2[:, by[1]] = p1[:, by[1]]
        p2[2:4, by[1]] = FP.neg(p1[2:4, by[1]])
        pt = DC.g2_unpack(p1[:, by[2]])
        lam = (field_rows(FP, (len(by[2]), 32)),
               field_rows(FP, (len(by[2]), 32)).flip(0))
        l2 = DC.Fp2PlainOps.sqr(lam)
        l3 = DC.Fp2PlainOps.mul(l2, lam)
        p2[:, by[2]] = DC.g2_pack(tuple(DC.Fp2PlainOps.mul(c, m)
                                        for c, m in zip(pt, (l2, l3, lam))))
        p1[4:, by[3]] = 0
        p2[4:, by[4]] = 0
        p1[4:, by[5]] = 0
        p2[4:, by[5]] = 0
        return p1, p2

    def flat_edges(a, b):
        """In the six rows on both sides of every 32-row block edge of K13
        (the first six rows when there is none), in turn: a and b all p - 1,
        a all p - 1, b all p - 1, a zero, b zero, both zero; in place."""
        rows = a.shape[0]
        at = [r for e in range(32, rows, 32) for r in range(e - 3, e + 3)
              if r < rows] or list(range(min(rows, 6)))
        by = [torch.tensor(at[c::6], device=dev, dtype=torch.long)
              for c in range(6)]
        a[by[0]], b[by[0]] = max_flat(a[by[0]].shape), max_flat(b[by[0]].shape)
        a[by[1]] = max_flat(a[by[1]].shape)
        b[by[2]] = max_flat(b[by[2]].shape)
        a[by[3]] = 0
        b[by[4]] = 0
        a[by[5]], b[by[5]] = 0, 0

    def miller_state(shape, add):
        """f, T (Z = 1 in the first rows, as at the loop's start), (Q,) P
        and masks with every active/inactive combination."""
        lead = shape[:-2]
        f = field_rows(FP, shape)
        T = field_rows(FP, lead + (2, 6, 32))
        T[:8, :, 4] = FP.one_mont.to(dev)
        T[:8, :, 5] = 0
        P_ = field_rows(FP, lead + (2, 2, 32))
        masks = torch.from_numpy(rng.integers(0, 2, size=lead + (2,),
                                              dtype=np.int32)).to(dev)
        masks[:4] = torch.tensor([[1, 1], [1, 0], [0, 1], [0, 0]],
                                 dtype=torch.int32, device=dev)
        if add:
            return f, T, field_rows(FP, lead + (2, 4, 32)), P_, masks
        return f, T, P_, masks

    def edge_rows(F, shape, run=1):
        """Rows whose every stored coefficient is m - 1, alternating with
        all-zero rows in runs of `run` rows: runs 1 and 2 side by side
        meet every pair of the two."""
        top = [((F.modulus - 1) >> (12 * i)) & 0xFFF for i in range(32)]
        x = torch.tensor(top, dtype=torch.int32, device=dev).expand(
            shape).contiguous()
        x[(torch.arange(shape[0], device=dev) // run) % 2 == 1] = 0
        return x

    def raw_fp(vals):
        """The stored limbs of the values themselves, not their
        Montgomery forms (raw p - 1 is the largest stored value)."""
        return torch.from_numpy(np.stack([int_to_limbs(v) for v in vals])
                                .astype(np.int32)).to(dev)

    def conj_edge_rows(shape):
        """Flat rows for K15's limb-level negation: in the first rows
        every slot cycles through 0, 1, 2, p-1 (raw and Montgomery) and
        the coefficients whose chunks above a borrowing chunk equal p's
        (the borrow crosses up to six lanes); then a zero row and an
        all-(p-1) row; the rest random."""
        c = [(P >> (48 * j)) & ((1 << 48) - 1) for j in range(8)]

        def from_chunks(ch):
            return sum(x << (48 * j) for j, x in enumerate(ch))

        edges = torch.cat([raw_fp([0, 1, 2, P - 1,
                                   from_chunks([c[0] + 1] + c[1:7]
                                               + [c[7] - 1]),
                                   from_chunks([c[0] + 1] + c[1:4]
                                               + [c[4] - 1] + c[5:]),
                                   from_chunks(c[:2] + [c[2] + 5] + c[3:7]
                                               + [c[7] - 1]),
                                   from_chunks([c[0] - 7] + c[1:]),
                                   from_chunks([0] * 7 + [c[7] - 1])]),
                           torch.from_numpy(FP.encode([1, 2, P - 1])).to(dev)])
        a = field_rows(FP, shape)
        E, rows = len(edges), shape[0]
        for r in range(min(rows, E)):
            a[r] = edges[(torch.arange(12, device=dev) + r) % E]
        if rows > E + 2:
            a[E] = 0
            a[E + 1] = max_flat((12, 32))
        return a

    def fp2_edge_rows(shape):
        """[n, 2, rows, 32] stacks whose item 0 holds every pair of 0, 1,
        p-1 (Montgomery and raw) as (x0, x1), then x1 = 0 and x0 = x1."""
        x = field_rows(FP, shape)
        edge = torch.cat([torch.from_numpy(FP.encode([0, 1, P - 1])).to(dev),
                          raw_fp([1, P - 1])])
        e = min(shape[2], 25)
        idx = torch.arange(e, device=dev)
        x[0, 0, :e], x[0, 1, :e] = edge[idx // 5], edge[idx % 5]
        if shape[2] > 33:
            x[0, 1, 25:29] = 0
            x[0, 1, 29:33] = x[0, 0, 29:33]
        return x

    def inputs(name, call, kind="random"):
        """Kernel arguments for `call`: random canonical values (with 0, 1,
        m-1 first), all-(p-1) flat rows ("max"), rows of all-(m-1) and of
        zero coefficients ("edge"), each kernel's edge operands ("edges":
        K13's at block edges, K15's and K6's edge values), K19's rows
        with H = 0 among them ("h0") or unitary ones."""
        if name == "flat_sqr":
            return ((edge_rows(FP, call) if kind == "edge"
                     else field_rows(FP, call)),)
        if name == "line_merge":
            shape = call[:-2] + (6, 32)
            if kind == "edge":
                return edge_rows(FP, shape), edge_rows(FP, shape, 2)
            return field_rows(FP, shape), field_rows(FP, shape)
        if name == "g2_add_line" and kind == "h0":
            # rows in turn: T = Q and T = -Q in affine form (Z = 1, so
            # H = 0), Z = 1, Z = 0, random
            x = field_rows(FP, call)
            for at, sign in ((0, 1), (1, -1)):
                y = x[..., at::5, :, :]
                y[..., 0:2, :] = y[..., 6:8, :]
                y[..., 2:4, :] = (y[..., 8:10, :] if sign > 0
                                  else FP.neg(y[..., 8:10, :]))
            for at in (0, 1, 2):
                x[..., at::5, 4, :] = FP.one_mont.to(dev)
                x[..., at::5, 5, :] = 0
            x[..., 3::5, 4:6, :] = 0
            return (x,)
        if name in ("g2_dbl_line", "g2_add_line"):
            x = field_rows(FP, call)
            x[..., :8, 4, :] = FP.one_mont.to(dev)      # Z = 1, as at start
            x[..., :8, 5, :] = 0
            x[..., 8:16, 4:6, :] = 0                    # Z = 0: infinity
            return (x,)
        if name in ("add", "sub"):
            F, shape = fields[call[0]], call[1]
            if kind == "edge":
                return edge_rows(F, shape), edge_rows(F, shape, 2)
            return field_rows(F, shape), field_rows(F, shape).flip(0)
        if name == "fp2_sqr_chain_mul":
            shape, _k, with_t = call
            x = field_rows(FP, shape)
            return (x, field_rows(FP, shape).flip(1).contiguous()
                    if with_t else None)
        if name == "fp2_sqr5_mul":
            return field_rows(FP, call), field_rows(FP, call)
        if name == "g2_point_dbl":
            p = field_rows(FP, call[0])
            p[4:, 5:9] = 0                          # infinite rows
            return (p,)
        if name == "g2_point_add":
            return g2_pair(call[0])
        if name in ("miller_dbl_iter", "miller_add_iter"):
            return miller_state(call, name == "miller_add_iter")
        if name == "flat_conj":
            return ((conj_edge_rows(call) if kind == "edges"
                     else field_rows(FP, call)),)
        if name == "flat_frob":
            a = field_rows(FP, call[0])
            if kind == "edge":
                a[1::3] = 0
                a[2::3] = max_flat(a[2::3].shape)
            return (a,)
        if name in ("fp2_products", "fp2_sqrs"):
            shape, n = call
            x = (fp2_edge_rows((n, 2) + shape) if kind == "edges"
                 else field_rows(FP, (n, 2) + shape))
            return (x,) if name == "fp2_sqrs" else (
                x, field_rows(FP, (n, 2) + shape).flip(2).contiguous())
        if name == "flat_mul":
            shape, b_idx = call
            bshape = shape[:-2] + (len(b_idx), 32)
            if kind == "max":
                return max_flat(shape), max_flat(bshape)
            a, b = field_rows(FP, shape), field_rows(FP, bshape)
            if kind == "edges":
                flat_edges(a, b)
            return a, b
        if name == "cyclo_sqr":
            return (unitary_rows(call[0]) if kind == "unitary"
                    else field_rows(FP, call[0]),)
        F, shape = fields[call[0]], call[1]
        if name == "mont_reduce":
            return (wide_rows(F, shape),)
        if name == "mont_mul" and kind == "wide":
            # a first operand of any 384 bits against R^2 and R^3, as
            # Field.reduce_wide multiplies the halves of a wide value
            a = torch.from_numpy(rng.integers(0, 4096, size=shape,
                                              dtype=np.int32)).to(dev)
            a[:64] = 4095
            b = torch.stack([F.R2, F.R3]).to(dev).repeat(
                math.prod(shape[:-1]) // 2, 1).reshape(shape)
            return a, b.contiguous()
        if name == "sqr_chain_mul" and call[2] == "pow":
            return (field_rows(F, shape),)
        return (field_rows(F, shape), field_rows(F, shape))

    def steps(name, x):
        """The plain step formula on rows x [..., 8 or 12, 32], its two
        outputs stacked as the kernel gives them."""
        c = [x[..., i, :] for i in range(x.shape[-2])]
        Tj = ((c[0], c[1]), (c[2], c[3]), (c[4], c[5]))
        if name == "g2_dbl_line":
            Tn, L = PR._dbl_step_plain(Tj, c[6], c[7])
        else:
            Tn, L = PR._add_step_plain(Tj, ((c[6], c[7]), (c[8], c[9])),
                                       c[10], c[11])
        return [torch.stack([v for xy in o for v in xy], -2) for o in (Tn, L)]

    def run(name, call, args, kernel: bool):
        """The kernel's or the plain version's output for `call`; the
        Miller iterations' and line steps' two outputs as one flat
        tensor."""
        if name == "flat_sqr":
            return (K.flat_sqr(args[0], FP) if kernel
                    else FL._flat_sqr_plain(args[0]))
        if name == "line_merge":
            return (K.line_merge(*args, FP) if kernel
                    else FL._line_merge_plain(*args))
        if name in ("g2_dbl_line", "g2_add_line"):
            out = (getattr(K, name)(args[0], FP) if kernel
                   else steps(name, args[0]))
            return torch.cat([o.reshape(-1) for o in out])
        if name in ("add", "sub"):
            F = fields[call[0]]
            return (getattr(K, name)(*args, F) if kernel
                    else getattr(F, name)(*args))
        if name == "fp2_sqr_chain_mul":
            return (K.fp2_sqr_chain_mul(args[0], call[1], args[1], FP)
                    if kernel else
                    TW._fp2_sqr_chain_mul_plain(args[0], call[1], args[1]))
        if name == "fp2_sqr5_mul":
            return (K.fp2_sqr5_mul(*args, FP) if kernel
                    else TW._fp2_sqr_chain_mul_plain(args[0], 5, args[1]))
        if name == "g2_point_dbl":
            return (K.g2_point_dbl(args[0], FP, call[1]) if kernel
                    else DC._g2_point_dbl_plain(args[0], call[1]))
        if name == "g2_point_add":
            return (K.g2_point_add(*args, call[1], FP) if kernel
                    else DC.g2_pack(DC._point_add_formula(
                        DC.g2_unpack(args[0]), DC.g2_unpack(args[1]),
                        DC.Fp2PlainOps, call[1])))
        if name in ("miller_dbl_iter", "miller_add_iter"):
            if kernel:
                out = getattr(K, name)(*args, FP)
            else:
                out = getattr(PR, f"_{name}_plain")(*args)
            return torch.cat([o.reshape(-1) for o in out])
        if name == "flat_conj":
            return (K.flat_conj(args[0], FP) if kernel
                    else FL._flat_conj_plain(args[0]))
        if name == "flat_frob":
            return (K.flat_frob(args[0], call[1], FL._FROB_WORDS[call[1]], FP)
                    if kernel else FL._flat_frob_plain(args[0], call[1]))
        if name == "fp2_products":
            return (K.fp2_products(*args, FP) if kernel
                    else TW._fp2_stack(TW._fp2_products_plain(list(zip(
                        TW._fp2_unstack(args[0]), TW._fp2_unstack(args[1]))))))
        if name == "fp2_sqrs":
            return (K.fp2_sqrs(args[0], FP) if kernel
                    else TW._fp2_stack(TW._fp2_sqrs_plain(
                        TW._fp2_unstack(args[0]))))
        if name == "flat_mul":
            return (K.flat_mul(*args, call[1], FP) if kernel
                    else FL._flat_mul_plain(*args, call[1]))
        if name == "cyclo_sqr":
            return (K.cyclo_sqr(args[0], FP, call[1]) if kernel
                    else FL._flat_cyclo_sqr_plain(args[0], call[1]))
        F = fields[call[0]]
        if name == "mont_mul":
            return (K.mont_mul(*args, F) if kernel
                    else F._mont_mul_plain(*args))
        if name == "mont_sqr":
            return (K.mont_sqr(args[0], F) if kernel
                    else F._mont_sqr_plain(args[0]))
        if name == "mont_reduce":
            return (K.mont_reduce(args[0], F) if kernel
                    else F._mont_reduce_plain(args[0]))
        if call[2] == "pow":                      # a whole addition chain
            plan = FLD.addchain_plan(call[3])
            chain = F._pow_addchain if kernel else F._pow_addchain_plain
            return chain(args[0], plan[0], plan[1], plan[4])
        k, t = call[2], args[1] if call[3] else None
        return (K.sqr_chain_mul(args[0], k, t, F) if kernel
                else F._sqr_chain_mul_plain(args[0], k, t))

    flat32, flat64 = (BATCH, 32), (BATCH, 64)
    flat12 = (BATCH, 12, 32)
    cases = {name: {(call, "random") for call in calls}
             for name, calls in all_calls.items()}
    for f in fields:
        cases["mont_mul"].add(((f, flat32), "random"))
        cases["mont_mul"].add(((f, (100, 32)), "random"))
        cases["mont_mul"].add(((f, flat32), "wide"))
        cases["mont_sqr"].add(((f, flat32), "random"))
        cases["mont_reduce"].add(((f, flat64), "random"))
        for k in (1, 4, 5, 9, 13, 63):
            for with_t in (False, True):
                cases["sqr_chain_mul"].add(((f, flat32, k, with_t), "random"))
    cases["sqr_chain_mul"].add((("fr", flat32, "pow", FR.modulus - 2),
                                "random"))
    for e in ((P + 1) // 4, (P - 3) // 4):   # decompression, the G1 map
        cases["sqr_chain_mul"].add((("fp", flat32, "pow", e), "random"))
    # the stacks the composite Fp2 and flat Fp12 products gave K3
    for stack in ((2, BATCH, 64), (16, 2, BATCH, 64)):
        cases["mont_reduce"].add((("fp", stack), "random"))
    cases["fp2_products"].add((((BATCH, 32), 9), "random"))
    for n in range(1, 6):
        for rows_ in (BATCH, 100):
            cases["fp2_products"].add((((rows_, 32), n), "random"))
    cases["fp2_sqrs"].add((((BATCH, 32), 9), "random"))
    for n in (1, 4, 8):
        for rows_ in (BATCH, 33, 1):
            cases["fp2_sqrs"].add((((rows_, 32), n), "edges"))
    for b_idx in (tuple(range(12)), LINE_IDX):
        cases["flat_mul"].add(((flat12, b_idx), "max"))
        for rows_ in (BATCH, 100, 8):
            cases["flat_mul"].add((((rows_, 12, 32), b_idx), "edges"))
    for b_idx in ((1, 4, 11), (11,), (0, 5, 6, 11)):     # other layouts
        cases["flat_mul"].add((((100, 12, 32), b_idx), "edges"))
    for k in (1, 32):
        cases["cyclo_sqr"].add(((flat12, k), "random"))
        cases["cyclo_sqr"].add(((flat12, k), "unitary"))
    cases["cyclo_sqr"].add((((100, 12, 32), 3), "random"))
    fp2_rows = (2, BATCH, 32)
    for k in (1, 5, 13, 63):
        for with_t in (False, True):
            cases["fp2_sqr_chain_mul"].add(((fp2_rows, k, with_t), "random"))
    for _shape, k, with_t in path_calls["fp2_sqr_chain_mul"]:
        cases["fp2_sqr_chain_mul"].add((((2, 100, 32), k, with_t), "random"))
    cases["fp2_sqr5_mul"].add((fp2_rows, "random"))
    for shape, n in (((6, BATCH, 32), 1), ((6, 100, 32), 1),
                     ((6, 100, 32), 9)):
        cases["g2_point_dbl"].add(((shape, n), "random"))
    for rows_ in (BATCH, 100, 64, 8):
        for with_double in (False, True):
            cases["g2_point_add"].add((((6, rows_, 32), with_double),
                                       "random"))
    for shape in (flat12, (100, 12, 32)):
        cases["miller_dbl_iter"].add((shape, "random"))
        cases["miller_add_iter"].add((shape, "random"))
    cases["flat_conj"].add((flat12, "random"))
    for rows_ in (BATCH, 33, 1):
        cases["flat_conj"].add(((rows_, 12, 32), "edges"))
    for n in (1, 2, 3):
        cases["flat_frob"].add(((flat12, n), "random"))
        for rows_ in (BATCH, 33, 1):
            cases["flat_frob"].add((((rows_, 12, 32), n), "edge"))
    for kind in ("random", "edge"):
        cases["flat_sqr"].add((flat12, kind))
        for rows_ in (1, 31, 33):
            cases["flat_sqr"].add((((rows_, 12, 32)), kind))
        cases["line_merge"].add((flat12, kind))
        for f in fields:
            cases["add"].add(((f, flat32), kind))
            cases["sub"].add(((f, flat32), kind))
    cases["g2_dbl_line"].add(((3, BATCH, 8, 32), "random"))
    for shape in ((3, 33, 8, 32), (1, 31, 8, 32), (1, 1, 8, 32)):
        cases["g2_dbl_line"].add((shape, "random"))
    cases["g2_add_line"].add(((3, BATCH, 12, 32), "random"))
    for shape in ((3, BATCH, 12, 32), (3, 33, 12, 32), (1, 31, 12, 32),
                  (1, 1, 12, 32)):
        cases["g2_add_line"].add((shape, "h0"))

    rows = []
    for name in K.KERNELS:
        for call, kind in sorted(cases[name], key=repr):
            args = inputs(name, call, kind)
            got = run(name, call, args, True)
            want = run(name, call, args, False)
            eq = bool(torch.equal(got, want))
            err = int((got.long() - want.long()).abs().max().item())
            rows.append({"kernel": name, "call": call, "inputs": kind,
                         "on_path": call in all_calls[name],
                         "bit_equal": eq, "max_abs_err": err})
            if not eq:
                fail(f"{name} {call} {kind}: kernel != plain "
                     f"(max err {err})")
            del args, got, want
        torch.cuda.synchronize()

    # times: K1, K2 and the window step (K4, k = 4, the sqr4_mul call) at
    # [16384, 32], K3 at the [2, 16384, 64] stack of one Fp2 product and
    # at [16, 2, 16384, 64], K4 at the path's call (a whole inversion),
    # at the window step and at the single steps k = 13 and 63;
    # K9 and K14 at the path's longest chain, then at each of their
    # other chains; the others at the path's most common call, and K13
    # also at its most common dense call, K7 also at the path's longest
    # chain and at k = 63, K10 also at its other form (the doubling)
    main_path_calls = {name: trio_calls[name] if name in TRIO
                       else path_calls[name] for name in K.KERNELS}

    def most_common(name, pick=lambda c: True):
        calls = {c: n for c, n in main_path_calls[name].items() if pick(c)}
        return max(sorted(calls, key=repr), key=calls.get)

    main_calls = {"mont_mul": ("fp", flat32), "mont_sqr": ("fp", flat32),
                  "mont_reduce": ("fp", (2, BATCH, 64))}
    main_calls["fp2_sqr5_mul"] = fp2_rows
    main_calls["line_merge"] = flat12
    main_calls["add"] = main_calls["sub"] = ("fp", flat32)
    chains = {name: sorted(path_calls[name], key=lambda c: (-c[1], repr(c)))
              for name in ("g2_point_dbl", "cyclo_sqr")}
    for name, calls in chains.items():
        main_calls[name] = calls[0]
    main_calls.update({name: most_common(name) for name in K.KERNELS
                       if name not in main_calls})
    longest_fp2 = max(path_calls["fp2_sqr_chain_mul"],
                      key=lambda c: (c[1], c[2]))
    other_add = [c for c in path_calls["g2_point_add"]
                 if c != main_calls["g2_point_add"]]
    timed = [(name, call) for name, call in main_calls.items()] + [
        ("mont_reduce", ("fp", (16, 2, BATCH, 64))),
        ("sqr_chain_mul", ("fp", flat32, 4, True)),
        ("sqr_chain_mul", ("fp", flat32, 13, True)),
        ("fp2_sqr_chain_mul", longest_fp2),
        ("fp2_sqr_chain_mul", (fp2_rows, 63, True)),
        ("sqr_chain_mul", ("fp", flat32, 63, True)),
        ("flat_mul", most_common("flat_mul", lambda c: len(c[1]) == 12)),
        ("flat_mul", max(sorted(trio_calls["flat_mul"], key=repr),
                         key=trio_calls["flat_mul"].get))
    ] + [("g2_point_add", c) for c in other_add] + [
        (name, call) for name, calls in chains.items() for call in calls[1:]]
    timings, per_kernel = [], {}
    for name, call in timed:
        args = inputs(name, call)
        bms, by = bound_ms(*work(name, call))
        # every call of a kernel's wrapper launches its kernel once
        ms, timer = device_ms(lambda: run(name, call, args, True), 50, 50)
        plain_ms, plain_timer = device_ms(
            lambda: run(name, call, args, False), 3)
        tm = {"kernel": name, "call": call,
              "launches": main_path_calls[name].get(call, 0),
              "trio_launches": trio_calls[name].get(call, 0),
              "ms": ms, "plain_ms": plain_ms, "timers": [timer, plain_timer],
              "bound_ms": bms, "bound_by": by}
        timings.append(tm)
        per_kernel.setdefault(name, tm)
        del args
    report["parity"] = {"phase": "parity", "checks": len(rows),
                        "on_path": sum(r["on_path"] for r in rows),
                        "all_bit_equal": all(r["bit_equal"] for r in rows),
                        "timings": timings}
    emit(report["parity"])

    # each kernel's device ms in one batch of its path (the trio batch for
    # the trio kernels, the default one for the others), its bound summed
    # over the calls that batch made, and the difference, its loss; null
    # where no profiled session saw every launch of the kernel
    path_ms = collections.Counter()
    complete = batch_complete | trio_complete
    for kern_list, on_path in ((batch_kernels, lambda n: n not in TRIO),
                               (trio_kernels, lambda n: n in TRIO)):
        for dev_name, d in kern_list:
            name = kernel_of(dev_name)
            if name is not None and on_path(name):
                path_ms[name] += d * 1e3
    bound_batch = {name: sum(n * bound_ms(*work(name, call))[0]
                             for call, n in main_path_calls[name].items())
                   for name in K.KERNELS}
    ptxas = KB.ptxas_stats(info["log"] or open(os.path.join(
        info["dir"], "nvcc.log")).read())
    sass = KB._sass_sizes(os.path.join(info["dir"], K.LIB_NAME)) or {}
    code = {name: {**{k: report["occupancy"][name][k]
                      for k in ("num_regs", "local_bytes", "blocks_per_sm")},
                   **{k: ptxas.get(dev_name, {}).get(k)
                      for k in ("stack_bytes", "spill_stores")},
                   "sass_instructions": sass.get(dev_name)}
            for name, dev_name in CODE_STATS.items()}
    kernels = []
    for name, kern in K.KERNELS.items():
        tm = per_kernel[name]
        path = path_ms[name] if name in complete else None
        kernels.append({
            "name": name, "route": "cuda", "source": kern.source,
            "replaces": kern.replaces,
            "launches": (trio_launches if name in TRIO else launches)[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows
                               if r["kernel"] == name),
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": None, "path_ms": path,
            "bound_ms_batch": bound_batch[name],
            "loss_ms": None if path is None else path - bound_batch[name],
            **({"code": code[name]} if name in code else {})})
    report["kernels"] = kernels
    report["parity_rows"] = rows
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
