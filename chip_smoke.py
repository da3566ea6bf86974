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
          structural lists (its wall recorded), then startup_recovery
          gives bad_sigs [40000], corrupt [50000], missing [[60000,
          60000]], verified_tip 39999,
          the repair leaves the tip at 39999 and a rescan is clean; the
          chained fixture's store (round 1 on the genesis anchor, round
          30's signature flipped, round 50's link broken): bad_sigs [30],
          unlinked [31, 50], every other verdict the slice phase's, every
          segment (at most 32 rounds) on the native host tier: one
          "native" dispatch record a round and no port kernel launched
          during that scan; a
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
          true through the Verifier, recover of one round equal (the
          native combination: no port kernel launched), its device step
          on the round's t rows unpadded
          (DeviceBackend._recover_device: K9/K10 on the tree sum's 1-4
          rows) and recover_rounds of that one round equal, a round
          of t - 1 partials raising ValueError; each call's launches,
          walls and issue times, partials and recoveries per second, the
          device kernels and busy time of one more rounds verify and
          recover_rounds, and the dispatch records
  native  the port's native C++ host tier (drand_tpu_torch/native, built
          with g++ into build/native/ beside the kernels' nvcc): its
          flags, hash, whether it was cached and its seconds;
          ChainVerifier.verify_beacon over the chained fixture's rounds
          1-65 (round 30's signature flipped, round 31 linking to it) and
          the G1 fixture's first 32 rounds (round 21 flipped), each
          verdict equal to the card's on the same beacons and no port
          kernel launched; the card's chained verdicts through
          ChainVerifier.verify_packed_segment_async anchored on the
          genesis seed (two "verify" records: round 1 in a bucket of 8,
          rounds 2-65 in one of 64); a 32-row
          verify_beacons on the host (32 "native" records, no card
          batch) against a 33-row one on the card (one "verify" record);
          HostBackend.verify_partials on the partials phase's 16-partial
          burst and on the four rounds holding its negative rows, equal
          to DeviceBackend's verdicts; the median and p99 of one
          verify_beacon, G2 and G1, over 256 calls each, and the
          16-partial burst's wall through AsyncPartialVerifier on
          HostBackend; the host CPU as lscpu names it (model name,
          vendor, architecture, CPUs)
  catchup verify-then-commit catch-up through the port's objectsync tier
          (drand_tpu_torch.objectsync): the recovery phase's 65,536-round
          unchained store published by ObjectPublisher into a directory
          under build/ (four sealed segments of 16384), synced in-process
          into an empty store anchored on the genesis seed through
          SchemeStore(AppendStore(SqliteStore)): ok, synced_to 65536, four
          "verify" records of n = bucket = 16384, each segment launching
          exactly what the slice phase's batch launched, the rows equal
          to the source's byte for byte; `python -m drand_tpu_torch.cli
          objectsync sync` on the same directory into a second store:
          exit 0, the same result and rows; up_to 40000 stopping at
          40000; the third segment re-written with round 40000's
          signature flipped, re-hashed and re-named in the manifest: ok
          false, synced_to 32768, the error naming that segment, the
          store holding exactly rounds 0-32768; the second segment's
          bytes altered without re-hashing: a CorruptObjectError, the
          store holding rounds 0-16384; walls, rounds per second and the
          client's fetch, verify and commit seconds
  follow  catch-up from a peer over gRPC on 127.0.0.1 (the port's
          PrivateGateway serving a ServingProcess over the full store
          stack; drand_tpu_torch.core.follow.follow_chain, its SyncManager
          and GrpcBeaconNetwork): peer A serves the recovery phase's
          65,536-round store (period 30 s, genesis 65,538 periods back);
          follow_chain into an empty folder up to 65536: rows equal to
          A's, each card segment (the pack stage's issue, counted where it
          happens) launching exactly what one unchained batch at its
          bucket launches; `python -m drand_tpu_torch.cli sync --follow`
          into a second folder in a fresh process: exit 0, ok, synced_to
          65536, rows equal; peer B, a copy with round 40000's signature
          flipped: given [B, A] (B tried first) the follower renews
          against A and ends at 65536 with A's rows, given [B] alone it
          stops at the verified prefix below 40000 with "follow stalled";
          round 6000 flipped in the first follower's store:
          check_past_beacons over rounds 1-8192 reports exactly [6000]
          and
          correct_past_beacons from A repairs it, the rows equal A's
          again; the chained fixture from a peer C: one card segment
          (round 1 on the genesis anchor in a bucket of 8, rounds 2-65 in
          one of 64) launching what the slice phase's chained segment
          launched, all true, rows equal; C with round 30 flipped: the
          segment's card verdicts equal verify_beacon's on the host
          (false at 30 and 31), nothing stored, "follow stalled"; walls,
          rounds per second, the manager's stage seconds, each segment's
          start, rounds and bucket, the card records and the peers
          opened in order
  beacon  the port's beacon engine (drand_tpu_torch.beacon.node Handler,
          beacon.chain ChainStore, core.daemon DrandDaemon) on a group of
          n = 16, t = 9, pedersen-bls-chained, period 3 s, catch-up period
          1 s, the secret polynomial and each node's key pair from fixed
          seeds, key pair, group and share written through key.store
          FileStore; (a) clockwork: 16 DrandDaemons in this process, each
          with its gateway on 127.0.0.1, node 0 checking partials on the
          card (DeviceBackend), nodes 1-15 on the host tier, one
          FakeClock: genesis, then rounds 1-6, each advance of one period
          waited for until all 16 stores hold the round (60 s a round);
          signer 5's round-4 partial with one byte flipped sent to node
          0's PartialBeacon before that advance: the 16 stores byte-equal,
          each round the dealt secret's signature, the ChainVerifier
          accepting the chain, PublicRand of node 0 giving round 6 and its
          PublicRandStream rounds 1-6 in order, node 0's verdict on the
          flipped partial false, each of node 0's verify_partials calls
          giving HostBackend's verdicts, and its first call launching
          exactly what the partials phase's 16-partial burst launched;
          each call's size, rounds and wall, and each round's wall from
          the advance until every store holds it; (b) live: run by the
          dkg phase on the ceremony's group (below); and, after the
          parity phase, the number of parity checks at the clockwork
          run's calls
  dkg     the fresh Pedersen DKG (drand_tpu_torch.crypto.dkg, core/
          dkg_runner.py): (a) ops.bls.dkg_commit_checks on the card at
          drand_tpu's stated shape, 128 polynomials of degree 64 from
          fixed seeds committed by the golden g1_mul_gen, in the deal
          shape (128 rows, one index; the first call) and the
          justification shape (each row its own index; the second), row
          17 with a
          valid but swapped commitment and row 93 with a wrong expected
          point: every verdict equal to the golden PubPoly.eval
          comparison, exactly those two rows false; each call's wall and
          launches of K1, K2 and K4 (and those read from the code), and
          the deal-shape call's device kernels (it runs under
          torch.profiler); (b) a ceremony of n = 16,
          t = 9 in this process with dealer 4 sealing a wrong share to
          nodes 8-15: all 16 nodes on the host path, nodes 0 and 8 again
          on the card with the same bundles (one batched deal check of 16
          rows each, dealer 4's justification of 8 rows batched in qual()
          and in finalize()), their verdicts, complaints, QUAL and shares
          equal to the host run's, dealer 4 in QUAL; (c) 16 nodes through
          the CLI alone on the wall clock, every one on the card: `python
          -m drand_tpu_torch.cli generate-keypair`, `start --control`,
          then `share --leader --nodes 16 --threshold 9` and 15 `share
          --connect` (period 10 s, --timeout 15): every share exits 0
          with the same group TOML, the 16 group files and distributed
          keys byte-equal, t shares giving the group key's secret, every
          node's deal and response phases complete with QUAL all 16 and
          at least one card deal check of 16 rows (its {"dkg": ...} and
          {"dispatch": ...} lines at stop); then the beacon phase's live
          part on that group: PublicRandStream of nodes 0 and 1 watched
          until node 1 holds round 4, every node's tip polled to round
          4, SIGTERM to every node: each exits 0, the 16 stores
          byte-equal in rounds 0-4 and verifying against the DKG's group
          key, node 0 made a card call in rounds 2-4 and no node's card
          call raised; each round's lateness on both streams and node 0's
          card calls (count, sizes, walls, starts) recorded, not
          asserted; the ceremony's phase times, share walls and genesis
          wait; and, after the parity phase, the parity checks at (a)'s
          and (b)'s calls

Each run of the slice, trio, g1, recovery, partials, native, catchup,
follow, beacon (clockwork) and dkg phases must launch every kernel of its
path
and no other, and never call
the plain limb convolution `_poly_mul_var`: the default batch all but the
trio kernels (flat_sqr,
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
fp2_products, fp2_sqrs, fp2_sqr_chain_mul, g2_point_dbl and g2_point_add;
a catch-up sync, a follow and the beacon clockwork the default batch's
kernels; a DKG commitment check mont_mul, mont_sqr and sqr_chain_mul;
and whatever
the host tier answers (the chained store's scan, recover of one round,
every verify_beacon and HostBackend call of the native phase) no kernel.

  parity  every kernel against its plain PyTorch version on the card, bit
          for bit, at every call the batches above made, the G1,
          recovery, partials, native, catchup, follow, beacon and dkg ones
          included
          (g2_point_dbl
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
import statistics
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
_T0 = time.perf_counter()       # the script's start, for progress on stderr
BATCH = 16384
FIXTURE = os.path.join(HERE, "aot", "fixtures",
                       "bench_sigs_unchained_16384_d6a762f2_ff8a2cc7.npy")
# rounds 16385-65536 of the same chain and key ([49152, 96])
SYNC_FIXTURE = os.path.join(HERE, "aot", "fixtures",
                            "bench_sync_sigs_65536_d6a762f2_ff8a2cc7.npy")
STORE_ROUNDS = 4 * BATCH
# the catchup phase's --up-to, inside the third segment; its poisoned
# third segment flips this round's signature
CATCHUP_UP_TO = 40000
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
    print(f"chip_smoke: {time.perf_counter() - _T0:.1f} s: "
          f"{obj.get('phase', '')} {obj.get('part', '')}".rstrip(),
          file=sys.stderr, flush=True)


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


DEVICE_KERNELS_NOTE = (
    "device kernel totals are lower bounds: a profiler session may lose "
    "events of torch's own kernels, whose number the script does not "
    "know; the port kernels' launches are counted exactly and checked")


def profile_kernels(fn, want: dict, tries: int = 4):
    """(kernels, complete): (name, seconds) of every device kernel that
    fn() launches (torch.profiler), and the set of the port's kernels
    whose every launch the session saw, `want` holding the launches fn()
    makes of each.  A session now and then loses events, so one is taken
    again while any port kernel falls short, up to `tries`; the session
    with the most complete kernels, then the most events, counts.  The
    number of torch's own kernels is known to nothing here, so a session
    that lost some of them stands: a total of device kernels is a lower
    bound (DEVICE_KERNELS_NOTE), the port kernels' counts are exact."""
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
        return report, summary, secs, segs, DSP.DISPATCH.records()

    def rows_of(recs):
        """[n, bucket] of each card batch among the records."""
        return [[r.n, r.bucket] for r in recs if r.seam == "verify"]

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
                    "dispatch": [r.to_dict() for r in recs
                                 if r.seam == "verify"]}

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
    t0 = time.perf_counter()
    fsck = subprocess.run(
        [sys.executable, "-m", "drand_tpu_torch.cli", "util", "fsck", copy,
         "--json"], cwd=HERE, capture_output=True, text=True, timeout=300)
    fsck_s = time.perf_counter() - t0
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
                      "fsck_exit": fsck.returncode, "fsck_wall_s": fsck_s,
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
    # every segment of this scan has at most 32 rounds: the host tier
    # verifies it (one native record a round) and no port kernel launches
    rep, _, secs, segs, recs = scan("recovery chained store", cstore, cv_c,
                                    [])
    # every round the scan verified other than round 30 is true in the
    # slice phase's verdicts on this fixture; round 30's flipped signature
    # is false through the slice phase's Verifier
    checked = [r for r in range(1, 66) if r not in (31, 50)]
    flip_ok = chained.verify_chain_segment(
        30, np.frombuffer(bytes(flipped), np.uint8)[None], sigs_c[28])
    native = [r for r in recs if r.seam == "native"]
    if (rep.bad_sigs, rep.unlinked, rep.corrupt, rep.missing,
            rep.verified_tip) != ([30], [31, 50], [], [], 29) or \
            not all(ok_c[r - 1] for r in checked) or flip_ok.tolist() != \
            [False] or segs[0][:2] != (1, 30) or rows_of(recs) or \
            len(native) != sum(s[1] for s in segs) or len(native) != 63:
        fail(f"chained store: {rep.to_dict()}, segments "
             f"{[s[:2] for s in segs]}, card records {rows_of(recs)}, "
             f"{len(native)} native records")
    out["chained"] = {"report": {k: v for k, v in rep.to_dict().items()
                                 if k != "path"},
                      "wall_s": secs, "segments": [s[:2] for s in segs],
                      "native_records": len(native),
                      "native_s": sum(r.device_s for r in native),
                      "verdicts_equal_slice": True, "card_records": [],
                      "kernels_launched": 0}
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
                 "dispatch": [r.to_dict() for r in recs
                              if r.seam == "verify"]}
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
    # one round: recover takes the native combination (no port kernel);
    # its device step on the round's t rows, unpadded (K9/K10 on the tree
    # sum's 1-4 rows), and recover_rounds of that one round (padded to 8
    # rounds) stay on the card
    parts5 = by_round[5][7:] + by_round[5][:7]
    one, recover_one_s, _ = run("recover", lambda: be.recover(msgs[5], parts5),
                                [])
    one_dev, recover_dev_s, _ = run(
        "recover device", lambda: be._recover_device(parts5), G2_CURVE)
    one_rounds, recover_r1_s, _ = run(
        "recover_rounds one", lambda: be.recover_rounds([msgs[5]], [parts5]),
        G2_CURVE)
    if not one == one_dev == want[5] or one_rounds != [want[5]]:
        fail("recover: round 6 differs from the secret's signature (native "
             f"{one == want[5]}, device {one_dev == want[5]}, recover_rounds "
             f"{one_rounds == [want[5]]})")
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
        "recover_native": True,
        "recover_device_wall_s": recover_dev_s,
        "recover_rounds_one_wall_s": recover_r1_s,
        "partials_per_s": R * n / rounds_next_s,
        "recoveries_per_s": R / recover_next_s,
        "rounds_verify_device_kernels": rounds_dev,
        "device_kernels_note": DEVICE_KERNELS_NOTE,
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
    # what the native phase holds HostBackend against
    ctx = {"pub": pub, "msgs": msgs, "by_round": by_round, "bad": bad,
           "negatives": negatives, "burst": oks, "burst_s": burst_s,
           "bad_verdicts": ok_bad}
    return out, all_calls, ctx


def cpu_model() -> dict:
    """The host CPU as lscpu names it: its model name, vendor,
    architecture and logical CPUs ({} where lscpu cannot run)."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True,
                             timeout=60).stdout
    except (OSError, subprocess.TimeoutExpired):
        return {}
    fields = dict(line.split(":", 1) for line in out.splitlines()
                  if ":" in line)
    return {k: fields[k].strip() for k in ("Model name", "Vendor ID",
                                           "Architecture", "CPU(s)")
            if k in fields}


def host_run(what, fn):
    """fn() driven once on the host tier: (its result, seconds, the count
    of each dispatch seam); fails if any port kernel launched."""
    from drand_tpu_torch import dispatch as DSP
    DSP.DISPATCH.clear()
    res, secs, counts, _, n_conv = drive(fn)
    check_path(what, counts, n_conv, [])
    return res, secs, collections.Counter(r.seam
                                          for r in DSP.DISPATCH.records())


def percentiles(times):
    t = sorted(times)
    return {"calls": len(t), "median_ms": statistics.median(t) * 1e3,
            "p99_ms": t[min(len(t) - 1, math.ceil(0.99 * len(t)) - 1)] * 1e3,
            "min_ms": t[0] * 1e3, "max_ms": t[-1] * 1e3}


def native_phase(build, default_path, sigs, sigs_c, pk_bytes, seed, sigs1,
                 pk2, verifier1, pctx):
    """The `native` phase: the port's native C++ host tier
    (drand_tpu_torch/native) under ChainVerifier and HostBackend, held
    against the card's verdicts on the same inputs.  Returns (its report
    line, the calls by kernel of each driven card run)."""
    import asyncio

    import numpy as np

    from drand_tpu_torch import dispatch as DSP
    from drand_tpu_torch import verify as V
    from drand_tpu_torch.beacon.crypto_backend import (AsyncPartialVerifier,
                                                       HostBackend)
    from drand_tpu_torch.chain.beacon import Beacon
    from drand_tpu_torch.chain.scheme import scheme_by_id
    from drand_tpu_torch.chain.segment import PackedBeacons
    from drand_tpu_torch.chain.verify import ChainVerifier
    from drand_tpu_torch.crypto.bls12381 import curve as GC

    out = {"phase": "native", "build": build, "cpu": cpu_model()}
    all_calls = []

    def card_run(what, fn, path):
        res, secs, counts, calls, n_conv = drive(fn)
        check_path(what, counts, n_conv, path)
        all_calls.append(calls)
        return res, secs

    # 1. verify_beacon over the chained fixture's rounds 1-65 (round 30's
    # signature flipped, each prev the preceding stored signature, so
    # round 31 links to the flipped one) and the G1 fixture's first 32
    # rounds (round 21 flipped), against the card's verdicts of the same
    # beacons; the chained ones through ChainVerifier's packed segment,
    # anchored on the genesis seed (round 1 alone in a bucket of its own)
    cv_c = ChainVerifier(scheme_by_id("pedersen-bls-chained"), pk_bytes)
    bad_c = sigs_c.copy()
    bad_c[29, 40] ^= 0x01
    beacons_c = [Beacon(r, bytes(bad_c[r - 1]),
                        seed if r == 1 else bytes(bad_c[r - 2]))
                 for r in range(1, 66)]
    host_c, host_c_s, seams_c = host_run(
        "native chained verify_beacon",
        lambda: [cv_c.verify_beacon(b) for b in beacons_c])
    DSP.DISPATCH.clear()
    card_c, _ = card_run(
        "native chained card segment",
        lambda: cv_c.verify_packed_segment_async(PackedBeacons(1, bad_c),
                                                 seed)(), default_path)
    recs_c = [[r.seam, r.n, r.bucket] for r in DSP.DISPATCH.records()]
    card_c = card_c.tolist()
    if host_c != card_c or host_c.count(False) != 2 or host_c[29] or \
            host_c[30] or seams_c != {"native": 65} or recs_c != \
            [["verify", 1, V.bucket(1)], ["verify", 64, V.bucket(64)]]:
        fail(f"native chained verify_beacon: host {host_c}, card {card_c}, "
             f"records {dict(seams_c)}, card records {recs_c}")
    cv_g = ChainVerifier(scheme_by_id("bls-unchained-g1-rfc9380"),
                         GC.g2_to_bytes(pk2))
    bad1 = sigs1[:32].copy()
    bad1[20, 20] ^= 0x01
    beacons_g = [Beacon(r, bytes(bad1[r - 1])) for r in range(1, 33)]
    host_g, host_g_s, seams_g = host_run(
        "native g1 verify_beacon",
        lambda: [cv_g.verify_beacon(b) for b in beacons_g])
    card_g, _ = card_run("native g1 card batch", lambda: verifier1.
                         verify_batch(np.arange(1, 33, dtype=np.uint64),
                                      bad1), G1_PATH)
    if host_g != card_g.tolist() or host_g.count(False) != 1 or \
            host_g[20] or seams_g != {"native": 32}:
        fail(f"native g1 verify_beacon: host {host_g}, card "
             f"{card_g.tolist()}, records {dict(seams_g)}")

    # 2. 32 rows on the host against 33 on the card
    cv_u = ChainVerifier(scheme_by_id("pedersen-bls-unchained"), pk_bytes)
    rows = [Beacon(r, bytes(sigs[r - 1])) for r in range(1, 34)]
    ok32, host32_s, seams32 = host_run(
        "native 32-row batch", lambda: cv_u.verify_beacons(rows[:32]))
    DSP.DISPATCH.clear()
    ok33, card33_s = card_run("native 33-row batch",
                              lambda: cv_u.verify_beacons(rows),
                              default_path)
    recs33 = [[r.seam, r.n, r.bucket] for r in DSP.DISPATCH.records()]
    if not (ok32.all() and ok33.all()) or seams32 != {"native": 32} or \
            recs33 != [["verify", 33, V.bucket(33)]]:
        fail(f"native 32/33 rows: {int(ok32.sum())}, {int(ok33.sum())} true, "
             f"records {dict(seams32)}, {recs33}")

    # 3. HostBackend on the partials phase's group: a 16-partial burst of
    # round 1 and the four rounds with a negative row, against
    # DeviceBackend's verdicts on the same partials
    hb = HostBackend(pctx["pub"], PARTIALS_T, PARTIALS_N)
    msgs, by_round, bad = pctx["msgs"], pctx["by_round"], pctx["bad"]
    burst_host, _, seams_b = host_run(
        "native HostBackend burst",
        lambda: hb.verify_partials([msgs[0]] * PARTIALS_N, by_round[0]))
    neg_rounds = sorted({r for r, _ in pctx["negatives"].values()})
    neg_host, _, seams_n = host_run(
        "native HostBackend negatives",
        lambda: [hb.verify_partials([msgs[r]] * PARTIALS_N, bad[r])
                 for r in neg_rounds])
    neg_card = [list(pctx["bad_verdicts"][r]) for r in neg_rounds]
    n_partials = PARTIALS_N * (1 + len(neg_rounds))
    if burst_host != list(pctx["burst"]) or neg_host != neg_card or \
            sum(row.count(False) for row in neg_host) != 4 or \
            seams_b["native"] + seams_n["native"] != n_partials - 1:
        fail(f"HostBackend: burst {burst_host}, negatives {neg_host} vs "
             f"card {neg_card}, records {dict(seams_b)} {dict(seams_n)}")

    # 4. latency: one verify_beacon, G2 and G1, over 256 calls each, and
    # the 16-partial burst through AsyncPartialVerifier on HostBackend
    def timed(calls):
        times = []
        for fn in calls:
            t0 = time.perf_counter()
            ok = fn()
            times.append(time.perf_counter() - t0)
            if not ok:
                fail("native latency: a valid beacon verified false")
        return percentiles(times)

    g1_all = sigs1[:256]
    lat_g2 = timed([lambda b=Beacon(r, bytes(sigs[r - 1])):
                    cv_u.verify_beacon(b) for r in range(1, 257)])
    lat_g1 = timed([lambda b=Beacon(r, bytes(g1_all[r - 1])):
                    cv_g.verify_beacon(b) for r in range(1, 257)])

    async def burst():
        ver = AsyncPartialVerifier(hb, max_delay=0.05)
        oks = await asyncio.gather(*[ver.verify(msgs[0], p)
                                     for p in by_round[0]])
        ver.stop()
        return oks

    oks, burst_s, _ = host_run("native HostBackend async burst",
                               lambda: asyncio.run(burst()))
    if oks != [True] * PARTIALS_N:
        fail(f"HostBackend async burst: {oks}")
    out.update({
        "chained_verify_beacon_equal_card": True,
        "chained_flipped_round": 30, "chained_false_rounds": [30, 31],
        "chained_card_records": recs_c, "chained_host_s": host_c_s,
        "g1_verify_beacon_equal_card": True, "g1_flipped_round": 21,
        "g1_host_s": host_g_s, "kernels_launched_on_host": 0,
        "rows32_host_wall_s": host32_s, "rows32_records": dict(seams32),
        "rows33_card_wall_s": card33_s, "rows33_records": recs33,
        "host_backend_equal_device": True,
        "host_backend_negative_rounds": neg_rounds,
        "verify_beacon_g2": lat_g2, "verify_beacon_g1": lat_g1,
        "host_burst_wall_s": burst_s,
        "device_burst_wall_s": pctx["burst_s"]})
    return out, all_calls


def catchup_phase(work_dir, default_path, launches, pk_bytes, seed):
    """The `catchup` phase: verify-then-commit catch-up from published
    segment objects through the port's objectsync tier and CLI, over the
    65,536-round unchained store the recovery phase built in `work_dir`.
    Returns (its report line, the calls by kernel of each driven run)."""
    import asyncio
    import sqlite3

    import torch

    from drand_tpu_torch import dispatch as DSP
    from drand_tpu_torch import objectsync as OS
    from drand_tpu_torch.chain.beacon import Beacon
    from drand_tpu_torch.chain.scheme import scheme_by_id
    from drand_tpu_torch.chain.store import (AppendStore, SchemeStore,
                                             SqliteStore)
    from drand_tpu_torch.chain.verify import ChainVerifier
    from drand_tpu_torch.ops import kernels as K

    out, all_calls = {"phase": "catchup"}, []
    scheme = scheme_by_id("pedersen-bls-unchained")
    chain_hash = hashlib.sha256(b"drand_tpu_torch catchup").digest()
    source = os.path.join(work_dir, "unchained.db")
    objects = os.path.join(work_dir, "objects")

    def table(path):
        con = sqlite3.connect(path)
        try:
            return con.execute("SELECT round, data FROM beacons "
                               "ORDER BY round").fetchall()
        finally:
            con.close()

    # 1. publish the store's sealed segments
    store = SqliteStore(source)
    pub = OS.ObjectPublisher(store, OS.FilesystemBackend(objects),
                             chain_hash=chain_hash, scheme_id=scheme.id,
                             segment_rounds=BATCH)
    t0 = time.perf_counter()
    published = asyncio.run(pub.publish_sealed())
    publish_s = time.perf_counter() - t0
    store.close()
    m = pub.manifest
    if published != 4 or [(e.start, e.count) for e in m.segments] != \
            [(1 + k * BATCH, BATCH) for k in range(4)]:
        fail(f"catchup publish: {published} segments, manifest "
             f"{[(e.start, e.count) for e in m.segments]}")
    want_rows = table(source)

    def fresh(name):
        base = SqliteStore(os.path.join(work_dir, name))
        store = SchemeStore(AppendStore(base), scheme.decouple_prev_sig)
        store.put(Beacon(0, seed))
        return base, store

    def sync(name, root=objects, up_to=0, path=default_path):
        """One in-process sync of a fresh store from `root`, driven once:
        (result, client stats, seconds, each segment's (start, rounds,
        launches), the card records, the table)."""
        base, store = fresh(name)
        cv = ChainVerifier(scheme, pk_bytes)
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
        client = OS.ObjectSyncClient(OS.FilesystemBackend(root), store, cv,
                                     chain_hash=chain_hash)
        DSP.DISPATCH.clear()
        res, secs, counts, calls, n_conv = drive(
            lambda: asyncio.run(client.sync(up_to=up_to)))
        check_path(f"catchup {name}", counts, n_conv, path)
        all_calls.append(calls)
        recs = [[r.n, r.bucket] for r in DSP.DISPATCH.records("verify")]
        base.close()
        return (res.to_dict(), dict(client.stats), secs, segs, recs,
                table(os.path.join(work_dir, name)))

    # 2. the whole chain in-process: four card batches, each what the
    # slice phase's batch launched, the rows equal to the source's
    res, stats, secs, segs, recs, rows = sync("synced.db")
    if res != {"ok": True, "synced_to": STORE_ROUNDS, "segments": 4,
               "rounds": STORE_ROUNDS, "error": ""} or \
            recs != [[BATCH, BATCH]] * 4 or \
            [s[2] for s in segs] != [launches] * 4 or rows != want_rows:
        fail(f"catchup sync: {res}, records {recs}, segments "
             f"{[s[:2] for s in segs]}, rows equal {rows == want_rows}")
    out["sync"] = {"result": res, "wall_s": secs,
                   "rounds_per_s": STORE_ROUNDS / secs, "stats": stats,
                   "dispatch": recs, "rows_equal_source": True,
                   "segment_launches_equal_slice_batch": True}

    # 3. the port's CLI on the same directory, into a second store
    cli_db = os.path.join(work_dir, "cli.db")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "drand_tpu_torch.cli", "objectsync", "sync",
         "--dir", objects, "--db", cli_db, "--chain-hash", chain_hash.hex(),
         "--scheme", scheme.id, "--public-key", pk_bytes.hex(),
         "--genesis-seed", seed.hex()],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    try:
        cli_out = json.loads(proc.stdout)
    except ValueError:
        cli_out = {}
    if proc.returncode or {k: cli_out.get(k) for k in res} != res or \
            table(cli_db) != want_rows:
        fail(f"catchup CLI: exit {proc.returncode}, "
             f"{proc.stdout.strip()[-600:]} {proc.stderr.strip()[-600:]}")
    out["cli"] = {"exit": proc.returncode, "wall_s": cli_s,
                  "result_equal_in_process": True, "stats": cli_out["stats"],
                  "rows_equal_source": True}

    # 4. up_to stops inside the third segment
    res, _, secs, segs, recs, rows = sync("upto.db", up_to=CATCHUP_UP_TO)
    if res != {"ok": True, "synced_to": CATCHUP_UP_TO, "segments": 3,
               "rounds": CATCHUP_UP_TO, "error": ""} or \
            rows != want_rows[:CATCHUP_UP_TO + 1]:
        fail(f"catchup up_to {CATCHUP_UP_TO}: {res}, records {recs}")
    out["up_to"] = {"result": res, "wall_s": secs, "dispatch": recs}

    # 5. the third segment re-written with round CATCHUP_UP_TO's
    # signature flipped, re-hashed and re-named in the manifest
    poisoned = os.path.join(work_dir, "poisoned")
    shutil.copytree(objects, poisoned)
    pm = OS.Manifest.from_json(open(os.path.join(
        poisoned, OS.MANIFEST_NAME), "rb").read())
    entry = pm.segments[2]
    seg = OS.decode_segment(open(os.path.join(poisoned, entry.name),
                                 "rb").read())
    seg_rows = [(r, sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
                 if r == CATCHUP_UP_TO else sig, prev)
                for r, sig, prev in seg.rows]
    blob = OS.encode_segment(seg.chain_hash, seg.scheme_id, seg_rows)
    os.unlink(os.path.join(poisoned, entry.name))
    entry.hash = OS.content_hash(blob)
    entry.name = OS.object_name(entry.start, entry.hash)
    with open(os.path.join(poisoned, entry.name), "wb") as f:
        f.write(blob)
    with open(os.path.join(poisoned, OS.MANIFEST_NAME), "wb") as f:
        f.write(pm.to_json())
    res, _, secs, segs, recs, rows = sync("poisoned.db", root=poisoned)
    if res["ok"] or res["synced_to"] != 2 * BATCH or \
            entry.name not in res["error"] or \
            str(CATCHUP_UP_TO) not in res["error"] \
            or rows != want_rows[:2 * BATCH + 1]:
        fail(f"catchup poisoned segment: {res}, {len(rows)} rows stored")
    out["poisoned"] = {"result": res, "wall_s": secs, "dispatch": recs,
                       "store_holds_verified_prefix": True}

    # 6. the second segment's bytes altered without re-hashing
    corrupt = os.path.join(work_dir, "corrupt")
    shutil.copytree(objects, corrupt)
    entry = m.segments[1]
    path = os.path.join(corrupt, entry.name)
    at = os.path.getsize(path) // 2          # a byte inside a row
    with open(path, "r+b") as f:
        f.seek(at)
        byte = f.read(1)
        f.seek(at)
        f.write(bytes([byte[0] ^ 1]))
    res, _, secs, segs, recs, rows = sync("corrupt.db", root=corrupt)
    try:
        asyncio.run(OS.ObjectSyncClient(OS.FilesystemBackend(corrupt), None,
                                        None)._fetch_segment(entry))
        raised = False
    except OS.CorruptObjectError:
        raised = True
    if res["ok"] or res["synced_to"] != BATCH or not raised or \
            "content hash mismatch" not in res["error"] or \
            rows != want_rows[:BATCH + 1]:
        fail(f"catchup corrupt object: {res}, raised {raised}, "
             f"{len(rows)} rows stored")
    out["corrupt"] = {"result": res, "wall_s": secs, "dispatch": recs,
                      "corrupt_object_error": True,
                      "store_holds_verified_prefix": True}
    out["publish_s"] = publish_s
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    return out, all_calls


FOLLOW_PERIOD = 30
FOLLOW_FLIP = 40000         # round flipped on the damaged peer
FOLLOW_CHECK = 6000         # round flipped for check-and-repair
FOLLOW_CHECK_UP_TO = 8192   # the check's depth: its first 16 batches


def follow_phase(work_dir, default_path, launches, chain_launches,
                 bucket_launches, pk_bytes, seed, sigs_c):
    """The `follow` phase: catch-up from a peer over gRPC on 127.0.0.1
    through the port's SyncManager, follow_chain, SyncChain server and
    `cli sync --follow`, over the 65,536-round unchained store the
    recovery phase built in `work_dir`.  `bucket_launches(b)` gives what
    one unchained batch at bucket b launches.  Returns (its report line,
    the calls by kernel of each driven run)."""
    import asyncio
    import sqlite3

    import torch

    from drand_tpu_torch import dispatch as DSP
    from drand_tpu_torch import verify as V
    from drand_tpu_torch.chain.beacon import Beacon
    from drand_tpu_torch.chain.info import Info
    from drand_tpu_torch.chain.scheme import scheme_by_id
    from drand_tpu_torch.chain.store import SqliteStore, new_chain_store
    from drand_tpu_torch.chain.verify import ChainVerifier
    from drand_tpu_torch.core import follow as FW
    from drand_tpu_torch.core import services as SVC
    from drand_tpu_torch.core.process import ServingProcess
    from drand_tpu_torch.net.client import PeerClients
    from drand_tpu_torch.net.gateway import PrivateGateway
    from drand_tpu_torch.ops import kernels as K

    out, all_calls = {"phase": "follow"}, []
    genesis = int(time.time()) - FOLLOW_PERIOD * STORE_ROUNDS - 60
    info_u = Info(pk_bytes, FOLLOW_PERIOD, genesis, seed,
                  scheme_id="pedersen-bls-unchained")
    info_c = Info(pk_bytes, FOLLOW_PERIOD, genesis, seed)

    class Clock:
        @staticmethod
        def now():
            return time.time()

    def group(info):
        return type("Group", (), {"period": info.period,
                                  "genesis_time": info.genesis_time,
                                  "scheme_id": info.scheme_id})

    def table(path):
        con = sqlite3.connect(path)
        try:
            return con.execute("SELECT round, data FROM beacons "
                               "ORDER BY round").fetchall()
        finally:
            con.close()

    def flip_row(path, round_):
        con = sqlite3.connect(path)
        with con:
            blob = bytearray(con.execute(
                "SELECT data FROM beacons WHERE round = ?",
                (round_,)).fetchone()[0])
            blob[13 + 40] ^= 0x01
            con.execute("UPDATE beacons SET data = ? WHERE round = ?",
                        (bytes(blob), round_))
        con.close()

    # the peers' stores: A the recovery phase's chain, B a copy with round
    # FOLLOW_FLIP's signature flipped, C the chained fixture
    path_a = os.path.join(work_dir, "unchained.db")
    path_b = os.path.join(work_dir, "follow-b.db")
    SqliteStore(path_a).save_to(path_b)
    flip_row(path_b, FOLLOW_FLIP)
    path_c = os.path.join(work_dir, "follow-c.db")
    chained_rows = [Beacon(0, seed)] + [
        Beacon(r, sigs_c[r - 1].tobytes(),
               seed if r == 1 else sigs_c[r - 2].tobytes())
        for r in range(1, sigs_c.shape[0] + 1)]
    store = SqliteStore(path_c)
    store.put_many(chained_rows)
    store.close()
    want_a, want_c = table(path_a), table(path_c)
    peers_of = {"A": (path_a, info_u), "B": (path_b, info_u),
                "C": (path_c, info_c)}
    def keeps_order(k):
        order = [0, 1]
        random.Random(k).shuffle(order)
        return order == [0, 1]
    # a seed under which the manager's shuffle keeps two peers in order
    keep_order = next(k for k in range(100) if keeps_order(k))

    async def serving(names):
        """A gateway a peer on 127.0.0.1 (port 0: a free one), started;
        returns (addresses, a coroutine that stops them and closes the
        stores)."""
        gws, stores = [], []
        for name in names:
            path, info = peers_of[name]
            st = new_chain_store(path, group(info), workers=2)
            procs = {"default": ServingProcess(st, info)}
            gw = PrivateGateway("127.0.0.1:0", SVC.ProtocolService(procs),
                                SVC.PublicService(procs))
            await gw.start()
            gws.append(gw)
            stores.append(st)

        async def stop():
            for gw in gws:
                await gw.stop()
            for st in stores:
                st.close()
        return [f"127.0.0.1:{gw.port}" for gw in gws], stop

    def follow(what, names, up_to=STORE_ROUNDS, path=default_path):
        """follow_chain into a fresh folder from the named peers, driven
        once: (progress or the stall message, the manager's stats,
        seconds, segments [start, rounds, the buckets of the batches it
        issued, launches], the card records, the peers opened in order,
        the db path, each segment's verdicts)."""
        folder = os.path.join(work_dir, f"follow-{what}")
        segs, opened, verdicts, issued = [], [], [], []
        mgr = {}

        def on_manager(sm):
            mgr["sm"] = sm
            inner = sm.verifier.verify_packed_segment_async
            batch = sm.verifier._verifier.verify_batch_async

            def batch_bucket(rounds, sigs, prev_sigs=None):
                issued.append(V.bucket(len(rounds)))
                return batch(rounds, sigs, prev_sigs)
            sm.verifier._verifier.verify_batch_async = batch_bucket

            def counted(packed, anchor):
                # only the pack stage issues, so `issued` and the counts
                # grow here by this segment's batches alone
                first = len(issued)
                before = K.launch_counts()
                pending = inner(packed, anchor)
                after = K.launch_counts()
                segs.append([packed.start_round, len(packed), issued[first:],
                             {n: after[n] - before[n] for n in after}])

                def resolve():
                    ok = pending()
                    verdicts.append(ok)
                    return ok
                return resolve
            sm.verifier.verify_packed_segment_async = counted
            sync_chain = sm.net.sync_chain

            def opening(node, from_round):
                opened.append((node.address, from_round))
                return sync_chain(node, from_round)
            sm.net.sync_chain = opening
            random.seed(keep_order)

        async def main():
            addrs, stop = await serving(names)
            clients = PeerClients()
            try:
                progress = []
                async for p in FW.follow_chain(
                        clients, addrs, folder, Clock(),
                        chain_hash=peers_of[names[0]][1].hash(),
                        up_to=up_to, on_manager=on_manager):
                    progress.append(p)
                return progress, addrs
            except FW.FollowStalled as exc:
                return str(exc), addrs
            finally:
                await clients.close()
                await stop()
        DSP.DISPATCH.clear()
        (progress, addrs), secs, counts, calls, n_conv = drive(
            lambda: asyncio.run(asyncio.wait_for(main(), 900)))
        check_path(f"follow {what}", counts, n_conv, path)
        all_calls.append(calls)
        recs = [[r.n, r.bucket] for r in DSP.DISPATCH.records("verify")]
        names_of = dict(zip(addrs, names))
        return (progress, dict(mgr["sm"].stats), secs, segs, recs,
                [(names_of[a], r) for a, r in opened],
                os.path.join(folder, FW.DB_NAME), verdicts)

    def check_segments(what, segs):
        """Every unchained card segment issued one batch and launched
        exactly what one batch at its bucket launches."""
        bad = [s[:3] for s in segs
               if len(s[2]) != 1 or s[3] != bucket_launches(s[2][0])]
        if bad:
            fail(f"follow {what}: segments {bad} launched other counts than "
                 f"one batch at their bucket")
        return [s[:3] for s in segs]

    def report(res, rounds):
        progress, stats, secs, segs, recs, opened, _, _ = res
        return {"result": progress if isinstance(progress, str)
                else progress[-1], "wall_s": secs,
                "rounds_per_s": rounds / secs, "stats": stats,
                "segments": [s[:3] for s in segs], "dispatch": recs,
                "peers_opened": opened}

    # 1. the whole chain in process from A: rows equal to the source's
    res = follow("A", ["A"])
    progress, stats, secs, segs, recs, opened, db, _ = res
    if progress[-1] != (STORE_ROUNDS, STORE_ROUNDS) or \
            stats["rounds"] != STORE_ROUNDS or table(db) != want_a:
        fail(f"follow from A: {progress[-3:]}, stats {stats}, rows equal "
             f"{table(db) == want_a}")
    out["follow"] = {**report(res, STORE_ROUNDS),
                     "segments": check_segments("A", segs),
                     "segment_launches_equal_batch_at_bucket": True,
                     "rows_equal_source": True}

    # 2. the same through the CLI in a fresh process
    async def cli_run():
        addrs, stop = await serving(["A"])
        try:
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-m", "drand_tpu_torch.cli", "sync",
                "--follow", "--sync-nodes", addrs[0], "--db",
                os.path.join(work_dir, "follow-cli"), "--up-to",
                str(STORE_ROUNDS), "--chain-hash", info_u.hash().hex(),
                cwd=HERE, stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.PIPE)
            try:
                stdout, stderr = await asyncio.wait_for(proc.communicate(),
                                                        600)
            except asyncio.TimeoutError:
                proc.kill()
                await proc.wait()
                raise
            return proc.returncode, stdout.decode(), stderr.decode()
        finally:
            await stop()
    t0 = time.perf_counter()
    rc, stdout, stderr = asyncio.run(cli_run())
    cli_s = time.perf_counter() - t0
    try:
        cli_out = json.loads(stdout)
    except ValueError:
        cli_out = {}
    cli_db = os.path.join(work_dir, "follow-cli", FW.DB_NAME)
    if rc or cli_out.get("ok") is not True or \
            cli_out.get("synced_to") != STORE_ROUNDS or \
            table(cli_db) != want_a:
        fail(f"follow CLI: exit {rc}, {stdout.strip()[-600:]} "
             f"{stderr.strip()[-600:]}")
    out["cli"] = {"exit": rc, "wall_s": cli_s, "result": {
        k: cli_out[k] for k in ("ok", "synced_to", "target")},
        "stats": cli_out["stats"], "rows_equal_source": True}

    # 3. the damaged peer B first, then A: the follower renews against A
    # and ends with A's rows; B alone stops at the verified prefix
    res = follow("BA", ["B", "A"])
    progress, stats, secs, segs, recs, opened, db, _ = res
    if progress[-1] != (STORE_ROUNDS, STORE_ROUNDS) or \
            [o[0] for o in opened] != ["B", "A"] or table(db) != want_a:
        fail(f"follow from [B, A]: {progress[-3:]}, opened {opened}, rows "
             f"equal {table(db) == want_a}")
    out["damaged_then_good"] = {**report(res, STORE_ROUNDS),
                                "segments": check_segments("BA", segs),
                                "rows_equal_a": True}
    res = follow("B", ["B"])
    progress, stats, secs, segs, recs, opened, db, _ = res
    rows_b = table(db)
    prefix = rows_b[-1][0]
    if not isinstance(progress, str) or "follow stalled" not in progress or \
            f"round {prefix}/" not in progress or prefix >= FOLLOW_FLIP or \
            rows_b != want_a[:prefix + 1]:
        fail(f"follow from [B]: {progress}, stored to {prefix}")
    out["damaged_alone"] = {**report(res, prefix),
                            "segments": check_segments("B", segs),
                            "stopped_at": prefix,
                            "store_holds_verified_prefix": True}

    # 4. check and repair: round FOLLOW_CHECK flipped in the follower's
    # store, found by check_past_beacons over rounds 1-FOLLOW_CHECK_UP_TO,
    # repaired from A (what `cli sync --up-to` without --follow runs)
    folder = os.path.join(work_dir, "follow-A")
    db = os.path.join(folder, FW.DB_NAME)
    flip_row(db, FOLLOW_CHECK)

    async def check_repair():
        addrs, stop = await serving(["A"])
        clients = PeerClients()
        try:
            return await FW.check_chain(clients, addrs, folder, Clock(),
                                        chain_hash=info_u.hash(),
                                        up_to=FOLLOW_CHECK_UP_TO)
        finally:
            await clients.close()
            await stop()
    DSP.DISPATCH.clear()
    res, secs, counts, calls, n_conv = drive(
        lambda: asyncio.run(asyncio.wait_for(check_repair(), 900)))
    check_path("follow check_past_beacons", counts, n_conv, default_path)
    all_calls.append(calls)
    recs = collections.Counter((r.n, r.bucket)
                               for r in DSP.DISPATCH.records("verify"))
    if (res["faulty"], res["fixed"], res["ok"]) != ([FOLLOW_CHECK], 1, True) \
            or table(db) != want_a:
        fail(f"follow check and repair: {res}, rows equal "
             f"{table(db) == want_a}")
    out["check_repair"] = {**res, "wall_s": secs, "dispatch": sorted(
        [list(k) + [n] for k, n in recs.items()]), "rows_equal_source": True}

    # 5. the chained fixture from peer C: one card segment (round 1 on the
    # genesis anchor, rounds 2-65 in a batch of 64) launching what the
    # slice phase's chained segment launched, its verdicts equal to the
    # native tier's; then a copy with round 30 flipped
    res = follow("C", ["C"], up_to=sigs_c.shape[0])
    progress, stats, secs, segs, recs, opened, db, verdicts = res
    if progress[-1] != (65, 65) or table(db) != want_c or \
            recs != [[1, V.bucket(1)], [64, V.bucket(64)]] or \
            [s[2] for s in segs] != [[V.bucket(1), V.bucket(64)]] or \
            [s[3] for s in segs] != [chain_launches] or \
            [v.tolist() for v in verdicts] != [[True] * 65]:
        fail(f"follow chained: {progress[-2:]}, records {recs}, segments "
             f"{[s[:3] for s in segs]}, rows equal {table(db) == want_c}")
    out["chained"] = {**report(res, 65), "rows_equal_source": True,
                      "segment_launches_equal_slice_chained": True}
    flip_row(path_c, 30)
    # the follower links each row to the one before it as served, so
    # round 31 links to the flipped round 30, as the native phase's
    bad_c = sigs_c.copy()
    bad_c[29, 40] ^= 0x01
    cv = ChainVerifier(scheme_by_id(info_c.scheme_id), pk_bytes)
    host = [cv.verify_beacon(Beacon(r, bad_c[r - 1].tobytes(),
                                    seed if r == 1 else
                                    bad_c[r - 2].tobytes()))
            for r in range(1, sigs_c.shape[0] + 1)]
    res = follow("C-flipped", ["C"], up_to=sigs_c.shape[0])
    progress, stats, secs, segs, recs, opened, db, verdicts = res
    if progress != "follow stalled at round 0/65" or \
            [v.tolist() for v in verdicts] != [host] or \
            host.count(False) != 2 or host[29] or host[30]:
        fail(f"follow chained, round 30 flipped: {progress}, card "
             f"{[v.tolist() for v in verdicts]}, host {host}")
    out["chained_flipped"] = {**report(res, 65),
                              "verdicts_equal_native": True,
                              "false_rounds": [i + 1 for i, ok in
                                               enumerate(host) if not ok]}
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    return out, all_calls


# the plain limb convolution, counted wherever the port calls it while
# `drive` runs
# the beacon phase's group: n = 16, t = 9 = minimum_threshold(16), as the
# partials phase's; period 3 s, catch-up period 1 s; the secret
# polynomial and the nodes' key pairs from fixed seeds
BEACON_N, BEACON_T, BEACON_PERIOD = 16, 9, 3
BEACON_SEED = b"drand_tpu_torch beacon group"
BEACON_ROUNDS = 6               # clockwork: rounds 1-6
BEACON_BAD_ROUND = 4            # the flipped partial: signer 5's, round 4
BEACON_LIVE_TARGET = 4          # live: stop once every node holds it
# live: the period of the DKG's group, 16 processes checking partials on
# one card from 8 host cores (a card call's ~1.1 s of host issue took
# 5.5 s with all 16 at once, so a 3-s period fell behind)
BEACON_LIVE_PERIOD = 10


def beacon_group(folders, addresses, genesis):
    """The beacon phase's group over `addresses` (node i's key pair from
    the seed "beacon node i"), each node's key pair, group and share
    written through the port's FileStore into folders[i].  Returns (the
    group, the polynomial, each node's share index)."""
    from drand_tpu_torch.crypto.bls12381 import curve as GC
    from drand_tpu_torch.crypto.poly import PriPoly
    from drand_tpu_torch.key.group import Group, minimum_threshold
    from drand_tpu_torch.key.keys import DistPublic, Pair, Share
    from drand_tpu_torch.key.store import FileStore
    assert BEACON_T == minimum_threshold(BEACON_N)
    poly = PriPoly.random(BEACON_T, rand=sha512_stream(BEACON_SEED))
    commits = [GC.g1_to_bytes(c) for c in poly.commit().commits]
    pairs = [Pair.generate(a, seed=b"beacon node %d" % i)
             for i, a in enumerate(addresses)]
    group = Group(threshold=BEACON_T, period=BEACON_PERIOD,
                  nodes=Group.sort_nodes([p.public for p in pairs]),
                  genesis_time=int(genesis), catchup_period=1,
                  scheme_id="pedersen-bls-chained",
                  public_key=DistPublic(commits))
    group.get_genesis_seed()
    index = [group.find(p.public).index for p in pairs]
    for folder, pair, idx in zip(folders, pairs, index):
        ks = FileStore(folder)
        ks.save_key_pair(pair)
        ks.save_group(group)
        ks.save_share(Share(commits, poly.eval(idx)))
    return group, poly, index


def beacon_rows(folder):
    """(round, stored bytes) of a node's chain database."""
    import sqlite3
    con = sqlite3.connect(os.path.join(folder, "multibeacon", "default",
                                       "db", "drand.db"))
    try:
        return con.execute("SELECT round, data FROM beacons "
                           "ORDER BY round").fetchall()
    finally:
        con.close()


def beacon_clockwork(work_dir, default_path, burst_launches):
    """Part (a) of the beacon phase: 16 port DrandDaemons in this process
    under one FakeClock, node 0 on the card, nodes 1-15 on the host
    tier; genesis, then rounds 1-6, one period a step, each waited for
    on all 16 stores.  Returns (its report, the calls by kernel of the
    driven run)."""
    import asyncio

    from drand_tpu_torch.beacon.clock import FakeClock
    from drand_tpu_torch.beacon.crypto_backend import HostBackend
    from drand_tpu_torch.chain.beacon import Beacon
    from drand_tpu_torch.chain.scheme import scheme_by_id
    from drand_tpu_torch.chain.verify import ChainVerifier
    from drand_tpu_torch.core.config import Config
    from drand_tpu_torch.core.daemon import DrandDaemon
    from drand_tpu_torch.crypto import sign as SG
    from drand_tpu_torch.crypto import tbls
    from drand_tpu_torch.crypto.poly import PriShare
    from drand_tpu_torch.net.client import PeerClients, make_metadata
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.protogen import drand_pb2

    n, period, start = BEACON_N, BEACON_PERIOD, 1_700_000_000.0
    folders = [os.path.join(work_dir, f"clockwork-{i}") for i in range(n)]
    node0_calls, per_round, streamed, state = [], [], [], {}

    def record_calls(be):
        """Wrap node 0's DeviceBackend.verify_partials: each call's
        inputs, verdicts, wall and launches (only node 0 launches port
        kernels in this run; its calls run one at a time in the crypto
        thread)."""
        inner = be.verify_partials

        def recorded(msgs, parts):
            before = K.launch_counts()
            t0 = time.perf_counter()
            out = inner(msgs, parts)
            wall = time.perf_counter() - t0
            after = K.launch_counts()
            node0_calls.append({
                "msgs": list(msgs), "parts": list(parts), "verdicts": out,
                "wall_s": wall, "at": time.time(),
                "launches": {k: after[k] - before[k] for k in after
                             if after[k] != before[k]}})
            return out
        be.verify_partials = recorded

    async def clockwork():
        clock = FakeClock(start)
        daemons, peers, reader = [], PeerClients(), None
        try:
            for i in range(n):
                d = DrandDaemon(Config(folder=folders[i],
                                       private_listen="127.0.0.1:0",
                                       clock=clock,
                                       device=None if i == 0 else "cpu"))
                await d.start()
                daemons.append(d)
            group, poly, index = beacon_group(
                folders, [d.private_addr() for d in daemons],
                start + period)
            state.update(group=group, poly=poly, index=index)
            for d in daemons:
                if await d.load_beacons_from_disk() != ["default"]:
                    fail(f"beacon: {d.private_addr()} loaded no beacon")
            procs = [d.processes["default"] for d in daemons]
            be = procs[0].handler.partials.backend
            if be.name != "device" or be.device.type != "cuda":
                fail(f"beacon: node 0's backend is {be.name} on "
                     f"{getattr(be, 'device', None)}")
            record_calls(be)
            addr0 = daemons[0].private_addr()
            md = make_metadata("default")
            stream = peers.public(addr0).PublicRandStream(
                drand_pb2.PublicRandRequest(round=0, metadata=md))

            async def read_stream():
                async for resp in stream:
                    streamed.append((resp.round, resp.signature))
            reader = asyncio.ensure_future(read_stream())
            for _ in range(20):
                await asyncio.sleep(0)      # tickers register sleepers
            shares = {i: PriShare(i, poly.eval(i).value)
                      for i in range(n)}
            for r in range(1, BEACON_ROUNDS + 1):
                bad = None
                if r == BEACON_BAD_ROUND:
                    # signer 5's partial for this round, one byte flipped,
                    # to node 0's PartialBeacon before the advance
                    last = procs[0].chain_store.last()
                    msg = procs[0].verifier.digest_message(r, last.signature)
                    good = tbls.sign_partial(shares[5], msg)
                    bad = good[:40] + bytes([good[40] ^ 1]) + good[41:]
                    await asyncio.wait_for(
                        peers.protocol(addr0).PartialBeacon(
                            drand_pb2.PartialBeaconPacket(
                                round=r, previous_sig=last.signature,
                                partial_sig=bad, metadata=md)), 120)
                    state["bad"] = bad
                calls_before = len(node0_calls)
                t0 = time.perf_counter()
                await clock.set_time(group.genesis_time + (r - 1) * period)
                limit = time.monotonic() + 60
                while min(p.chain_store.tip_round() for p in procs) < r:
                    if time.monotonic() > limit:
                        fail(f"beacon clockwork: round {r} not stored on "
                             f"every node within 60 s: tips "
                             f"{[p.chain_store.tip_round() for p in procs]}")
                    await asyncio.sleep(0.005)
                wall = time.perf_counter() - t0
                per_round.append({"round": r, "all_stored_wall_s": wall,
                                  "node0_calls_since_advance":
                                      len(node0_calls) - calls_before})
            limit = time.monotonic() + 30
            while len(streamed) < BEACON_ROUNDS and time.monotonic() < limit:
                await asyncio.sleep(0.01)
            tip = await asyncio.wait_for(peers.public(addr0).PublicRand(
                drand_pb2.PublicRandRequest(round=0, metadata=md)), 30)
            state["public_rand"] = (tip.round, tip.signature)
        finally:
            if reader is not None:
                reader.cancel()
                await asyncio.gather(reader, return_exceptions=True)
            await peers.close()
            for d in daemons:
                await d.stop()

    from drand_tpu_torch.beacon import crypto_backend as CB

    def run_clockwork():
        asyncio.run(clockwork())
        # a stopped engine leaves its last calls in the crypto thread:
        # wait for them, so every launch is counted within the run
        CB._EXECUTOR.submit(lambda: None).result()
    _, run_s, counts, calls, n_conv = drive(run_clockwork)
    check_path("beacon clockwork", counts, n_conv, default_path)
    group, poly = state["group"], state["poly"]
    rows = [beacon_rows(f) for f in folders]
    if any(r != rows[0] for r in rows) or \
            [r for r, _ in rows[0]] != list(range(BEACON_ROUNDS + 1)):
        fail("beacon clockwork: the 16 stores differ or lack rounds 0-8")
    cv = ChainVerifier(scheme_by_id(group.scheme_id),
                       group.public_key.key_bytes())
    from drand_tpu_torch.chain.codec import decode_beacon
    stored = [decode_beacon(data) for _, data in rows[0]]
    prev, want = group.genesis_seed, []
    for r in range(1, BEACON_ROUNDS + 1):
        sig = SG.bls_sign(poly.secret(), cv.digest_message(r, prev))
        want.append(Beacon(r, sig, prev))
        prev = sig
    if [(b.signature, b.previous_sig) for b in stored[1:]] != \
            [(b.signature, b.previous_sig) for b in want] or \
            stored[0].signature != group.genesis_seed:
        fail("beacon clockwork: stored signatures differ from the dealt "
             "secret's")
    if not cv.verify_chain_segment(stored[1:], group.genesis_seed).all():
        fail("beacon clockwork: the ChainVerifier rejects the chain")
    if state["public_rand"] != (BEACON_ROUNDS, want[-1].signature):
        fail(f"beacon clockwork: PublicRand gave round "
             f"{state['public_rand'][0]}")
    if streamed[:BEACON_ROUNDS] != [(b.round, b.signature) for b in want]:
        fail(f"beacon clockwork: PublicRandStream gave rounds "
             f"{[r for r, _ in streamed]}")
    bad_verdicts = [v for c in node0_calls
                    for p, v in zip(c["parts"], c["verdicts"])
                    if p == state["bad"]]
    if bad_verdicts != [False]:
        fail(f"beacon clockwork: node 0's verdicts on the flipped partial "
             f"{bad_verdicts}")
    host = HostBackend(poly.commit(), BEACON_T, BEACON_N)
    for c in node0_calls:
        if list(c["verdicts"]) != host.verify_partials(c["msgs"], c["parts"]):
            fail("beacon clockwork: a card call's verdicts differ from "
                 "HostBackend's")
    first = node0_calls[0]["launches"]
    if first != burst_launches:
        fail(f"beacon clockwork: node 0's first call launched {first}, the "
             f"partials phase's burst {burst_launches}")
    round_of = {}
    prev = group.genesis_seed
    for b in want:
        round_of[cv.digest_message(b.round, prev)] = b.round
        prev = b.signature
    for c in node0_calls:
        c["rounds"] = sorted({round_of.get(m, -1) for m in c["msgs"]})
    by_round = collections.defaultdict(list)
    for c in node0_calls:
        by_round[c["rounds"][0]].append(c)
    for pr in per_round:
        cs = by_round.get(pr["round"], [])
        pr.update(node0_calls=len(cs), node0_sizes=[len(c["msgs"])
                                                    for c in cs],
                  node0_walls_s=[c["wall_s"] for c in cs])
    return {
        "phase": "beacon", "part": "clockwork", "card": nvidia_smi(),
        "n": BEACON_N,
        "t": BEACON_T, "period_s": BEACON_PERIOD,
        "scheme": group.scheme_id, "rounds": BEACON_ROUNDS,
        "node0": "card (DeviceBackend)", "nodes_1_15": "host tier",
        "stores_byte_equal": True, "equal_dealt_signatures": True,
        "chain_verifier_accepts": True, "public_rand_round": BEACON_ROUNDS,
        "stream_rounds": [r for r, _ in streamed],
        "bad_partial": {"signer_index": 5, "round": BEACON_BAD_ROUND,
                        "verdict": False},
        "card_verdicts_equal_host": True,
        "first_call_launches_equal_burst": True,
        "run_s": run_s, "per_round": per_round,
        "node0_calls": [{"n": len(c["msgs"]), "rounds": c["rounds"],
                         "wall_s": c["wall_s"]} for c in node0_calls],
        "launches": {k: v for k, v in counts.items() if v},
        "first_call_launches": first}, [calls]


def beacon_phase(work_dir, default_path, burst_launches):
    """The `beacon` phase's clockwork group in this process (its live part
    runs in the `dkg` phase, on the ceremony's group).  Returns (its
    report, the calls by kernel of its driven run)."""
    clockwork, calls = beacon_clockwork(work_dir, default_path,
                                        burst_launches)
    emit({k: v for k, v in clockwork.items() if k != "per_round"})
    for row in clockwork["per_round"]:
        emit({"phase": "beacon", "part": "clockwork round", **row})
    return clockwork, calls


# the dkg phase: the batched commitment check at the reference's stated
# shape (n = 128 dealers, t = 65: `pubpoly_eval_g1_stacked`'s docstring),
# a faulty dealer's ceremony in this process and the ceremony through the
# CLI, both at the beacon phase's n = 16, t = 9
DKG_WIDE_N, DKG_WIDE_T = 128, 65
DKG_WIDE_INDEX = 5              # the deal shape's one index
DKG_WIDE_SWAPPED = 17           # this row's commitment 1 is its commitment 0
DKG_WIDE_WRONG = 93             # this row's expected point is one G1 off
DKG_PATH = ("mont_mul", "mont_sqr", "sqr_chain_mul")
DKG_FAULTY_DEALER = 4           # seals a wrong share to nodes 8-15
DKG_FAULTY_TO = tuple(range(8, 16))
DKG_CARD_NODES = (0, 8)         # their twins check on the card
DKG_TIMEOUT = 15                # `cli share --timeout`: a phase's limit
DKG_SECRET = b"drand_tpu_torch chip_smoke dkg"


def dkg_launches(t: int) -> dict:
    """K1, K2 and K4 launches of one `dkg_commit_checks` call at threshold
    t, read from the code (ops/bls.py, ops/curve.py): t - 1 Horner steps,
    each a 16-bit ladder (a bit: a doubling, 3 K1 and 1 K2, and an
    addition without its doubling case, 5 K1) then an addition with it
    (8 K1, 1 K2); then the affine map (one K4 inversion, 1 K2, 3 K1)."""
    return {"mont_mul": 136 * (t - 1) + 3, "mont_sqr": 17 * (t - 1) + 1,
            "sqr_chain_mul": 1}


def dkg_bounds(calls) -> dict:
    """Each DKG kernel's bound summed over a run's calls."""
    return {name: sum(n * bound_ms(*work(name, call))[0]
                      for call, n in calls[name].items())
            for name in DKG_PATH}


def dkg_wide():
    """Part (a) of the dkg phase: 128 polynomials of degree 64 from fixed
    seeds, committed by the golden `g1_mul_gen`; `dkg_commit_checks` on
    the card in the deal shape (128 rows, one index; the process's first
    call) and the justification shape (each row its own index; the
    second), row 17 with a valid but swapped commitment and row 93 with
    a wrong expected point: every verdict equal to the golden
    PubPoly.eval comparison, exactly those two rows false; each call's
    wall and launches, and the deal-shape call's device kernels (it runs
    under the profiler, so its wall includes the profiler's cost).
    Returns (its report, the calls by kernel of its driven
    runs)."""
    import numpy as np

    from drand_tpu_torch.crypto.bls12381 import curve as GC
    from drand_tpu_torch.crypto.poly import PriPoly, PubPoly
    from drand_tpu_torch.ops import bls as BLS

    n, t = DKG_WIDE_N, DKG_WIDE_T
    t0 = time.perf_counter()
    polys = [PriPoly.random(t, rand=sha512_stream(b"dkg wide %d" % i))
             for i in range(n)]
    commits = [[GC.g1_mul_gen(c) for c in p.coeffs] for p in polys]
    commit_s = time.perf_counter() - t0
    commits[DKG_WIDE_SWAPPED][1] = commits[DKG_WIDE_SWAPPED][0]
    limbs = [BLS.g1_rows_to_limbs(c) for c in commits]
    ctx = np.stack([x for x, _, _ in limbs])
    cty = np.stack([y for _, y, _ in limbs])
    cases = {}
    for shape, idx in (("deal", [DKG_WIDE_INDEX] * n),
                       ("justification", [(37 * r + 11) % n
                                          for r in range(n)])):
        values = [p.eval(i).value for p, i in zip(polys, idx)]
        values[DKG_WIDE_WRONG] += 1
        expected = [GC.g1_mul_gen(v) for v in values]
        golden = [GC.g1_eq(PubPoly(c).eval(i), e)
                  for c, i, e in zip(commits, idx, expected)]
        cases[shape] = (np.asarray(idx, dtype=np.int32),
                        *BLS.g1_rows_to_limbs(expected), golden)
    host_s = time.perf_counter() - t0
    want = dkg_launches(t)
    bad = sorted((DKG_WIDE_SWAPPED, DKG_WIDE_WRONG))
    out = {"phase": "dkg", "part": "wide", "card": nvidia_smi(), "rows": n,
           "t": t, "commit_host_s": commit_s, "inputs_host_s": host_s,
           "launches_predicted": want}
    all_calls, kern, complete = [], [], set()
    for shape in ("deal", "justification"):
        idx, ex, ey, einf, golden = cases[shape]

        def call():
            return drive(
                lambda: BLS.dkg_commit_checks(ctx, cty, idx, ex, ey, einf))
        if shape == "deal":
            got = []
            t0 = time.perf_counter()
            kern, complete = profile_kernels(lambda: got.append(call()),
                                             want, tries=1)
            out["profile_s"] = time.perf_counter() - t0
            ok, secs, counts, calls, n_conv = got[0]
        else:
            ok, secs, counts, calls, n_conv = call()
        check_path(f"dkg wide, {shape} shape", counts, n_conv, DKG_PATH)
        all_calls.append(calls)
        if ok.tolist() != golden or \
                [r for r in range(n) if not ok[r]] != bad:
            fail(f"dkg wide, {shape} shape: false rows "
                 f"{[r for r in range(n) if not ok[r]]}, golden "
                 f"{[r for r in range(n) if not golden[r]]}")
        out[shape] = {"wall_s": secs, "profiled": shape == "deal",
                      "launches": {k: counts[k] for k in DKG_PATH},
                      "launches_as_predicted": all(counts[k] == want[k]
                                                   for k in DKG_PATH),
                      "bound_ms": dkg_bounds(calls),
                      "false_rows": bad, "verdicts_equal_golden": True}
    ms = collections.Counter()
    for dev_name, d in kern:
        name = kernel_of(dev_name)
        if name is not None:
            ms[name] += d * 1e3
    out["deal"].update(
        device_kernels=len(kern), busy_s=sum(d for _, d in kern),
        device_kernels_note=DEVICE_KERNELS_NOTE,
        path_ms={k: (ms[k] if k in complete else None) for k in DKG_PATH})
    return out, all_calls


def dkg_faulty():
    """Part (b) of the dkg phase: a ceremony of n = 16, t = 9 in this
    process, dealer 4 sealing a wrong share to nodes 8-15.  Every node
    runs on the host path (the golden model); nodes 0 and 8 run again on
    the card with the same bundles: their deal verdicts (16 rows, one
    batched call each), complaints, QUAL (dealer 4's justification, 8
    rows, batched in qual() and again in finalize()) and shares equal
    the host run's; dealer 4 stays in QUAL, and t shares give the group
    key's secret.  Returns (its report, the calls by kernel of the card
    run)."""
    import hashlib

    from drand_tpu_torch import dispatch as DSP
    from drand_tpu_torch.crypto import dkg as DKG
    from drand_tpu_torch.crypto import ecies
    from drand_tpu_torch.crypto import sign as SG
    from drand_tpu_torch.crypto.bls12381 import curve as GC
    from drand_tpu_torch.crypto.poly import recover_secret

    n, t, bad = BEACON_N, BEACON_T, DKG_FAULTY_DEALER
    keys = [SG.keygen(b"dkg faulty node %d" % i) for i in range(n)]
    nodes = [DKG.DkgNode(i, pk) for i, (_, pk) in enumerate(keys)]
    nonce = hashlib.sha256(b"chip_smoke dkg faulty dealer").digest()

    def conf(i):
        return DKG.DkgConfig(longterm=keys[i][0], new_nodes=nodes,
                             threshold=t, nonce=nonce)
    t0 = time.perf_counter()
    host = [DKG.DkgProtocol(conf(i), device="cpu") for i in range(n)]
    deals = [p.make_deal_bundle() for p in host]
    poly = host[bad]._poly
    deals[bad].deals = [DKG.Deal(node.index, ecies.seal(
        node.public, ((poly.eval(node.index).value
                       + (node.index in DKG_FAULTY_TO)) % GC.R)
        .to_bytes(32, "big"))) for node in nodes]
    deals[bad].signature = SG.schnorr_sign(keys[bad][0], deals[bad].hash())
    for p in host:
        if not all(p.receive_deal_bundle(d) for d in deals):
            fail("dkg faulty dealer: a deal bundle refused")
    host_checked = [p._check_deals() for p in host]
    resps = [p.make_response_bundle() for p in host]
    for p in host:
        for rb in resps:
            p.receive_response_bundle(rb)
    just = host[bad].make_justification_bundle()
    for p in host:
        p.receive_justification_bundle(just)
    host_qual = [p.qual() for p in host]
    host_shares = [p.finalize() for p in host]
    host_s = time.perf_counter() - t0
    complaints = host[0].complaints()
    if complaints != {bad: set(DKG_FAULTY_TO)} or \
            len(just.justifications) != len(DKG_FAULTY_TO) or \
            any(q != list(range(n)) for q in host_qual):
        fail(f"dkg faulty dealer (host): complaints {complaints}, "
             f"QUAL {host_qual[0]}")

    def card_run():
        out = {}
        for i in DKG_CARD_NODES:
            c = DKG.DkgProtocol(conf(i))
            for d in deals:
                c.receive_deal_bundle(d)
            checked = c._check_deals()
            for rb in resps:
                c.receive_response_bundle(rb)
            c.receive_justification_bundle(just)
            out[i] = (checked, c.complaints(), c.qual(), c.finalize())
        return out
    before = len(DSP.DISPATCH)
    res, card_s, counts, calls, n_conv = drive(card_run)
    check_path("dkg faulty dealer (card)", counts, n_conv, DKG_PATH)
    records = [(r.seam, r.n) for r in DSP.DISPATCH.records()[before:]]
    want_records = [("dkg_deals", n), ("dkg_justifications", 8),
                    ("dkg_justifications", 8)] * len(DKG_CARD_NODES)

    def share_bytes(dks):
        return ([GC.g1_to_bytes(c) for c in dks.commits],
                dks.pri_share.index, dks.pri_share.value)
    for i, (checked, comp, qual, dks) in res.items():
        if checked != host_checked[i] or comp != complaints or \
                qual != host_qual[i] or \
                share_bytes(dks) != share_bytes(host_shares[i]):
            fail(f"dkg faulty dealer: node {i}'s card run differs from the "
                 f"host run: verdicts {checked} / {host_checked[i]}, QUAL "
                 f"{qual}")
    if records != want_records:
        fail(f"dkg faulty dealer: card calls {records}, want {want_records}")
    if res[DKG_FAULTY_TO[0]][0][bad] or not res[0][0][bad]:
        fail("dkg faulty dealer: the deal verdicts on dealer 4")
    key = host_shares[0].commits[0]
    secret = recover_secret([s.pri_share for s in host_shares[3:3 + t]], t)
    if not GC.g1_eq(GC.g1_mul_gen(secret), key) or any(
            share_bytes(s)[0] != share_bytes(host_shares[0])[0]
            for s in host_shares):
        fail("dkg faulty dealer: the shares do not give the group key")
    return {"phase": "dkg", "part": "faulty dealer", "n": n, "t": t,
            "dealer": bad, "wrong_shares_to": list(DKG_FAULTY_TO),
            "complaints": len(complaints[bad]),
            "justification_rows": len(just.justifications),
            "qual": host_qual[0], "card_nodes": list(DKG_CARD_NODES),
            "card_equal_host": True, "card_records": records,
            "host_run_s": host_s, "card_run_s": card_s,
            "launches": {k: counts[k] for k in DKG_PATH},
            "bound_ms": dkg_bounds(calls)}, [calls]


async def _wait_leader(addr: str, limit: float) -> None:
    """Until the leader's InitDKG has begun: its SignalDKGParticipant
    answers "no DKG setup in progress" before, and refuses an empty
    secret ("wrong setup secret") after."""
    import asyncio

    import grpc

    from drand_tpu_torch.net.client import PeerClients, make_metadata
    from drand_tpu_torch.protogen import drand_pb2
    peers = PeerClients()
    deadline = time.monotonic() + limit
    try:
        while True:
            try:
                await peers.protocol(addr).SignalDKGParticipant(
                    drand_pb2.SignalDKGPacket(
                        metadata=make_metadata("default")), timeout=10)
            except grpc.aio.AioRpcError as exc:
                # the leader's manager refuses the empty secret; any
                # other answer (no setup yet, a deadline, no connection)
                # says nothing of it
                if "wrong setup secret" in (exc.details() or ""):
                    return
            if time.monotonic() > deadline:
                fail(f"dkg ceremony: the leader {addr} did not start its "
                     f"setup within {limit} s")
            await asyncio.sleep(0.2)
    finally:
        await peers.close()


def dkg_live(work_dir):
    """Part (c) of the dkg phase, and the beacon phase's live part: 16
    nodes through the CLI alone, on the wall clock, every one on the
    card: `cli generate-keypair`, `cli start --control`, then `cli share
    --leader --nodes 16 --threshold 9` and 15 `cli share --connect`
    (period BEACON_LIVE_PERIOD, catch-up period 1 s, --timeout
    DKG_TIMEOUT);
    then the ceremony's group produces the chain until every node holds
    round BEACON_LIVE_TARGET, and SIGTERM stops every node.  Fails unless
    every share exits 0 with the same TOML, the 16 group files and the
    16 distributed keys are byte-equal, t shares give the group key's
    secret, every node's phases closed complete with QUAL all 16 and it
    made a card deal check ({"dkg": ...} and {"dispatch": ...} lines of
    `cli start` at stop), every node exits 0, the 16 stores are
    byte-equal to the target and verify against the group key, node 0
    made a card call in rounds 2 to the target and no card call of any
    node raised.  Returns (the ceremony's report, the live report)."""
    import asyncio
    import signal
    import socket

    from drand_tpu_torch.chain.codec import decode_beacon
    from drand_tpu_torch.chain.scheme import scheme_by_id
    from drand_tpu_torch.chain.time import time_of_round
    from drand_tpu_torch.chain.verify import ChainVerifier
    from drand_tpu_torch.crypto.bls12381 import curve as GC
    from drand_tpu_torch.crypto.poly import recover_secret
    from drand_tpu_torch.key.group import Group
    from drand_tpu_torch.key.store import FileStore
    from drand_tpu_torch.net.client import PeerClients, make_metadata
    from drand_tpu_torch.protogen import drand_pb2

    n, t, period = BEACON_N, BEACON_T, BEACON_LIVE_PERIOD
    target = BEACON_LIVE_TARGET
    socks = []
    for _ in range(2 * n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    addrs = [f"127.0.0.1:{p}" for p in ports[:n]]
    controls = [str(p) for p in ports[n:]]
    folders = [os.path.join(work_dir, f"live-{i}") for i in range(n)]
    cli = [sys.executable, "-m", "drand_tpu_torch.cli"]
    t_start = time.time()
    gens = [subprocess.Popen(cli + ["generate-keypair", "--folder", f, a],
                             cwd=HERE, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for f, a in zip(folders, addrs)]
    for i, g in enumerate(gens):
        out, err = g.communicate(timeout=300)
        if g.returncode:
            fail(f"dkg ceremony: generate-keypair of node {i} exited "
                 f"{g.returncode}: {err[-2000:]}")
    keys_s = time.time() - t_start
    outs = [os.path.join(f, "stdout.txt") for f in folders]
    errs = [os.path.join(f, "stderr.txt") for f in folders]
    procs, shares, arrivals, rcs = [], [], {0: {}, 1: {}}, []
    secret = os.path.join(work_dir, "dkg-secret")
    with open(secret, "wb") as f:
        f.write(DKG_SECRET)
    share = cli + ["share", "--secret-file", secret, "--period", str(period),
                   "--catchup-period", "1", "--timeout", str(DKG_TIMEOUT)]
    try:
        for i in range(n):
            with open(outs[i], "w") as out, open(errs[i], "w") as err:
                procs.append(subprocess.Popen(
                    cli + ["start", "--folder", folders[i],
                           "--private-listen", addrs[i], "--tls-disable",
                           "--control", controls[i]],
                    cwd=HERE, stdout=out, stderr=err))
        up, limit = [False] * n, time.time() + 300
        while not all(up):
            for i in range(n):
                if not up[i] and procs[i].poll() is not None:
                    fail(f"dkg ceremony: node {i} exited "
                         f"{procs[i].returncode} before serving")
                with open(outs[i]) as f:
                    up[i] = f.read().startswith("daemon running: ")
            if time.time() > limit:
                fail(f"dkg ceremony: nodes {[i for i in range(n) if not up[i]]}"
                     " not serving within 300 s")
            time.sleep(0.1)
        up_s = time.time() - t_start
        t_share = time.time()
        shares.append(subprocess.Popen(
            share + ["--control", controls[0], "--leader", "--nodes", str(n),
                     "--threshold", str(t)], cwd=HERE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        asyncio.run(_wait_leader(addrs[0], 120))
        shares += [subprocess.Popen(
            share + ["--control", controls[i], "--connect", addrs[0]],
            cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for i in range(1, n)]
        results, share_walls = [], []
        for i, sp in enumerate(shares):
            results.append(sp.communicate(timeout=6 * DKG_TIMEOUT + 300))
            share_walls.append(time.time() - t_share)
            if sp.returncode:
                fail(f"dkg ceremony: share of node {i} exited "
                     f"{sp.returncode}: {results[-1][1][-2000:]}")
        if any(out != results[0][0] for out, _ in results):
            fail("dkg ceremony: the share commands printed different groups")
        group = Group.from_toml(results[0][0])
        files = []
        for f in folders:
            with open(os.path.join(f, "multibeacon", "default", "groups",
                                   "drand_group.toml"), "rb") as fh:
                files.append(fh.read())
        node_shares = [FileStore(f).load_share() for f in folders]
        key = group.public_key.key_bytes()
        if any(x != files[0] for x in files) or \
                files[0].decode() != results[0][0] or \
                any(s.commits != group.public_key.coefficients
                    for s in node_shares) or \
                sorted(s.share_index() for s in node_shares) != list(range(n)):
            fail("dkg ceremony: the group files or the distributed keys "
                 "differ between nodes")
        secret_s = recover_secret([s.pri_share for s in node_shares[:t]], t)
        if GC.g1_to_bytes(GC.g1_mul_gen(secret_s)) != key:
            fail("dkg ceremony: t shares do not give the group key's secret")
        genesis = group.genesis_time
        done_at = time.time()

        async def watch():
            peers = PeerClients()
            md = make_metadata("default")

            async def follow(i):
                stream = peers.public(addrs[i]).PublicRandStream(
                    drand_pb2.PublicRandRequest(round=0, metadata=md))
                async for resp in stream:
                    arrivals[i].setdefault(resp.round, time.time())
                    if i == 1 and resp.round >= target:
                        return

            async def tip(i):
                resp = await peers.public(addrs[i]).PublicRand(
                    drand_pb2.PublicRandRequest(round=0, metadata=md),
                    timeout=30)
                return resp.round
            tasks = [asyncio.ensure_future(follow(i)) for i in (0, 1)]
            try:
                limit = genesis + (target + 10) * period - time.time()
                await asyncio.wait_for(asyncio.shield(tasks[1]), limit)
                settle = time.time() + 10 * period
                while min(await asyncio.gather(*(tip(i) for i in range(n)))) \
                        < target:
                    if time.time() > settle:
                        fail(f"beacon live: tips "
                             f"{await asyncio.gather(*(tip(i) for i in range(n)))}"
                             f" short of round {target}")
                    await asyncio.sleep(0.2)
            finally:
                for task in tasks:
                    task.cancel()
                await asyncio.gather(*tasks, return_exceptions=True)
                await peers.close()
        try:
            asyncio.run(watch())
        except asyncio.TimeoutError:
            fail(f"beacon live: node 1 did not reach round {target}: "
                 f"{sorted(arrivals[1])}")
    finally:
        for sp in shares:
            if sp.poll() is None:
                sp.kill()
                sp.communicate()
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                rcs.append(p.wait(timeout=60))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                rcs.append("killed")
    if rcs != [0] * n:
        fail(f"beacon live: exit codes on SIGTERM {rcs}")
    records, statuses = [], []
    for i in range(n):
        recs, st = [], None
        with open(outs[i]) as f:
            for line in f:
                if line.startswith('{"dispatch"'):
                    recs.append(json.loads(line)["dispatch"])
                elif line.startswith('{"dkg"'):
                    st = json.loads(line)["dkg"]
        records.append(recs)
        statuses.append(st)
        with open(errs[i]) as f:
            err = f.read()
        if "partial-verify backend error" in err:
            fail(f"beacon live: a card call of node {i} raised "
                 "(partial-verify backend error in its stderr)")
        if st is None or st["state"] != "done" or \
                st["qual"] != list(range(n)) or \
                [(p["phase"], p["outcome"]) for p in st["phases"]] != \
                [("deal", "complete"), ("response", "complete")]:
            fail(f"dkg ceremony: node {i}'s ceremony {st}")
        deal_checks = [r for r in recs if r["seam"] == "dkg_deals"]
        if not deal_checks or any(r["n"] != n for r in deal_checks):
            fail(f"dkg ceremony: node {i}'s card deal checks {deal_checks}")
    rows = [beacon_rows(f) for f in folders]
    if any(r[:target + 1] != rows[0][:target + 1] for r in rows) or \
            [r for r, _ in rows[0][:target + 1]] != list(range(target + 1)):
        fail(f"beacon live: the 16 stores differ in rounds 0-{target}: "
             f"tips {[r[-1][0] for r in rows]}")
    stored = [decode_beacon(data) for _, data in rows[0][:target + 1]]
    cv = ChainVerifier(scheme_by_id(group.scheme_id), key)
    if stored[0].signature != group.genesis_seed or not \
            cv.verify_chain_segment(stored[1:], group.genesis_seed).all():
        fail("beacon live: the chain does not verify against the DKG's "
             "group key")
    card = [r for r in records[0] if r["seam"] == "partials"]
    t_from = time_of_round(period, genesis, 2)
    t_to = time_of_round(period, genesis, target) + period
    if not any(t_from <= c["wall"] - c["device_s"] < t_to for c in card):
        fail(f"beacon live: node 0 made no card call in rounds 2-{target}")
    table = []
    for r in range(1, target + 1):
        t_r = time_of_round(period, genesis, r)
        # a record is stamped when its call returns: a call belongs to
        # the round in whose period it started
        calls = [c for c in card
                 if t_r <= c["wall"] - c["device_s"] < t_r + period]
        late = {i: (arrivals[i][r] - t_r if r in arrivals[i] else None)
                for i in (0, 1)}
        table.append({"round": r, "node0_late_s": late[0],
                      "node1_late_s": late[1], "node0_calls": len(calls),
                      "node0_sizes": [c["n"] for c in calls],
                      "node0_walls_s": [c["device_s"] for c in calls],
                      "node0_starts_s": [c["wall"] - c["device_s"] - t_r
                                         for c in calls]})
    deal_walls = [[r["device_s"] for r in recs if r["seam"] == "dkg_deals"]
                  for recs in records]
    ceremony = {
        "phase": "dkg", "part": "ceremony", "n": n, "t": t,
        "timeout_s": DKG_TIMEOUT, "period_s": period,
        "keypairs_s": keys_s, "nodes_serving_after_s": up_s,
        "share_walls_s": share_walls, "genesis_after_share_s":
            genesis - t_share, "genesis_wait_s": genesis - done_at,
        "group_hash": group.hash().hex(), "group_key": key.hex(),
        "groups_byte_equal": True, "dist_keys_byte_equal": True,
        "shares_give_group_key": True, "qual_all": True,
        "phases": [[p["duration_s"] for p in st["phases"]]
                   for st in statuses],
        "card_deal_checks": [len(w) for w in deal_walls],
        "card_deal_check_walls_s": deal_walls}
    live = {
        "phase": "beacon", "part": "live", "n": n, "t": t,
        "period_s": period, "group": "the dkg ceremony's",
        "exit_codes_all_zero": True, "target": target,
        "tips": [r[-1][0] for r in rows], "stores_byte_equal_to_target": True,
        "chain_verifies_against_dkg_key": True,
        "node0_partials_records": len(card),
        "nodes_partials_records": [sum(r["seam"] == "partials" for r in recs)
                                   for recs in records],
        "node0_other_records": collections.Counter(
            r["seam"] for r in records[0] if r["seam"] != "partials"),
        "table": table}
    return ceremony, live


def dkg_phase(work_dir):
    """The `dkg` phase: (a) the batched check at n = 128, t = 65, (b) the
    faulty dealer's ceremony in this process, (c) the ceremony through
    the CLI and the chain from its group (the beacon phase's live part).
    Returns (the reports, the calls by kernel of (a)'s and (b)'s driven
    runs)."""
    t0 = time.perf_counter()
    wide, wide_calls = dkg_wide()
    wide["part_s"] = time.perf_counter() - t0
    emit(wide)
    t0 = time.perf_counter()
    faulty, faulty_calls = dkg_faulty()
    faulty["part_s"] = time.perf_counter() - t0
    emit(faulty)
    t0 = time.perf_counter()
    ceremony, live = dkg_live(work_dir)
    ceremony["part_s"] = time.perf_counter() - t0
    emit(ceremony)
    emit({k: v for k, v in live.items() if k != "table"})
    for row in live["table"]:
        emit({"phase": "beacon", "part": "live round", **row})
    return {"wide": wide, "faulty": faulty, "ceremony": ceremony,
            "live": live}, wide_calls + faulty_calls


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
    # the native host tier's g++ build runs beside the kernels' nvcc
    from drand_tpu_torch import native as NT
    native_build = {}

    def build_native():
        try:
            native_build["info"] = NT.build_info()
        except Exception as exc:
            native_build["error"] = f"{type(exc).__name__}: {exc}"
    native_thread = threading.Thread(target=build_native)
    native_thread.start()
    info = K.build()
    native_thread.join()
    if "error" in native_build:
        fail(f"native tier build: {native_build['error']}")
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
        "device_kernels_note": DEVICE_KERNELS_NOTE,
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
        "device_kernels_note": DEVICE_KERNELS_NOTE,
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
        "device_kernels_note": DEVICE_KERNELS_NOTE,
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
        emit(report["recovery"])

        # -- partials --------------------------------------------------------
        report["partials"], partials_calls, pctx = partials_phase(
            default_path)
        emit(report["partials"])

        # -- native ----------------------------------------------------------
        report["native"], native_calls = native_phase(
            native_build["info"], default_path, sigs, sigs_c, pk_bytes, seed,
            sigs1, pk2, verifier1, pctx)
        emit(report["native"])

        # -- catchup ---------------------------------------------------------
        report["catchup"], catchup_calls = catchup_phase(
            rec_dir, default_path, launches, pk_bytes, seed)
        emit(report["catchup"])

        # -- follow ----------------------------------------------------------
        at_bucket = {BATCH: launches}

        def bucket_launches(b):
            """What one unchained batch at bucket b launches."""
            if b not in at_bucket:
                _, _, counts, calls, _ = drive(lambda: verifier.verify_batch(
                    rounds[:b], sigs[:b]))
                follow_refs.append(calls)
                at_bucket[b] = counts
            return at_bucket[b]
        follow_refs = []
        report["follow"], follow_calls = follow_phase(
            rec_dir, default_path, launches, chain_launches, bucket_launches,
            pk_bytes, seed, sigs_c)
        follow_calls += follow_refs
        emit(report["follow"])
    finally:
        shutil.rmtree(rec_dir, ignore_errors=True)

    # -- beacon, dkg ---------------------------------------------------------
    beacon_dir = tempfile.mkdtemp(prefix="beacon-",
                                  dir=os.path.join(HERE, "build"))
    try:
        report["beacon"], beacon_calls = beacon_phase(
            beacon_dir, default_path, report["partials"]["launches"]["burst"])
        report["dkg"], dkg_calls = dkg_phase(beacon_dir)
    finally:
        shutil.rmtree(beacon_dir, ignore_errors=True)

    # every call the runs made, for the parity phase
    all_calls = {name: set(path_calls[name]) | set(chain_calls[name])
                 | set(trio_calls[name]) | set(pairing_calls[name])
                 | set(g1_calls[name]) | set(g1_trio_calls[name])
                 | set().union(*(c[name] for c in recovery_calls))
                 | set().union(*(c[name] for c in partials_calls))
                 | set().union(*(c[name] for c in native_calls))
                 | set().union(*(c[name] for c in catchup_calls))
                 | set().union(*(c[name] for c in follow_calls))
                 | set().union(*(c[name] for c in beacon_calls))
                 | set().union(*(c[name] for c in dkg_calls))
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
    beacon_rows_ = [r for r in rows
                    if any(r["call"] in c[r["kernel"]] for c in beacon_calls)]
    report["beacon_parity"] = {
        "phase": "beacon", "part": "parity", "checks": len(beacon_rows_),
        "kernels": sorted({r["kernel"] for r in beacon_rows_}),
        "all_bit_equal": all(r["bit_equal"] for r in beacon_rows_)}
    emit(report["beacon_parity"])
    dkg_rows = [r for r in rows
                if any(r["call"] in c[r["kernel"]] for c in dkg_calls)]
    if {r["kernel"] for r in dkg_rows} != set(DKG_PATH):
        fail(f"dkg: parity checks at its calls cover "
             f"{sorted({r['kernel'] for r in dkg_rows})}")
    report["dkg_parity"] = {
        "phase": "dkg", "part": "parity", "checks": len(dkg_rows),
        "kernels": sorted({r["kernel"] for r in dkg_rows}),
        "calls": sorted({str(r["call"]) for r in dkg_rows}),
        "all_bit_equal": all(r["bit_equal"] for r in dkg_rows)}
    emit(report["dkg_parity"])
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
