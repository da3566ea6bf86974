"""CUDA-event times of the split-step kernels, or batch walls, on one GPU.

    python -m drand_tpu_torch.kernel_bench [--walls N | --sass LIB...]

Without --walls: the registers, stack frame and spill of K1, K4, K5, K6,
K7, K9, K10, K11, K12, K13 (each instance), K14-K20
(`-Xptxas -v` in the build log) and the SASS instructions of every kernel
in the library (`cuobjdump -sass`, null without it), then K1 on [16384, 32] x 2
(its path call), K4 on one Fermat inversion a^(p-2) of [16384, 32] (the
path's call: one launch) and at the single step k = 13 with t, K5 on [1,
2, 2, 16384, 32] (n = 1, the path's most common call), K6 on [n, 2,
16384, 32] at n = 1 (its most common call) and n = 8, K15 on [16384, 12,
32] and [4224, 12, 32], K16 on [16384, 12, 32] at n = 1, 2, 3 (the
path's calls), K17 on [16384, 12, 32], K18 on [2, 16384, 8, 32] and K19
on [2, 16384, 12, 32] (the trio path's calls), K13 on
16384 rows dense and on LINE_IDX and on 4224 rows dense
(one 32-row block a SM), K9 at n = 1, 2, 3, 9, 16, 32, K10 without and
with the doubling, K11 and K12 on 16384 rows, and K7 on [2, 16384] at
k = 6 and at the longest k of the calls one default batch makes
(`Kernel.calls`), each with t, each held bit for bit against its plain
version (exit 1 otherwise) and timed as the mean ms of 40 back-to-back
launches between two CUDA events, queued behind a device sleep so that
the host's issue time between launches does not count.
With --sass LIB...: the SASS instructions of every kernel in each built
library, so two trees' builds are compared kernel by kernel.
With --walls N: N default 16384-round batches of the committed unchained
fixture after two warm-up batches, each timed on the host clock up to
its verdicts on the host.

It imports drand_tpu_torch from the current directory, so two trees are
compared on one card by running this file from each tree's root in turn
(`cd <tree> && python3 <this file> --walls 8`).  One JSON line; needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROUNDS = 16384
# the kernels whose registers, spill and code size are reported, as their
# names show in ptxas's and cuobjdump's output
KERNEL_NAMES = ("k_mont_mul", "k_fp_pow_chain", "k_fp2_products",
                "k_fp2_sqrs", "k_fp2_sqr_chain_mul", "k_flat_mul",
                "k_g2_point_dbl", "k_g2_point_add", "k_miller_iterILb0",
                "k_miller_iterILb1", "k_cyclo_sqr", "k_flat_conj",
                "k_flat_frob", "k_flat_sqr", "k_g2_dbl_line",
                "k_g2_add_line", "k_line_merge")


def _kernel_name(mangled: str):
    """The KERNEL_NAMES entry of a mangled kernel name (K13's instances
    with their pattern of b), or None."""
    name = next((k for k in KERNEL_NAMES if k in mangled), None)
    m = re.search(r"FlatBE(\d)E", mangled)
    if name == "k_flat_mul" and m:
        name += ("<DENSE>", "<ANY>")[int(m.group(1))]
    return name


def _any_kernel_name(mangled: str) -> str:
    """_kernel_name, or for a kernel outside KERNEL_NAMES its own name
    from the mangled one (a template instance with its first argument:
    k_add_sub<Lb1E>)."""
    name = _kernel_name(mangled)
    if name:
        return name
    for m in re.finditer("k_", mangled):
        i = m.start()
        for d in (1, 2):                  # the name's length, before it
            if not mangled[i - d:i].isdigit():
                break
            end = i + int(mangled[i - d:i])
            if (mangled[end:end + 1] in ("E", "I")
                    and re.fullmatch(r"k_[a-z0-9_]+", mangled[i:end])):
                arg = re.match(r"I(L\w+?E)", mangled[end:])
                return mangled[i:end] + (f"<{arg.group(1)}>" if arg else "")
    return mangled


def ptxas_stats(log: str) -> dict:
    """Per KERNEL_NAMES kernel of a build log (`-Xptxas -v`): its two
    ptxas lines, and from them its registers, stack frame and spill store
    and load bytes."""
    lines, out = log.splitlines(), {}
    fields = (("stack_bytes", r"(\d+) bytes stack frame"),
              ("spill_stores", r"(\d+) bytes spill stores"),
              ("spill_loads", r"(\d+) bytes spill loads"),
              ("registers", r"Used (\d+) registers"))
    for i, line in enumerate(lines):
        name = "Function properties" in line and _kernel_name(line)
        if name:
            text = " ".join(x.strip() for x in lines[i + 1:i + 3])
            out[name] = {"ptxas": text}
            for key, pat in fields:
                m = re.search(pat, text)
                if m:
                    out[name][key] = int(m.group(1))
    return out


FIXTURE = "aot/fixtures/bench_sigs_unchained_16384_d6a762f2_ff8a2cc7.npy"


def _event_ms(fn, reps: int = 40) -> float:
    """Mean device ms of `reps` back-to-back calls: a device sleep goes
    first, so every launch is queued before the start event runs and the
    host's issue time between launches does not count."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)           # ~25 ms at the boost clock
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _sass_sizes(lib: Path) -> dict | None:
    """SASS instructions of every kernel in the built library
    (`cuobjdump -sass`), or None where the toolkit has no cuobjdump."""
    tool = Path("/usr/local/cuda/bin/cuobjdump")
    if not tool.exists():
        return None
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    sizes, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            mangled = line.split("Function :")[1].strip()
            name = _any_kernel_name(mangled)
            sizes[name] = 0
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/ ", line):
            sizes[name] += 1
    return sizes


def _verifier():
    from drand_tpu_torch import fixtures as FX
    from drand_tpu_torch import verify as V
    _sk, pk = FX.fixture_keypair()
    return (V.Verifier(pk, V.SHAPE_UNCHAINED), np.load(FIXTURE),
            np.arange(1, ROUNDS + 1, dtype=np.uint64))


def kernels(dev) -> dict:
    from drand_tpu_torch.ops import curve as C
    from drand_tpu_torch.ops import flat12 as FL
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops import pairing as PR
    from drand_tpu_torch.ops import towers as TW
    from drand_tpu_torch.ops.field import FP, addchain_plan
    # the build's nvcc log, also when an earlier process built the library
    ptxas = ptxas_stats((Path(K.build()["dir"]) / "nvcc.log").read_text())
    rng = np.random.default_rng(1)

    def rows(shape):
        limbs = rng.integers(0, 4096, size=(int(np.prod(shape)), 32),
                             dtype=np.int32)
        limbs[:, 31] &= 0x7F                     # below 2^379 < p
        return torch.from_numpy(limbs.reshape(shape + (32,))).to(dev)

    p = rows((6, ROUNDS))
    p[4:, :8] = 0                                # infinite rows
    f, T, P = rows((ROUNDS, 12)), rows((ROUNDS, 2, 6)), rows((ROUNDS, 2, 2))
    Q = rows((ROUNDS, 2, 4))
    masks = torch.from_numpy(rng.integers(0, 2, size=(ROUNDS, 2),
                                          dtype=np.int32)).to(dev)
    # the K7 chains one default batch runs
    verifier, sigs, rounds = _verifier()
    K.reset_launches()
    verifier.verify_batch(rounds, sigs)
    longest = max(k for _s, k, _t in K.KERNELS["fp2_sqr_chain_mul"].calls)
    x, t = rows((2, ROUNDS)), rows((2, ROUNDS))
    q = rows((6, ROUNDS))
    q[:, :64] = p[:, :64]                        # P + P
    q[4:, 64:72] = 0                             # P + infinity
    ms = {}
    # K1 at its path call, K4 on one inversion (one launch) and one step
    a, b = rows((ROUNDS,)), rows((ROUNDS,))
    if not torch.equal(K.mont_mul(a, b, FP), FP._mont_mul_plain(a, b)):
        sys.exit("mont_mul: kernel != plain")
    ms["mont_mul"] = _event_ms(lambda: K.mont_mul(a, b, FP))
    plan = addchain_plan(FP.modulus - 2)
    ops, build, used_odd = plan[0], plan[1], plan[4]
    if not torch.equal(FP._pow_addchain(a, ops, build, used_odd),
                       FP._pow_addchain_plain(a, ops, build, used_odd)):
        sys.exit("sqr_chain_mul p-2 chain: kernel != plain")
    ms["sqr_chain_mul inv"] = _event_ms(
        lambda: FP._pow_addchain(a, ops, build, used_odd), 10)
    if not torch.equal(K.sqr_chain_mul(a, 13, b, FP),
                       FP._sqr_chain_mul_plain(a, 13, b)):
        sys.exit("sqr_chain_mul k=13: kernel != plain")
    ms["sqr_chain_mul k=13"] = _event_ms(lambda: K.sqr_chain_mul(a, 13, b, FP))
    # K5's most common call: one pair, coordinates [2, 16384, 32]
    xs, ys = rows((1, 2, 2, ROUNDS)), rows((1, 2, 2, ROUNDS))
    want = TW._fp2_stack(TW._fp2_products_plain(list(zip(
        TW._fp2_unstack(xs), TW._fp2_unstack(ys)))))
    if not torch.equal(K.fp2_products(xs, ys, FP), want):
        sys.exit("fp2_products n=1: kernel != plain")
    ms["fp2_products n=1"] = _event_ms(lambda: K.fp2_products(xs, ys, FP))
    # K6 at the path's most common call (n = 1) and its longest (n = 8)
    for n in (1, 8):
        xs = rows((n, 2, ROUNDS))
        want = TW._fp2_stack(TW._fp2_sqrs_plain(TW._fp2_unstack(xs)))
        if not torch.equal(K.fp2_sqrs(xs, FP), want):
            sys.exit(f"fp2_sqrs n={n}: kernel != plain")
        ms[f"fp2_sqrs n={n}"] = _event_ms(lambda: K.fp2_sqrs(xs, FP))
    # K15 at the path's call, and on 4224 rows (its launch and ramp)
    for n_rows in (ROUNDS, 4224):
        if not torch.equal(K.flat_conj(f[:n_rows], FP),
                           FL._flat_conj_plain(f[:n_rows])):
            sys.exit(f"flat_conj {n_rows} rows: kernel != plain")
        ms[f"flat_conj {n_rows} rows"] = _event_ms(
            lambda: K.flat_conj(f[:n_rows], FP))
    # K16 at the path's calls (n = 2 twice a batch, n = 1 once) and n = 3
    for n in (1, 2, 3):
        if not torch.equal(K.flat_frob(f, n, FL._FROB_WORDS[n], FP),
                           FL._flat_frob_plain(f, n)):
            sys.exit(f"flat_frob n={n}: kernel != plain")
        ms[f"flat_frob n={n}"] = _event_ms(
            lambda: K.flat_frob(f, n, FL._FROB_WORDS[n], FP))
    # K17 at the trio path's call
    if not torch.equal(K.flat_sqr(f, FP), FL._flat_sqr_plain(f)):
        sys.exit("flat_sqr: kernel != plain")
    ms["flat_sqr"] = _event_ms(lambda: K.flat_sqr(f, FP))
    # K18 and K19 at the trio path's calls: two pairs stacked on 16384 rows
    # each
    for name, width in (("g2_dbl_line", 8), ("g2_add_line", 12)):
        xl = rows((2, ROUNDS, width))
        xl[:, :8, 4] = FP.one_mont.to(dev)                # Z = 1
        xl[:, :8, 5] = 0
        c = [xl[..., i, :] for i in range(width)]
        Tj = ((c[0], c[1]), (c[2], c[3]), (c[4], c[5]))
        Tn, L = (PR._dbl_step_plain(Tj, c[6], c[7]) if width == 8 else
                 PR._add_step_plain(Tj, ((c[6], c[7]), (c[8], c[9])), c[10],
                                    c[11]))
        got = getattr(K, name)(xl, FP)
        if not all(torch.equal(g, torch.stack([v for xy in w for v in xy],
                                              -2))
                   for g, w in zip(got, (Tn, L))):
            sys.exit(f"{name}: kernel != plain")
        ms[name] = _event_ms(lambda: getattr(K, name)(xl, FP))
    b_dense = rows((ROUNDS, 12))
    for what, b_idx in (("dense", tuple(range(12))), ("line", FL.LINE_IDX)):
        b = b_dense if what == "dense" else rows((ROUNDS, len(b_idx)))
        if not torch.equal(K.flat_mul(f, b, b_idx, FP),
                           FL._flat_mul_plain(f, b, b_idx)):
            sys.exit(f"flat_mul {what}: kernel != plain")
        ms[f"flat_mul {what}"] = _event_ms(
            lambda: K.flat_mul(f, b, b_idx, FP))
    # one 32-row block a SM: the latency of a block, against the full
    # batch's four blocks a SM
    ms["flat_mul dense 4224 rows"] = _event_ms(
        lambda: K.flat_mul(f[:4224], b_dense[:4224], tuple(range(12)), FP))
    for k in sorted({6, longest}):
        if not torch.equal(K.fp2_sqr_chain_mul(x, k, t, FP),
                           TW._fp2_sqr_chain_mul_plain(x, k, t)):
            sys.exit(f"fp2_sqr_chain_mul k={k}: kernel != plain")
        ms[f"fp2_sqr_chain_mul k={k}"] = _event_ms(
            lambda: K.fp2_sqr_chain_mul(x, k, t, FP))
    for with_double in (False, True):
        want = C.g2_pack(C._point_add_formula(
            C.g2_unpack(p), C.g2_unpack(q), C.Fp2PlainOps, with_double))
        if not torch.equal(K.g2_point_add(p, q, with_double, FP), want):
            sys.exit(f"g2_point_add with_double={with_double}: "
                     f"kernel != plain")
        ms[f"g2_point_add with_double={with_double}"] = _event_ms(
            lambda: K.g2_point_add(p, q, with_double, FP))
    for n in (1, 2, 3, 9, 16, 32):
        if not torch.equal(K.g2_point_dbl(p, FP, n),
                           C._g2_point_dbl_plain(p, n)):
            sys.exit(f"g2_point_dbl n={n}: kernel != plain")
        ms[f"g2_point_dbl n={n}"] = _event_ms(
            lambda: K.g2_point_dbl(p, FP, n))
    for name, args in (("miller_dbl_iter", (f, T, P, masks)),
                       ("miller_add_iter", (f, T, Q, P, masks))):
        got = getattr(K, name)(*args, FP)
        want = getattr(PR, f"_{name}_plain")(*args)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            sys.exit(f"{name}: kernel != plain")
        ms[name] = _event_ms(lambda: getattr(K, name)(*args, FP))
    sass = _sass_sizes(Path(K.build()["dir"]) / K.LIB_NAME)
    return {"ptxas": ptxas, "ms": ms, "sass_instructions": sass}


def walls(n: int) -> list:
    verifier, sigs, rounds = _verifier()
    out = []
    for i in range(n + 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = verifier.verify_batch(rounds, sigs)
        if i >= 2:
            out.append(time.perf_counter() - t0)
        if not ok.all():
            sys.exit(f"batch {i}: {int(ok.sum())}/{ROUNDS} true")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--walls", type=int, default=0,
                    help="time this many batches instead of the kernels")
    ap.add_argument("--sass", nargs="+", metavar="LIB",
                    help="only count the SASS instructions of every kernel "
                         "in these built libraries (no device needed)")
    args = ap.parse_args()
    if args.sass:
        print(json.dumps({"sass_instructions": {
            lib: _sass_sizes(Path(lib)) for lib in args.sass}}), flush=True)
        return 0
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    dev = torch.device("cuda", 0)
    out = {"tree": os.path.basename(os.getcwd()),
           "device": torch.cuda.get_device_name(0)}
    if args.walls:
        out["walls_s"] = walls(args.walls)
    else:
        out.update(kernels(dev))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
