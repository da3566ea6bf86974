"""CUDA-event times of the split-step kernels, or batch walls, on one GPU.

    python -m drand_tpu_torch.kernel_bench [--walls N]

Without --walls: the registers and spill of K9, K11 and K12 (`-Xptxas -v`
in the build log), then K9 at n = 1, 2, 3, 9, 16, 32, K11 and K12 on
16384 rows, each held bit for bit against its plain version (exit 1
otherwise) and timed as the mean ms of 40 back-to-back launches between
two CUDA events.  With --walls N: N default 16384-round batches of the
committed unchained fixture after two warm-up batches, each timed on the
host clock up to its verdicts on the host.

It imports drand_tpu_torch from the current directory, so two trees are
compared on one card by running this file from each tree's root in turn
(`cd <tree> && python3 <this file> --walls 8`).  One JSON line; needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROUNDS = 16384
FIXTURE = "aot/fixtures/bench_sigs_unchained_16384_d6a762f2_ff8a2cc7.npy"


def _event_ms(fn, reps: int = 40) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernels(dev) -> dict:
    from drand_tpu_torch.ops import curve as C
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops import pairing as PR
    from drand_tpu_torch.ops.field import FP
    log = K.build()["log"].splitlines()
    ptxas = {}
    names = ("k_g2_point_dbl", "k_miller_iterILb0", "k_miller_iterILb1")
    for i, line in enumerate(log):
        for name in names:
            if "Function properties" in line and name in line:
                ptxas[name] = " ".join(x.strip() for x in log[i + 1:i + 3])
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
    ms = {}
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
    return {"ptxas": ptxas, "ms": ms}


def walls(n: int) -> list:
    from drand_tpu_torch import fixtures as FX
    from drand_tpu_torch import verify as V
    _sk, pk = FX.fixture_keypair()
    verifier = V.Verifier(pk, V.SHAPE_UNCHAINED)
    sigs = np.load(FIXTURE)
    rounds = np.arange(1, ROUNDS + 1, dtype=np.uint64)
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
    args = ap.parse_args()
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
