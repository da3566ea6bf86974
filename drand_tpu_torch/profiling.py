"""Where the time of one verify batch goes on the GPU.

    python -m drand_tpu_torch.profiling [--rounds 8 16384]
        [--miller-merged 0|1]

For each batch size, on the committed unchained fixture (rounds from 1),
through Verifier.verify_batch_async (--miller-merged 1, the default) or
with drand_tpu's trio Miller executor (--miller-merged 0,
`trio_batch_async`):

  wall_s       one unprofiled batch, host clock, ending in a synchronize
  issue_s      the part of it the host spent issuing the batch
               (`verify_batch_async` returning)
  kernels      device kernels launched by one batch (torch.profiler)
  busy_s       the sum of their device durations: one stream, so this is
               the time the card was busy
  idle_share   1 - busy_s / wall_s
  ours         launches and busy seconds of the port's own CUDA kernels
  top          the kernels with the most device time

The profiled batch runs several times slower than the unprofiled one, so
only its kernel durations and counts are read, never its wall time.  One
JSON line per batch size; the same goes to
chiprun_out/profile_verify_m<merged>.json.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from drand_tpu_torch.verify import bucket

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "aot" / "fixtures" / "bench_sigs_unchained_16384_d6a762f2_ff8a2cc7.npy"
OURS = ("k_mont_mul", "k_mont_sqr", "k_mont_reduce", "k_fp_pow_chain",
        "k_fp2_products", "k_fp2_sqrs", "k_fp2_sqr_chain_mul",
        "k_g2_point_dbl", "k_g2_point_add", "k_miller_iter", "k_flat_mul",
        "k_cyclo_sqr", "k_flat_conj", "k_flat_frob", "k_flat_sqr",
        "k_g2_dbl_line", "k_g2_add_line", "k_line_merge", "k_add_sub")


def device_kernels(prof):
    """(name, duration in seconds) of every device kernel in a trace."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name()
        if name.startswith(("Memcpy", "Memset")):
            continue
        out.append((name, e.duration_ns() * 1e-9))
    return out


def trio_batch_async(verifier, rounds, sigs: np.ndarray, prev_sigs=None):
    """`verifier.verify_batch_async` with drand_tpu's trio Miller executor:
    the same digests and checks through ops/bls.py verify_g2_sigs with
    merged=False, for a batch whose size is a bucket (not padded)."""
    from drand_tpu_torch.ops import bls as BLS
    from drand_tpu_torch.ops.sha256 import sha256
    msgs = verifier.messages(np.asarray(rounds, dtype=np.uint64), prev_sigs)
    if msgs.shape[0] != bucket(msgs.shape[0]):
        raise ValueError(f"{msgs.shape[0]} rounds: not a bucket size")
    d = verifier.device
    ok = BLS.verify_g2_sigs(
        sha256(torch.from_numpy(np.ascontiguousarray(msgs)).to(d)),
        torch.from_numpy(np.ascontiguousarray(sigs, dtype=np.uint8)).to(d),
        verifier.pk_limbs, verifier.shape.dst, merged=False)
    return lambda: ok.cpu().numpy()


def profile_batch(issue, sigs: np.ndarray) -> dict:
    """issue(rounds, sigs) queues a batch and returns its resolver."""
    from torch.profiler import ProfilerActivity, profile
    n = sigs.shape[0]
    rounds = np.arange(1, n + 1, dtype=np.uint64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resolve = issue(rounds, sigs)
    issue_s = time.perf_counter() - t0
    ok = resolve()
    wall = time.perf_counter() - t0
    if not ok.all():
        raise RuntimeError(f"{n} rounds: {int(ok.sum())} true")

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        issue(rounds, sigs)()
        torch.cuda.synchronize()
    kern = device_kernels(prof)
    busy = sum(d for _, d in kern)
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for name, d in kern:
        by_name[name][0] += 1
        by_name[name][1] += d
    ours = {k: v for k, v in by_name.items()
            if any(f"{o}(" in k or f"{o}<" in k for o in OURS)}
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    return {"rounds": n, "wall_s": wall, "issue_s": issue_s,
            "kernels": len(kern), "busy_s": busy,
            "idle_share": 1.0 - busy / wall,
            "ours": {k[:80]: v for k, v in ours.items()},
            "top": [(k[:120], c, s) for k, (c, s) in top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, nargs="+", default=[8, 16384])
    ap.add_argument("--miller-merged", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiling: needs a CUDA device", file=sys.stderr)
        return 2
    from drand_tpu_torch import fixtures as FX
    from drand_tpu_torch import verify as V
    from drand_tpu_torch.ops import kernels as K

    K.build()
    _, pk = FX.fixture_keypair()
    sigs = np.load(FIXTURE)
    verifier = V.Verifier(pk, V.SHAPE_UNCHAINED)
    if args.miller_merged:
        issue = verifier.verify_batch_async
    else:
        def issue(rounds, sigs):
            return trio_batch_async(verifier, rounds, sigs)
    issue(np.arange(1, 9, dtype=np.uint64), sigs[:8])()         # warm-up
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    rows = []
    for n in args.rounds:
        row = profile_batch(issue, sigs[:n])
        row["card"] = card
        row["miller_merged"] = args.miller_merged
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = ROOT / "chiprun_out"
    os.makedirs(out, exist_ok=True)
    name = f"profile_verify_m{args.miller_merged}.json"
    (out / name).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
