"""Threshold crypto of the live beacon path: partial signature
verification and Lagrange recovery, on the host or batched on the GPU.

Counterpart of `drand_tpu/beacon/crypto_backend.py`'s `HostBackend`,
`DeviceBackend`, `AsyncPartialVerifier` and `run_in_crypto_thread`.  A
drand node checks each incoming partial signature (two pairings) and, at
threshold, recovers the round's group signature:

  - `HostBackend`: one partial at a time through the native C++ tier
    (`drand_tpu_torch/native`, `verify_partial`), recovery through
    `_native_recover` (the t-point G2 combination in C);
  - `DeviceBackend.verify_partials`: one batch of partials in arrival
    order on the backend's device; each distinct message hashes to G2
    once (`dedup_messages`) and each signer's key is gathered from the
    signer-key table (`beacon/signer_table.py`), or, when an index lies
    outside the table, evaluated in the batch (`ops/bls.py`
    `pubpoly_eval_g1`);
  - `DeviceBackend.verify_partials_rounds`: rounds-major, one digest
    and S partials a round, hash-to-curve once a round;
  - `DeviceBackend.recover_rounds`: the [rounds, t] multi-scalar
    multiplication of the Lagrange recovery, a 256-bit per-row ladder
    (`ops/curve.py` `point_mul_bits`) and a tree sum; `recover` of one
    round tries `_native_recover` first, as the reference does, and runs
    the same multiplication on t rows when that gives nothing;
  - `AsyncPartialVerifier`: coalesces the partials that arrive within one
    window into one `verify_partials` call, run in a worker thread.

`make_backend(pub_poly, threshold, n, device)` picks the backend of a
beacon engine from the device it is given, through `device.resolve`: a
CUDA device gives `DeviceBackend` on it, "cpu" `HostBackend` (drand_tpu
picks by its environment and JAX's backend; the port reads no
environment, and with no CUDA and no device named it raises).  There is
no golden-model verify (a native library that cannot be built raises),
no compiled-program cache or mesh sharding, and no metrics.  Each batched device call records one dispatch
(`dispatch.py`): "partials" for `verify_partials`, "rounds" for
`verify_partials_rounds`; each native check records a "native" one.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import logging
from typing import Sequence

import numpy as np
import torch

from drand_tpu_torch import native
from drand_tpu_torch.beacon.signer_table import SignerKeyTable
from drand_tpu_torch.crypto import tbls
from drand_tpu_torch.crypto.bls12381 import curve as GC
from drand_tpu_torch.crypto.bls12381.constants import DST_G2
from drand_tpu_torch.crypto.poly import _lagrange_basis_at_zero
from drand_tpu_torch.device import resolve
from drand_tpu_torch.dispatch import timed_dispatch
from drand_tpu_torch.ops import bls as BLS
from drand_tpu_torch.ops import curve as DC
from drand_tpu_torch.ops import towers as T

log = logging.getLogger("drand_tpu_torch.beacon")

# One worker: device work serializes anyway, and one thread keeps the
# batches off the event loop.
_EXECUTOR = concurrent.futures.ThreadPoolExecutor(
    max_workers=1, thread_name_prefix="drand-crypto")


def dedup_messages(msgs: Sequence[bytes]):
    """First-seen-order message dedup: -> (unique list, per-item map)."""
    seen: dict[bytes, int] = {}
    mmap = []
    for m in msgs:
        mmap.append(seen.setdefault(m, len(seen)))
    return list(seen), mmap


def _threshold_points(partials: Sequence[bytes], threshold: int, n: int,
                      skip=(), what: str = ""):
    """The first t distinct in-group signers of `partials` in arrival
    order: (their indices sorted, {index: signature}, {index: its
    Lagrange basis at 0}); ValueError (led by `what`) when fewer than t.
    A partial whose parse raises one of `skip` is passed over (any other
    error propagates)."""
    pts: dict = {}
    for p in partials:
        try:
            idx, sig = tbls.index_of(p), bytes(tbls.sig_of(p))
        except skip:
            continue
        if idx < n and idx not in pts:
            pts[idx] = sig
        if len(pts) >= threshold:
            break
    if len(pts) < threshold:
        raise ValueError(f"{what}not enough partials: "
                         f"{len(pts)}/{threshold}")
    indices = sorted(pts)[:threshold]
    return indices, pts, _lagrange_basis_at_zero(indices)


def _native_recover(partials: Sequence[bytes], threshold: int,
                    n: int) -> bytes | None:
    """Threshold recovery through the native tier: the Lagrange basis on
    the host (Python ints), the t-point G2 linear combination in C, over
    the first t distinct in-group indices.  None when too few partials
    parse or the combination rejects one (a malformed point, an infinity
    result); a library that cannot be built raises."""
    try:
        indices, pts, basis = _threshold_points(partials, threshold, n,
                                                skip=Exception)
    except ValueError:
        return None     # too few partials parse
    return native.g2_lincomb([pts[i] for i in indices],
                             [basis[i].to_bytes(32, "big") for i in indices])


class HostBackend:
    """Threshold crypto for one group on the host, through the native
    tier: each partial one native check against the commitments (the
    library evaluates the public polynomial at the partial's index), and
    recovery through `_native_recover`, then, where that gives nothing,
    `tbls.recover` of the partials taken as verified, which drand_tpu's
    host backend falls back to.
    A partial that is not bytes-like raises TypeError, as in drand_tpu's
    host backend."""

    name = "host"

    def __init__(self, pub_poly, threshold: int, n: int):
        self.update_group(pub_poly, threshold, n)

    def update_group(self, pub_poly, threshold: int, n: int) -> None:
        """A reshare or group transition: new key material."""
        self.pub_poly = pub_poly
        self.threshold = threshold
        self.n = n
        self._commits48 = [GC.g1_to_bytes(c) for c in pub_poly.commits]

    def verify_partials(self, msgs: Sequence[bytes],
                        partials: Sequence[bytes]) -> list[bool]:
        """Verdicts of partials[i] on msgs[i], one native check each."""
        return [native.verify_partial(self._commits48, m, p, DST_G2)
                for m, p in zip(msgs, partials)]

    def recover(self, msg: bytes, partials: Sequence[bytes]) -> bytes:
        out = _native_recover(partials, self.threshold, self.n)
        if out is not None:
            return out
        return tbls.recover(self.pub_poly, msg, partials, self.threshold,
                            self.n, verified=True)


def _pad(k: int, buckets) -> int:
    for b in buckets:
        if k <= b:
            return b
    return -(-k // buckets[-1]) * buckets[-1]


def _lagrange_bits(lams) -> np.ndarray:
    """Scalars < 2^256 [..., t] (Python ints) -> [..., t, 256] int32 bits,
    most significant first."""
    lams = np.asarray(lams, dtype=object)
    raw = np.frombuffer(b"".join(int(v).to_bytes(32, "big")
                                 for v in lams.reshape(-1)), np.uint8)
    return np.unpackbits(raw.reshape(lams.shape + (32,)),
                         axis=-1).astype(np.int32)


class DeviceBackend:
    """Batched threshold crypto for one group (public polynomial, t, n) on
    `device.resolve(device)`: the current CUDA device unless the caller
    names another (the tests pass device="cpu")."""

    name = "device"
    BUCKETS = (4, 16, 64, 256, 1024)
    # distinct-message buckets of the arrival-order batch
    U_BUCKETS = (2, 8, 32, 128, 512, 1024)
    ROUND_BUCKETS = (8, 64, 256, 1024)

    def __init__(self, pub_poly, threshold: int, n: int, device=None):
        self.device = resolve(device)
        self.stats = {"batches": 0, "partials": 0, "distinct_messages": 0,
                      "table_hits": 0, "table_fallbacks": 0}
        self.table = None
        self.update_group(pub_poly, threshold, n)

    def update_group(self, pub_poly, threshold: int, n: int) -> None:
        """A reshare or group transition: new key material, and a new
        table epoch when the commitments or n change."""
        self.pub_poly = pub_poly
        self.threshold = threshold
        self.n = n
        self.table = (SignerKeyTable(pub_poly, n, device=self.device)
                      if self.table is None else self.table.update(pub_poly, n))
        self._commits = [tuple(c.to(self.device)
                               for c in BLS.g1_affine_limbs(pt))
                         for pt in pub_poly.commits]

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- batched partial verification ---------------------------------------

    def verify_partials(self, msgs: Sequence[bytes],
                        partials: Sequence[bytes]) -> list[bool]:
        """Verdicts of partials[i] on msgs[i], one batch padded to a
        bucket.  A partial that is too short, or whose signature is not 96
        bytes, is false."""
        k = len(msgs)
        if k == 0:
            return []
        idxs, sigs, ok_wire = [], [], []
        for p in partials:
            try:
                idx, sig = tbls.index_of(p), tbls.sig_of(p)
                ok = len(sig) == 96
            except Exception:
                # too short, or not bytes at all: false, as in drand_tpu
                idx, sig, ok = 0, bytes(96), False
            idxs.append(idx)
            sigs.append(sig)
            ok_wire.append(ok)
        self.stats["batches"] += 1
        self.stats["partials"] += k
        b = _pad(k, self.BUCKETS)
        sigs_a = np.zeros((b, 96), dtype=np.uint8)
        idx_a = np.zeros((b,), dtype=np.int32)
        for i, (s, ix) in enumerate(zip(sigs, idxs)):
            if len(s) == 96:   # short or long stays zero; ok_wire rejects it
                sigs_a[i] = np.frombuffer(s, dtype=np.uint8)
            idx_a[i] = ix
        msg_len = len(msgs[0])
        if self.table.contains_all(idxs):
            # each distinct message hashes once; keys from the table
            umsgs, mmap = dedup_messages(msgs)
            self.stats["distinct_messages"] += len(umsgs)
            self.stats["table_hits"] += k
            umsgs_a = np.zeros((_pad(len(umsgs), self.U_BUCKETS), msg_len),
                               dtype=np.uint8)
            for i, m in enumerate(umsgs):
                umsgs_a[i] = np.frombuffer(m, dtype=np.uint8)
            mmap_a = np.zeros((b,), dtype=np.int32)
            mmap_a[:k] = mmap
            with timed_dispatch("partials", n=k, bucket=b):
                out = BLS.verify_partial_g2_sigs_tabled(
                    self._tensor(umsgs_a), self._tensor(mmap_a),
                    self._tensor(sigs_a), self._tensor(idx_a),
                    self.table.arrays(), DST_G2)
                res = out[:k].cpu().numpy()
        else:
            # an index outside the table: every key of the batch evaluated
            # in the batch, which takes any index
            self.stats["distinct_messages"] += len(set(msgs))
            self.stats["table_fallbacks"] += k
            msgs_a = np.zeros((b, msg_len), dtype=np.uint8)
            for i, m in enumerate(msgs):
                msgs_a[i] = np.frombuffer(m, dtype=np.uint8)
            with timed_dispatch("partials", n=k, bucket=b):
                out = BLS.verify_partial_g2_sigs(
                    self._tensor(msgs_a), self._tensor(sigs_a),
                    self._tensor(idx_a), self._commits, DST_G2)
                res = out[:k].cpu().numpy()
        return [bool(r) and w for r, w in zip(res, ok_wire)]

    def verify_partials_rounds(self, round_msgs: Sequence[bytes],
                               partials_by_round: Sequence[Sequence[bytes]]
                               ) -> list[list[bool]]:
        """Rounds-major verdicts: one digest a round and that round's
        partials, the rounds padded to a bucket.  An index outside the
        table sends the whole call through the flat `verify_partials`."""
        R = len(round_msgs)
        if R == 0:
            return []
        S = max(len(p) for p in partials_by_round)
        idxs = np.zeros((R, S), dtype=np.int32)
        sigs_a = np.zeros((R, S, 96), dtype=np.uint8)
        ok_wire = np.zeros((R, S), dtype=bool)
        for r, parts in enumerate(partials_by_round):
            for j, p in enumerate(parts):
                try:
                    idxs[r, j] = tbls.index_of(p)
                    s = tbls.sig_of(p)
                    if len(s) == 96:
                        sigs_a[r, j] = np.frombuffer(s, dtype=np.uint8)
                        ok_wire[r, j] = True
                except Exception:
                    continue    # too short, or not bytes: false
        k = int(sum(len(p) for p in partials_by_round))
        self.stats["batches"] += 1
        self.stats["partials"] += k
        self.stats["distinct_messages"] += R
        if not self.table.contains_all(idxs):
            self.stats["table_fallbacks"] += k
            flat_msgs, flat_parts = [], []
            for r, parts in enumerate(partials_by_round):
                flat_msgs += [round_msgs[r]] * len(parts)
                flat_parts += list(parts)
            flat = self.verify_partials(flat_msgs, flat_parts)
            out, pos = [], 0
            for parts in partials_by_round:
                out.append(flat[pos:pos + len(parts)])
                pos += len(parts)
            return out
        self.stats["table_hits"] += k
        rb = _pad(R, self.ROUND_BUCKETS)
        rmsgs_a = np.zeros((rb, len(round_msgs[0])), dtype=np.uint8)
        for r, m in enumerate(round_msgs):
            rmsgs_a[r] = np.frombuffer(m, dtype=np.uint8)
        if rb != R:
            sigs_a = np.concatenate(
                [sigs_a, np.zeros((rb - R, S, 96), np.uint8)])
            idxs = np.concatenate([idxs, np.zeros((rb - R, S), np.int32)])
        with timed_dispatch("rounds", n=R, bucket=rb):
            out = BLS.verify_partial_g2_sigs_shared(
                self._tensor(rmsgs_a), self._tensor(sigs_a),
                self._tensor(idxs), self.table.arrays(), DST_G2)
            res = out[:R, :S].cpu().numpy() & ok_wire
        return [[bool(res[r, j]) for j in range(len(parts))]
                for r, parts in enumerate(partials_by_round)]

    # -- Lagrange recovery --------------------------------------------------

    def _round_points(self, parts, what: str):
        """The first t distinct in-group signers' signatures of a round, by
        index, and their Lagrange bases at 0."""
        indices, pts, basis = _threshold_points(
            parts, self.threshold, self.n, what=what)
        return ([np.frombuffer(pts[i], dtype=np.uint8) for i in indices],
                [basis[i] for i in indices])

    def _recover_msm(self, sigs_a: np.ndarray, lams):
        """sum_j lams[r][j] * sigma[r, j] for every round r: sigs_a [rb, t,
        96] uint8, lams [rb][t] scalars.  The rb*t rows run t-major (row j
        * rb + r), so each level of the tree sum over t adds two
        contiguous blocks of rows.  Returns the sums' affine (x, y), inf
        [rb] and valid [rb] (every signature decoded and finite) on the
        device, without waiting for it."""
        rb, t = sigs_a.shape[:2]
        sig_rows = self._tensor(sigs_a.transpose(1, 0, 2).reshape(t * rb, 96))
        bits = self._tensor(_lagrange_bits(lams).transpose(1, 0, 2)
                            .reshape(t * rb, 256))
        (sx, sy), s_inf, s_valid = BLS.g2_decompress(sig_rows)
        one = T.fp2_broadcast(T.FP2_ONE, s_inf.shape, self.device)
        acc = DC.point_mul_bits((sx, sy, one), bits, DC.Fp2Ops)

        def rows(pt, lo, hi):
            return tuple(tuple(c[lo * rb:hi * rb] for c in xy) for xy in pt)

        m = t
        while m > 1:
            h = m // 2
            s = DC.point_add(rows(acc, 0, h), rows(acc, h, 2 * h), DC.Fp2Ops)
            if m % 2:
                tail = rows(acc, 2 * h, m)
                acc = tuple(tuple(torch.cat([u, v]) for u, v in zip(a, b))
                            for a, b in zip(s, tail))
                m = h + 1
            else:
                acc, m = s, h
        (ax, ay), inf = DC.point_to_affine(acc, DC.Fp2Ops)
        return ax, ay, inf, (s_valid & ~s_inf).reshape(t, rb).all(0)

    @staticmethod
    def _compressed(ax, ay, inf, valid, what: str) -> list[bytes]:
        """The compressed sums of `_recover_msm`, every one valid and
        finite, else ValueError (its message led by what.format(row))."""
        ax, ay = tuple(c.cpu() for c in ax), tuple(c.cpu() for c in ay)
        inf, valid = inf.cpu().numpy(), valid.cpu().numpy()
        out = []
        for r in range(inf.shape[0]):
            if not valid[r] or inf[r]:
                raise ValueError(
                    f"{what.format(r)}device recovery failed "
                    "(invalid partials)")
            out.append(GC.g2_to_bytes(
                (T.fp2_decode(ax, r), T.fp2_decode(ay, r), (1, 0))))
        return out

    def recover_rounds(self, msgs: Sequence[bytes],
                       partials_by_round: Sequence[Sequence[bytes]]
                       ) -> list[bytes]:
        """The group signature of every round from its partials, as one
        batched multi-scalar multiplication over the rounds padded to a
        bucket (padded rounds repeat round 0).  Each round needs t
        in-group partials; raises ValueError on any round that lacks
        them or whose partials do not decode."""
        t = self.threshold
        R = len(msgs)
        if R == 0:
            return []
        rb = _pad(R, self.ROUND_BUCKETS)
        sigs_a = np.zeros((rb, t, 96), dtype=np.uint8)
        lams = []
        for r, parts in enumerate(partials_by_round):
            sig_rows, basis = self._round_points(parts, f"round {r}: ")
            sigs_a[r] = np.stack(sig_rows)
            lams.append(basis)
        sigs_a[R:] = sigs_a[0]
        lams += [lams[0]] * (rb - R)
        ax, ay, inf, valid = self._recover_msm(sigs_a, lams)
        return self._compressed(tuple(c[:R] for c in ax),
                                tuple(c[:R] for c in ay), inf[:R], valid[:R],
                                "round {}: ")

    def recover(self, msg: bytes, partials: Sequence[bytes]) -> bytes:
        """The group signature of one round from its partials: the native
        combination first (the latency path of a live round, as in
        drand_tpu), else the same multi-scalar multiplication as
        `recover_rounds` on t rows of the device."""
        out = _native_recover(partials, self.threshold, self.n)
        if out is not None:
            return out
        return self._recover_device(partials)

    def _recover_device(self, partials: Sequence[bytes]) -> bytes:
        """`recover`'s device step: the multi-scalar multiplication on the
        t rows of one round, unpadded."""
        sig_rows, basis = self._round_points(partials, "")
        return self._compressed(*self._recover_msm(np.stack(sig_rows)[None],
                                                   [basis]), "")[0]


def make_backend(pub_poly, threshold: int, n: int, device=None):
    """The threshold backend of one group on `device.resolve(device)`:
    `DeviceBackend` on a CUDA device, `HostBackend` on the CPU."""
    dev = resolve(device)
    if dev.type == "cuda":
        return DeviceBackend(pub_poly, threshold, n, device=dev)
    return HostBackend(pub_poly, threshold, n)


class AsyncPartialVerifier:
    """Micro-batches partial verifications into single backend calls.

    Arrivals within `max_delay` seconds (or up to `max_batch`) coalesce;
    every caller awaits its own verdict.  The backend runs in the shared
    worker thread, never on the event loop.
    """

    # 16 full batches of backlog; a partial past it is dropped, its
    # verdict false (fail closed)
    MAX_PENDING = 1024

    def __init__(self, backend, max_delay: float = 0.02, max_batch: int = 64):
        self.backend = backend
        self.max_delay = max_delay
        self.max_batch = max_batch
        self._queue: asyncio.Queue = asyncio.Queue(maxsize=self.MAX_PENDING)
        self._task: asyncio.Task | None = None

    async def verify(self, msg: bytes, partial: bytes) -> bool:
        self._ensure_worker()
        fut = asyncio.get_running_loop().create_future()
        try:
            self._queue.put_nowait((msg, partial, fut))
        except asyncio.QueueFull:
            return False
        return await fut

    def _ensure_worker(self):
        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(self._worker())

    def stop(self):
        if self._task is not None:
            self._task.cancel()
            self._task = None
        # fail closed every caller still waiting for a verdict
        while not self._queue.empty():
            try:
                _, _, fut = self._queue.get_nowait()
                if not fut.done():
                    fut.set_result(False)
            except asyncio.QueueEmpty:
                break

    async def _worker(self):
        loop = asyncio.get_running_loop()
        while True:
            batch = [await self._queue.get()]
            try:
                deadline = loop.time() + self.max_delay
                while len(batch) < self.max_batch:
                    timeout = deadline - loop.time()
                    if timeout <= 0:
                        break
                    try:
                        batch.append(await asyncio.wait_for(
                            self._queue.get(), timeout))
                    except asyncio.TimeoutError:
                        break
                try:
                    results = await loop.run_in_executor(
                        _EXECUTOR, self.backend.verify_partials,
                        [b[0] for b in batch], [b[1] for b in batch])
                except Exception as exc:  # backend failure: fail closed
                    log.warning("partial-verify backend error: %s", exc)
                    results = [False] * len(batch)
                for (_, _, fut), ok in zip(batch, results):
                    if not fut.done():
                        fut.set_result(bool(ok))
            except asyncio.CancelledError:
                # stopped mid-batch: fail closed every dequeued caller
                for _, _, fut in batch:
                    if not fut.done():
                        fut.set_result(False)
                raise


async def run_in_crypto_thread(fn, *args):
    """Run a blocking crypto call in the shared worker thread."""
    return await asyncio.get_running_loop().run_in_executor(_EXECUTOR, fn, *args)
