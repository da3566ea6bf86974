"""Build, load and launch the hand-written CUDA kernels of `csrc/`.

The kernels are compiled with `nvcc` for sm_90a into a shared library with
a plain C interface and loaded with ctypes: no PyTorch headers, so a build
takes seconds.  The build runs at first use, into
`build/drand_tpu_torch/<hash of the sources>/` beside the package, and is
reused while the sources are unchanged.

Each wrapper takes CUDA tensors only (the CPU path is the plain PyTorch
version in `ops/field.py`, `ops/towers.py` or `ops/flat12.py`): it makes
broadcast operands contiguous, checks device, dtype, shape, contiguity and
alignment and raises on anything else, allocates its output with
`torch.empty`, launches on PyTorch's current stream, raises on a CUDA
error, and adds one to its kernel's `launches` where it launches (and
counts the launch under its call in `calls`: field and shape for K1-K3,
K21 and K22; for K4 field, shape and either k and whether t is given (a
single step) or "pow" and the exponent (a whole chain); shape and n for
K5/K6;
shape and b_idx for K13; shape, k and whether t is given for K7; shape
and k for K14; shape and n for K9; shape for K8, K11, K12, K15,
K17-K20; shape and with_double for K10; shape and n for K16).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "drand_tpu_torch"
# one nvcc per entry, all started together: a source and its own flags.
# curve_kernels.cu and miller_kernels.cu are each built in two parts, each
# part minutes of nvcc.
SOURCES = (("field_kernels.cu", ()), ("tower_kernels.cu", ()),
           ("curve_kernels.cu", ("-DDT_CURVE_PART=0",)),
           ("curve_kernels.cu", ("-DDT_CURVE_PART=1",)),
           ("miller_kernels.cu", ("-DDT_MILLER_ADD=0",)),
           ("miller_kernels.cu", ("-DDT_MILLER_ADD=1",)))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libdrand_tpu_torch_kernels.so"


@dataclass
class Kernel:
    """One CUDA kernel: its C entry point, the TPU kernel it replaces, the
    number of launches its wrapper has made, and those launches by call
    (the key each wrapper documents)."""
    name: str
    symbol: str
    replaces: str
    source: str = "drand_tpu_torch/csrc/field_kernels.cu"
    launches: int = 0
    calls: collections.Counter = field(default_factory=collections.Counter)


_TOWER = "drand_tpu_torch/csrc/tower_kernels.cu"
_CURVE = "drand_tpu_torch/csrc/curve_kernels.cu"
_MILLER = "drand_tpu_torch/csrc/miller_kernels.cu"
KERNELS = {
    "mont_mul": Kernel("mont_mul", "dt_mont_mul",
                       "drand_tpu/ops/pallas_field.py:723"),
    "mont_sqr": Kernel("mont_sqr", "dt_mont_sqr",
                       "drand_tpu/ops/pallas_field.py:737"),
    "mont_reduce": Kernel("mont_reduce", "dt_mont_reduce",
                          "drand_tpu/ops/pallas_field.py:746"),
    "sqr_chain_mul": Kernel("sqr_chain_mul", "dt_fp_pow_chain",
                            "drand_tpu/ops/pallas_field.py:1253"),
    "fp2_products": Kernel("fp2_products", "dt_fp2_products",
                           "drand_tpu/ops/pallas_field.py:1062", _TOWER),
    "fp2_sqrs": Kernel("fp2_sqrs", "dt_fp2_sqrs",
                       "drand_tpu/ops/pallas_field.py:1029", _TOWER),
    "flat_mul": Kernel("flat_mul", "dt_flat_mul",
                       "drand_tpu/ops/pallas_field.py:1125", _TOWER),
    "cyclo_sqr": Kernel("cyclo_sqr", "dt_cyclo_sqr",
                        "drand_tpu/ops/pallas_field.py:647", _TOWER),
    "fp2_sqr_chain_mul": Kernel("fp2_sqr_chain_mul", "dt_fp2_sqr_chain_mul",
                                "drand_tpu/ops/pallas_field.py:1326", _TOWER),
    "fp2_sqr5_mul": Kernel("fp2_sqr5_mul", "dt_fp2_sqr5_mul",
                           "drand_tpu/ops/pallas_field.py:1348", _TOWER),
    "g2_point_dbl": Kernel("g2_point_dbl", "dt_g2_point_dbl",
                           "drand_tpu/ops/pallas_field.py:1705", _CURVE),
    "g2_point_add": Kernel("g2_point_add", "dt_g2_point_add",
                           "drand_tpu/ops/pallas_field.py:1720", _CURVE),
    "miller_dbl_iter": Kernel("miller_dbl_iter", "dt_miller_dbl_iter",
                              "drand_tpu/ops/pallas_field.py:2088", _MILLER),
    "miller_add_iter": Kernel("miller_add_iter", "dt_miller_add_iter",
                              "drand_tpu/ops/pallas_field.py:2121", _MILLER),
    "flat_conj": Kernel("flat_conj", "dt_flat_conj",
                        "drand_tpu/ops/pallas_field.py:1812", _TOWER),
    "flat_frob": Kernel("flat_frob", "dt_flat_frob",
                        "drand_tpu/ops/pallas_field.py:1834", _TOWER),
    "flat_sqr": Kernel("flat_sqr", "dt_flat_sqr",
                       "drand_tpu/ops/pallas_field.py:1758", _TOWER),
    "g2_dbl_line": Kernel("g2_dbl_line", "dt_g2_dbl_line",
                          "drand_tpu/ops/pallas_field.py:1538", _CURVE),
    "g2_add_line": Kernel("g2_add_line", "dt_g2_add_line",
                          "drand_tpu/ops/pallas_field.py:1551", _CURVE),
    "line_merge": Kernel("line_merge", "dt_line_merge",
                         "drand_tpu/ops/pallas_field.py:1898", _TOWER),
    "add": Kernel("add", "dt_add", "drand_tpu/ops/pallas_field.py:759"),
    "sub": Kernel("sub", "dt_sub", "drand_tpu/ops/pallas_field.py:762"),
}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0
        k.calls.clear()


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "dt_mont_mul": [_P, _P, _P, _LL, _P, _P],
    "dt_mont_sqr": [_P, _P, _LL, _P, _P],
    "dt_mont_reduce": [_P, _P, _LL, _P, _P],
    "dt_fp_pow_chain": [_P, _P, _P, _LL, _P, _I, _P, _P, _P],
    "dt_fp2_products": [_P, _P, _P, _LL, _I, _P, _P],
    "dt_fp2_sqrs": [_P, _P, _LL, _I, _P, _P],
    "dt_flat_mul": [_P, _P, _P, _LL, _P, _I, _P, _P],
    "dt_cyclo_sqr": [_P, _P, _LL, _I, _P, _P],
    "dt_fp2_sqr_chain_mul": [_P, _P, _P, _LL, _I, _P, _P],
    "dt_fp2_sqr5_mul": [_P, _P, _P, _LL, _P, _P],
    "dt_g2_point_dbl": [_P, _P, _LL, _I, _P, _P],
    "dt_g2_point_add": [_P, _P, _P, _LL, _I, _P, _P, _P],
    "dt_miller_dbl_iter": [_P, _P, _P, _P, _P, _P, _LL, _P, _P, _P],
    "dt_miller_add_iter": [_P, _P, _P, _P, _P, _P, _P, _LL, _P, _P, _P],
    "dt_flat_conj": [_P, _P, _LL, _P, _P],
    "dt_flat_frob": [_P, _P, _LL, _P, _P, _P],
    "dt_flat_sqr": [_P, _P, _LL, _P, _P],
    "dt_g2_dbl_line": [_P, _P, _P, _LL, _P, _P],
    "dt_g2_add_line": [_P, _P, _P, _LL, _P, _P],
    "dt_line_merge": [_P, _P, _P, _LL, _P, _P],
    "dt_add": [_P, _P, _P, _LL, _P, _P],
    "dt_sub": [_P, _P, _P, _LL, _P, _P],
    "dt_mont_mul_attrs": [_P],
    "dt_fp_pow_chain_attrs": [_P],
    "dt_cyclo_sqr_attrs": [_P],
    "dt_flat_mul_attrs": [_P],
    "dt_fp2_products_attrs": [_P],
    "dt_fp2_sqrs_attrs": [_P],
    "dt_flat_conj_attrs": [_P],
    "dt_flat_frob_attrs": [_P],
    "dt_g2_dbl_line_attrs": [_P],
    "dt_flat_sqr_attrs": [_P],
    "dt_g2_add_line_attrs": [_P],
    "dt_line_merge_attrs": [_P],
    "dt_fp2_sqr_chain_mul_attrs": [_P],
    "dt_g2_point_dbl_attrs": [_P],
    "dt_g2_point_add_attrs": [_P],
    "dt_miller_dbl_iter_attrs": [_P],
    "dt_miller_add_iter_attrs": [_P],
}

_lock = threading.Lock()
_state: dict = {}


def source_hash() -> str:
    h = hashlib.sha256(f"{NVCC_FLAGS} {SOURCES}".encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _compile(out_dir: Path) -> dict:
    """One nvcc per source, all started together, then one link."""
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for i, (src, flags) in enumerate(SOURCES):
        obj = out_dir / (Path(src).stem + f".{i}.{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-c", str(CSRC / src), "-o",
               str(obj)]
        procs.append((" ".join((src, *flags)), obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    logs, objs, failed = [], [], []
    for what, obj, proc in procs:
        out, err = proc.communicate()
        logs.append(f"== {what} (done by {time.perf_counter() - t0:.1f} s)\n"
                    f"{out}{err}")
        objs.append(str(obj))
        if proc.returncode:
            failed.append(what)
    (out_dir / "nvcc.log").write_text("\n".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    link = subprocess.run([nvcc, "-shared", *objs, "-o", str(tmp)],
                          capture_output=True, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, out_dir / LIB_NAME)
    for o in objs:
        os.unlink(o)
    return {"seconds": time.perf_counter() - t0, "log": "\n".join(logs)}


def build() -> dict:
    """Build (if needed) and load the kernel library; idempotent.
    Returns {"dir", "seconds" (0 when reused), "log"}."""
    with _lock:
        if "lib" in _state:
            return _state["info"]
        out_dir = BUILD_ROOT / source_hash()
        so = out_dir / LIB_NAME
        info = {"dir": str(out_dir), "seconds": 0.0, "log": ""}
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            info.update(_compile(out_dir))
        lib = ctypes.CDLL(str(so))
        for sym, args in _ARGTYPES.items():
            fn = getattr(lib, sym)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.dt_error_string.argtypes = [ctypes.c_int]
        lib.dt_error_string.restype = ctypes.c_char_p
        _state["lib"], _state["info"] = lib, info
        return info


def kernel_attrs(name: str) -> dict:
    """What `cudaFuncGetAttributes` and
    `cudaOccupancyMaxActiveBlocksPerMultiprocessor` say of the kernel of
    `name` on the current device, for the kernels that export them
    (mont_mul, sqr_chain_mul, fp2_products, fp2_sqrs, fp2_sqr_chain_mul,
    flat_mul (its dense instance), g2_point_dbl, g2_point_add,
    miller_dbl_iter, miller_add_iter, cyclo_sqr, flat_conj, flat_frob,
    flat_sqr, g2_dbl_line, g2_add_line, line_merge)."""
    lib = _lib()
    out = np.zeros(5, dtype=np.int32)
    rc = getattr(lib, KERNELS[name].symbol + "_attrs")(out.ctypes.data)
    if rc:
        raise RuntimeError(f"{name} attributes: CUDA error {rc}: "
                           f"{lib.dt_error_string(rc).decode()}")
    return dict(zip(("num_regs", "local_bytes", "shared_bytes",
                     "threads_per_block", "blocks_per_sm"),
                    (int(v) for v in out)))


def _lib():
    if "lib" not in _state:
        build()
    return _state["lib"]


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _check(x: torch.Tensor, what: str, limbs: int) -> None:
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(f"{what}: the CUDA kernel takes a CUDA tensor, got "
                         f"{getattr(x, 'device', type(x))}")
    if x.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32 limbs, got {x.dtype}")
    if x.ndim < 1 or x.shape[-1] != limbs:
        raise ValueError(f"{what}: expected [..., {limbs}], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: expected 16-byte alignment")


def _same(a: torch.Tensor, b: torch.Tensor, what: str) -> None:
    if a.shape != b.shape or a.device != b.device:
        raise ValueError(f"{what}: operands differ in shape or device: "
                         f"{tuple(a.shape)}@{a.device} vs "
                         f"{tuple(b.shape)}@{b.device}")


def _launch(name: str, call: tuple, device: torch.device, *args) -> None:
    """Launch `name`'s kernel and count the launch."""
    lib = _lib()
    kernel = KERNELS[name]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, kernel.symbol)(*args, stream)
    if rc:
        raise RuntimeError(f"{name}: CUDA error {rc}: "
                           f"{lib.dt_error_string(rc).decode()}")
    kernel.launches += 1
    kernel.calls[call] += 1


def mont_mul(a: torch.Tensor, b: torch.Tensor, field) -> torch.Tensor:
    """K1: a*b*2^-384 mod m for canonical [..., 32] limbs."""
    _check(a, "mont_mul a", 32)
    _check(b, "mont_mul b", 32)
    _same(a, b, "mont_mul")
    out = torch.empty_like(a)
    n = a.numel() // 32
    if n:
        _launch("mont_mul", (field.name, tuple(a.shape)), a.device,
                a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                field.kernel_arg.ctypes.data)
    return out


def mont_sqr(a: torch.Tensor, field) -> torch.Tensor:
    """K2: a*a*2^-384 mod m for canonical [..., 32] limbs."""
    _check(a, "mont_sqr a", 32)
    out = torch.empty_like(a)
    n = a.numel() // 32
    if n:
        _launch("mont_sqr", (field.name, tuple(a.shape)), a.device,
                a.data_ptr(), out.data_ptr(), n, field.kernel_arg.ctypes.data)
    return out


def mont_reduce(t: torch.Tensor, field) -> torch.Tensor:
    """K3: t*2^-384 mod m for [..., 64] wide limbs (contract in
    `Field.mont_reduce`)."""
    _check(t, "mont_reduce t", 64)
    out = torch.empty(t.shape[:-1] + (32,), dtype=torch.int32,
                      device=t.device)
    n = t.numel() // 64
    if n:
        _launch("mont_reduce", (field.name, tuple(t.shape)), t.device,
                t.data_ptr(), out.data_ptr(), n, field.kernel_arg.ctypes.data)
    return out


# K4's programs (csrc/field_arith32.cuh chain_row): one int32 code a step,
# k << 8 | op << 6 | slot.
CHAIN_SQRMUL, CHAIN_LOAD, CHAIN_STORE = 0, 1, 2
CHAIN_NONE, CHAIN_T = 63, 62     # slot codes: no product; the rows of t
CHAIN_SLOTS = 62                 # scratch slots 0..61, 48 bytes a row each
CHAIN_MAX_K = (1 << 23) - 1


def chain_code(op: int, k: int = 0, slot: int = CHAIN_NONE) -> int:
    """One step of a K4 program: x = x^(2^k) (* slot) for CHAIN_SQRMUL,
    x = slot for CHAIN_LOAD, slot = x for CHAIN_STORE."""
    if not (0 <= k <= CHAIN_MAX_K and op in (CHAIN_SQRMUL, CHAIN_LOAD,
                                             CHAIN_STORE)
            and (0 <= slot < CHAIN_SLOTS
                 or (op == CHAIN_SQRMUL and slot in (CHAIN_NONE, CHAIN_T)))):
        raise ValueError(f"K4 takes no step op={op} k={k} slot={slot}")
    return k << 8 | op << 6 | slot


def chain_work(codes) -> tuple:
    """(squares, products) a row of the K4 program `codes` runs."""
    sqrs = muls = 0
    for c in codes:
        if (c >> 6) & 3 == CHAIN_SQRMUL:
            sqrs += c >> 8
            muls += (c & 63) != CHAIN_NONE
    return sqrs, muls


@functools.lru_cache(maxsize=None)
def _program_tensor(codes: tuple) -> torch.Tensor:
    return torch.tensor(codes, dtype=torch.int32)


def _chain(a: torch.Tensor, t, codes: tuple, n_slots: int, call: tuple,
           field) -> torch.Tensor:
    """Launch K4 on the rows of a (and t) through the program `codes`."""
    from drand_tpu_torch.ops.field import dev   # field imports this module
    _check(a, "sqr_chain_mul a", 32)
    if t is not None:
        _check(t, "sqr_chain_mul t", 32)
        _same(a, t, "sqr_chain_mul")
    if not 0 <= n_slots <= CHAIN_SLOTS:
        raise ValueError(f"sqr_chain_mul: {n_slots} scratch slots; K4 has "
                         f"{CHAIN_SLOTS}")
    out = torch.empty_like(a)
    n = a.numel() // 32
    if n:
        steps = dev(_program_tensor(codes), a.device)
        scratch = (torch.empty(n_slots * 12 * n, dtype=torch.int32,
                               device=a.device) if n_slots else None)
        _launch("sqr_chain_mul", call, a.device, a.data_ptr(),
                None if t is None else t.data_ptr(), out.data_ptr(), n,
                steps.data_ptr(), len(codes),
                None if scratch is None else scratch.data_ptr(),
                field.kernel_arg.ctypes.data)
    return out


def sqr_chain_mul(a: torch.Tensor, k: int, t, field) -> torch.Tensor:
    """K4 at one step: a^(2^k) * t (t given) or a^(2^k), canonical [...,
    32] limbs."""
    code = chain_code(CHAIN_SQRMUL, k, CHAIN_NONE if t is None else CHAIN_T)
    return _chain(a, t, (code,), 0,
                  (field.name, tuple(a.shape), k, t is not None), field)


def pow_chain(a: torch.Tensor, codes: tuple, n_slots: int, e: int,
              field) -> torch.Tensor:
    """K4 on a whole addition chain in one launch: the program `codes`
    (`field.chain_program`, which computes a^e) on canonical [..., 32]
    limbs, with n_slots scratch slots."""
    return _chain(a, None, tuple(codes), n_slots,
                  (field.name, tuple(a.shape), "pow", e), field)


def _fp2_stack_check(x: torch.Tensor, what: str) -> int:
    """[n, 2, ..., 32] Fp2 stack: returns the rows of one coordinate."""
    _check(x, what, 32)
    if x.ndim < 3 or x.shape[1] != 2:
        raise ValueError(f"{what}: expected [n, 2, ..., 32], got "
                         f"{tuple(x.shape)}")
    return x[0, 0].numel() // 32


def fp2_products(x: torch.Tensor, y: torch.Tensor, field) -> torch.Tensor:
    """K5: n stacked Fp2 products.  x, y [n, 2, ..., 32] canonical, with
    coordinate c of pair p at [p, c]; returns [n, 2, ..., 32], pair p's
    product at [p]."""
    x, y = x.contiguous(), y.contiguous()
    rows = _fp2_stack_check(x, "fp2_products x")
    _fp2_stack_check(y, "fp2_products y")
    _same(x, y, "fp2_products")
    out = torch.empty_like(x)
    n = x.shape[0]
    if n and rows:
        _launch("fp2_products", (tuple(x.shape[2:]), n), x.device,
                x.data_ptr(), y.data_ptr(), out.data_ptr(), rows, n,
                field.kernel_arg.ctypes.data)
    return out


def fp2_sqrs(x: torch.Tensor, field) -> torch.Tensor:
    """K6: n stacked Fp2 squares, [n, 2, ..., 32] canonical in and out."""
    x = x.contiguous()
    rows = _fp2_stack_check(x, "fp2_sqrs x")
    out = torch.empty_like(x)
    n = x.shape[0]
    if n and rows:
        _launch("fp2_sqrs", (tuple(x.shape[2:]), n), x.device, x.data_ptr(),
                out.data_ptr(), rows, n, field.kernel_arg.ctypes.data)
    return out


def flat_mul(a: torch.Tensor, b: torch.Tensor, b_idx, field) -> torch.Tensor:
    """K13: flat Fp12 a*b.  a [..., 12, 32]; b [..., J, 32] holding the
    coefficients of the J distinct w-powers `b_idx` (all 12 when dense);
    leading shapes broadcast.  Canonical in and out, [..., 12, 32].  The
    kernel's instance follows b_idx: 0..11 in order (dense), or any other
    set."""
    b_idx = tuple(int(i) for i in b_idx)
    J = len(b_idx)
    if not (1 <= J <= 12 and len(set(b_idx)) == J
            and all(0 <= i < 12 for i in b_idx)):
        raise ValueError(f"flat_mul: b_idx must hold distinct powers 0..11, "
                         f"got {b_idx}")
    for x, rows, what in ((a, 12, "flat_mul a"), (b, J, "flat_mul b")):
        if not isinstance(x, torch.Tensor) or x.ndim < 2 or \
                x.shape[-2:] != (rows, 32):
            raise ValueError(f"{what}: expected [..., {rows}, 32], got "
                             f"{tuple(getattr(x, 'shape', ()))}")
    shape = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a = a.expand(shape + (12, 32)).contiguous()
    b = b.expand(shape + (J, 32)).contiguous()
    _check(a, "flat_mul a", 32)
    _check(b, "flat_mul b", 32)
    if a.device != b.device:
        raise ValueError(f"flat_mul: operands on {a.device} and {b.device}")
    out = torch.empty_like(a)
    rows = a.numel() // (12 * 32)
    if rows:
        idx = np.asarray(b_idx, dtype=np.int32)
        _launch("flat_mul", (tuple(a.shape), b_idx), a.device, a.data_ptr(),
                b.data_ptr(), out.data_ptr(), rows, idx.ctypes.data, J,
                field.kernel_arg.ctypes.data)
    return out


def cyclo_sqr(a: torch.Tensor, field, k: int = 1) -> torch.Tensor:
    """K14: k Granger-Scott cyclotomic squares of flat Fp12 [..., 12, 32]
    in one launch (the function of `flat12._flat_cyclo_sqr_plain`, k
    times, on any canonical input), canonical in and out."""
    a = a.contiguous()
    _shaped(a, "cyclo_sqr a", (12, 32))
    if not 1 <= k < 2 ** 31:
        raise ValueError(f"cyclo_sqr: k out of range: {k}")
    out = torch.empty_like(a)
    rows = a.numel() // (12 * 32)
    if rows:
        _launch("cyclo_sqr", (tuple(a.shape), k), a.device, a.data_ptr(),
                out.data_ptr(), rows, k, field.kernel_arg.ctypes.data)
    return out


def _shaped(x: torch.Tensor, what: str, tail: tuple) -> None:
    """A contiguous int32 CUDA tensor whose trailing dimensions are
    `tail` (the last one the 32 limbs)."""
    _check(x, what, 32)
    if x.ndim < len(tail) or tuple(x.shape[x.ndim - len(tail):]) != tail:
        raise ValueError(f"{what}: expected [..., {', '.join(map(str, tail))}]"
                         f", got {tuple(x.shape)}")


def _lead_check(x: torch.Tensor, what: str, lead: int) -> int:
    """A coordinate-major stack [lead, ..., 32]: returns its rows."""
    _check(x, what, 32)
    if x.ndim < 2 or x.shape[0] != lead:
        raise ValueError(f"{what}: expected [{lead}, ..., 32], got "
                         f"{tuple(x.shape)}")
    return x[0].numel() // 32


def fp2_sqr_chain_mul(x: torch.Tensor, k: int, t, field) -> torch.Tensor:
    """K7: x^(2^k) * t (t given) or x^(2^k) in Fp2.  x, t [2, ..., 32]
    canonical (coordinate c at [c]); returns [2, ..., 32]."""
    x = x.contiguous()
    rows = _lead_check(x, "fp2_sqr_chain_mul x", 2)
    if t is not None:
        t = t.contiguous()
        _lead_check(t, "fp2_sqr_chain_mul t", 2)
        _same(x, t, "fp2_sqr_chain_mul")
    if not 0 <= k < 2 ** 31:
        raise ValueError(f"fp2_sqr_chain_mul: k out of range: {k}")
    out = torch.empty_like(x)
    if rows:
        _launch("fp2_sqr_chain_mul", (tuple(x.shape), k, t is not None),
                x.device, x.data_ptr(), None if t is None else t.data_ptr(),
                out.data_ptr(), rows, k, field.kernel_arg.ctypes.data)
    return out


def fp2_sqr5_mul(x: torch.Tensor, t: torch.Tensor, field) -> torch.Tensor:
    """K8: the window step x^32 * t in Fp2, [2, ..., 32] canonical."""
    x, t = x.contiguous(), t.contiguous()
    rows = _lead_check(x, "fp2_sqr5_mul x", 2)
    _lead_check(t, "fp2_sqr5_mul t", 2)
    _same(x, t, "fp2_sqr5_mul")
    out = torch.empty_like(x)
    if rows:
        _launch("fp2_sqr5_mul", tuple(x.shape), x.device, x.data_ptr(),
                t.data_ptr(), out.data_ptr(), rows,
                field.kernel_arg.ctypes.data)
    return out


def g2_point_dbl(p: torch.Tensor, field, n: int = 1) -> torch.Tensor:
    """K9: n Jacobian doublings ([2^n]P) of G2 points [6, ..., 32] (X0 X1
    Y0 Y1 Z0 Z1) in one launch (the function of
    `curve._g2_point_dbl_plain`), canonical in and out."""
    p = p.contiguous()
    rows = _lead_check(p, "g2_point_dbl p", 6)
    if not 1 <= n < 2 ** 31:
        raise ValueError(f"g2_point_dbl: n out of range: {n}")
    out = torch.empty_like(p)
    if rows:
        _launch("g2_point_dbl", (tuple(p.shape), n), p.device, p.data_ptr(),
                out.data_ptr(), rows, n, field.kernel_arg.ctypes.data)
    return out


def g2_point_add(p1: torch.Tensor, p2: torch.Tensor, with_double: bool,
                 field) -> torch.Tensor:
    """K10: general Jacobian addition of G2 points [6, ..., 32], every
    case branchless (P + P doubles only where `with_double`)."""
    shape = torch.broadcast_shapes(p1.shape, p2.shape)
    p1, p2 = p1.expand(shape).contiguous(), p2.expand(shape).contiguous()
    rows = _lead_check(p1, "g2_point_add p1", 6)
    _lead_check(p2, "g2_point_add p2", 6)
    _same(p1, p2, "g2_point_add")
    out = torch.empty_like(p1)
    if rows:
        _launch("g2_point_add", (tuple(p1.shape), bool(with_double)),
                p1.device, p1.data_ptr(), p2.data_ptr(), out.data_ptr(), rows,
                int(bool(with_double)), field.kernel_one.ctypes.data,
                field.kernel_arg.ctypes.data)
    return out


def _miller_check(f, T, P, masks, Q=None):
    lead = f.shape[:-2]
    _shaped(f, "miller f", (12, 32))
    for x, tail, what in ((T, (2, 6, 32), "miller T"),
                          (P, (2, 2, 32), "miller P"),
                          (Q, (2, 4, 32), "miller Q")):
        if x is None:
            continue
        _shaped(x, what, tail)
        if x.shape[:-3] != lead or x.device != f.device:
            raise ValueError(f"{what}: leading shape or device differs from "
                             f"f's {tuple(lead)}@{f.device}")
    if masks.dtype != torch.int32 or masks.shape != lead + (2,) or \
            not masks.is_contiguous() or masks.device != f.device:
        raise ValueError(f"miller masks: expected contiguous int32 "
                         f"{tuple(lead) + (2,)} on {f.device}")
    return f.numel() // (12 * 32)


def miller_dbl_iter(f, T, P, masks, field):
    """K11: one merged Miller doubling iteration of the two-pair check.
    f [..., 12, 32], T [..., 2, 6, 32], P [..., 2, 2, 32], masks [..., 2]
    int32; returns (f^2 * l1 * l2, the doubled T), the lines multiplied
    in one after the other."""
    f, T, P = f.contiguous(), T.contiguous(), P.contiguous()
    rows = _miller_check(f, T, P, masks)
    fo, To = torch.empty_like(f), torch.empty_like(T)
    if rows:
        _launch("miller_dbl_iter", tuple(f.shape), f.device, f.data_ptr(),
                T.data_ptr(), P.data_ptr(), masks.data_ptr(), fo.data_ptr(),
                To.data_ptr(), rows, field.kernel_one.ctypes.data,
                field.kernel_arg.ctypes.data)
    return fo, To


def miller_add_iter(f, T, Q, P, masks, field):
    """K12: one merged Miller addition step of the two-pair check, Q
    [..., 2, 4, 32] affine; returns (f * l1 * l2, the new T)."""
    f, T, Q, P = f.contiguous(), T.contiguous(), Q.contiguous(), P.contiguous()
    rows = _miller_check(f, T, P, masks, Q)
    fo, To = torch.empty_like(f), torch.empty_like(T)
    if rows:
        _launch("miller_add_iter", tuple(f.shape), f.device, f.data_ptr(),
                T.data_ptr(), Q.data_ptr(), P.data_ptr(), masks.data_ptr(),
                fo.data_ptr(), To.data_ptr(), rows,
                field.kernel_one.ctypes.data, field.kernel_arg.ctypes.data)
    return fo, To


def flat_conj(a: torch.Tensor, field) -> torch.Tensor:
    """K15: f^(p^6) of flat Fp12 [..., 12, 32], canonical in and out."""
    a = a.contiguous()
    _shaped(a, "flat_conj a", (12, 32))
    out = torch.empty_like(a)
    rows = a.numel() // (12 * 32)
    if rows:
        _launch("flat_conj", tuple(a.shape), a.device, a.data_ptr(),
                out.data_ptr(), rows, field.kernel_arg.ctypes.data)
    return out


def flat_frob(a: torch.Tensor, n: int, consts: np.ndarray,
              field) -> torch.Tensor:
    """K16: f^(p^n) of flat Fp12 [..., 12, 32]; `consts` the 6 x 4 x 6
    uint64 words of the per-slot 2x2 Montgomery matrices of frob^n."""
    a = a.contiguous()
    _shaped(a, "flat_frob a", (12, 32))
    consts = np.ascontiguousarray(consts, dtype=np.uint64)
    if consts.size != 6 * 4 * 6:
        raise ValueError(f"flat_frob: expected 144 constant words, got "
                         f"{consts.size}")
    out = torch.empty_like(a)
    rows = a.numel() // (12 * 32)
    if rows:
        _launch("flat_frob", (tuple(a.shape), int(n)), a.device,
                a.data_ptr(), out.data_ptr(), rows, consts.ctypes.data,
                field.kernel_arg.ctypes.data)
    return out


def flat_sqr(a: torch.Tensor, field) -> torch.Tensor:
    """K17: the slot-symmetric square of flat Fp12 [..., 12, 32],
    canonical in and out (the function of `flat_mul(a, a)`)."""
    a = a.contiguous()
    _shaped(a, "flat_sqr a", (12, 32))
    out = torch.empty_like(a)
    rows = a.numel() // (12 * 32)
    if rows:
        _launch("flat_sqr", tuple(a.shape), a.device, a.data_ptr(),
                out.data_ptr(), rows, field.kernel_arg.ctypes.data)
    return out


def _line_step(name: str, x: torch.Tensor, width: int, field):
    x = x.contiguous()
    _shaped(x, f"{name} in", (width, 32))
    lead = x.shape[:-2]
    to = torch.empty(lead + (6, 32), dtype=torch.int32, device=x.device)
    lo = torch.empty_like(to)
    rows = x.numel() // (width * 32)
    if rows:
        _launch(name, tuple(x.shape), x.device, x.data_ptr(), to.data_ptr(),
                lo.data_ptr(), rows, field.kernel_arg.ctypes.data)
    return to, lo


def g2_dbl_line(x: torch.Tensor, field):
    """K18: the Miller doubling step on rows x [..., 8, 32] (X0 X1 Y0 Y1
    Z0 Z1 xp yp); returns (T' [..., 6, 32], the line triple a0 a1 b0 b1
    c0 c1 [..., 6, 32])."""
    return _line_step("g2_dbl_line", x, 8, field)


def g2_add_line(x: torch.Tensor, field):
    """K19: the Miller mixed-addition step on rows x [..., 12, 32] (X0 X1
    Y0 Y1 Z0 Z1 xq0 xq1 yq0 yq1 xp yp); returns (T', the line triple)."""
    return _line_step("g2_add_line", x, 12, field)


def line_merge(l1: torch.Tensor, l2: torch.Tensor, field) -> torch.Tensor:
    """K20: the dense [..., 12, 32] product of two sparse lines [..., 6,
    32] on LINE_IDX; leading shapes broadcast."""
    shape = torch.broadcast_shapes(l1.shape[:-2], l2.shape[:-2])
    l1 = l1.expand(shape + (6, 32)).contiguous()
    l2 = l2.expand(shape + (6, 32)).contiguous()
    _shaped(l1, "line_merge l1", (6, 32))
    _shaped(l2, "line_merge l2", (6, 32))
    _same(l1, l2, "line_merge")
    out = torch.empty(shape + (12, 32), dtype=torch.int32, device=l1.device)
    rows = l1.numel() // (6 * 32)
    if rows:
        _launch("line_merge", tuple(out.shape), l1.device, l1.data_ptr(),
                l2.data_ptr(), out.data_ptr(), rows,
                field.kernel_arg.ctypes.data)
    return out


def _add_sub(name: str, a: torch.Tensor, b: torch.Tensor, field):
    shape = torch.broadcast_shapes(a.shape, b.shape)
    a, b = a.expand(shape).contiguous(), b.expand(shape).contiguous()
    _check(a, f"{name} a", 32)
    _check(b, f"{name} b", 32)
    _same(a, b, name)
    out = torch.empty_like(a)
    n = a.numel() // 32
    if n:
        _launch(name, (field.name, tuple(a.shape)), a.device, a.data_ptr(),
                b.data_ptr(), out.data_ptr(), n, field.kernel_arg.ctypes.data)
    return out


def add(a: torch.Tensor, b: torch.Tensor, field) -> torch.Tensor:
    """K21: canonical (a + b) mod m, [..., 32] limbs, shapes broadcast."""
    return _add_sub("add", a, b, field)


def sub(a: torch.Tensor, b: torch.Tensor, field) -> torch.Tensor:
    """K22: canonical (a - b) mod m, [..., 32] limbs, shapes broadcast."""
    return _add_sub("sub", a, b, field)
