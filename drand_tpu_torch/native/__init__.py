"""Native (C++) BLS12-381 host tier of the port (counterpart of
`drand_tpu/native/__init__.py`).

Compiles the port's own copy of the library (`native/bls381.cpp`,
`native/constants.h`) with `g++` at first use into `build/native/` beside
the package, and exposes ctypes wrappers.  The build probes flag sets in
preference order (`-O3 -march=native` first, portable `-O2` after) and
caches the .so keyed on a content hash of (source, constants.h, the chosen
flags, the host CPU) recorded in a sidecar meta file, so a flag change, an
mtime-preserving checkout or a build directory copied to another machine
never serves a stale library.  Concurrent first uses (test workers) build
once: the build holds a lock file, writes a per-process temporary file and
moves it into place with `os.replace`.  `build_info()` gives the flags,
hash, whether the library was cached and the build's seconds.

Unlike drand_tpu's module there is no golden-model fallback: when no flag
set compiles, every entry point raises `NativeBuildError` with the
compiler's output (`available()` only says whether the library loads).
There is no environment override and no metrics hook; each verify records
one "native" dispatch (n = bucket = 1) in `dispatch.DISPATCH`.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import json
import os
import platform
import subprocess
import threading
import time
from pathlib import Path

from drand_tpu_torch.dispatch import record_dispatch

SRC_DIR = Path(__file__).resolve().parent
SOURCES = (SRC_DIR / "bls381.cpp", SRC_DIR / "constants.h")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
LIB_NAME = "_libdrandbls.so"

# probed in order; the first set that compiles wins and is recorded in
# the sidecar meta so build_info() reports what actually ran
FLAG_SETS = (("-O3", "-march=native"), ("-O2",))
CXX = "g++"
BUILD_TIMEOUT_S = 300


class NativeBuildError(RuntimeError):
    """The library could not be built or loaded; carries the compiler's
    output."""


_lock = threading.Lock()
_state: dict = {}


def _cpu_identity() -> bytes:
    """The host CPU's model and feature flags (`-march=native` builds for
    them), from /proc/cpuinfo where there is one."""
    try:
        with open("/proc/cpuinfo", encoding="utf-8", errors="replace") as f:
            lines = [ln for ln in f.read().splitlines()
                     if ln.startswith(("model name", "flags"))]
        return "\n".join(lines[:2]).encode()
    except OSError:
        return f"{platform.machine()} {platform.processor()}".encode()


def _key(flags) -> str:
    h = hashlib.sha256()
    for path in SOURCES:
        h.update(path.read_bytes())
        h.update(b"\0")
    h.update(" ".join(flags).encode())
    h.update(b"\0")
    h.update(_cpu_identity())
    return h.hexdigest()


def _read_meta(meta_path: Path) -> dict | None:
    try:
        meta = json.loads(meta_path.read_text(encoding="utf-8"))
        return meta if isinstance(meta, dict) else None
    except (OSError, ValueError):
        return None


def _write_atomic(path: Path, data: bytes) -> None:
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def build() -> dict:
    """Build the library with CXX into BUILD_DIR unless a build of the
    same key is there; returns {"lib", "flags", "hash", "cached",
    "seconds"}.  Raises NativeBuildError with the compiler's output when
    no flag set compiles or the compiler cannot be run."""
    build_dir, cxx = Path(BUILD_DIR), CXX
    build_dir.mkdir(parents=True, exist_ok=True)
    lib = build_dir / LIB_NAME
    meta_path = build_dir / (LIB_NAME + ".meta.json")
    t0 = time.perf_counter()
    errors = []
    with open(build_dir / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)     # one build; the rest reuse it
        meta = _read_meta(meta_path)
        for flags in FLAG_SETS:
            key = _key(flags)
            if (meta and meta.get("hash") == key
                    and list(meta.get("flags", ())) == list(flags)
                    and lib.exists()):
                return {"lib": str(lib), "flags": list(flags), "hash": key,
                        "cached": True,
                        "seconds": time.perf_counter() - t0}
            tmp = lib.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
            cmd = [cxx, *flags, "-shared", "-fPIC", "-o", str(tmp),
                   str(SOURCES[0])]
            try:
                out = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=BUILD_TIMEOUT_S)
            except (OSError, subprocess.TimeoutExpired) as exc:
                raise NativeBuildError(
                    f"native tier: {' '.join(cmd)} could not run: "
                    f"{type(exc).__name__}: {exc}") from exc
            if out.returncode:
                errors.append(f"$ {' '.join(cmd)}\n{out.stdout}{out.stderr}")
                tmp.unlink(missing_ok=True)
                continue                     # e.g. -march=native unsupported
            os.replace(tmp, lib)
            _write_atomic(meta_path, json.dumps(
                {"hash": key, "flags": list(flags)}, indent=2,
                sort_keys=True).encode())
            return {"lib": str(lib), "flags": list(flags), "hash": key,
                    "cached": False, "seconds": time.perf_counter() - t0}
    raise NativeBuildError("native tier: no flag set compiled:\n"
                           + "\n".join(errors))


def _bind(lib) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    for name, args in [
        ("drand_bls_verify_g2",
         [u8p, u8p, ctypes.c_size_t, u8p, u8p, ctypes.c_size_t]),
        ("drand_bls_verify_g1",
         [u8p, u8p, ctypes.c_size_t, u8p, u8p, ctypes.c_size_t]),
        ("drand_tbls_verify_partial",
         [u8p, ctypes.c_int, u8p, ctypes.c_size_t, u8p, ctypes.c_size_t,
          u8p, ctypes.c_size_t]),
        ("drand_g2_lincomb", [u8p, u8p, ctypes.c_int, u8p]),
        ("drand_test_tower_op", [ctypes.c_int, u8p, u8p, u8p]),
    ]:
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    for name in ("drand_hash_to_g2_compressed",
                 "drand_hash_to_g1_compressed"):
        fn = getattr(lib, name)
        fn.argtypes = [u8p, u8p, ctypes.c_size_t, u8p, ctypes.c_size_t]
        fn.restype = None


def _load():
    """The loaded library; builds it at the first call.  A failed build
    raises NativeBuildError, at this call and every later one."""
    with _lock:
        if "lib" in _state:
            return _state["lib"]
        if "error" in _state:
            raise _state["error"]
        try:
            info = build()
            lib = ctypes.CDLL(info["lib"])
            _bind(lib)
        except NativeBuildError as exc:
            _state["error"] = exc
            raise
        except (OSError, AttributeError) as exc:
            _state["error"] = NativeBuildError(
                f"native tier: cannot load the built library: {exc}")
            raise _state["error"] from exc
        _state["lib"], _state["info"] = lib, info
        return lib


def available() -> bool:
    """Whether the library builds and loads on this host."""
    try:
        _load()
        return True
    except NativeBuildError:
        return False


def build_info() -> dict:
    """{lib, flags, hash, cached, seconds} of the loaded library; raises
    NativeBuildError when it cannot be built."""
    _load()
    return dict(_state["info"])


def _buf(b: bytes):
    return (ctypes.c_uint8 * len(b)).from_buffer_copy(b)


def _msg(msg: bytes):
    return _buf(msg) if msg else _buf(b"\0")


def _observe(seconds: float) -> None:
    # one unbatched verify on the host: n = bucket = 1
    record_dispatch("native", 1, 1, seconds)


def verify_g2(pk48: bytes, msg: bytes, sig96: bytes, dst: bytes) -> bool:
    # wire bytes are attacker-controlled: length-gate before the C call,
    # which reads fixed-size buffers
    if len(pk48) != 48 or len(sig96) != 96:
        return False
    lib = _load()
    t0 = time.perf_counter()
    ok = bool(lib.drand_bls_verify_g2(
        _buf(pk48), _msg(msg), len(msg), _buf(sig96), _buf(dst), len(dst)))
    _observe(time.perf_counter() - t0)
    return ok


def verify_g1(pk96: bytes, msg: bytes, sig48: bytes, dst: bytes) -> bool:
    if len(pk96) != 96 or len(sig48) != 48:
        return False
    lib = _load()
    t0 = time.perf_counter()
    ok = bool(lib.drand_bls_verify_g1(
        _buf(pk96), _msg(msg), len(msg), _buf(sig48), _buf(dst), len(dst)))
    _observe(time.perf_counter() - t0)
    return ok


def verify_partial(commits48: list[bytes], msg: bytes, partial: bytes,
                   dst: bytes) -> bool:
    if len(partial) != 98 or not commits48 or \
            any(len(c) != 48 for c in commits48):
        return False
    lib = _load()
    cat = b"".join(commits48)
    t0 = time.perf_counter()
    ok = bool(lib.drand_tbls_verify_partial(
        _buf(cat), len(commits48), _msg(msg), len(msg),
        _buf(partial), len(partial), _buf(dst), len(dst)))
    _observe(time.perf_counter() - t0)
    return ok


def g2_lincomb(sigs96: list[bytes], scalars32: list[bytes]) -> bytes | None:
    """sum(scalar_i * sig_i) over G2, compressed: the threshold-recovery
    combine.  None on malformed points or an infinity result."""
    if not sigs96 or len(sigs96) != len(scalars32) or \
            any(len(s) != 96 for s in sigs96) or \
            any(len(c) != 32 for c in scalars32):
        return None
    lib = _load()
    out = (ctypes.c_uint8 * 96)()
    ok = lib.drand_g2_lincomb(_buf(b"".join(sigs96)),
                              _buf(b"".join(scalars32)), len(sigs96), out)
    return bytes(out) if ok else None


def hash_to_g2(msg: bytes, dst: bytes) -> bytes:
    lib = _load()
    out = (ctypes.c_uint8 * 96)()
    lib.drand_hash_to_g2_compressed(out, _msg(msg), len(msg), _buf(dst),
                                    len(dst))
    return bytes(out)


def hash_to_g1(msg: bytes, dst: bytes) -> bytes:
    lib = _load()
    out = (ctypes.c_uint8 * 48)()
    lib.drand_hash_to_g1_compressed(out, _msg(msg), len(msg), _buf(dst),
                                    len(dst))
    return bytes(out)


# operand sizes per tower_op opcode (b = 0 for the unary ops); the
# output is the size of operand a
_TOWER_A_LEN = {0: 48, 1: 48, 2: 96, 3: 96, 4: 288, 5: 288, 6: 576,
                7: 576, 8: 576, 9: 576}
_TOWER_B_LEN = {0: 48, 1: 0, 2: 96, 3: 0, 4: 288, 5: 0, 6: 576, 7: 0,
                8: 0, 9: 240}


def tower_op(op: int, a: bytes, b: bytes = b"") -> bytes | None:
    """Test hook into the tower arithmetic: opcode `op` on big-endian
    canonical coefficients (the table at drand_test_tower_op in
    bls381.cpp).  None on bad sizes or non-canonical input, as the C side
    gates."""
    lib = _load()
    if op not in _TOWER_A_LEN or len(a) != _TOWER_A_LEN[op] \
            or len(b) != _TOWER_B_LEN[op]:
        return None
    out = (ctypes.c_uint8 * len(a))()
    ok = lib.drand_test_tower_op(op, _buf(a), _msg(b), out)
    return bytes(out) if ok else None
