"""The port stands alone (no JAX, nothing of drand_tpu), picks its device
explicitly, refuses CPU tensors in its CUDA wrappers, and carries
drand_tpu's verifier state over exactly."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from drand_tpu.crypto.bls12381 import curve as JGC
from drand_tpu.ops import bls as JBLS
from drand_tpu_torch import convert
from drand_tpu_torch import device as D
from drand_tpu_torch import verify as V
from drand_tpu_torch.ops import flat12 as F
from drand_tpu_torch.ops import kernels as K
from drand_tpu_torch.ops.field import FP

ROOT = Path(__file__).resolve().parents[1]

_PURITY = r"""
import importlib, pkgutil, sys
import drand_tpu_torch
names = ["drand_tpu_torch"]
for m in pkgutil.walk_packages(drand_tpu_torch.__path__, "drand_tpu_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k == "drand_tpu"
             or k.startswith("drand_tpu."))
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_neither_jax_nor_drand_tpu():
    out = subprocess.run([sys.executable, "-c", _PURITY], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 15


def test_chip_smoke_imports_neither():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module)
    top = {m.split(".")[0] for m in mods}
    assert "drand_tpu_torch" in top
    assert not top & {"jax", "drand_tpu"}


def test_verifier_without_device_raises_on_cuda_less_host():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is the GPU")
    _, pk = convert_pk()
    with pytest.raises(RuntimeError, match="CUDA"):
        V.Verifier(pk, V.SHAPE_UNCHAINED)
    with pytest.raises(RuntimeError):
        D.resolve(None)
    assert D.resolve("cpu") == torch.device("cpu")


def test_g1_verifier_without_device_raises_on_cuda_less_host():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is the GPU")
    pk = JGC.g2_mul(JGC.G2_GEN, 0x1234567890ABCDEF)
    with pytest.raises(RuntimeError, match="CUDA"):
        V.Verifier(pk, V.SHAPE_UNCHAINED_G1)
    assert V.Verifier(pk, V.SHAPE_UNCHAINED_G1,
                      device="cpu").device == torch.device("cpu")


def test_profiling_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the profile would run")
    from drand_tpu_torch import profiling
    assert profiling.main(["--rounds", "8"]) == 2
    assert profiling.main(["--rounds", "8", "--scheme",
                           "bls-unchained-g1-rfc9380"]) == 2


def test_cuda_wrappers_refuse_cpu_tensors():
    a = torch.as_tensor(FP.encode([1, 2]))
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.mont_mul(a, a, FP)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.mont_reduce(torch.zeros((2, 64), dtype=torch.int32), FP)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.sqr_chain_mul(a, 4, None, FP)
    x = torch.stack([a, a])[None]                 # one Fp2 pair, [1, 2, 2, 32]
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.fp2_products(x, x, FP)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.fp2_sqrs(x, FP)
    f = torch.zeros((2, 12, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.flat_mul(f, f, tuple(range(12)), FP)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.cyclo_sqr(f, FP)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.fp2_sqr_chain_mul(x[0], 3, x[0], FP)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.fp2_sqr5_mul(x[0], x[0], FP)
    pt = torch.zeros((6, 2, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.g2_point_dbl(pt, FP)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.g2_point_add(pt, pt, True, FP)
    Ts = torch.zeros((2, 2, 6, 32), dtype=torch.int32)
    P = torch.zeros((2, 2, 2, 32), dtype=torch.int32)
    Q = torch.zeros((2, 2, 4, 32), dtype=torch.int32)
    m = torch.ones((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.miller_dbl_iter(f, Ts, P, m, FP)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.miller_add_iter(f, Ts, Q, P, m, FP)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.flat_conj(f, FP)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.flat_frob(f, 1, F._FROB_WORDS[1], FP)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.flat_sqr(f, FP)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.g2_dbl_line(torch.zeros((3, 2, 8, 32), dtype=torch.int32), FP)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.g2_add_line(torch.zeros((3, 2, 12, 32), dtype=torch.int32), FP)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.line_merge(f[..., :6, :], f[..., 6:, :], FP)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.add(a, a, FP)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.sub(a, a, FP)


def convert_pk():
    pk = JGC.g1_mul(JGC.G1_GEN, 0x1234567890ABCDEF)
    return JBLS._const_g1_affine(pk), pk


def test_convert_carries_pk_and_signer_table():
    state, pk = convert_pk()
    got = convert.from_drand_tpu(state)
    built = V.Verifier(pk, V.SHAPE_UNCHAINED, device="cpu").pk_limbs
    for g, b, s in zip(got, built, state):
        assert torch.equal(g, b)
        np.testing.assert_array_equal(g.numpy(), np.asarray(s))
    pts = [pk, JGC.G1_INF, JGC.G1_GEN]
    tx, ty, tinf = JBLS.g1_rows_to_limbs(pts)
    cx, cy, cinf = convert.from_drand_tpu((tx, ty, tinf))
    np.testing.assert_array_equal(cx.numpy(), tx)
    np.testing.assert_array_equal(cy.numpy(), ty)
    assert cinf.tolist() == [False, True, False]
    with pytest.raises(ValueError):
        convert.from_drand_tpu((np.full(32, 4096, np.int32), np.zeros(32, np.int32)))


def test_convert_carries_g2_key_and_keeps_it_apart_from_g1():
    """drand_tpu's short-signature key ((x0, x1), (y0, y1)) comes over as
    such; the same limbs as two [2, 32] arrays no longer pass as a G1 (x,
    y), and neither key passes for the other scheme's Verifier."""
    from drand_tpu import verify as JV
    pk = JGC.g2_mul(JGC.G2_GEN, 0x1234567890ABCDEF)
    state = JV.Verifier(pk, JV.SHAPE_UNCHAINED_G1)._pk
    got = convert.from_drand_tpu(state)
    built = V.Verifier(pk, V.SHAPE_UNCHAINED_G1, device="cpu").pk_limbs
    for g, b, s in zip(got, built, state):
        for gc, bc, sc in zip(g, b, s):
            assert torch.equal(gc, bc)
            np.testing.assert_array_equal(gc.numpy(), np.asarray(sc))
    with pytest.raises(ValueError, match="key coordinate"):
        convert.from_drand_tpu(tuple(np.stack([np.asarray(c) for c in xy])
                                     for xy in state))
    with pytest.raises(ValueError):
        convert.from_drand_tpu((state[0], np.asarray(state[1][0])))
    with pytest.raises(ValueError):
        V.Verifier.from_pk_limbs(got, V.SHAPE_UNCHAINED, device="cpu")
    g1_key = convert.from_drand_tpu(convert_pk()[0])
    with pytest.raises(ValueError):
        V.Verifier.from_pk_limbs(g1_key, V.SHAPE_UNCHAINED_G1, device="cpu")
