"""Kernels and slice on a CUDA card (marker `cuda`; skipped without one).

Run on the GPU machine with
`python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`
(the suite's conftest imports JAX, which a GPU machine need not have).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", ["fp", "fr"])
def test_kernels_match_plain_versions_on_card(cuda, name):
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops.field import FP, FR
    F = {"fp": FP, "fr": FR}[name]
    rng = np.random.default_rng(7)
    vals = [0, 1, F.modulus - 1] + [
        int.from_bytes(rng.bytes(48), "little") % F.modulus for _ in range(200)]
    a = torch.from_numpy(F.encode(vals)).to(cuda)
    b = a.flip(0).contiguous()
    assert torch.equal(K.mont_mul(a, b, F), F._mont_mul_plain(a, b))
    assert torch.equal(K.mont_sqr(a, F), F._mont_sqr_plain(a))
    for k in (1, 4, 9):
        assert torch.equal(K.sqr_chain_mul(a, k, b, F),
                           F._sqr_chain_mul_plain(a, k, b))
    wide = torch.cat([a, b], -1)
    wide[:, 53:] = 0                 # < 2^636 < 2^384 * r: inside K3's contract
    assert torch.equal(K.mont_reduce(wide.contiguous(), F),
                       F._mont_reduce_plain(wide))


_REPUNIT_EXP = (((1 << 110) - 1) << 24) | 0b101100111010110110000111


@pytest.mark.parametrize("name", ["fp", "fr"])
@pytest.mark.parametrize("which", ["m-2", "(m+1)/4", "repunit"])
def test_pow_chain_kernel_matches_plain_steps_on_card(cuda, name, which):
    """K4 runs a whole addition chain in one launch, bit-equal to the
    plan's plain steps, on 16384 rows (0, 1, m-1 among them) and a ragged
    300."""
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops.field import FP, FR, addchain_plan
    F = {"fp": FP, "fr": FR}[name]
    m = F.modulus
    e = {"m-2": m - 2, "(m+1)/4": (m + 1) // 4, "repunit": _REPUNIT_EXP}[which]
    ops, build, _, _, used_odd = addchain_plan(e)
    rng = np.random.default_rng(17)
    for rows in (16384, 300):
        vals = [0, 1, m - 1] + [int.from_bytes(rng.bytes(48), "little") % m
                                for _ in range(rows - 3)]
        a = torch.from_numpy(F.encode(vals)).to(cuda)
        K.reset_launches()
        got = F._pow_addchain(a, ops, build, used_odd)
        assert K.launch_counts()["sqr_chain_mul"] == 1
        assert torch.equal(got, F._pow_addchain_plain(a, ops, build,
                                                      used_odd))
    want = [pow(F.from_limbs_host(r), e, m) for r in a.cpu().numpy()[:40]]
    assert [F.from_limbs_host(r) for r in got.cpu().numpy()[:40]] == want


def test_inv_is_one_k4_launch_on_card(cuda):
    """Field.inv on the card is one K4 launch and nothing else."""
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops.field import FP
    rng = np.random.default_rng(18)
    a = _fp_rows(rng, (1000,)).to(cuda)
    K.reset_launches()
    inv = FP.inv(a)
    assert {k: v for k, v in K.launch_counts().items() if v} == {
        "sqr_chain_mul": 1}
    assert torch.equal(FP._mont_mul_plain(inv[1:], a[1:]),
                       FP.one_mont.to(cuda).expand(999, 32))


def test_mont_kernels_staged_on_card(cuda):
    """K1 and K2 through their staged blocks: 16384 rows, a ragged 100 and
    8, a [2, 3, 50] stack, all-(p-1) (against all-(p-1)), and K1's first
    operands of any 384 bits against R^2 and R^3 (Field.reduce_wide)."""
    from drand_tpu_torch.crypto.bls12381.constants import P
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops.field import FP
    rng = np.random.default_rng(19)
    for shape in ((16384,), (100,), (8,), (2, 3, 50)):
        a = _fp_rows(rng, shape).to(cuda)
        b = _fp_rows(rng, shape).flip(0).contiguous().to(cuda)
        assert torch.equal(K.mont_mul(a, b, FP), FP._mont_mul_plain(a, b))
        assert torch.equal(K.mont_sqr(a, FP), FP._mont_sqr_plain(a))
    top = torch.tensor([((P - 1) >> (12 * i)) & 0xFFF for i in range(32)],
                       dtype=torch.int32, device=cuda).expand(70, 32)
    top = top.contiguous()
    assert torch.equal(K.mont_mul(top, top, FP), FP._mont_mul_plain(top, top))
    assert torch.equal(K.mont_sqr(top, FP), FP._mont_sqr_plain(top))
    wide = torch.from_numpy(rng.integers(0, 4096, size=(16384, 32),
                                         dtype=np.int32)).to(cuda)
    wide[:64] = 4095
    for const in (FP.R2, FP.R3):
        c = const.to(cuda).expand(16384, 32).contiguous()
        assert torch.equal(K.mont_mul(wide, c, FP),
                           FP._mont_mul_plain(wide, c))


def _fp_rows(rng, shape):
    """Canonical Fp limbs of `shape` + (32,): 0, 1, p-1, then random."""
    from drand_tpu_torch.crypto.bls12381.constants import P
    from drand_tpu_torch.ops.field import FP
    n = int(np.prod(shape))
    vals = [0, 1, P - 1] + [int.from_bytes(rng.bytes(48), "little") % P
                            for _ in range(n - 3)]
    return torch.from_numpy(FP.encode(vals[:n]).reshape(tuple(shape) + (32,)))


def _max_flat_row():
    """Every stored coefficient p - 1: the largest convolution values."""
    from drand_tpu_torch.crypto.bls12381.constants import P
    row = [((P - 1) >> (12 * i)) & 0xFFF for i in range(32)]
    return torch.tensor([row] * 12, dtype=torch.int32)


def _random_rows(rng, shape):
    """Canonical Fp limbs of `shape` + (32,) at any size: random limbs
    below 2^379 < p."""
    x = rng.integers(0, 4096, size=tuple(shape) + (32,), dtype=np.int32)
    x[..., 31] &= 0x7F
    return torch.from_numpy(x)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 9])
def test_fp2_kernels_match_plain_versions_on_card(cuda, n):
    """K5 and K6 on n stacked pairs of 300 rows, and K5 also on 16384 and
    a ragged 100 rows (32 pair-rows a block)."""
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops import towers as T
    from drand_tpu_torch.ops.field import FP
    rng = np.random.default_rng(11)
    for rows in (16384, 100, 300):
        x = _fp_rows(rng, (n, 2, rows)).to(cuda)
        y = _fp_rows(rng, (n, 2, rows)).flip(2).contiguous().to(cuda)
        got = K.fp2_products(x, y, FP)
        want = T._fp2_products_plain(
            list(zip(T._fp2_unstack(x), T._fp2_unstack(y))))
        assert torch.equal(got, T._fp2_stack(want))
    got = K.fp2_sqrs(x, FP)
    assert torch.equal(got, T._fp2_stack(T._fp2_sqrs_plain(T._fp2_unstack(x))))


@pytest.mark.parametrize("n", [1, 4, 8])
def test_fp2_sqrs_kernel_matches_plain_version_on_card(cuda, n):
    """K6 (two lanes a row, 32-row blocks) at the path's n = 1, 4, 8 on
    ragged row counts 1, 31, 33 and 16384 + 7, with every pair of 0, 1,
    p-1 (Montgomery and raw), x1 = 0 and x0 = x1 in item 0; on a [n, 2,
    3, 50] stack; and through towers.fp2_sqrs on coordinates of
    broadcast shapes."""
    from drand_tpu_torch.crypto.bls12381.constants import P
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops import towers as T
    from drand_tpu_torch.ops.field import FP
    from test_torch_kernel_harness import _raw
    rng = np.random.default_rng(30 + n)
    edge = torch.from_numpy(np.concatenate([FP.encode([0, 1, P - 1]),
                                            _raw([1, P - 1])]))
    for rows in (1, 31, 33, 16384 + 7):
        x = _fp_rows(rng, (n, 2, rows))
        e = min(rows, 25)
        x[0, 0, :e] = edge[torch.arange(e) // 5]
        x[0, 1, :e] = edge[torch.arange(e) % 5]
        if rows > 33:
            x[0, 1, 25:29] = 0
            x[0, 1, 29:33] = x[0, 0, 29:33]
        x = x.to(cuda)
        got = K.fp2_sqrs(x, FP)
        assert torch.equal(got, T._fp2_stack(T._fp2_sqrs_plain(
            T._fp2_unstack(x))))
    x = _fp_rows(rng, (n, 2, 3, 50)).to(cuda)
    assert torch.equal(K.fp2_sqrs(x, FP), T._fp2_stack(T._fp2_sqrs_plain(
        T._fp2_unstack(x))))
    a = (x[0, 0, :1], x[0, 1])                 # [1, 50] against [3, 50]
    got = T.fp2_sqrs([a] * n)
    want = T._fp2_sqrs_plain([tuple(c.cpu() for c in a)] * n)
    for g, w in zip(got, want):
        assert torch.equal(g[0].cpu(), w[0]) and torch.equal(g[1].cpu(), w[1])


def test_flat_conj_kernel_matches_plain_version_on_card(cuda):
    """K15 (eight lanes a coefficient, a grid-stride loop over as many
    blocks as the card holds) on ragged row counts 1, 31, 33 and 16384 +
    7, the harness's edge coefficients (borrows crossing lanes) in every
    slot of the first rows and zero and all-(p-1) rows among them; on a
    broadcast [3, 50] leading shape."""
    from drand_tpu_torch.ops import flat12 as F
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops.field import FP
    from test_torch_kernel_harness import _conj_edges
    rng = np.random.default_rng(31)
    edges = torch.from_numpy(_conj_edges())
    E = len(edges)
    for rows in (1, 31, 33, 16384 + 7):
        a = _fp_rows(rng, (rows, 12))
        for r in range(min(rows, E)):
            a[r] = edges[(torch.arange(12) + r) % E]
        if rows > E + 2:
            a[E] = 0
            a[E + 1] = _max_flat_row()
        a = a.to(cuda)
        assert torch.equal(K.flat_conj(a, FP), F._flat_conj_plain(a))
    b = _fp_rows(rng, (1, 50, 12)).to(cuda).expand(3, 50, 12, 32)
    assert torch.equal(F.flat_conj(b), F._flat_conj_plain(b))


def test_k6_k15_attrs_show_no_spill_on_card(cuda):
    """kernel_attrs of K6 and K15: no local memory, at least one block a
    SM."""
    from drand_tpu_torch.ops import kernels as K
    for name in ("fp2_sqrs", "flat_conj"):
        at = K.kernel_attrs(name)
        assert at["local_bytes"] == 0, (name, at)
        assert at["blocks_per_sm"] >= 1, (name, at)


@pytest.mark.parametrize("b_idx", [tuple(range(12)), (0, 2, 3, 6, 8, 9),
                                   (11,), (0, 5, 6, 11)])
def test_flat_mul_kernel_matches_plain_version_on_card(cuda, b_idx):
    """K13 (dense, on LINE_IDX and on other sparse layouts) on 100,
    16384 and 8 rows, with the all-(p-1) operand on one side, the other or
    both, and zero rows, in the rows on both sides of each 32-row block
    edge."""
    from drand_tpu_torch.ops import flat12 as F
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops.field import FP
    rng = np.random.default_rng(12)
    J = len(b_idx)
    for rows in (100, 16384, 8):
        a = _fp_rows(rng, (rows, 12))
        b = _fp_rows(rng, (rows, J))
        at = [r for e in range(32, rows, 32) for r in (e - 2, e - 1, e, e + 1)
              if r < rows] or [0, 1, 2, 3]
        a[at[0::4]] = _max_flat_row()
        b[at[0::4]] = _max_flat_row()[:J]
        a[at[1::4]] = _max_flat_row()
        b[at[2::4]] = _max_flat_row()[:J]
        a[at[3::4]] = 0
        a, b = a.to(cuda), b.to(cuda)
        assert torch.equal(K.flat_mul(a, b, b_idx, FP),
                           F._flat_mul_plain(a, b, b_idx))
    # broadcast leading shapes, as the Miller loop's first square gives
    one = F.flat_broadcast(F.FLAT_ONE, (b.shape[0],), cuda)
    assert torch.equal(K.flat_mul(one, b, b_idx, FP),
                       F._flat_mul_plain(one, b, b_idx))


def test_cyclo_sqr_kernel_matches_plain_version_on_card(cuda):
    from drand_tpu_torch.ops import flat12 as F
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops.field import FP
    rng = np.random.default_rng(13)
    a = _fp_rows(rng, (200, 12)).to(cuda)
    assert torch.equal(K.cyclo_sqr(a, FP), F._flat_cyclo_sqr_plain(a))
    # the chain form: k squares in one launch, 200 rows a ragged last block
    for k in (2, 9, 32):
        assert torch.equal(K.cyclo_sqr(a, FP, k),
                           F._flat_cyclo_sqr_plain(a, k))
    # unitary rows (the final exponentiation's easy part): the full square
    u = F.flat_mul(F.flat_conj(a), F.flat_inv(a))
    u = F.flat_mul(F.flat_frob(u, 2), u)
    got = K.cyclo_sqr(u, FP)
    assert torch.equal(got, F._flat_cyclo_sqr_plain(u))
    assert torch.equal(got, F._flat_mul_plain(u, u))


def test_tower_ops_reach_their_kernels_on_card(cuda, monkeypatch):
    """On a CUDA tensor the tower entry points launch K5, K6, K13 and K14
    and never reach a plain version or the limb convolution."""
    from drand_tpu_torch.ops import field as TFd
    from drand_tpu_torch.ops import flat12 as F
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops import towers as T

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on a CUDA tensor")

    for mod, name in ((T, "_fp2_products_plain"), (T, "_fp2_sqrs_plain"),
                      (F, "_flat_mul_plain"), (F, "_flat_cyclo_sqr_plain"),
                      (T, "_poly_mul_var"), (F, "_poly_mul_var"),
                      (TFd, "_poly_mul_var")):
        monkeypatch.setattr(mod, name, refuse)
    rng = np.random.default_rng(14)
    x = _fp_rows(rng, (2, 64)).to(cuda)
    a = _fp_rows(rng, (64, 12)).to(cuda)
    K.reset_launches()
    T.fp2_products([((x[0], x[1]), (x[1], x[0]))])
    T.fp2_sqr((x[0], x[1]))
    T.fp2_sqrs([(x[0], x[1]), (x[1], x[0])])
    F.flat_mul(a, a[..., :6, :], (0, 2, 3, 6, 8, 9))
    F.flat_mul(a, a)
    F.flat_cyclo_sqr(a)
    counts = K.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "fp2_products": 1, "fp2_sqrs": 2, "flat_mul": 2, "cyclo_sqr": 1}


def test_chained_segment_on_card(cuda):
    from drand_tpu_torch import fixtures as FX
    from drand_tpu_torch import verify as V
    _, pk = FX.fixture_keypair()
    sigs, _, _ = FX.load_chained_fixture()
    ok = V.Verifier(pk, V.SHAPE_CHAINED).verify_chain_segment(2, sigs[1:9],
                                                              sigs[0])
    assert ok.all()


def test_chained_segment_async_on_card(cuda):
    """Two segments queued, then resolved in reverse order: rounds 1-65
    from the genesis seed (round 1 alone in a bucket of its own) and
    rounds 20-26 with round 22's signature flipped; each equals the
    blocking form."""
    from drand_tpu_torch import fixtures as FX
    from drand_tpu_torch import verify as V
    _, pk = FX.fixture_keypair()
    sigs, _, seed = FX.load_chained_fixture()
    seed = np.frombuffer(seed, np.uint8)
    ver = V.Verifier(pk, V.SHAPE_CHAINED)
    bad = sigs[19:26].copy()
    bad[2, 40] ^= 0x01
    first = ver.verify_chain_segment_async(1, sigs, seed)
    second = ver.verify_chain_segment_async(20, bad, sigs[18])
    ok2, ok1 = second(), first()
    assert ok1.shape == (65,) and ok1.all()
    assert ok2.tolist() == [True, True, False, False, True, True, True]
    np.testing.assert_array_equal(ok1, ver.verify_chain_segment(1, sigs, seed))
    np.testing.assert_array_equal(
        ok2, ver.verify_chain_segment(20, bad, sigs[18]))


@pytest.mark.parametrize("k", [1, 5, 13])
def test_fp2_chain_kernels_match_plain_versions_on_card(cuda, k):
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops import towers as T
    from drand_tpu_torch.ops.field import FP
    rng = np.random.default_rng(15)
    x = _fp_rows(rng, (2, 300)).to(cuda)
    t = _fp_rows(rng, (2, 300)).to(cuda)
    assert torch.equal(K.fp2_sqr_chain_mul(x, k, t, FP),
                       T._fp2_sqr_chain_mul_plain(x, k, t))
    assert torch.equal(K.fp2_sqr_chain_mul(x, k, None, FP),
                       T._fp2_sqr_chain_mul_plain(x, k))
    if k == 5:
        assert torch.equal(K.fp2_sqr5_mul(x, t, FP),
                           T._fp2_sqr_chain_mul_plain(x, 5, t))


def test_g2_point_kernels_match_plain_versions_on_card(cuda):
    """K9 and K10 on random rows with the doubling, cancelling and
    infinite cases among them."""
    from drand_tpu_torch.ops import curve as C
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops.field import FP
    rng = np.random.default_rng(16)
    p1 = _fp_rows(rng, (6, 300))
    p2 = _fp_rows(rng, (6, 300))
    p2[:, :2] = p1[:, :2]
    p2[2:4, 1] = FP.neg(p1[2:4, 1])
    p1[4:, 2] = 0
    p2[4:, 3] = 0
    p1, p2 = p1.to(cuda), p2.to(cuda)
    ops = C.Fp2PlainOps
    assert torch.equal(K.g2_point_dbl(p1, FP), C.g2_pack(
        C._point_double_formula(C.g2_unpack(p1), ops)))
    for wd in (False, True):
        assert torch.equal(K.g2_point_add(p1, p2, wd, FP), C.g2_pack(
            C._point_add_formula(C.g2_unpack(p1), C.g2_unpack(p2), ops, wd)))


@pytest.mark.parametrize("n", [1, 2, 3, 9, 16, 32])
def test_g2_point_dbl_chain_matches_plain_version_on_card(cuda, n):
    """K9's chain of n doublings (each run length of the path's ladders)
    on a row count that leaves a partial block, infinite rows among
    them, against n plain doublings."""
    from drand_tpu_torch.ops import curve as C
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops.field import FP
    p = _fp_rows(np.random.default_rng(20 + n), (6, 100))
    p[4:, 5:9] = 0
    p = p.to(cuda)
    assert torch.equal(K.g2_point_dbl(p, FP, n), C._g2_point_dbl_plain(p, n))


def test_x_ladder_runs_one_k9_launch_a_run_on_card(cuda):
    """[|x|]Q on the card: one K9 launch for each of the ladder's six
    runs of doublings and one K10 launch for each of its five additions,
    equal to the ladder on the CPU."""
    from drand_tpu_torch.ops import curve as C
    from drand_tpu_torch.ops import kernels as K
    pt = C.g2_unpack(_fp_rows(np.random.default_rng(21), (6, 64)))
    want = C.g2_pack(C.g2_mul_x_abs(pt))
    K.reset_launches()
    got = C.g2_pack(C.g2_mul_x_abs(tuple(tuple(c.to(cuda) for c in xy)
                                         for xy in pt)))
    assert K.launch_counts()["g2_point_dbl"] == 6
    assert K.launch_counts()["g2_point_add"] == 5
    assert torch.equal(got.cpu(), want)


def test_miller_kernels_match_plain_versions_on_card(cuda):
    """K11 and K12 on random rows (a row count that leaves a partial
    block), every active/inactive pair combination among them."""
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops import pairing as PR
    from drand_tpu_torch.ops.field import FP
    rng = np.random.default_rng(17)
    n = 37
    f = _fp_rows(rng, (n, 12)).to(cuda)
    Ts = _fp_rows(rng, (n, 2, 6)).to(cuda)
    Q = _fp_rows(rng, (n, 2, 4)).to(cuda)
    P = _fp_rows(rng, (n, 2, 2)).to(cuda)
    masks = torch.from_numpy(rng.integers(0, 2, (n, 2), dtype=np.int32))
    masks[:4] = torch.tensor([[1, 1], [1, 0], [0, 1], [0, 0]])
    masks = masks.to(cuda)
    for got, want in zip(K.miller_dbl_iter(f, Ts, P, masks, FP),
                         PR._miller_dbl_iter_plain(f, Ts, P, masks)):
        assert torch.equal(got, want)
    for got, want in zip(K.miller_add_iter(f, Ts, Q, P, masks, FP),
                         PR._miller_add_iter_plain(f, Ts, Q, P, masks)):
        assert torch.equal(got, want)


def test_flat_conj_and_frob_kernels_match_plain_versions_on_card(cuda):
    from drand_tpu_torch.ops import flat12 as F
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops.field import FP
    rng = np.random.default_rng(18)
    a = _fp_rows(rng, (200, 12))
    a[0] = _max_flat_row()
    a = a.to(cuda)
    assert torch.equal(K.flat_conj(a, FP), F._flat_conj_plain(a))
    for n in (1, 2, 3):
        assert torch.equal(K.flat_frob(a, n, F._FROB_WORDS[n], FP),
                           F._flat_frob_plain(a, n))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_flat_frob_kernel_matches_plain_version_on_card(cuda, n):
    """K16 (a warp an output coefficient of 32 rows, each term by its
    constant's class) on 1, 33 and 16384 rows: 0, 1, p-1 in the first
    row's slots, then a zero row, an all-(p-1) row and random rows."""
    from drand_tpu_torch.ops import flat12 as F
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops.field import FP
    rng = np.random.default_rng(40 + n)
    for rows in (1, 33, 16384):
        a = _random_rows(rng, (rows, 12))
        a[0] = _fp_rows(rng, (12,))
        if rows > 2:
            a[1] = 0
            a[2] = _max_flat_row()
        a = a.to(cuda)
        K.reset_launches()
        got = K.flat_frob(a, n, F._FROB_WORDS[n], FP)
        assert K.launch_counts()["flat_frob"] == 1
        assert torch.equal(got, F._flat_frob_plain(a, n))


def test_g2_dbl_line_kernel_matches_plain_version_on_card(cuda):
    """K18 (three threads a row on K11's doubling shares, 32 rows a block)
    on 1, 31 and 33 rows and on three pairs of 16384 rows stacked, Z = 1
    and Z = 0 rows and 0, 1, p-1 coordinates among them."""
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops import pairing as PR
    from drand_tpu_torch.ops.field import FP
    rng = np.random.default_rng(44)
    for shape in ((1, 1), (1, 31), (1, 33), (3, 16384)):
        x = _random_rows(rng, shape + (8,))
        x[:, 0] = _fp_rows(rng, (shape[0], 8))
        x[:, 1::4, 4] = FP.one_mont
        x[:, 1::4, 5] = 0
        x[:, 2::4, 4:6] = 0
        x = x.to(cuda)
        K.reset_launches()
        to, lo = K.g2_dbl_line(x, FP)
        assert K.launch_counts()["g2_dbl_line"] == 1
        c = [x[..., i, :] for i in range(8)]
        Tn, L = PR._dbl_step_plain(((c[0], c[1]), (c[2], c[3]), (c[4], c[5])),
                                   c[6], c[7])
        assert torch.equal(to, torch.stack([v for xy in Tn for v in xy], -2))
        assert torch.equal(lo, torch.stack([v for xy in L for v in xy], -2))


def test_flat_sqr_kernel_matches_plain_version_on_card(cuda):
    """K17 (32 rows a block staged through stage.cuh, six threads a row
    folding their coefficients into the output rows) on 1, 31 and 33 rows
    and on a [3, 16384] stack, one launch each: 0, 1, p-1 in the first
    row's slots, then a zero row, an all-(p-1) row and random rows."""
    from drand_tpu_torch.ops import flat12 as F
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops.field import FP
    rng = np.random.default_rng(45)
    for shape in ((1,), (31,), (33,), (3, 16384)):
        a = _random_rows(rng, shape + (12,))
        a.view(-1, 12, 32)[0] = _fp_rows(rng, (12,))
        if a.numel() > 2 * 12 * 32:
            a.view(-1, 12, 32)[1] = 0
            a.view(-1, 12, 32)[2] = _max_flat_row()
        a = a.to(cuda)
        K.reset_launches()
        got = K.flat_sqr(a, FP)
        assert K.launch_counts()["flat_sqr"] == 1
        assert torch.equal(got, F._flat_sqr_plain(a))


def test_g2_add_line_kernel_matches_plain_version_on_card(cuda):
    """K19 (three threads a row on K12's addition shares, 32 rows a block)
    on 1, 31 and 33 rows and on three pairs of 16384 rows stacked, one
    launch each: Z = 1 rows, Z = 0 rows, T = Q and T = -Q in affine form
    (H = 0) and 0, 1, p-1 coordinates among them."""
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops import pairing as PR
    from drand_tpu_torch.ops.field import FP
    rng = np.random.default_rng(46)
    for shape in ((1, 1), (1, 31), (1, 33), (3, 16384)):
        x = _random_rows(rng, shape + (12,))
        x[:, 0] = _fp_rows(rng, (shape[0], 12))
        x[:, 1::5, 4] = FP.one_mont
        x[:, 1::5, 5] = 0
        x[:, 2::5, 4:6] = 0
        for k, row in ((3, 0), (4, 1)):        # T = Q, T = -Q, affine
            x[:, k::5, 0:2] = x[:, k::5, 6:8]
            x[:, k::5, 2:4] = x[:, k::5, 8:10]
            if row:
                x[:, k::5, 2:4] = FP.neg(x[:, k::5, 8:10])
            x[:, k::5, 4] = FP.one_mont
            x[:, k::5, 5] = 0
        x = x.to(cuda)
        K.reset_launches()
        to, lo = K.g2_add_line(x, FP)
        assert K.launch_counts()["g2_add_line"] == 1
        c = [x[..., i, :] for i in range(12)]
        Tn, L = PR._add_step_plain(((c[0], c[1]), (c[2], c[3]), (c[4], c[5])),
                                   ((c[6], c[7]), (c[8], c[9])), c[10], c[11])
        assert torch.equal(to, torch.stack([v for xy in Tn for v in xy], -2))
        assert torch.equal(lo, torch.stack([v for xy in L for v in xy], -2))


def test_k16_k18_attrs_show_no_spill_on_card(cuda):
    """kernel_attrs of K16 and K18: no local memory (no spill, no stack
    frame); K16 two 384-thread blocks a SM, K18 at most 168 registers and
    four blocks (12 warps) a SM."""
    from drand_tpu_torch.ops import kernels as K
    frob, line = K.kernel_attrs("flat_frob"), K.kernel_attrs("g2_dbl_line")
    assert frob["local_bytes"] == 0 and frob["blocks_per_sm"] >= 2, frob
    assert line["local_bytes"] == 0 and line["num_regs"] <= 168, line
    assert line["blocks_per_sm"] >= 4, line


def test_k17_k19_attrs_show_no_spill_on_card(cuda):
    """kernel_attrs of K17 and K19: no local memory (no spill, no stack
    frame); K17 four 192-thread blocks a SM (16384 rows in one wave), K19
    at most 168 registers and four 96-thread blocks a SM."""
    from drand_tpu_torch.ops import kernels as K
    sqr, add = K.kernel_attrs("flat_sqr"), K.kernel_attrs("g2_add_line")
    assert sqr["local_bytes"] == 0 and sqr["blocks_per_sm"] >= 4, sqr
    assert add["local_bytes"] == 0 and add["num_regs"] <= 168, add
    assert add["blocks_per_sm"] >= 4, add


def test_curve_and_pairing_ops_reach_their_kernels_on_card(cuda, monkeypatch):
    """On a CUDA tensor the Fp2 power, the G2 point ops, the Miller loop
    and the Frobenius maps launch K7, K9-K12, K15 and K16 and never reach
    a plain version."""
    from drand_tpu_torch.ops import curve as C
    from drand_tpu_torch.ops import flat12 as F
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops import pairing as PR
    from drand_tpu_torch.ops import towers as T

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on a CUDA tensor")

    for mod, name in ((T, "_fp2_sqr_chain_mul_plain"),
                      (C, "_point_double_formula"), (C, "_point_add_formula"),
                      (PR, "_miller_dbl_iter_plain"),
                      (PR, "_miller_add_iter_plain"),
                      (F, "_flat_conj_plain"), (F, "_flat_frob_plain")):
        monkeypatch.setattr(mod, name, refuse)
    rng = np.random.default_rng(19)
    x = _fp_rows(rng, (2, 64)).to(cuda)
    pt = C.g2_unpack(_fp_rows(rng, (6, 64)).to(cuda))
    a = _fp_rows(rng, (64, 12)).to(cuda)
    K.reset_launches()
    T.fp2_pow_const((x[0], x[1]), T._E_RATIO)
    C.point_add(C.point_double(pt, C.Fp2Ops), pt, C.Fp2Ops)
    PR.miller_loop_pairs([((x[0], x[1]), ((x[0], x[1]), (x[1], x[0])))] * 2)
    F.flat_frob(F.flat_conj(a), 2)
    counts = K.launch_counts()
    for name in ("fp2_sqr_chain_mul", "g2_point_dbl", "g2_point_add",
                 "miller_dbl_iter", "miller_add_iter", "flat_conj",
                 "flat_frob"):
        assert counts[name] > 0, (name, counts)
    assert counts["miller_add_iter"] == 5 and counts["miller_dbl_iter"] == 63


def test_trio_kernels_match_plain_versions_on_card(cuda):
    """K17 and K20 with the all-(p-1) and zero rows, K18 and K19 on three
    pairs stacked on the rows (Z = 1 in the first rows), K21 and K22 with
    0, 1 and p-1 meeting each other."""
    from drand_tpu_torch.ops import flat12 as F
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops import pairing as PR
    from drand_tpu_torch.ops.field import FP
    rng = np.random.default_rng(20)
    a = _fp_rows(rng, (101, 12))
    a[0] = _max_flat_row()
    a[1] = 0
    a = a.to(cuda)
    assert torch.equal(K.flat_sqr(a, FP), F._flat_sqr_plain(a))
    l1, l2 = a[..., :6, :], a.flip(0)[..., 6:, :]
    assert torch.equal(K.line_merge(l1, l2, FP), F._line_merge_plain(l1, l2))
    for width, step in ((8, PR._dbl_step_plain), (12, PR._add_step_plain)):
        x = _fp_rows(rng, (3, 50, width))
        x[:, :5, 4] = FP.one_mont
        x[:, :5, 5] = 0
        x = x.to(cuda)
        to, lo = (K.g2_add_line if width == 12 else K.g2_dbl_line)(x, FP)
        c = [x[..., i, :] for i in range(width)]
        Tj = ((c[0], c[1]), (c[2], c[3]), (c[4], c[5]))
        args = ((Tj, c[6], c[7]) if width == 8 else
                (Tj, ((c[6], c[7]), (c[8], c[9])), c[10], c[11]))
        Tn, L = step(*args)
        assert torch.equal(to, torch.stack([v for xy in Tn for v in xy], -2))
        assert torch.equal(lo, torch.stack([v for xy in L for v in xy], -2))
    e = _fp_rows(rng, (40,)).to(cuda)
    x, y = e.repeat_interleave(40, 0), e.repeat(40, 1)
    assert torch.equal(K.add(x, y, FP), FP.add(x, y))
    assert torch.equal(K.sub(x, y, FP), FP.sub(x, y))


def test_three_pair_check_reaches_trio_kernels_on_card(cuda, monkeypatch):
    """pairing_check_pairs at K = 3 takes the trio executor on the card:
    K17, K18, K19 (and K13 for the lines) launch, K11 and K12 do not, no
    plain version runs, and the verdicts equal the golden model's."""
    from drand_tpu_torch.crypto.bls12381 import curve as GC
    from drand_tpu_torch.crypto.bls12381 import pairing as GP
    from drand_tpu_torch.ops import flat12 as F
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops import pairing as PR
    from drand_tpu_torch.ops.field import FP

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on a CUDA tensor")

    for mod, name in ((F, "_flat_sqr_plain"), (F, "_flat_mul_plain"),
                      (PR, "_dbl_step_plain"), (PR, "_add_step_plain")):
        monkeypatch.setattr(mod, name, refuse)
    p = GC.g1_mul(GC.G1_GEN, 0x1234567)
    q = GC.g2_mul_raw(GC.G2_GEN, 0x7654321)
    rows = [[(p, q), (GC.g1_neg(p), q), (p, q)]] * 2

    def enc(vals):
        return torch.from_numpy(FP.encode(vals)).to(cuda)
    pairs = []
    for k in range(3):
        (xp, yp), (xq, yq) = (GC.g1_affine(rows[0][k][0]),
                              GC.g2_affine(rows[0][k][1]))
        pairs.append(((enc([xp] * 2), enc([yp] * 2)),
                      ((enc([xq[0]] * 2), enc([xq[1]] * 2)),
                       (enc([yq[0]] * 2), enc([yq[1]] * 2)))))
    active = [torch.tensor([True, True], device=cuda),
              torch.tensor([True, True], device=cuda),
              torch.tensor([False, True], device=cuda)]
    K.reset_launches()
    ok = PR.pairing_check_pairs(pairs, active)
    counts = K.launch_counts()
    for name in ("flat_sqr", "g2_dbl_line", "g2_add_line", "flat_mul"):
        assert counts[name] > 0, (name, counts)
    assert counts["miller_dbl_iter"] == counts["miller_add_iter"] == 0
    want = [GP.pairing_check(rows[0][:2]), GP.pairing_check(rows[0])]
    assert ok.tolist() == want == [True, False]


def test_trio_verifier_on_card(cuda):
    """The trio Miller executor verifies the committed chained rounds 2-9
    and refuses one with a flipped byte."""
    from drand_tpu_torch import fixtures as FX
    from drand_tpu_torch import verify as V
    from drand_tpu_torch.profiling import trio_batch_async
    _, pk = FX.fixture_keypair()
    sigs, _, _ = FX.load_chained_fixture()
    ver = V.Verifier(pk, V.SHAPE_CHAINED)
    rounds = np.arange(2, 10, dtype=np.uint64)
    bad = sigs[1:9].copy()
    bad[3, 40] ^= 1
    assert trio_batch_async(ver, rounds, sigs[1:9], sigs[:8])().all()
    assert trio_batch_async(ver, rounds, bad, sigs[:8])().tolist() == \
        [True] * 3 + [False] + [True] * 4


def test_pow_chain_kernel_at_sqrt_ratio_exponent_on_card(cuda):
    """K4 at the G1 map's (p - 3)/4, the exponent of
    towers.make_fp_sqrt_ratio: FP.pow_const takes the addition chain, one
    launch, bit-equal to the plan's plain steps on 16384 rows (0, 1, p-1
    among them) and to pow on the first 40."""
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops.field import FP, addchain_plan
    p = FP.modulus
    e = (p - 3) // 4
    ops, build, _, _, used_odd = addchain_plan(e)
    rng = np.random.default_rng(19)
    vals = [0, 1, p - 1] + [int.from_bytes(rng.bytes(48), "little") % p
                            for _ in range(16381)]
    a = torch.from_numpy(FP.encode(vals)).to(cuda)
    K.reset_launches()
    got = FP.pow_const(a, e)
    assert {k: v for k, v in K.launch_counts().items() if v} == {
        "sqr_chain_mul": 1}
    assert torch.equal(got, FP._pow_addchain_plain(a, ops, build, used_odd))
    want = [pow(v, e, p) for v in vals[:40]]
    assert [FP.from_limbs_host(r) for r in got.cpu().numpy()[:40]] == want


def test_g1_verifier_on_card(cuda):
    """The short-signature scheme on the card, both Miller executors: the
    committed G1 fixture's rounds 1-64 true, and a flipped byte false in
    exactly its row."""
    from drand_tpu_torch import fixtures as FX
    from drand_tpu_torch import verify as V
    from drand_tpu_torch.profiling import trio_batch_async
    _, pk = FX.fixture_keypair_g2()
    sigs = np.load(FX.G1_FIXTURE)[:64]
    ver = V.Verifier(pk, V.SHAPE_UNCHAINED_G1)
    rounds = np.arange(1, 65, dtype=np.uint64)
    bad = sigs.copy()
    bad[37, 20] ^= 1
    assert ver.verify_batch(rounds, sigs).all()
    want = [True] * 37 + [False] + [True] * 26
    assert ver.verify_batch(rounds, bad).tolist() == want
    assert trio_batch_async(ver, rounds, bad)().tolist() == want


def test_chain_verifier_on_card(cuda):
    """The port's ChainVerifier with no device named runs on the card:
    rounds 1-65 of the committed chained segment from the genesis seed
    (round 1 alone in a bucket of its own) with round 30's signature
    flipped and round 31's prev the flipped signature: rounds 30 and 31
    false, as the port's Verifier gives them; the packed form agrees."""
    from drand_tpu_torch import fixtures as FX
    from drand_tpu_torch import verify as V
    from drand_tpu_torch.chain.beacon import Beacon
    from drand_tpu_torch.chain.scheme import scheme_by_id
    from drand_tpu_torch.chain.segment import PackedBeacons
    from drand_tpu_torch.chain.verify import ChainVerifier
    _, pk = FX.fixture_keypair()
    sigs, pk_bytes, seed = FX.load_chained_fixture()
    bad = sigs.copy()
    bad[29, 40] ^= 0x01
    cv = ChainVerifier(scheme_by_id("pedersen-bls-chained"), pk_bytes)
    assert cv.device.type == "cuda"
    beacons = [Beacon(r, bytes(bad[r - 1]),
                      seed if r == 1 else bytes(bad[r - 2]))
               for r in range(1, 66)]
    got = cv.verify_chain_segment(beacons, seed)
    want = V.Verifier(pk, V.SHAPE_CHAINED).verify_chain_segment(
        1, bad, np.frombuffer(seed, np.uint8))
    assert got.tolist() == want.tolist() == \
        [True] * 29 + [False, False] + [True] * 34
    packed = cv.verify_packed_segment_async(PackedBeacons(1, bad), seed)()
    assert packed.tolist() == got.tolist()


def test_startup_recovery_on_card(cuda, tmp_path):
    """startup_recovery over a store of the genesis seed and the 65
    chained rounds with round 20's signature flipped and round 40's blob
    torn, the BLS stage on the card: bad_sigs [20] (round 21's stored prev
    then fails its link), corrupt [40], the tip rolled back to 19, one
    dispatch record a batch, and a clean rescan."""
    import asyncio
    import sqlite3

    from drand_tpu_torch import dispatch as D
    from drand_tpu_torch import fixtures as FX
    from drand_tpu_torch.chain.beacon import Beacon
    from drand_tpu_torch.chain.recovery import scan_store, startup_recovery
    from drand_tpu_torch.chain.scheme import scheme_by_id
    from drand_tpu_torch.chain.store import SqliteStore
    from drand_tpu_torch.chain.verify import ChainVerifier
    sigs, pk_bytes, seed = FX.load_chained_fixture()
    path = str(tmp_path / "chain.db")
    store = SqliteStore(path)
    rows = [Beacon(0, seed)] + [
        Beacon(r, bytes(sigs[r - 1]), seed if r == 1 else bytes(sigs[r - 2]))
        for r in range(1, 66)]
    rows[20].signature = bytes([rows[20].signature[0] ^ 0x01]) + \
        rows[20].signature[1:]
    store.put_many(rows)
    con = sqlite3.connect(path)
    with con:
        con.execute("UPDATE beacons SET data = substr(data, 1, 50) "
                    "WHERE round = 40")
    con.close()
    cv = ChainVerifier(scheme_by_id("pedersen-bls-chained"), pk_bytes)
    D.DISPATCH.clear()
    report, summary = asyncio.run(startup_recovery(store, cv))
    assert (report.corrupt, report.unlinked, report.bad_sigs,
            report.missing, report.verified_tip) == ([40], [21], [20], [], 19)
    assert summary == {"quarantined": 3, "truncated": 43, "verified_tip": 19}
    # rounds 1-20 (round 1 alone against the seed), 22-39 and 41-65
    assert [(r.n, r.bucket) for r in D.DISPATCH.records("verify")] == \
        [(1, 8), (19, 64), (18, 64), (25, 64)]
    again = asyncio.run(scan_store(store, cv))
    assert again.ok and again.verify_checked and again.verified_tip == 19
    store.close()


def test_g1_chain_verifier_on_card(cuda):
    """bls-unchained-g1-rfc9380 through the port's ChainVerifier, the key
    as compressed G2 bytes: rounds 1-64 of the G1 fixture true, one
    flipped byte false in exactly its row."""
    from drand_tpu_torch import fixtures as FX
    from drand_tpu_torch.chain.scheme import scheme_by_id
    from drand_tpu_torch.chain.segment import PackedBeacons
    from drand_tpu_torch.chain.verify import ChainVerifier
    from drand_tpu_torch.crypto.bls12381 import curve as GC
    _, pk = FX.fixture_keypair_g2()
    sigs = np.load(FX.G1_FIXTURE)[:64].copy()
    sigs[17, 20] ^= 1
    cv = ChainVerifier(scheme_by_id("bls-unchained-g1-rfc9380"),
                       GC.g2_to_bytes(pk))
    got = cv.verify_packed_segment_async(
        PackedBeacons(1, sigs, chained=False), b"")()
    assert got.tolist() == [True] * 17 + [False] + [True] * 46


def _partials_group(t=9, n=16, secret=424242):
    import hashlib

    from drand_tpu_torch.crypto.poly import PriPoly

    def rand(k):
        return b"".join(hashlib.sha512(b"card" + i.to_bytes(8, "big")).digest()
                        for i in range(-(-k // 64)))[:k]
    poly = PriPoly.random(t, secret=secret, rand=rand)
    return poly, poly.shares(n), poly.commit()


def test_g2_point_mul_bits_from_infinity_matches_plain_on_card(cuda):
    """Every row's ladder starts at infinity, K9 and K10 take it from the
    first step, and the result is bit-equal to the formulas under
    Fp2PlainOps (rows at scalar 0 stay at infinity)."""
    from drand_tpu_torch.crypto.bls12381 import curve as GC
    from drand_tpu_torch.crypto.bls12381.constants import R
    from drand_tpu_torch.ops import curve as DC
    from drand_tpu_torch.ops import kernels as K
    from drand_tpu_torch.ops import towers as T
    from drand_tpu_torch.ops.field import FP
    rng = np.random.default_rng(15)
    rows = 300
    base = [GC.g2_affine(GC.g2_mul_raw(GC.G2_GEN, 3 + i)) for i in range(10)]
    aff = [base[i % 10] for i in range(rows)]
    scal = [0, 1, R - 1] + [int.from_bytes(rng.bytes(32), "big") % R
                            for _ in range(rows - 3)]

    def enc(vals):
        return torch.from_numpy(FP.encode(vals)).to(cuda)

    pt = ((enc([a[0][0] for a in aff]), enc([a[0][1] for a in aff])),
          (enc([a[1][0] for a in aff]), enc([a[1][1] for a in aff])),
          T.fp2_broadcast(T.FP2_ONE, (rows,), cuda))
    bits = torch.from_numpy(np.unpackbits(np.frombuffer(b"".join(
        s.to_bytes(32, "big") for s in scal), np.uint8).reshape(rows, 32),
        axis=-1).astype(np.int32)).to(cuda)
    K.reset_launches()
    got = DC.point_mul_bits(pt, bits, DC.Fp2Ops)
    assert K.KERNELS["g2_point_dbl"].launches == 256
    assert K.KERNELS["g2_point_add"].launches == 256
    want = DC.point_mul_bits(pt, bits, DC.Fp2PlainOps)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b)
    assert bool(DC.point_is_inf(got, DC.Fp2Ops)[0])
    for row in (1, 2, 7):
        want_pt = GC.g2_mul_raw((aff[row][0], aff[row][1], (1, 0)), scal[row])
        assert GC.g2_affine(DC.g2_decode(got, row)) == GC.g2_affine(want_pt)


def test_rounds_verify_64x16_one_flipped_on_card(cuda):
    import hashlib

    from drand_tpu_torch import dispatch as DSP
    from drand_tpu_torch import fixtures as FX
    from drand_tpu_torch import verify as V
    from drand_tpu_torch.beacon.crypto_backend import DeviceBackend
    _, shares, pub = _partials_group()
    rounds = np.arange(1, 65, dtype=np.uint64)
    be8 = V.rounds_be8(rounds)
    msgs = [hashlib.sha256(m.tobytes()).digest() for m in be8]
    sigs = [FX.sign_batch_g2(s.value, be8) for s in shares]
    by_round = [[s.index.to_bytes(2, "big") + sigs[j][r].tobytes()
                 for j, s in enumerate(shares)] for r in range(64)]
    be = DeviceBackend(pub, 9, 16)
    assert be.device.type == "cuda"
    DSP.DISPATCH.clear()
    assert all(all(row) for row in be.verify_partials_rounds(msgs, by_round))
    g = by_round[32][5]
    by_round[32][5] = g[:10] + bytes([g[10] ^ 1]) + g[11:]
    ok = be.verify_partials_rounds(msgs, by_round)
    assert [(r, j) for r in range(64) for j in range(16)
            if not ok[r][j]] == [(32, 5)]
    assert [(r.seam, r.n, r.bucket) for r in DSP.DISPATCH.records()] == \
        [("rounds", 64, 64)] * 2


def test_recover_rounds_equals_secret_signatures_on_card(cuda):
    import hashlib

    from drand_tpu_torch import fixtures as FX
    from drand_tpu_torch import verify as V
    from drand_tpu_torch.beacon.crypto_backend import DeviceBackend
    poly, shares, pub = _partials_group()
    rounds = np.arange(1, 41, dtype=np.uint64)
    be8 = V.rounds_be8(rounds)
    msgs = [hashlib.sha256(m.tobytes()).digest() for m in be8]
    sigs = [FX.sign_batch_g2(s.value, be8) for s in shares]
    parts = [[shares[(r + j) % 16].index.to_bytes(2, "big")
              + sigs[(r + j) % 16][r].tobytes() for j in range(9)]
             for r in range(40)]
    want = [bytes(s) for s in FX.sign_batch_g2(poly.secret(), be8)]
    be = DeviceBackend(pub, 9, 16)
    assert be.recover_rounds(msgs, parts) == want      # bucket 64: padded
    assert be.recover(msgs[3], parts[3]) == want[3]
    ok = V.Verifier(pub.commits[0], V.SHAPE_UNCHAINED).verify_batch(
        rounds, np.stack([np.frombuffer(s, np.uint8) for s in want]))
    assert ok.all()
