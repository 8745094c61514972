"""The CUDA kernels' arithmetic, checked on the host.

`kernels/build.py build_host` compiles each `csrc/<name>.cu` with the
host C++ compiler: the same device functions, with every PTX carry
instruction emulated (csrc/common.cuh), driven lane by lane through the
same C entry points the CUDA build exports.  Each kernel's host build is
held bit for bit against its plain torch version, on edge cases, and its
count of Fp products per lane against `verify.FP_MULS_PER_LANE`, the
work behind `verify.FP_MULS_NEEDED`, which the kernels' bounds count.  The CUDA build itself is held
against the plain versions on the card by chip_smoke.py and
tests/test_torch_cuda.py.
"""

import shutil

import numpy as np
import pytest
import torch

from lodestar_tpu.crypto import bls as GB
from lodestar_tpu.crypto import curves as GC
from lodestar_tpu.crypto import fields as GT
from lodestar_tpu.crypto import hash_to_curve as GH
from lodestar_tpu_torch.kernels import build as B
from lodestar_tpu_torch.kernels import layout as LY
from lodestar_tpu_torch.kernels import verify as KV

P = GT.P
RNG = np.random.default_rng(0xC5C)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: parallel test workers must not oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def libs():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler to build the CUDA sources for the host")
    return {name: B.load_host(name) for name in B.SOURCES}


def i32(*shape):
    return torch.empty(shape, dtype=torch.int32)


def g2_planes(pts):
    return torch.from_numpy(
        np.stack([np.stack([LY.encode_batch([q[c][k] for q in pts]) for k in range(2)]) for c in range(2)])
    ).contiguous()


def g1_planes(pts, zs):
    """Jacobian planes [3, 12, n] of affine points scaled by Z."""
    cols = [(x * z * z % P, y * z * z * z % P, z) for (x, y), z in zip(pts, zs)]
    return torch.from_numpy(np.stack([LY.encode_batch([c[i] for c in cols]) for i in range(3)])).contiguous()


def scalar():
    return int.from_bytes(RNG.bytes(32), "little") % (GT.R - 2) + 2


def test_mont_convert_host_build_equals_plain(libs):
    vals = [0, 1, P - 1, P, P + 1, 2 * P, 9 * P, (1 << 384) - 1] + [
        int.from_bytes(RNG.bytes(48), "little") for _ in range(16)
    ]
    x = torch.from_numpy(LY.encode_plain_batch(vals)).reshape(3, LY.NL, 8).contiguous()
    out = i32(3, LY.NL, 8)
    assert libs["mont"].lt_mont_convert(x.data_ptr(), out.data_ptr(), 3, 8, None) == 0
    assert torch.equal(out, KV.mont_convert_plain(x))
    assert libs["mont"].lt_host_fp_muls() == 24 * KV.FP_MULS_PER_LANE["mont_convert"]


def test_subgroup_host_build_equals_plain(libs):
    outside = []
    for j in range(2):
        u = GH.hash_to_field_fp2(b"host-%d" % j, 1, b"csrc-host")[0]
        outside.append(GH.map_to_curve_svdw(GC.FP2_OPS, u))
    pts = [GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, scalar()) for _ in range(2)] + outside
    q = g2_planes(pts)
    q_inf = torch.tensor([[0, 0, 0, 1]], dtype=torch.int32)  # an outside point flagged infinity
    out = i32(1, 4)
    assert libs["subgroup"].lt_g2_subgroup_check(q.data_ptr(), q_inf.data_ptr(), out.data_ptr(), 4, None) == 0
    assert out.tolist() == [[1, 1, 0, 1]]
    assert torch.equal(out, KV.g2_subgroup_check_plain(q, q_inf))
    assert libs["subgroup"].lt_host_fp_muls() == 4 * KV.FP_MULS_PER_LANE["g2_subgroup_check"]


def test_miller_and_each_final_host_build_equal_plain(libs):
    """Lanes: a valid signature relation (pk, H) x (-G1, sig), the same
    pair with a wrong signature, and a dead lane."""
    sk = scalar()
    h = GH.hash_to_g2(b"csrc-host-message")
    sig = GC.scalar_mul(GC.FP2_OPS, h, sk)
    pk = GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, sk)
    bad = GC.scalar_mul(GC.FP2_OPS, h, sk + 1)
    neg_g1 = GC.affine_neg(GC.FP_OPS, GC.G1_GEN)
    zs = [int.from_bytes(RNG.bytes(48), "little") % P for _ in range(3)]
    p1, q1 = g1_planes([pk] * 3, zs), g2_planes([h] * 3)
    p2, q2 = g1_planes([neg_g1] * 3, [1, 1, 1]), g2_planes([sig, bad, sig])
    f1, f2 = i32(12, LY.NL, 3), i32(12, LY.NL, 3)
    mil = libs["miller"]
    assert mil.lt_miller_loop(p1.data_ptr(), q1.data_ptr(), f1.data_ptr(), 3, None) == 0
    assert mil.lt_miller_loop(p2.data_ptr(), q2.data_ptr(), f2.data_ptr(), 3, None) == 0
    assert mil.lt_host_fp_muls() == 6 * KV.FP_MULS_PER_LANE["miller_loop"]
    assert torch.equal(f1, KV.miller_loop_plain(p1, q1))
    assert torch.equal(f2, KV.miller_loop_plain(p2, q2))
    live = torch.tensor([[1, 1, 0]], dtype=torch.int32)
    ok = i32(1, 3)
    fin = libs["final"]
    assert fin.lt_each_final(live.data_ptr(), f1.data_ptr(), f2.data_ptr(), ok.data_ptr(), 3, None) == 0
    assert ok.tolist() == [[1, 0, 1]]
    assert torch.equal(ok, KV.each_final_plain(live, f1, f2))
    assert fin.lt_host_fp_muls() == 3 * KV.FP_MULS_PER_LANE["each_final"]
    assert GB.verify(pk, b"csrc-host-message", sig)


def _words(ks):
    """128-bit scalars -> randomizer word planes int32 [4, n]."""
    w = np.array([[(k >> (32 * (3 - i))) & 0xFFFFFFFF for k in ks] for i in range(4)], np.uint32)
    return torch.from_numpy(w.view(np.int32)).contiguous()


def g2_jac_planes(pts, zs):
    """Jacobian G2 planes [3, 2, 12, n] of affine points scaled by Z."""
    cols = []
    for (x, y), z in zip(pts, zs):
        z2 = GT.fp2_mul(z, z)
        cols.append((GT.fp2_mul(x, z2), GT.fp2_mul(y, GT.fp2_mul(z2, z)), z))
    return torch.from_numpy(
        np.stack([np.stack([LY.encode_batch([c[i][k] for c in cols]) for k in range(2)]) for i in range(3)])
    ).contiguous()


def rand_fp2():
    return tuple(int.from_bytes(RNG.bytes(48), "little") % P for _ in range(2))


def test_randmul_host_build_equals_plain(libs):
    """r P in G1 and r Q in G2 with the subgroup row: scalars 0, 1, all
    ones and a random one; a base flagged infinity; an outside point."""
    ks = [0, 1, (1 << 128) - 1, int.from_bytes(RNG.bytes(16), "big") | 1]
    rw = _words(ks)
    inf = torch.tensor([[0, 0, 1, 0]], dtype=torch.int32)
    lib = libs["randmul"]
    p = g1_planes([GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, scalar()) for _ in range(4)], [1] * 4)
    out, out_inf = i32(3, LY.NL, 4), i32(1, 4)
    assert lib.lt_g1_rpk(p.data_ptr(), inf.data_ptr(), rw.data_ptr(), out.data_ptr(), out_inf.data_ptr(), 4, None) == 0
    assert lib.lt_host_fp_muls() == 4 * KV.FP_MULS_PER_LANE["g1_rpk"]
    want = KV.g1_rpk_plain(p, inf, rw)
    assert torch.equal(out, want[0]) and torch.equal(out_inf, want[1])
    assert out_inf.tolist() == [[1, 0, 1, 0]]
    u = GH.hash_to_field_fp2(b"host-rsig", 1, b"csrc-host")[0]
    q = g2_planes([GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, scalar()) for _ in range(3)]
                  + [GH.map_to_curve_svdw(GC.FP2_OPS, u)])
    out, out_inf, sub = i32(3, 2, LY.NL, 4), i32(1, 4), i32(1, 4)
    assert lib.lt_g2_rsig_sub(q.data_ptr(), inf.data_ptr(), rw.data_ptr(), out.data_ptr(), out_inf.data_ptr(),
                              sub.data_ptr(), 4, None) == 0
    assert lib.lt_host_fp_muls() == 4 * KV.FP_MULS_PER_LANE["g2_rsig_sub"]
    want = KV.g2_rsig_sub_plain(q, inf, rw)
    assert all(torch.equal(a, b) for a, b in zip((out, out_inf, sub), want))
    assert sub.tolist() == [[1, 1, 1, 0]]


@pytest.mark.parametrize("n", [5, 300])
def test_reduce_host_build_equals_plain(libs, n):
    """The one-block lane reductions: fewer lanes than slots, and lanes
    folded past one tile; P + (-P) and P + P meet in the fold."""
    base = [GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, scalar()) for _ in range(3)]
    pts = [base[i % 3] for i in range(n)]
    if n > 128:
        pts[128] = GC.affine_neg(GC.FP2_OPS, pts[0])  # slot 0: P then -P
    pts_p = g2_jac_planes(pts, [rand_fp2() for _ in range(n)])
    excl = torch.tensor([[int(i % 4 == 1) for i in range(n)]], dtype=torch.int32)
    lib = libs["reduce"]
    scr, scr_inf = i32(3, 2, LY.NL, KV.BT), i32(1, KV.BT)
    assert lib.lt_sum_g2(pts_p.data_ptr(), excl.data_ptr(), scr.data_ptr(), scr_inf.data_ptr(), n, None) == 0
    assert lib.lt_host_fp_muls() == (max(n, KV.BT) - 1) * KV.FP_MULS_PER_LANE["sum_g2"]
    s, s_inf = KV.sum_g2_plain(pts_p, excl)
    assert torch.equal(scr[..., :1], s) and torch.equal(scr_inf[:, :1], s_inf)
    f = torch.from_numpy(np.stack([LY.encode_batch([int.from_bytes(RNG.bytes(48), "little") % P for _ in range(n)])
                                   for _ in range(12)])).contiguous()
    live = 1 - excl
    scr = i32(12, LY.NL, KV.BT)
    assert lib.lt_prod12(live.data_ptr(), f.data_ptr(), scr.data_ptr(), n, None) == 0
    assert lib.lt_host_fp_muls() == (max(n, KV.BT) - 1) * KV.FP_MULS_PER_LANE["prod12"]
    assert torch.equal(scr[..., :1], KV.prod12_plain(live, f))


def test_tail_host_build_equals_plain(libs):
    """affine_g2 on a finite point, a flagged one and Z = 0; final_one on
    a valid relation, a wrong one, and A = O."""
    lib = libs["tail"]
    pts = [GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, scalar()) for _ in range(3)]
    p = g2_jac_planes(pts, [rand_fp2(), rand_fp2(), (0, 0)])
    p_inf = torch.tensor([[0, 1, 0]], dtype=torch.int32)
    a, a_inf = i32(2, 2, LY.NL, 3), i32(1, 3)
    assert lib.lt_affine_g2(p.data_ptr(), p_inf.data_ptr(), a.data_ptr(), a_inf.data_ptr(), 3, None) == 0
    assert lib.lt_host_fp_muls() == 3 * KV.FP_MULS_PER_LANE["affine_g2"]
    want = KV.affine_g2_plain(p, p_inf)
    assert torch.equal(a, want[0]) and torch.equal(a_inf, want[1])
    assert a_inf.tolist() == [[0, 1, 1]]
    assert torch.equal(a[..., 1:], g2_planes([GC.G2_GEN] * 2))
    sk = scalar()
    h = GH.hash_to_g2(b"csrc-host-tail")
    pk = GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, sk)
    sig = GC.scalar_mul(GC.FP2_OPS, h, sk)
    neg_g1 = GC.affine_neg(GC.FP_OPS, GC.G1_GEN)
    prod = KV.miller_loop_plain(g1_planes([pk] * 3, [1] * 3), g2_planes([h] * 3))
    fa = KV.miller_loop_plain(g1_planes([neg_g1] * 3, [1] * 3),
                              g2_planes([sig, GC.scalar_mul(GC.FP2_OPS, h, sk + 1), sig]))
    fa_inf = torch.tensor([[0, 0, 1]], dtype=torch.int32)
    ok = i32(1, 3)
    assert lib.lt_final_one(fa_inf.data_ptr(), prod.data_ptr(), fa.data_ptr(), ok.data_ptr(), 3, None) == 0
    assert lib.lt_host_fp_muls() == 3 * KV.FP_MULS_PER_LANE["final_one"]
    assert torch.equal(ok, KV.final_one_plain(fa_inf, prod, fa))
    assert ok.tolist() == [[1, 0, 0]]  # A = O leaves e(pk, H) alone: not one


def test_ingest_host_build_counts_and_equals_plain(libs):
    """g2_decompress (a point, infinity, an x off the curve) bit-equal to
    its plain version, and hash_g2 giving hash_to_g2 of two roots; the Fp
    products per lane are the cost model's (the hash's plain version is
    held against the host build in tests/test_torch_ingest.py)."""
    lib = libs["ingest"]
    pt = GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, scalar())
    xs = [pt[0], (0, 0), (5, 9)]
    x = torch.from_numpy(np.stack([LY.encode_plain_batch([v[k] for v in xs]) for k in range(2)])).contiguous()
    flags = torch.tensor([[GT.fp2_sgn(pt[1]), 0, 1], [0, 1, 0]], dtype=torch.int32)
    xy, ok = i32(2, 2, LY.NL, 3), i32(1, 3)
    assert lib.lt_g2_decompress(x.data_ptr(), flags.data_ptr(), xy.data_ptr(), ok.data_ptr(), 3, None) == 0
    assert lib.lt_host_fp_muls() == 3 * KV.FP_MULS_PER_LANE["g2_decompress"]
    want = KV.g2_decompress_plain(x, flags)
    assert torch.equal(xy, want[0]) and torch.equal(ok, want[1])
    assert ok.tolist() == [[1, 1, 0]] and torch.equal(xy[..., :1], g2_planes([pt]))
    roots = [b"csrc-host-hash-0", b"csrc-host-hash-1"]
    us = [GH.hash_to_field_fp2(r, 2, GH.DST_G2) for r in roots]
    u = torch.from_numpy(np.stack([np.stack([LY.encode_plain_batch([v[i][k] for v in us]) for k in range(2)])
                                   for i in range(2)])).contiguous()
    sgn = torch.tensor([[GH._sgn0_fp2(v[i]) for v in us] for i in range(2)], dtype=torch.int32)
    out, ok = i32(3, 2, LY.NL, 2), i32(1, 2)
    assert lib.lt_hash_g2(u.data_ptr(), sgn.data_ptr(), out.data_ptr(), ok.data_ptr(), 2, None) == 0
    assert lib.lt_host_fp_muls() == 2 * KV.FP_MULS_PER_LANE["hash_g2"]
    assert ok.tolist() == [[1, 1]]
    c = [[LY.decode_batch(out[i, k].numpy()) for k in range(2)] for i in range(3)]
    for j, r in enumerate(roots):
        (x0, x1), (y0, y1), (z0, z1) = ((c[i][0][j], c[i][1][j]) for i in range(3))
        zi = GT.fp2_inv((z0, z1))
        zi2 = GT.fp2_mul(zi, zi)
        assert (GT.fp2_mul((x0, x1), zi2), GT.fp2_mul((y0, y1), GT.fp2_mul(zi2, zi))) == GH.hash_to_g2(r)


@pytest.mark.parametrize("k", [1, 4, 64])
def test_agg_pk_host_build_counts_and_equals_plain(libs, k):
    """K - 1 complete additions per lane (a tree per 32-row chunk, then
    the chunks in order): the host build's product count and its planes
    equal the plain version's; a lane with every row masked is infinity."""
    keys = [GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, scalar()) for _ in range(5)]
    tx = torch.from_numpy(LY.encode_batch([p[0] for p in keys]))
    ty = torch.from_numpy(LY.encode_batch([p[1] for p in keys]))
    n = 3
    idx = torch.from_numpy(RNG.integers(0, 5, size=(n, k)).astype(np.int32))
    kmask = torch.from_numpy((RNG.random((n, k)) < 0.8).astype(np.int32))
    kmask[1] = 0
    kmask[2] = 1
    out, out_inf = i32(3, LY.NL, n), i32(1, n)
    lib = libs["aggpk"]
    assert lib.lt_agg_pk(tx.data_ptr(), ty.data_ptr(), 5, idx.data_ptr(), kmask.data_ptr(), k, out.data_ptr(),
                         out_inf.data_ptr(), n, None) == 0
    assert lib.lt_host_fp_muls() == n * (k - 1) * KV.FP_MULS_PER_LANE["agg_pk"]
    want = KV.agg_pk_plain(tx, ty, idx, kmask)
    assert torch.equal(out, want[0]) and torch.equal(out_inf, want[1])
    assert out_inf.tolist()[0][1:] == [1, 0]


def test_agg_pk_host_build_flags_rows_outside_the_table(libs):
    """A live row outside [0, V) flags its lane infinity (so its set
    fails); a masked one is read as row 0 and counts as infinity.  The
    host build reads no memory outside the table, and equals the plain
    version."""
    keys = [GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, scalar()) for _ in range(5)]
    tx = torch.from_numpy(LY.encode_batch([p[0] for p in keys]))
    ty = torch.from_numpy(LY.encode_batch([p[1] for p in keys]))
    idx = torch.tensor([[0, 1, 2, 3], [4, -1, 2, 3], [0, 1, 5, 3], [1 << 30, 1, 2, -(1 << 30)]], dtype=torch.int32)
    kmask = torch.tensor([[1, 1, 1, 1], [1, 1, 1, 1], [1, 1, 1, 1], [0, 1, 1, 0]], dtype=torch.int32)
    out, out_inf = i32(3, LY.NL, 4), i32(1, 4)
    assert libs["aggpk"].lt_agg_pk(tx.data_ptr(), ty.data_ptr(), 5, idx.data_ptr(), kmask.data_ptr(), 4,
                                   out.data_ptr(), out_inf.data_ptr(), 4, None) == 0
    want = KV.agg_pk_plain(tx, ty, idx, kmask)
    assert torch.equal(out, want[0]) and torch.equal(out_inf, want[1])
    assert out_inf.tolist() == [[0, 1, 1, 0]]
    in_range = torch.where(kmask[3:] != 0, idx[3:], 0)
    assert torch.equal(out[..., 3:], KV.agg_pk_plain(tx, ty, in_range, kmask[3:])[0])
    with pytest.raises(ValueError, match="V >= 1"):
        KV.agg_pk(tx[:, :0], ty[:, :0], idx, kmask)


def test_keyvalidate_host_build_counts_and_equals_plain(libs):
    """A key of G1, the order-3 key x = 0 and a lane flagged infinity:
    (x, y) and ok bit-equal to the plain version; the Fp products per
    lane are the cost model's (the oracle cases are in
    tests/test_torch_keyvalidate.py)."""
    pk = GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, scalar())
    x = torch.from_numpy(LY.encode_plain_batch([pk[0], 0, pk[0]])).contiguous()
    flags = torch.tensor([[GT.fp_sgn(pk[1]), 0, GT.fp_sgn(pk[1])], [0, 0, 1]], dtype=torch.int32)
    xy, ok = i32(2, LY.NL, 3), i32(1, 3)
    lib = libs["keyvalidate"]
    assert lib.lt_g1_keyvalidate(x.data_ptr(), flags.data_ptr(), xy.data_ptr(), ok.data_ptr(), 3, None) == 0
    assert lib.lt_host_fp_muls() == 3 * KV.FP_MULS_PER_LANE["g1_keyvalidate"]
    want = KV.g1_keyvalidate_plain(x, flags)
    assert torch.equal(xy, want[0]) and torch.equal(ok, want[1])
    assert ok.tolist() == [[1, 0, 0]] and LY.decode_batch(xy[1, :, :1].numpy()) == [pk[1]]


def test_needed_products_decompose_the_host_counts():
    """The bounds count `FP_MULS_NEEDED`: the host-build counts (checked
    in the tests above) split into curve operations, less the doubling
    that each complete addition makes beside it and, where the addend is
    affine, the mixed addition's saving."""
    assert (GT.R.bit_length() - 1, bin(GT.R).count("1") - 1) == (KV.R_DOUBLINGS, KV.R_ADDITIONS)
    e = (GT.P + 1) // 4  # the square root's power: squarings and multiplies
    sqrt = e.bit_length() - 1 + bin(e).count("1") - 1
    chain = KV.R_DOUBLINGS * KV.DBL_MULS
    full, full2 = KV.ADD_MULS + KV.DBL_MULS, KV.ADD2_MULS + KV.DBL2_MULS
    # 5: x to Montgomery, x^3 (2), the square check, fp_sgn's conversion
    assert KV.FP_MULS_PER_LANE["g1_keyvalidate"] == 5 + sqrt + chain + KV.R_ADDITIONS * full
    assert KV.FP_MULS_NEEDED["g1_keyvalidate"] == 5 + sqrt + chain + KV.R_ADDITIONS * KV.MADD_MULS
    assert KV.FP_MULS_PER_LANE["seg_sum_g1"] == KV.FP_MULS_PER_LANE["agg_pk"] == full
    assert KV.FP_MULS_PER_LANE["seg_sum_g2"] == KV.FP_MULS_PER_LANE["sum_g2"] == full2
    # an Fp2 product is 3 Fp products, an Fp2 square 2
    assert (KV.DBL2_MULS, KV.ADD2_MULS) == (2 * 3 + 5 * 2, 12 * 3 + 4 * 2)
    assert KV.FP_MULS_NEEDED.keys() == KV.FP_MULS_PER_LANE.keys()
    assert all(KV.FP_MULS_NEEDED[k] <= v for k, v in KV.FP_MULS_PER_LANE.items())


@pytest.mark.parametrize("n", [1, 5, 16])
def test_segsum_host_build_counts_and_equals_plain(libs, n):
    """One complete addition per lane and round, log2 n rounds (one for
    n = 1), in G1 and G2; groups of 1..3 lanes, a dead lane; the host build
    equals the plain version bit for bit."""
    assert KV.seg_rounds(n) == max(1, (n - 1).bit_length())
    group = torch.from_numpy(np.repeat(np.arange(n), 3)[:n].astype(np.int32))
    dead = torch.from_numpy((np.arange(n) % 4 == 3).astype(np.int32)[None, :]).contiguous()
    lib = libs["segsum"]
    pts = [GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, scalar()) for _ in range(n)]
    p = g1_planes(pts, [scalar() for _ in range(n)])
    out, out_inf, scr, scr_inf = i32(3, LY.NL, n), i32(1, n), i32(3, LY.NL, n), i32(1, n)
    assert lib.lt_seg_sum_g1(p.data_ptr(), dead.data_ptr(), group.data_ptr(), out.data_ptr(), out_inf.data_ptr(),
                             scr.data_ptr(), scr_inf.data_ptr(), n, None) == 0
    assert lib.lt_host_fp_muls() == KV.seg_rounds(n) * n * KV.FP_MULS_PER_LANE["seg_sum_g1"]
    want = KV.seg_sum_g1_plain(p, dead, group)
    assert torch.equal(out, want[0]) and torch.equal(out_inf, want[1])
    q = g2_planes([GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, scalar()) for _ in range(n)])
    out, scr = i32(3, 2, LY.NL, n), i32(3, 2, LY.NL, n)
    assert lib.lt_seg_sum_g2(q.data_ptr(), dead.data_ptr(), group.data_ptr(), out.data_ptr(), out_inf.data_ptr(),
                             scr.data_ptr(), scr_inf.data_ptr(), n, None) == 0
    assert lib.lt_host_fp_muls() == KV.seg_rounds(n) * n * KV.FP_MULS_PER_LANE["seg_sum_g2"]
    want = KV.seg_sum_g2_plain(q, dead, group)
    assert torch.equal(out, want[0]) and torch.equal(out_inf, want[1])
