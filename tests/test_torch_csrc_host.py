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

import ctypes
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


EDGE_384 = [0, 1, P - 1, P, P + 1, 2 * P, 9 * P, (1 << 384) - 1]  # plain values the ingest admits


def plain_g2_planes(vals, n):
    """Plain limb planes [2, 2, 12, n] of 4 n integers below 2^384, value
    4 j + c at lane j, coordinate c."""
    return torch.from_numpy(LY.encode_plain_batch(vals)).reshape(LY.NL, n, 2, 2).permute(2, 3, 0, 1).contiguous()


@pytest.mark.parametrize("source", ["subgroup", "randmul", "ingest"])
def test_mont_ingest_host_build_equals_plain(libs, source):
    """The Montgomery ingest that each path's heading kernel makes in its
    first phase (g2_subgroup_check and g2_rsig_sub: the decoded paths'
    signature and message; g2_decompress: the wire paths' message), on
    plain values in [p, 2^384) and below p: the Montgomery planes each
    writes equal mont_convert_plain's bit for bit, and the Fp products per
    lane are the pinned counts (the ingest's among them)."""
    n = 6
    vals = EDGE_384 + [int.from_bytes(RNG.bytes(48), "little") for _ in range(4 * n - len(EDGE_384))]
    msg = plain_g2_planes(vals, n)
    sig = plain_g2_planes(vals[::-1], n)
    inf, lib = torch.zeros((1, n), dtype=torch.int32), libs[source]
    lib.lt_host_fp_muls()
    if source == "subgroup":
        out, conv = i32(1, n), i32(2, 2, 2, LY.NL, n)
        assert lib.lt_g2_subgroup_check(sig.data_ptr(), inf.data_ptr(), msg.data_ptr(), out.data_ptr(),
                                        conv.data_ptr(), n, None) == 0
        got, name = (conv[0], conv[1]), "g2_subgroup_check"
    elif source == "randmul":
        rw = _words([0, 1, 5, (1 << 128) - 1, 3 << 64, 7])
        out, out_inf, sub, msg_out = i32(3, 2, LY.NL, n), i32(1, n), i32(1, n), i32(2, 2, LY.NL, n)
        assert lib.lt_g2_rsig_sub(sig.data_ptr(), inf.data_ptr(), msg.data_ptr(), rw.data_ptr(), out.data_ptr(),
                                  out_inf.data_ptr(), sub.data_ptr(), msg_out.data_ptr(), n, None) == 0
        got, name = (msg_out,), "g2_rsig_sub"
        assert torch.equal(out, KV.g2_rsig_sub_plain(sig, inf, rw, msg)[0])
    else:
        x, flags = i32(2, LY.NL, n).zero_(), torch.tensor([[0] * n, [1] * n], dtype=torch.int32)
        xy, ok, msg_out = i32(2, 2, LY.NL, n), i32(1, n), i32(2, 2, LY.NL, n)
        assert lib.lt_g2_decompress(x.data_ptr(), flags.data_ptr(), msg.data_ptr(), xy.data_ptr(), msg_out.data_ptr(),
                                    ok.data_ptr(), n, None) == 0
        got, name = (msg_out,), "g2_decompress"
    want = (KV.mont_convert_plain(sig), KV.mont_convert_plain(msg))[-len(got):]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert [LY.decode_batch(got[-1][c, k].numpy()) for c in range(2) for k in range(2)] == [
        [vals[4 * j + 2 * c + k] % P for j in range(n)] for c in range(2) for k in range(2)]
    assert lib.lt_host_fp_muls() == n * KV.FP_MULS_PER_LANE[name]


@pytest.mark.parametrize("ingest", [False, True])
def test_subgroup_host_build_equals_plain(libs, ingest):
    """Points of G2, outside points and one flagged infinity, in Montgomery
    form (the wire per-set path's) or as plain limbs beside the message
    (the decoded path's, converted in the kernel): the flags are the plain
    version's, and the products per lane the pinned count, less the
    ingest's where there is none."""
    outside = []
    for j in range(2):
        u = GH.hash_to_field_fp2(b"host-%d" % j, 1, b"csrc-host")[0]
        outside.append(GH.map_to_curve_svdw(GC.FP2_OPS, u))
    pts = [GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, scalar()) for _ in range(2)] + outside
    q = g2_planes(pts)
    q_inf = torch.tensor([[0, 0, 0, 1]], dtype=torch.int32)  # an outside point flagged infinity
    out, conv = i32(1, 4), i32(2, 2, 2, LY.NL, 4)
    libs["subgroup"].lt_host_fp_muls()
    if ingest:
        plain = plain_g2_planes([v for p in pts for c in p for v in c], 4)
        msg = plain_g2_planes([int.from_bytes(RNG.bytes(48), "little") for _ in range(16)], 4)
        assert libs["subgroup"].lt_g2_subgroup_check(plain.data_ptr(), q_inf.data_ptr(), msg.data_ptr(),
                                                     out.data_ptr(), conv.data_ptr(), 4, None) == 0
        want = KV.g2_subgroup_check_plain(plain, q_inf, msg)
        assert torch.equal(conv[0], q) and torch.equal(conv[0], want[1]) and torch.equal(conv[1], want[2])
        want = want[0]
    else:
        assert libs["subgroup"].lt_g2_subgroup_check(q.data_ptr(), q_inf.data_ptr(), None, out.data_ptr(), None, 4,
                                                     None) == 0
        want = KV.g2_subgroup_check_plain(q, q_inf)
    assert out.tolist() == [[1, 1, 0, 1]]
    assert torch.equal(out, want)
    skipped = 0 if ingest else KV.INGEST_MULS
    assert libs["subgroup"].lt_host_fp_muls() == 4 * (KV.FP_MULS_PER_LANE["g2_subgroup_check"] - skipped)


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
    assert lib.lt_g2_rsig_sub(q.data_ptr(), inf.data_ptr(), None, rw.data_ptr(), out.data_ptr(), out_inf.data_ptr(),
                              sub.data_ptr(), None, 4, None) == 0
    assert lib.lt_host_fp_muls() == 4 * (KV.FP_MULS_PER_LANE["g2_rsig_sub"] - KV.INGEST_MULS)  # Montgomery q
    want = KV.g2_rsig_sub_plain(q, inf, rw)
    assert all(torch.equal(a, b) for a, b in zip((out, out_inf, sub), want))
    assert sub.tolist() == [[1, 1, 1, 0]]


@pytest.mark.parametrize("n", [5, 300])
def test_reduce_host_build_equals_plain(libs, n):
    """The lane reductions: the sum's tree within one block's span and over
    launches on the partials; P + P (other Z) and P + (-P) meet at its
    first level (both lanes live), the latter adding nothing to the sum.
    The product: the same tree, n - 1 products, dead lanes the Fp12 one."""
    base = [GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, scalar()) for _ in range(3)]
    pts = [base[i % 3] for i in range(n)]
    pts[3] = pts[2]  # lanes 2 and 3: a doubling
    if n > 128:
        pts[131] = GC.affine_neg(GC.FP2_OPS, pts[130])  # lanes 130 and 131: infinity
    pts_p = g2_jac_planes(pts, [rand_fp2() for _ in range(n)])
    excl = torch.tensor([[int(i % 4 == 1) for i in range(n)]], dtype=torch.int32)
    lib = libs["reduce"]
    lanes = lib.lt_tree_scratch_lanes(n)
    scr, scr_inf, out, out_inf = i32(3 * 2 * LY.NL * lanes), i32(lanes), i32(3, 2, LY.NL, 1), i32(1, 1)
    made = ctypes.c_int(0)
    assert lib.lt_sum_g2(pts_p.data_ptr(), excl.data_ptr(), scr.data_ptr(), scr_inf.data_ptr(), out.data_ptr(),
                         out_inf.data_ptr(), n, ctypes.addressof(made), None) == 0
    assert made.value == (1 if n <= 32 else 2)
    assert lib.lt_host_fp_muls() == (n - 1) * KV.FP_MULS_PER_LANE["sum_g2"]
    s, s_inf = KV.sum_g2_plain(pts_p, excl)
    assert torch.equal(out, s) and torch.equal(out_inf, s_inf)
    if n > 128:
        pair = pts_p[..., 130:132].contiguous()
        assert KV.sum_g2_plain(pair, torch.zeros((1, 2), dtype=torch.int32))[1].tolist() == [[1]]
        without = excl.clone()
        without[0, 130:132] = 1
        aff = KV.affine_g2_plain(s, s_inf)
        assert all(torch.equal(a, b) for a, b in zip(aff, KV.affine_g2_plain(*KV.sum_g2_plain(pts_p, without))))
    f = torch.from_numpy(np.stack([LY.encode_batch([int.from_bytes(RNG.bytes(48), "little") % P for _ in range(n)])
                                   for _ in range(12)])).contiguous()
    live = 1 - excl
    scr, out = i32(12 * LY.NL * lanes), i32(12, LY.NL, 1)
    assert lib.lt_prod12(live.data_ptr(), f.data_ptr(), scr.data_ptr(), out.data_ptr(), n, ctypes.addressof(made),
                         None) == 0
    assert made.value == (1 if n <= 32 else 2)
    assert lib.lt_host_fp_muls() == (n - 1) * KV.FP_MULS_PER_LANE["prod12"]
    assert torch.equal(out, KV.prod12_plain(live, f))


def test_tail_host_build_equals_plain(libs):
    """affine_g2 on a finite point, a flagged one and Z = 0; final_one on
    a valid relation, a wrong one, and A = O."""
    lib = libs["tail"]
    pts = [GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, scalar()) for _ in range(3)]
    p = g2_jac_planes(pts, [rand_fp2(), rand_fp2(), (0, 0)])
    p_inf = torch.tensor([[0, 1, 0]], dtype=torch.int32)
    a, a_inf = i32(2, 2, LY.NL, 3), i32(1, 3)
    lib.lt_host_gcd_steps()  # the counter is the library's: drain another test's
    assert lib.lt_affine_g2(p.data_ptr(), p_inf.data_ptr(), a.data_ptr(), a_inf.data_ptr(), 3, None) == 0
    assert lib.lt_host_fp_muls() == 3 * KV.FP_MULS_PER_LANE["affine_g2"]
    assert lib.lt_host_gcd_steps() == KV.affine_g2_gcd_steps(p)  # the Z = 0 lane takes none
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
    assert lib.lt_g2_decompress(x.data_ptr(), flags.data_ptr(), None, xy.data_ptr(), None, ok.data_ptr(), 3,
                                None) == 0
    assert lib.lt_host_fp_muls() == 3 * KV.FP_MULS_PER_LANE["g2_decompress"]  # the message's 4 on zeros
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


def _window_steps(e: int, width: int):
    """(bits of the first window, windows) of e's MSB-first sliding window."""
    bits, i, first, count = bin(e)[2:], 0, None, 0
    while i < len(bits):
        if bits[i] == "1":
            j = min(i + width, len(bits))
            while bits[j - 1] == "0":
                j -= 1
            first = j - i if first is None else first
            count, i = count + 1, j
        else:
            i += 1
    return first, count


def test_needed_products_decompose_the_host_counts():
    """The bounds count `FP_MULS_NEEDED`: the host-build counts (checked
    in the tests above) split into curve operations, less the doubling
    that each complete addition makes beside it and, where the addend is
    affine, the mixed addition's saving."""
    z = -GT.X_PARAM  # KeyValidate's two chains over |z|
    assert (z.bit_length() - 1, bin(z).count("1") - 1) == (KV.Z_DOUBLINGS, KV.Z_ADDITIONS)
    e = (GT.P + 1) // 4  # the square root's power: 8 odd powers, a squaring a bit after the first window, a product a window after it
    first, count = _window_steps(e, 4)
    sqrt = 8 + e.bit_length() - first + count - 1
    chains = 2 * KV.Z_DOUBLINGS * KV.DBL_MULS + KV.Z_ADDITIONS * (KV.MADD_MULS + KV.ADD_MULS)
    full, full2 = KV.ADD_MULS + KV.DBL_MULS, KV.ADD2_MULS + KV.DBL2_MULS
    # 10: x to Montgomery, x^3 (2), the square check, fp_sgn's conversion;
    # the test's Z^2, Z^3, beta x, beta x Z^2 and y Z^3.  The kernel makes
    # only what the function needs (mixed additions where P is the addend)
    assert KV.FP_MULS_PER_LANE["g1_keyvalidate"] == KV.FP_MULS_NEEDED["g1_keyvalidate"] == 10 + sqrt + chains
    # the [r]P design's need, the earlier bound's yardstick: the binary
    # ladder's squarings and multiplies, r's doublings and mixed additions
    ladder = e.bit_length() - 1 + bin(e).count("1") - 1
    r_chain = (GT.R.bit_length() - 1) * KV.DBL_MULS + (bin(GT.R).count("1") - 1) * KV.MADD_MULS
    assert KV.R_CHAIN_NEEDED == 5 + ladder + r_chain == 3852
    assert KV.FP_MULS_PER_LANE["seg_sum_g1"] == KV.FP_MULS_PER_LANE["agg_pk"] == full
    assert KV.FP_MULS_PER_LANE["seg_sum_g2"] == KV.FP_MULS_PER_LANE["sum_g2"] == full2
    # an Fp2 product is 3 Fp products, an Fp2 square 2
    assert (KV.DBL2_MULS, KV.ADD2_MULS) == (2 * 3 + 5 * 2, 12 * 3 + 4 * 2)
    # the final exponentiation: A B and the easy part (one Fp12 inversion,
    # a Frobenius p^2, two Fp12 products), five powers by |x| (63 cyclotomic
    # squarings and 5 Fp12 products each) and the glue (7 Fp12 products, 2
    # Frobenius maps, 1 cyclotomic squaring).  The Fp12 inversion's one Fp
    # inversion makes one product (the binary GCD's result times R^3), where
    # the Fermat chain made 380 squarings and 228 products.
    x = -GT.X_PARAM
    mul12, cyclo, frob, fp6_mul, fp6_sqr = 54, 18, 18, 18, 12
    fp6_inv = 3 * (2 + 3) + 3 * 3 + (2 + 1 + 2) + 3 * 3  # cofactors, norm, Fp2 inversion, outputs
    inv12 = 2 * fp6_sqr + fp6_inv + 2 * fp6_mul
    powers = 5 * ((x.bit_length() - 1) * cyclo + (bin(x).count("1") - 1) * mul12)
    final = (3 + 7) * mul12 + inv12 + 3 * frob + cyclo + powers
    assert KV.FP_MULS_PER_LANE["each_final"] == KV.FP_MULS_PER_LANE["final_one"] == final
    # affine_g2: the norm (2), the inverse times R^3 (1), Z0 / n and Z1 / n
    # (2), 1 / Z^2 (an Fp2 square), 1 / Z^3, x and y (three Fp2 products),
    # all of them needed; the one Fp inversion beside them is counted by
    # its binary GCD's multiplies on the data (test_torch_warp_sum.py)
    assert KV.FP_MULS_PER_LANE["affine_g2"] == KV.FP_MULS_NEEDED["affine_g2"] == 2 + 1 + 2 + 2 + 3 * 3
    # hash_g2: the products its program makes (tests/test_torch_warp_hash.py
    # splits them) less the doubling beside each of its six complete
    # additions and the four candidates' square-root chains; the chains
    # the data needs and its two inversions are counted on the data
    assert KV.FP_MULS_NEEDED["hash_g2"] == (KV.FP_MULS_PER_LANE["hash_g2"] - KV.HASH_ADDITIONS * KV.DBL2_MULS
                                            - 4 * sum(KV.HASH_ROOT_MULS.values()))
    assert KV.FP_MULS_PER_LANE["prod12"] == KV.FP_MULS_NEEDED["prod12"] == 3 * 6 * 3  # 3 Fp6 products of 6 Fp2
    assert KV.FP_MULS_NEEDED.keys() == KV.FP_MULS_PER_LANE.keys()
    assert all(KV.FP_MULS_NEEDED[k] <= v for k, v in KV.FP_MULS_PER_LANE.items())


@pytest.mark.parametrize("n", [1, 5, 16])
def test_segsum_host_build_counts_and_equals_plain(libs, n):
    """One complete addition per lane and round where neither operand is
    infinity (the other lanes copy), log2 n rounds (one for n = 1), each
    one launch as the entry point reports them, in G1 and G2; groups of
    1..3 lanes, a dead lane; the host build equals the plain version bit
    for bit."""
    assert KV.seg_rounds(n) == max(1, (n - 1).bit_length())
    group = torch.from_numpy(np.repeat(np.arange(n), 3)[:n].astype(np.int32))
    dead = torch.from_numpy((np.arange(n) % 4 == 3).astype(np.int32)[None, :]).contiguous()
    lib = libs["segsum"]
    pts = [GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, scalar()) for _ in range(n)]
    p = g1_planes(pts, [scalar() for _ in range(n)])
    out, out_inf, scr, scr_inf = i32(3, LY.NL, n), i32(1, n), i32(3, LY.NL, n), i32(1, n)
    made = ctypes.c_int(-1)
    lib.lt_host_fp_muls()
    assert lib.lt_seg_sum_g1(p.data_ptr(), dead.data_ptr(), group.data_ptr(), out.data_ptr(), out_inf.data_ptr(),
                             scr.data_ptr(), scr_inf.data_ptr(), n, ctypes.addressof(made), None) == 0
    assert made.value == KV.seg_rounds(n)
    adds = KV.seg_additions("seg_sum_g1", p, dead, group)
    assert lib.lt_host_fp_muls() == adds * KV.FP_MULS_PER_LANE["seg_sum_g1"]
    # no sum is P + (-P) here, so in round s a lane's value is infinity
    # where every lane of its group in (l - s, l] is dead, and it adds
    # where both it and its partner's (l - 2s, l - s] hold a live lane
    g, live = group.tolist(), (dead[0] == 0).tolist()

    def finite(lo, hi):
        return any(live[k] for k in range(max(lo, 0), hi + 1) if g[k] == g[hi])

    assert adds == sum(1 for s in (1 << k for k in range(KV.seg_rounds(n))) for l in range(s, n)
                       if g[l - s] == g[l] and finite(l - s + 1, l) and finite(l - 2 * s + 1, l - s))
    want = KV.seg_sum_g1_plain(p, dead, group)
    assert torch.equal(out, want[0]) and torch.equal(out_inf, want[1])
    q = g2_planes([GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, scalar()) for _ in range(n)])
    out, scr = i32(3, 2, LY.NL, n), i32(3, 2, LY.NL, n)
    assert lib.lt_seg_sum_g2(q.data_ptr(), dead.data_ptr(), group.data_ptr(), out.data_ptr(), out_inf.data_ptr(),
                             scr.data_ptr(), scr_inf.data_ptr(), n, ctypes.addressof(made), None) == 0
    assert made.value == KV.seg_rounds(n)
    assert lib.lt_host_fp_muls() == adds * KV.FP_MULS_PER_LANE["seg_sum_g2"]
    want = KV.seg_sum_g2_plain(q, dead, group)
    assert torch.equal(out, want[0]) and torch.equal(out_inf, want[1])
    lib.lt_host_rounds()  # leave the library's counters drained
