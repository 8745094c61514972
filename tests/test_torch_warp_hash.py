"""Hashing signing roots to G2 and the Fp12 lane product on the warp
engine (`csrc/ingest.cu lt_hash_g2`, `csrc/reduce.cu lt_prod12`), on the
host.

`kernels/warp_schedule.py hash_program` is RFC 9380's map for G2 as
segments: the simplified SWU of u0 and u1 side by side (their two Fp
inversions in one phase, the four square roots of gx1 and gx2 by the norm
method), the 3-isogeny into Jacobian form without inversion, and the
cofactor clearing by psi (RFC 9380 appendix G.3) with complete additions;
csrc/ingest.cu's segment loop makes the per-lane selects between them.
`prod12_program` is one Fp12 product of the lane product's pairwise tree.
Here both programs, run on Python integers through the drivers' steps in
either thread order, are held against the crypto oracle
(`lodestar_tpu/crypto/hash_to_curve.py`, `fields`) and the plain versions
(`kernels/verify.py hash_g2_plain`, `prod12_plain`), and the host builds
(virtual threads, and a block's warps, forwards or reversed) bit for bit
against the plain versions, with their product, round and inversion step
counts and launch records pinned.  Every comparison is exact.
"""

import ctypes
import functools
import shutil

import numpy as np
import pytest
import torch

from lodestar_tpu.crypto import curves as GC
from lodestar_tpu.crypto import fields as GT
from lodestar_tpu.crypto import hash_to_curve as GH
from lodestar_tpu_torch.bls import ingest as IN
from lodestar_tpu_torch.kernels import build as B
from lodestar_tpu_torch.kernels import ingest as IG
from lodestar_tpu_torch.kernels import layout as LY
from lodestar_tpu_torch.kernels import verify as KV
from lodestar_tpu_torch.kernels import warp_schedule as W

P = GT.P
RNG = np.random.default_rng(0x4A54)
ORDERS = [0, 1]  # virtual threads and warps forwards, reversed
ROOTS = [b"warp-hash-%d" % i for i in range(4)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def libs():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler to build the CUDA sources for the host")
    return {name: B.load_host(name) for name in ("ingest", "reduce")}


def rand_fp():
    return int.from_bytes(RNG.bytes(48), "little") % P


def rand_fp2():
    return (rand_fp(), rand_fp())


def i32(*shape):
    return torch.empty(shape, dtype=torch.int32)


def neg2(a):
    return ((-a[0]) % P, (-a[1]) % P)


@functools.lru_cache(maxsize=None)
def hash_lanes():
    """(u0, u1) per lane: the 4 roots' hash_to_field outputs; u0 = 0
    (tv1 = 0: SSWU's exceptional branch x1 = B / (Z A); Z u^2 = -1 has no
    root u in Fp2), and u0 = u1 = 0; u1 = u0 (q0 == q1: the first addition
    doubles); u1 = -u0 (q1 = -q0: P is infinity, and so is the hash)."""
    lanes = [tuple(GH.hash_to_field_fp2(r, 2, GH.DST_G2)) for r in ROOTS]
    u = rand_fp2()
    lanes += [((0, 0), rand_fp2()), ((0, 0), (0, 0)), (u, u), (u, neg2(u))]
    return lanes


def lane_planes(lanes):
    """-> (u planes [2, 2, 12, n] plain, sgn0 bits [2, n])."""
    u = np.stack([np.stack([LY.encode_plain_batch([v[i][k] for v in lanes]) for k in range(2)]) for i in range(2)])
    sgn = np.array([[GH._sgn0_fp2(v[i]) for v in lanes] for i in range(2)], np.int32)
    return torch.from_numpy(np.ascontiguousarray(u)), torch.from_numpy(sgn)


def oracle(u0, u1):
    """hash_to_g2's map for (u0, u1) by the oracle: None for infinity."""
    q = GC.affine_add(GC.FP2_OPS, GH.iso3_map(GH.map_to_curve_sswu_g2(u0)), GH.iso3_map(GH.map_to_curve_sswu_g2(u1)))
    return None if q is None else GH.clear_cofactor_g2(q)


@functools.lru_cache(maxsize=None)
def plain_hash():
    """One plain hash of every lane (a call costs seconds on a CPU)."""
    u, sgn = lane_planes(hash_lanes())
    return u, sgn, KV.hash_g2_plain(u, sgn)


def jac_ints(planes):
    """Jacobian planes [3, 2, 12, n] -> per lane ((X0, X1), (Y0, Y1), (Z0, Z1))."""
    c = [[LY.decode_batch(planes[i, k].numpy()) for k in range(2)] for i in range(3)]
    return [tuple((c[i][0][j], c[i][1][j]) for i in range(3)) for j in range(planes.shape[-1])]


def to_affine(pt):
    X, Y, Z = pt
    if Z == (0, 0):
        return None
    zi = GT.fp2_inv(Z)
    zi2 = GT.fp2_sqr(zi)
    return GT.fp2_mul(X, zi2), GT.fp2_mul(Y, GT.fp2_mul(zi2, zi))


def mont(v):
    return v * LY.R % P


def drive_hash(prog, u0, u1, s0, s1, reverse=False, picks=None):
    """hash_program through csrc/ingest.cu hash_g2_warp's steps on Python
    integers (u0, u1 plain, as the kernel loads them): segments, the square roots' selects, the SSWU picks and the
    complete additions' selects -> (Jacobian output as Fp2 pairs, ok).
    picks, where given, gets per u the selects that decide the roots'
    need: (gx1 chosen, the chosen gx's imaginary part 0, its rp^2 == xp)."""
    io = prog.io
    st = {io["UIN"] + i: v for i, v in enumerate((*u0, *u1))}

    def seg(k):
        st.update(W.simulate(prog.segs, [prog.order[k]], prog.nslots, prog.consts, st, reverse))

    def sq(k, f):
        return io["SQ"] + k * io["SQ_STRIDE"] + io["SQ_" + f]

    def eq(a, b, n):  # b None: zero
        return all(st[a + i] == (0 if b is None else st[b + i]) for i in range(n))

    def cp(d, s, n):
        vals = [st[s + i] for i in range(n)]
        st.update({d + i: v for i, v in enumerate(vals)})

    def add(k, dst):
        seg(k)
        p_inf, q_inf = eq(io["AP"] + 4, None, 2), eq(io["AQ"] + 4, None, 2)
        h0, r0 = eq(io["AH"], None, 2), eq(io["AR"], None, 2)
        cp(dst, io["AQ"] if p_inf else io["AP"] if q_inf else io["AD"] if h0 and r0 else io["AS"], 6)

    def add_regs(k, a, b, dst):
        cp(io["AP"], a, 6)
        cp(io["AQ"], b, 6)
        add(k, dst)

    seg(0)
    sp_ok = [eq(sq(k, "SP2"), sq(k, "A"), 1) for k in range(4)]
    a1z = [eq(sq(k, "A") + 1, None, 1) for k in range(4)]
    seg(1)
    p_oks = [eq(sq(k, "RP2"), sq(k, "XP"), 1) for k in range(4)]
    for k, p_ok in enumerate(p_oks):
        cp(sq(k, "Y"), sq(k, "RP" if p_ok else "RM"), 1)
        cp(sq(k, "IX0"), sq(k, "IP" if p_ok else "IM"), 1)
    seg(2)
    for k in range(4):
        if a1z[k]:
            if sp_ok[k]:
                cp(sq(k, "Y"), sq(k, "SP"), 1)
                st[sq(k, "Y1")] = 0
            else:
                st[sq(k, "Y")] = 0
                cp(sq(k, "Y1"), sq(k, "SM"), 1)
    seg(3)
    for i, s in enumerate((s0, s1)):
        ok1 = eq(sq(2 * i, "S"), sq(2 * i, "A"), 2)
        k = 2 * i + (0 if ok1 else 1)
        if picks is not None:
            picks.append((ok1, a1z[k], p_oks[k]))
        cp(io["AFF"] + 4 * i, io["CX"] + 4 * i + (0 if ok1 else 2), 2)
        v0, v1 = st[sq(k, "RAW")], st[sq(k, "RAW") + 1]
        sgn0 = (v0 & 1) | (v0 == 0 and v1 & 1)
        cp(io["AFF"] + 4 * i + 2, sq(k, "Y") if sgn0 == s else sq(k, "NY"), 2)
    seg(4)
    good = not eq(io["AP"] + 4, None, 2) and not eq(io["AQ"] + 4, None, 2)
    add(5, io["PT"])
    seg(6)
    add(7, io["T3"])
    add_regs(8, io["T1"], io["T2"], io["U"])
    seg(9)
    add_regs(10, io["T3"], io["T2B"], io["T3"])
    add_regs(11, io["T3"], io["MT1"], io["T3"])
    add_regs(12, io["T3"], io["MP"], io["OUT"])
    v = [st[io["OUT"] + i] * LY.R_INV % P for i in range(6)]
    return ((v[0], v[1]), (v[2], v[3]), (v[4], v[5])), good


def test_programs_are_pinned():
    """The generated programs' rounds and products are the kernels' pinned
    counts; the hash's two Fp inversions share one phase; the chains by
    |x| are 63 doublings and 5 full additions; the need is the products
    less the doublings made beside the six complete additions."""
    h, m = W.hash_program(), W.prod12_program()
    assert (h.rounds, h.fp_muls, h.phases, h.nslots) == (KV.ROUNDS_PER_LANE["hash_g2"], KV.FP_MULS_PER_LANE["hash_g2"],
                                                         3729, 338)
    assert (m.rounds, m.fp_muls, m.phases, m.nslots) == (KV.ROUNDS_PER_LANE["prod12"], KV.FP_MULS_PER_LANE["prod12"],
                                                         17, 176)
    inv = [sum(op[0] == W.INV for q in ph for op in q) for i in h.order for ph in h.segs[i].phases]
    assert sorted(c for c in inv if c) == [2]
    seg = {h.segs[i].name: h.segs[i] for i in h.order}
    assert [h.segs[i].name for i in h.order].count("add") == KV.HASH_ADDITIONS == 6
    # the addend P's Z^2 is made once for the chain's five additions
    x = -GT.X_PARAM
    chain = (x.bit_length() - 1) * KV.DBL2_MULS + (bin(x).count("1") - 1) * KV.ADD2_MULS - 4 * 2
    assert seg["chain_u"].fp_muls == chain
    assert seg["add"].fp_muls == KV.ADD2_MULS + KV.DBL2_MULS
    # the square roots' chains: segment b is rp and rm of the four
    # candidates; segment a their norm and sp chains and SSWU's own
    # products (u, tv1 and its inverse, x1, x2, the candidates' gx and
    # halves); every chain is one pow_window chain and its few products
    roots = KV.HASH_ROOT_MULS
    pw_s, pw_t = KV._pow_window_muls(W.SQRT_EXP), KV._pow_window_muls((P - 3) // 4)
    assert (roots["norm"], roots["sp"], roots["rp"], roots["rm"]) == (pw_s + 2, pw_s + 1, pw_t + 4, pw_t + 3)
    assert seg["b"].fp_muls == 4 * (roots["rp"] + roots["rm"])
    assert seg["a"].fp_muls - 4 * (roots["norm"] + roots["sp"]) == 74
    assert KV.FP_MULS_NEEDED["hash_g2"] == h.fp_muls - 6 * KV.DBL2_MULS - 4 * sum(roots.values())
    assert m.fp_muls == 54 and m.segs[0].rounds == 2


@pytest.mark.parametrize("reverse", [False, True])
def test_hash_program_simulation_equals_oracle_and_plain(reverse):
    """The hash program on Python integers, through the segment loop's
    selects, gives the oracle's point (infinity for u1 = -u0) and the
    plain version's Jacobian triple on every lane: ordinary roots, the
    exceptional branch, q0 == q1 (a doubling) and q1 == -q0."""
    prog = W.hash_program()
    _, _, (out, ok) = plain_hash()
    want = jac_ints(out)
    assert ok.tolist() == [[1] * len(hash_lanes())]
    picks, need = [], KV.HASH_ROOT_MULS
    for j, (u0, u1) in enumerate(hash_lanes()):
        got, good = drive_hash(prog, u0, u1, GH._sgn0_fp2(u0), GH._sgn0_fp2(u1), reverse, picks)
        assert good and got == want[j], j
        assert to_affine(got) == oracle(u0, u1), j
    # the bound's model of the roots' need makes the program's selects
    assert KV.hash_g2_root_muls(lane_planes(hash_lanes())[0]) == sum(
        need["norm"] * (1 if ok1 else 2) + (need["sp"] if a1z else need["rp"] + (0 if p_ok else need["rm"]))
        for ok1, a1z, p_ok in picks)
    assert [to_affine(p) for p in want[:4]] == [GH.hash_to_g2(r) for r in ROOTS]
    assert want[-1][2] == (0, 0) and want[-2][2] != (0, 0)


def test_psi_clearing_equals_h_eff():
    """The plain psi clearing of E2 points outside G2 (iso3 images of SSWU
    outputs of random u, and sums of two) gives the oracle's [h_eff] P as
    points, whatever P's Z; infinity (Z = 0) stays infinity."""
    pts = []
    for _ in range(3):
        q = GH.iso3_map(GH.map_to_curve_sswu_g2(rand_fp2()))
        assert GC.scalar_mul(GC.FP2_OPS, q, GT.R) is not None  # outside G2
        pts.append(q)
    pts.append(GC.affine_add(GC.FP2_OPS, pts[0], pts[1]))
    zs = [rand_fp2() for _ in pts] + [(0, 0)]
    pts.append(pts[0])
    planes = []
    for (x, y), z in zip(pts, zs):
        z2 = GT.fp2_sqr(z)
        planes.append((GT.fp2_mul(x, z2), GT.fp2_mul(y, GT.fp2_mul(z2, z)), z))
    p = [torch.from_numpy(np.stack([LY.encode_batch([pl[c][k] for pl in planes]) for k in range(2)]))
         for c in range(3)]
    out = IG.clear_cofactor_g2_psi(tuple(LY.planes_to_digits(c) for c in p))
    got = jac_ints(LY.digits_to_planes(torch.stack(out)))
    assert [to_affine(g) for g in got[:-1]] == [GH.clear_cofactor_g2(q) for q in pts[:-1]]
    assert got[-1][2] == (0, 0)


@pytest.mark.parametrize("order", ORDERS)
def test_hash_host_build_equals_plain(libs, order):
    """The host build of lt_hash_g2, its virtual threads forwards or
    reversed, equals the plain version bit for bit on every lane, with the
    program's products and rounds per lane, the binary GCD's outer steps of
    both inversions as `verify.hash_g2_gcd_steps` counts them, and its
    launch as the library records it."""
    lib = libs["ingest"]
    u, sgn, (want, want_ok) = plain_hash()
    n = u.shape[-1]
    out, ok = i32(3, 2, LY.NL, n), i32(1, n)
    lib.lt_host_fp_muls(), lib.lt_host_rounds(), lib.lt_host_gcd_steps()  # drain another test's
    lib.lt_host_warp_order(order)
    assert lib.lt_hash_g2(u.data_ptr(), sgn.data_ptr(), out.data_ptr(), ok.data_ptr(), n, None) == 0
    lib.lt_host_warp_order(0)
    assert torch.equal(out, want) and torch.equal(ok, want_ok)
    assert lib.lt_host_fp_muls() == n * KV.FP_MULS_PER_LANE["hash_g2"]
    assert lib.lt_host_rounds() == n * KV.ROUNDS_PER_LANE["hash_g2"]
    assert lib.lt_host_gcd_steps() == KV.hash_g2_gcd_steps(u) > 0
    prog = W.hash_program()
    shape = (ctypes.c_int * 8)()
    assert lib.lt_warp_last_launch(b"hash_g2", shape) == 0
    smem = LY.NL * 4 * (4 * prog.nslots + len(prog.consts))
    assert list(shape) == [n, -(-n // 4), 128, 4, smem, prog.nslots, prog.phases, prog.rounds]


def test_hash_root_need_on_random_roots():
    """On 64 roots' u the roots' need is, per u, gx1's norm chain, gx2's
    where gx1 is not a square, rp, and rm where rp fails: three to four
    chains, about three on average, so the bound's need stays below the
    program's products."""
    u, _ = IN.hash_field_planes([b"need-%d" % i for i in range(64)])
    u = torch.from_numpy(np.ascontiguousarray(u[..., :64]))
    r = KV.HASH_ROOT_MULS
    per_u = [KV.hash_g2_root_muls(u[..., j:j + 1]) for j in range(64)]
    lo, hi = 2 * (r["norm"] + r["rp"]), 2 * (2 * r["norm"] + r["rp"] + r["rm"])
    assert all(lo <= m <= hi for m in per_u) and sum(per_u) == KV.hash_g2_root_muls(u)
    assert 2.5 * 128 < sum(per_u) / r["norm"] < 3.5 * 128
    assert KV.FP_MULS_NEEDED["hash_g2"] + max(per_u) < KV.FP_MULS_PER_LANE["hash_g2"]


def test_hash_gcd_steps_skip_the_exceptional_branch():
    """tv1 = 0 (u = 0) inverts 0: no outer step."""
    u, _ = lane_planes([((0, 0), (0, 0))])
    assert KV.hash_g2_gcd_steps(u) == 0


def test_message_cache_pads_the_distinct_misses():
    """`bls/ingest.py hash_field_planes` hashes each root to the field once
    and repeats the last column up to the batch width: the kernel's inputs
    per lane are the roots' and the repeats the last root's."""
    roots = [b"pad-%d" % i for i in range(5)]
    u, sgn = IN.hash_field_planes(roots)
    assert u.shape == (2, 2, LY.NL, IN.BT) and sgn.shape == (2, IN.BT)
    want_u, want_sgn = lane_planes([tuple(GH.hash_to_field_fp2(r, 2, GH.DST_G2)) for r in roots + [roots[-1]] * 123])
    assert np.array_equal(u, want_u.numpy()) and np.array_equal(sgn, want_sgn.numpy())


def rand_f12(n, dead=()):
    """n random Fp12 lanes (Montgomery planes [12, 12, n]) and live flags [1, n]."""
    f = torch.from_numpy(np.stack([LY.encode_batch([rand_fp() for _ in range(n)]) for _ in range(12)])).contiguous()
    live = torch.ones((1, n), dtype=torch.int32)
    live[0, list(dead)] = 0
    return f, live


@pytest.mark.parametrize("reverse", [False, True])
def test_prod12_program_simulation_equals_oracle(reverse):
    """One product of the program on Python integers equals the oracle's
    Fp12 product (crypto/fields.py), in the JAX package's leaf order."""
    prog = W.prod12_program()
    for _ in range(3):
        a, b = [rand_fp() for _ in range(12)], [rand_fp() for _ in range(12)]
        state = {prog.io["A"] + k: mont(v) for k, v in enumerate(a)}
        state.update({prog.io["B"] + k: mont(v) for k, v in enumerate(b)})
        out = prog.run(state, reverse)
        got = [out[prog.io["C"] + k] * LY.R_INV % P for k in range(12)]

        def f12(v):  # leaf k = 6 h + 2 i + j
            return tuple(tuple((v[6 * h + 2 * i], v[6 * h + 2 * i + 1]) for i in range(3)) for h in range(2))

        want = GT.fp12_mul(f12(a), f12(b))
        assert got == [want[h][i][j] for h in range(2) for i in range(3) for j in range(2)]
    assert prog.consts[prog.io["ONE"]] == mont(1)


@functools.lru_cache(maxsize=None)
def prod_case(n, all_dead=False):
    dead = range(n) if all_dead else [i for i in range(n) if i % 7 == 3]
    f, live = rand_f12(n, dead)
    return f, live, KV.prod12_plain(live, f)


def host_prod(lib, f, live, order):
    n = f.shape[-1]
    lanes = lib.lt_tree_scratch_lanes(n)
    scr, out = i32(12 * LY.NL * lanes), i32(12, LY.NL, 1)
    made = ctypes.c_int(-1)
    lib.lt_host_rounds(), lib.lt_host_fp_muls()  # drain another test's
    lib.lt_host_warp_order(order)
    assert lib.lt_prod12(live.data_ptr(), f.data_ptr(), scr.data_ptr(), out.data_ptr(), n, ctypes.addressof(made),
                         None) == 0
    lib.lt_host_warp_order(0)
    return out, made.value


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("n", [1, 2, 3, 31, 32, 33, 128, 129, 512])
def test_prod12_host_build_equals_plain(libs, n, order):
    """The host build's tree, its threads and warps forwards or reversed,
    equals the plain product bit for bit with dead lanes scattered: within
    one block, over two launches, one lane past a tile; n - 1 products of
    the program's rounds and products; its first launch as recorded."""
    lib = libs["reduce"]
    f, live, want = prod_case(n)
    out, launches = host_prod(lib, f, live, order)
    assert torch.equal(out, want)
    assert launches == (1 if n <= 32 else 2)
    assert lib.lt_host_rounds() == (n - 1) * KV.ROUNDS_PER_LANE["prod12"]
    assert lib.lt_host_fp_muls() == (n - 1) * KV.FP_MULS_PER_LANE["prod12"]
    prog = W.prod12_program()
    shape = (ctypes.c_int * 8)()
    assert lib.lt_warp_last_launch(b"prod12", shape) == 0
    smem = LY.NL * 4 * (16 * prog.nslots + len(prog.consts))
    assert list(shape) == [n, -(-n // 32), 32 * 16, 32, smem, prog.nslots, prog.phases, prog.rounds]


@pytest.mark.parametrize("n", [1, 129])
def test_prod12_host_build_every_lane_dead(libs, n):
    """Every lane dead (one lane, and 129): the product is the Fp12 one,
    in both orders."""
    f, live, want = prod_case(n, all_dead=True)
    one = torch.zeros((12, LY.NL, 1), dtype=torch.int32)
    one[0] = torch.from_numpy(LY.encode_batch([1]))
    assert torch.equal(want, one)
    for order in ORDERS:
        assert torch.equal(host_prod(libs["reduce"], f, live, order)[0], want)
    assert libs["reduce"].lt_host_fp_muls() == (n - 1) * KV.FP_MULS_PER_LANE["prod12"]
    libs["reduce"].lt_host_rounds()  # leave the library's counters drained
