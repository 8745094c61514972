"""The G2 lane sum and the affine conversion on the warp engine
(`csrc/reduce.cu lt_sum_g2`, `csrc/tail.cu lt_affine_g2`), on the host.

`kernels/warp_schedule.py sumg2_program` is one complete G2 addition:
P + Q by the generic Jacobian addition with 2P beside it and the H and R
that `jac_add_full`'s selects read; the kernel's driver makes those
selects and walks a pairwise tree over the lanes, one warp per addition,
16 warps per block, relaunching on the blocks' partials.
`affine_program` is the affine conversion with Z inverted through its
norm by the variable-time binary GCD.  Here both programs, run on Python
integers through the drivers' steps, and the host builds (virtual
threads, and a block's warps, forwards or reversed) are held bit for bit
against the plain versions `kernels/verify.py sum_g2_plain` (the same
tree, `curve.sum_points_lanes`) and `affine_g2_plain`.  The round and
product counts are pinned to `verify.ROUNDS_PER_LANE` and
`FP_MULS_PER_LANE` (sum_g2's per addition), and each launch, as the
library reports it by the kernel's name, to its program's.
"""

import ctypes
import functools
import shutil

import numpy as np
import pytest
import torch

from lodestar_tpu.crypto import fields as GT
from lodestar_tpu_torch.kernels import build as B
from lodestar_tpu_torch.kernels import curve as CV
from lodestar_tpu_torch.kernels import layout as LY
from lodestar_tpu_torch.kernels import verify as KV
from lodestar_tpu_torch.kernels import warp_schedule as W

P = GT.P
RNG = np.random.default_rng(0x5C3)
ORDERS = [0, 1]  # virtual threads and warps forwards, reversed


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
    return {name: B.load_host(name) for name in ("reduce", "tail", "final")}


def rand_fp():
    return int.from_bytes(RNG.bytes(48), "little") % P


def i32(*shape):
    return torch.empty(shape, dtype=torch.int32)


def planes(cols, shape):
    """Per lane a list of Fp integers -> their Montgomery planes [*shape, 12, n]."""
    n = len(cols)
    flat = np.stack([LY.encode_batch([c[k] for c in cols]) for k in range(len(cols[0]))])
    return torch.from_numpy(np.ascontiguousarray(flat.reshape(*shape, LY.NL, n)))


def mont_ints(t):
    """Planes [..., 12, n] -> per lane the Montgomery integers of the leading entries."""
    flat = t.reshape(-1, LY.NL, t.shape[-1])
    cols = [LY.decode_plain_batch(flat[i].numpy()) for i in range(flat.shape[0])]
    return [[c[j] for c in cols] for j in range(t.shape[-1])]


def scaled(pt, lam):
    """The Jacobian triple of the same point (on the curve or not) with Z
    times lam: (X lam^2, Y lam^3, Z lam) over Fp2 pairs."""
    def mul(a, b):
        return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)
    l2 = mul(lam, lam)
    return (mul(pt[0], l2), mul(pt[1], mul(l2, lam)), mul(pt[2], lam))


def neg(pt):
    return (pt[0], ((-pt[1][0]) % P, (-pt[1][1]) % P), pt[2])


def rand_pt():
    return tuple((rand_fp(), rand_fp()) for _ in range(3))


def flat(pt):
    return [v for c in pt for v in c]


@functools.lru_cache(maxsize=None)
def sum_case(n, all_excluded=False):
    """n Jacobian lanes of random field elements (the formulas do not need
    points of the curve) with lanes excluded, and at the tree's first
    level a doubling (lane 3 the same point as lane 2 with another Z) and
    an infinity (lane 7 the negation of lane 6); a pair of equal partial
    sums at the second level too (lanes 8..11 are lanes 12..15 again).
    -> (planes [3, 2, 12, n], excl [1, n], the plain sum)."""
    pts = [rand_pt() for _ in range(n)]
    excl = [int(i % 5 == 4) for i in range(n)]
    if n >= 4:
        pts[3] = scaled(pts[2], (rand_fp(), rand_fp()))
    if n >= 8:
        pts[7] = neg(pts[6])
    if n >= 16:
        pts[8:12] = pts[12:16]
        excl[8:12] = excl[12:16]
    if all_excluded:
        excl = [1] * n
    p = planes([flat(q) for q in pts], (3, 2))
    ex = torch.tensor([excl], dtype=torch.int32)
    return p, ex, KV.sum_g2_plain(p, ex)


def test_programs_are_pinned():
    """The generated programs' rounds and products are the kernels'
    pinned counts: one complete addition with its doubling in 5 rounds,
    the affine conversion in 7 (one the inversion)."""
    s, a = W.sumg2_program(), W.affine_program()
    assert (s.rounds, s.fp_muls, s.phases) == (KV.ROUNDS_PER_LANE["sum_g2"], KV.FP_MULS_PER_LANE["sum_g2"], 31)
    assert (a.rounds, a.fp_muls, a.phases) == (KV.ROUNDS_PER_LANE["affine_g2"], KV.FP_MULS_PER_LANE["affine_g2"], 18)
    assert KV.FP_MULS_PER_LANE["sum_g2"] == KV.ADD2_MULS + KV.DBL2_MULS
    assert sum(1 for ph in a.segs[0].phases for q in ph for op in q if op[0] == W.INV) == 1
    assert (s.nslots, a.nslots) == (89, 24)


def drive_add(prog, p, p_inf, q, q_inf, reverse=False):
    """One addition of the tree as csrc/reduce.cu sum_level makes it: the
    program on P and Q, then the selects -> (six Fp values, infinity)."""
    io = prog.io
    state = {io["P"] + i: v for i, v in enumerate(p)}
    state.update({io["Q"] + i: v for i, v in enumerate(q)})
    out = prog.run(state, reverse)
    h_zero = all(out[io["H"] + i] == 0 for i in range(2))
    r_zero = all(out[io["R"] + i] == 0 for i in range(2))
    src = io["Q"] if p_inf else io["P"] if q_inf else io["DBL"] if h_zero and r_zero else io["S"]
    return [out[src + i] for i in range(6)], (p_inf and q_inf) or (h_zero and not r_zero and not p_inf and not q_inf)


@pytest.mark.parametrize("reverse", [False, True])
def test_add_program_simulation_equals_plain(reverse):
    """The addition program on Python integers, thread by thread in either
    order, with the driver's selects, equals the plain `jac_add_full` on
    every case of its dispatch: distinct points, P == Q with other Z
    (doubling), P == -Q (infinity), either operand flagged."""
    prog = W.sumg2_program()
    a, b = rand_pt(), rand_pt()
    cases = [(a, 0, b, 0), (a, 0, scaled(a, (rand_fp(), rand_fp())), 0), (a, 0, neg(a), 0), (a, 1, b, 0),
             (a, 0, b, 1), (a, 1, b, 1)]
    lo = planes([flat(c[0]) for c in cases], (3, 2))
    hi = planes([flat(c[2]) for c in cases], (3, 2))
    lo_d, hi_d = LY.planes_to_digits(lo), LY.planes_to_digits(hi)
    s, s_inf = CV.jac_add_full(CV.FP2_OPS, (lo_d[0], lo_d[1], lo_d[2]), torch.tensor([c[1] == 1 for c in cases]),
                               (hi_d[0], hi_d[1], hi_d[2]), torch.tensor([c[3] == 1 for c in cases]))
    want = mont_ints(LY.digits_to_planes(torch.stack(s)))
    for j, (pl, ql) in enumerate(zip(mont_ints(lo), mont_ints(hi))):
        got, inf = drive_add(prog, pl, cases[j][1] == 1, ql, cases[j][3] == 1, reverse)
        assert got == want[j] and inf == bool(s_inf[j]), j
    assert s_inf.tolist() == [False, False, True, False, False, True]


@pytest.mark.parametrize("reverse", [False, True])
def test_affine_program_simulation_equals_plain(reverse):
    """The affine program on Python integers equals the plain conversion
    on finite lanes (the driver replaces infinity lanes by the generator)."""
    prog = W.affine_program()
    pts = [rand_pt() for _ in range(3)]
    p = planes([flat(q) for q in pts], (3, 2))
    want = mont_ints(KV.affine_g2_plain(p, torch.zeros((1, 3), dtype=torch.int32))[0])
    for j, ints in enumerate(mont_ints(p)):
        out = prog.run({prog.io["P"] + i: v for i, v in enumerate(ints)}, reverse)
        assert [out[prog.io["A"] + i] for i in range(4)] == want[j]
    gen = [prog.consts[prog.io["G2"] + i] for i in range(4)]
    ones = torch.ones((1, 1), dtype=torch.int32)
    assert mont_ints(KV.affine_g2_plain(p[..., :1].contiguous(), ones)[0])[0] == gen


def host_sum(lib, p, ex, order):
    """-> (the sum, its flag, the launches the entry point reports)."""
    n = p.shape[-1]
    lanes = lib.lt_tree_scratch_lanes(n)
    scr, scr_inf, out, out_inf = i32(3 * 2 * LY.NL * lanes), i32(lanes), i32(3, 2, LY.NL, 1), i32(1, 1)
    made = ctypes.c_int(-1)
    lib.lt_host_rounds(), lib.lt_host_fp_muls()  # the counters are the library's: drain another test's
    lib.lt_host_warp_order(order)
    assert lib.lt_sum_g2(p.data_ptr(), ex.data_ptr(), scr.data_ptr(), scr_inf.data_ptr(), out.data_ptr(),
                         out_inf.data_ptr(), n, ctypes.addressof(made), None) == 0
    lib.lt_host_warp_order(0)
    return out, out_inf, made.value


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("n", [1, 2, 3, 128, 129, 300, 512])
def test_sum_host_build_equals_plain(libs, n, order):
    """The host build, its threads and warps forwards or reversed, equals
    the plain tree bit for bit: one lane (passed through), a pair, an odd
    count, within one block's span and over two and three launches on the
    partials (129: a lone lane passing up through every level), with
    excluded lanes, a doubling, an infinity and equal partial sums.  It
    makes n - 1 additions of the program's rounds and products, and
    reports its first launch."""
    lib = libs["reduce"]
    p, ex, (want, want_inf) = sum_case(n)
    out, out_inf, launches = host_sum(lib, p, ex, order)
    assert torch.equal(out, want) and torch.equal(out_inf, want_inf)
    assert launches == (1 if n <= 32 else 2 if n <= 1024 else 3)
    assert lib.lt_host_rounds() == (n - 1) * KV.ROUNDS_PER_LANE["sum_g2"]
    assert lib.lt_host_fp_muls() == (n - 1) * KV.FP_MULS_PER_LANE["sum_g2"]
    prog = W.sumg2_program()
    shape = (ctypes.c_int * 8)()
    assert lib.lt_warp_last_launch(b"sum_g2", shape) == 0
    smem = LY.NL * 4 * (16 * prog.nslots + len(prog.consts))  # 16 warps, 32 elements per block
    assert list(shape) == [n, -(-n // 32), 32 * 16, 32, smem, prog.nslots, prog.phases, prog.rounds]


@pytest.mark.parametrize("n", [1, 3, 129])
def test_sum_host_build_every_lane_excluded(libs, n):
    """Every lane excluded: the sum is infinity, its coordinates the plain
    tree's (the selects' pass-through), in both orders."""
    p, ex, (want, want_inf) = sum_case(n, all_excluded=True)
    assert want_inf.tolist() == [[1]]
    for order in ORDERS:
        out, out_inf, _ = host_sum(libs["reduce"], p, ex, order)
        assert torch.equal(out, want) and torch.equal(out_inf, want_inf)
    assert libs["reduce"].lt_host_fp_muls() == (n - 1) * KV.FP_MULS_PER_LANE["sum_g2"]
    libs["reduce"].lt_host_rounds()  # leave the library's counters drained


@pytest.mark.parametrize("n, launches", [(32, 1), (33, 2), (1024, 2), (1025, 3), (2048, 3)])
def test_sum_launches_and_scratch(libs, n, launches):
    """Launches of one sum, as the entry point reports them: 32 elements
    per block to one partial, until one is left (1 up to 32 lanes, 2 up
    to 1024, 3 past it); the partials buffer the library asks for holds
    the first two launches' partials, and the sum (every lane but one
    excluded, so the plain tree runs no addition) is the one live lane."""
    lib = libs["reduce"]
    assert lib.lt_tree_scratch_lanes(n) == -(-n // 32) + -(-n // 1024)
    p = planes([flat(rand_pt()) for _ in range(n)], (3, 2))
    ex = torch.ones((1, n), dtype=torch.int32)
    ex[0, n - 1] = 0
    out, out_inf, made = host_sum(lib, p, ex, 0)
    assert made == launches
    assert torch.equal(out, p[..., n - 1:]) and out_inf.tolist() == [[0]]
    lib.lt_host_rounds(), lib.lt_host_fp_muls()  # leave the library's counters drained


@pytest.mark.parametrize("order", ORDERS)
def test_affine_host_build_equals_plain(libs, order):
    """The host build equals the plain version on finite lanes, a lane
    flagged infinity, lanes with Z = 0 flagged or not (the generator and
    flag 1), and runs 7 rounds of 16 products per lane."""
    lib = libs["tail"]
    pts = [rand_pt() for _ in range(6)]
    pts[2] = (pts[2][0], pts[2][1], (0, 0))
    pts[4] = (pts[4][0], pts[4][1], (0, 0))
    p = planes([flat(q) for q in pts], (3, 2))
    p_inf = torch.tensor([[0, 1, 0, 0, 1, 0]], dtype=torch.int32)
    a, a_inf = i32(2, 2, LY.NL, 6), i32(1, 6)
    lib.lt_host_rounds(), lib.lt_host_fp_muls(), lib.lt_host_gcd_steps()
    lib.lt_host_warp_order(order)
    assert lib.lt_affine_g2(p.data_ptr(), p_inf.data_ptr(), a.data_ptr(), a_inf.data_ptr(), 6, None) == 0
    lib.lt_host_warp_order(0)
    want = KV.affine_g2_plain(p, p_inf)
    assert torch.equal(a, want[0]) and torch.equal(a_inf, want[1])
    assert a_inf.tolist() == [[0, 1, 1, 0, 1, 0]]
    assert lib.lt_host_rounds() == 6 * KV.ROUNDS_PER_LANE["affine_g2"]
    assert lib.lt_host_fp_muls() == 6 * KV.FP_MULS_PER_LANE["affine_g2"]
    # every lane inverts the norm of its Z, flagged lanes too; Z = 0 takes no step
    assert lib.lt_host_gcd_steps() == KV.affine_g2_gcd_steps(p) > 0
    assert KV.affine_g2_gcd_steps(p[..., 2:3]) == 0
    shape = (ctypes.c_int * 8)()
    prog = W.affine_program()
    assert lib.lt_warp_last_launch(b"affine_g2", shape) == 0
    smem = LY.NL * 4 * (4 * prog.nslots + len(prog.consts))
    assert list(shape) == [6, 2, 128, 4, smem, prog.nslots, prog.phases, prog.rounds]


def test_gcd_step_count_is_the_host_builds(libs):
    """`verify.gcd_steps`, which the affine conversion's bound counts, runs
    as many outer steps as the host build of fp_inv_var on 0, 1, p - 1,
    powers of two and random values (the input is the Montgomery integer),
    and its multiplies per step are those of the step's four linear
    combinations."""
    lib = libs["final"]
    vals = [0, 1, P - 1, 2, 1 << 380, (1 << 64) - 1] + [rand_fp() for _ in range(200)]
    a = torch.from_numpy(LY.encode_batch(vals)).contiguous()
    r = i32(LY.NL, len(vals))
    lib.lt_host_gcd_steps(), lib.lt_host_fp_muls()
    for j in range(len(vals)):
        assert lib.lt_host_fp_inv_var(a[:, j:j + 1].contiguous().data_ptr(), r.data_ptr(), 1) == 0
        assert lib.lt_host_gcd_steps() == KV.gcd_steps(vals[j] * LY.R % P), j
    lib.lt_host_fp_muls()
    # at most 2 log2 p = 762 divsteps, 30 to a step
    assert all(0 < KV.gcd_steps(v * LY.R % P) <= 26 for v in vals[1:])
    assert KV.GCD_IMAD_PER_STEP == 246
