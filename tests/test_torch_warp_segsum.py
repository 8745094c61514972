"""The segmented sums on the warp engine (`csrc/segsum.cu lt_seg_sum_g1`,
`lt_seg_sum_g2`), on the host.

Each round of JAX's Hillis-Steele scan is one launch of one warp per
lane: `kernels/warp_schedule.py sumg1_program` (over Fp) and
`sumg2_program` (over Fp2) make one complete addition, P + Q with 2P
beside it and the H and R that `jac_add_full`'s selects read, and a lane
whose operand counts as infinity only copies the other.  Here the G1
program, run on Python integers through the driver's selects, and the
host builds (a block's warps, 4 to 16 as `verify.seg_warps` gives them,
and each warp's 32 virtual threads forwards or reversed) are held bit for bit against the plain versions
`kernels/verify.py seg_sum_g1_plain` and `seg_sum_g2_plain` on every
lane: groups that span blocks, one group of every lane, every lane its
own group, every lane dead, a doubling and a P + (-P) inside a group.
The launches and products each call reports are pinned to
`verify.seg_rounds` and `seg_additions`, the rounds and products per
addition to `ROUNDS_PER_LANE` and `FP_MULS_PER_LANE`, and each launch, as
the library reports it by the kernel's name, to its program's.
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
RNG = np.random.default_rng(0x5E65)
ORDERS = [0, 1]  # virtual threads and warps forwards, reversed
RUNS = [3, 3, 40, 1, 2, 7, 1, 19, 5, 64, 1, 1, 300, 9]  # the mixed pattern's group lengths, cycled


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler to build the CUDA sources for the host")
    return B.load_host("segsum")


def rand_fp():
    return int.from_bytes(RNG.bytes(48), "little") % P


def planes(cols, shape):
    """Per lane a list of Fp integers -> their Montgomery planes [*shape, 12, n]."""
    n = len(cols)
    flat = np.stack([LY.encode_batch([c[k] for c in cols]) for k in range(len(cols[0]))])
    return torch.from_numpy(np.ascontiguousarray(flat.reshape(*shape, LY.NL, n)))


def mont_ints(t):
    flat = t.reshape(-1, LY.NL, t.shape[-1])
    cols = [LY.decode_plain_batch(flat[i].numpy()) for i in range(flat.shape[0])]
    return [[c[j] for c in cols] for j in range(t.shape[-1])]


def groups(n, pattern):
    if pattern == "one":
        return [0] * n
    if pattern == "each":
        return list(range(n))
    g, k = [], 0
    while len(g) < n:
        g += [k] * RUNS[k % len(RUNS)]
        k += 1
    return g[:n]


@functools.lru_cache(maxsize=None)
def case(g2, n, pattern):
    """n lanes of random field elements (the formulas need no curve
    points) in the pattern's groups, every seventh lane dead (every lane
    for "dead"), lane 1 the point of lane 0 (a doubling in round one) and
    lane 4 the negation of lane 3 (infinity there): G1 Jacobian with
    random Z, G2 affine.  -> (points, dead [1, n], group [n], the plain
    output, the additions it makes)."""
    w = 2 if g2 else 1
    coords = 2 if g2 else 3
    pts = [[rand_fp() for _ in range(coords * w)] for _ in range(n)]
    if n >= 2:
        pts[1] = list(pts[0])
        if not g2:  # the same point with another Z: (X l^2, Y l^3, Z l)
            lam = rand_fp()
            pts[1] = [pts[0][0] * lam * lam % P, pts[0][1] * pow(lam, 3, P) % P, pts[0][2] * lam % P]
    if n >= 5:
        pts[4] = list(pts[3])
        for i in range(w):  # -P: Y negated
            pts[4][w + i] = (-pts[3][w + i]) % P
    dead = torch.tensor([[int(pattern == "dead" or i % 7 == 6) for i in range(n)]], dtype=torch.int32)
    group = torch.tensor(groups(n, "mixed" if pattern == "dead" else pattern), dtype=torch.int32)
    p = planes(pts, (coords, 2) if g2 else (coords,))
    name = "seg_sum_g2" if g2 else "seg_sum_g1"
    plain = (KV.seg_sum_g2_plain if g2 else KV.seg_sum_g1_plain)(p, dead, group)
    return p, dead, group, plain, KV.seg_additions(name, p, dead, group)


def host_seg(lib, g2, p, dead, group, order):
    """-> (out, out_inf, the launches the entry point reports)."""
    n = group.shape[0]
    shape = (3, 2, LY.NL, n) if g2 else (3, LY.NL, n)
    out, scr = torch.empty(shape, dtype=torch.int32), torch.empty(shape, dtype=torch.int32)
    out_inf, scr_inf = torch.empty((1, n), dtype=torch.int32), torch.empty((1, n), dtype=torch.int32)
    made = ctypes.c_int(-1)
    lib.lt_host_rounds(), lib.lt_host_fp_muls()  # the counters are the library's: drain another test's
    lib.lt_host_warp_order(order)
    fn = lib.lt_seg_sum_g2 if g2 else lib.lt_seg_sum_g1
    assert fn(p.data_ptr(), dead.data_ptr(), group.data_ptr(), out.data_ptr(), out_inf.data_ptr(), scr.data_ptr(),
              scr_inf.data_ptr(), n, ctypes.addressof(made), None) == 0
    lib.lt_host_warp_order(0)
    return out, out_inf, made.value


def test_programs_are_pinned():
    """One complete addition with its doubling in 5 rounds over either
    field: 23 Fp products in G1 (16 + 7), 60 in G2 (44 + 16), as the
    lane sum's program had it; the kernels' pinned counts."""
    g1, g2 = W.sumg1_program(), W.sumg2_program()
    assert (g1.rounds, g1.fp_muls, g1.phases, g1.nslots) == (KV.ROUNDS_PER_LANE["seg_sum_g1"],
                                                            KV.FP_MULS_PER_LANE["seg_sum_g1"], 18, 36)
    assert (g2.rounds, g2.fp_muls, g2.phases, g2.nslots) == (KV.ROUNDS_PER_LANE["seg_sum_g2"],
                                                            KV.FP_MULS_PER_LANE["seg_sum_g2"], 31, 89)
    assert KV.ROUNDS_PER_LANE["seg_sum_g2"] == KV.ROUNDS_PER_LANE["sum_g2"]
    assert KV.FP_MULS_PER_LANE["seg_sum_g1"] == KV.ADD_MULS + KV.DBL_MULS
    assert KV.FP_MULS_PER_LANE["seg_sum_g2"] == KV.ADD2_MULS + KV.DBL2_MULS
    for prog in (g1, g2):
        assert [prog.consts[prog.io["ZERO"]], prog.consts[prog.io["ONE"]]] == [0, W.mont(1)]
        assert not any(op[0] == W.INV for ph in prog.segs[0].phases for q in ph for op in q)
        W.check_hazards(prog.segs[0])


def drive_add(prog, w, p, p_inf, q, q_inf, reverse=False):
    """One lane's addition as csrc/segsum.cu seg_lane makes it: a copy of
    the other operand where one is infinity, else the program on P and Q
    and the selects -> (the 3 w Fp values, infinity)."""
    io = prog.io
    if p_inf or q_inf:
        return list(q if p_inf else p), p_inf and q_inf
    state = {io["P"] + i: v for i, v in enumerate(p)}
    state.update({io["Q"] + i: v for i, v in enumerate(q)})
    out = prog.run(state, reverse)
    h_zero = all(out[io["H"] + i] == 0 for i in range(w))
    r_zero = all(out[io["R"] + i] == 0 for i in range(w))
    src = io["DBL"] if h_zero and r_zero else io["S"]
    return [out[src + i] for i in range(3 * w)], h_zero and not r_zero


@pytest.mark.parametrize("reverse", [False, True])
def test_g1_add_program_simulation_equals_plain(reverse):
    """The G1 addition on Python integers, thread by thread in either
    order, with the driver's copies and selects, equals the plain
    `jac_add_full` over Fp on every case of its dispatch: distinct points,
    P == Q with another Z (doubling), P == -Q (infinity), either or both
    operands flagged."""
    prog = W.sumg1_program()
    a, b = [rand_fp() for _ in range(3)], [rand_fp() for _ in range(3)]
    lam = rand_fp()
    a2 = [a[0] * lam * lam % P, a[1] * pow(lam, 3, P) % P, a[2] * lam % P]
    na = [a[0], (-a[1]) % P, a[2]]
    cases = [(a, 0, b, 0), (a, 0, a2, 0), (a, 0, na, 0), (a, 1, b, 0), (a, 0, b, 1), (a, 1, b, 1)]
    lo, hi = planes([c[0] for c in cases], (3,)), planes([c[2] for c in cases], (3,))
    lo_d, hi_d = LY.planes_to_digits(lo), LY.planes_to_digits(hi)
    s, s_inf = CV.jac_add_full(CV.FP_OPS, (lo_d[0], lo_d[1], lo_d[2]), torch.tensor([c[1] == 1 for c in cases]),
                               (hi_d[0], hi_d[1], hi_d[2]), torch.tensor([c[3] == 1 for c in cases]))
    want = mont_ints(LY.digits_to_planes(torch.stack(s)))
    for j, (pl, ql) in enumerate(zip(mont_ints(lo), mont_ints(hi))):
        got, inf = drive_add(prog, 1, pl, cases[j][1] == 1, ql, cases[j][3] == 1, reverse)
        assert got == want[j] and inf == bool(s_inf[j]), j
    assert s_inf.tolist() == [False, False, True, False, False, True]


def assert_last_launch(lib, g2, n):
    prog = W.sumg2_program() if g2 else W.sumg1_program()
    shape = (ctypes.c_int * 8)()
    assert lib.lt_warp_last_launch(b"seg_sum_g2" if g2 else b"seg_sum_g1", shape) == 0
    w = KV.seg_warps(n)
    smem = LY.NL * 4 * (w * prog.nslots + len(prog.consts))
    assert list(shape) == [n, -(-n // w), 32 * w, w, smem, prog.nslots, prog.phases, prog.rounds]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("n", [1, 2, 33, 128, 512])
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_host_build_equals_plain(lib, g2, n, order):
    """The host build in either order equals the plain scan on every lane,
    value and flag, on the mixed groups (one of 40 lanes over three
    blocks, a doubling, a P + (-P), dead lanes; at 512 a group of 300
    lanes); it launches once per round and makes one addition of the
    program's rounds and products where neither operand is infinity."""
    p, dead, group, (want, want_inf), adds = case(g2, n, "mixed")
    out, out_inf, launches = host_seg(lib, g2, p, dead, group, order)
    assert torch.equal(out, want) and torch.equal(out_inf, want_inf)
    name = "seg_sum_g2" if g2 else "seg_sum_g1"
    assert launches == KV.seg_rounds(n)
    assert lib.lt_host_rounds() == adds * KV.ROUNDS_PER_LANE[name]
    assert lib.lt_host_fp_muls() == adds * KV.FP_MULS_PER_LANE[name]
    assert_last_launch(lib, g2, n)
    if n >= 5:  # lane 4's group sum is P + (-P) in round one; lane 1's a doubling
        assert want_inf[0, 4] == 1 and want_inf[0, 1] == 0
    assert adds < KV.seg_rounds(n) * n  # copy lanes make none


@pytest.mark.parametrize("pattern", ["one", "each", "dead"])
@pytest.mark.parametrize("n", [1, 33, 512])
@pytest.mark.parametrize("g2", [False, True], ids=["g1", "g2"])
def test_host_build_group_patterns(lib, g2, n, pattern):
    """One group of every lane (its last lane the whole sum), every lane
    its own group (no addition: every lane copies itself), and every lane
    dead (infinity everywhere, no addition): bit for bit in both orders,
    the additions made as `seg_additions` counts them."""
    p, dead, group, (want, want_inf), adds = case(g2, n, pattern)
    name = "seg_sum_g2" if g2 else "seg_sum_g1"
    for order in ORDERS:
        out, out_inf, launches = host_seg(lib, g2, p, dead, group, order)
        assert torch.equal(out, want) and torch.equal(out_inf, want_inf)
        assert launches == KV.seg_rounds(n)
        assert lib.lt_host_fp_muls() == adds * KV.FP_MULS_PER_LANE[name]
        lib.lt_host_rounds()
    if pattern != "one":
        assert adds == 0
    if pattern == "dead":
        assert want_inf.tolist() == [[1] * n]
    if pattern == "each" and not g2:  # every live lane its own value (a dead one takes its partner's)
        live = dead[0] == 0
        assert torch.equal(want[..., live], p[..., live]) and want_inf.tolist() == dead.tolist()
    if pattern == "one" and n > 1:
        assert want_inf[0, -1] == 0


def test_launches_are_the_rounds(lib):
    """No lanes: no launch; otherwise one per round s = 1, 2, 4, .. < n, of
    4 lanes per block up to 512 lanes, 8 up to 1024, 16 past it."""
    for n, rounds in ((1, 1), (2, 1), (3, 2), (16, 4), (17, 5), (2048, 11)):
        assert KV.seg_rounds(n) == rounds
    assert [KV.seg_warps(n) for n in (1, 512, 513, 1024, 1025, 2048, 4096)] == [4, 4, 8, 8, 16, 16, 16]
    p = torch.zeros((3, LY.NL, 1), dtype=torch.int32)
    made = ctypes.c_int(-1)
    z = torch.zeros(1, dtype=torch.int32)
    assert lib.lt_seg_sum_g1(p.data_ptr(), z.data_ptr(), z.data_ptr(), p.data_ptr(), z.data_ptr(), p.data_ptr(),
                             z.data_ptr(), 0, ctypes.addressof(made), None) == 0
    assert made.value == 0
