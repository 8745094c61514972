"""The warp-per-lane Miller loop and final exponentiation, on the host.

`kernels/warp_schedule.py` packs the pairing's Fp operations into phases
(`warp_prog.cuh`, written at build time) that `csrc/warp12.cuh` runs one
warp per lane.  The
host build (`kernels/build.py build_host`) runs a phase's 32 virtual
threads one after another, forwards or reversed (`lt_host_warp_order`):
a phase in which one thread read a slot another one writes would give
different values in the two orders.  Each kernel is held against its
plain torch version, or the oracle, in both orders; the round and
product counts are pinned to `verify.ROUNDS_PER_LANE` and
`FP_MULS_PER_LANE`, which PERF.md prints, and each launch's shape, as the
library reports it (`lt_warp_last_launch`), to the programs'.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from lodestar_tpu.crypto import curves as GC
from lodestar_tpu.crypto import fields as GT
from lodestar_tpu.crypto import hash_to_curve as GH
from lodestar_tpu.crypto import pairing as GP
from lodestar_tpu_torch.kernels import build as B
from lodestar_tpu_torch.kernels import layout as LY
from lodestar_tpu_torch.kernels import verify as KV
from lodestar_tpu_torch.kernels import warp_schedule as W

P = GT.P
RNG = np.random.default_rng(0x3A8)
ORDERS = [0, 1]  # virtual threads forwards, reversed


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
    return {name: B.load_host(name) for name in ("miller", "final", "tail")}


@pytest.fixture(scope="module")
def progs():
    mil, fin = W.miller_program(), W.final_program()
    return {"miller": mil, "final": fin, "tail": fin}


def i32(*shape):
    return torch.empty(shape, dtype=torch.int32)


def assert_last_launch(lib, name, prog, n):
    """The last launch of the library's kernel `name`: n lanes, 4 per block
    of 128 threads, the program's slots, constants, phases and rounds."""
    shape = (ctypes.c_int * 8)()
    assert lib.lt_warp_last_launch(name.encode(), shape) == 0
    smem = LY.NL * 4 * (4 * prog.nslots + len(prog.consts))
    assert list(shape) == [n, (n + 3) // 4, 128, 4, smem, prog.nslots, prog.phases, prog.rounds]


def rand_fp():
    return int.from_bytes(RNG.bytes(48), "little") % P


def scalar():
    return int.from_bytes(RNG.bytes(32), "little") % (GT.R - 2) + 2


def g1_planes(pts, zs):
    cols = [(x * z * z % P, y * z * z * z % P, z) for (x, y), z in zip(pts, zs)]
    return torch.from_numpy(np.stack([LY.encode_batch([c[i] for c in cols]) for i in range(3)])).contiguous()


def g2_planes(pts):
    return torch.from_numpy(
        np.stack([np.stack([LY.encode_batch([q[c][k] for q in pts]) for k in range(2)]) for c in range(2)])
    ).contiguous()


def fp12_planes(vals):
    """Oracle Fp12 values -> planes [12, 12, n] in the leaf order 6 h + 2 i + j."""
    leaves = [[v[h][i][j] for v in vals] for h in range(2) for i in range(3) for j in range(2)]
    return torch.from_numpy(np.stack([LY.encode_batch(col) for col in leaves])).contiguous()


def fp12_values(planes):
    n = planes.shape[-1]
    leaves = [LY.decode_batch(planes[k].numpy()) for k in range(12)]
    return [tuple(tuple((leaves[6 * h + 2 * i][j], leaves[6 * h + 2 * i + 1][j]) for i in range(3))
                  for h in range(2)) for j in range(n)]


@pytest.fixture(scope="module")
def relation():
    """A key, a message point, its signature and a wrong one."""
    sk = scalar()
    h = GH.hash_to_g2(b"warp-pairing-message")
    return (GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, sk), h, GC.scalar_mul(GC.FP2_OPS, h, sk),
            GC.scalar_mul(GC.FP2_OPS, h, sk + 1))


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("n", [1, 3, 5])
def test_warp_miller_and_finals_equal_plain(libs, progs, relation, n, order):
    """Lanes cycle through a valid relation (pk, H) x (-G1, sig), the same
    pair with a wrong signature, and a dead lane; P is Jacobian with
    Z != 1 on both sides.  5 lanes leave the second block's lanes 1..3
    idle (4 lanes per block)."""
    pk, h, sig, bad = relation
    neg_g1 = GC.affine_neg(GC.FP_OPS, GC.G1_GEN)
    p1 = g1_planes([pk] * n, [rand_fp() for _ in range(n)])
    p2 = g1_planes([neg_g1] * n, [rand_fp() for _ in range(n)])
    q1, q2 = g2_planes([h] * n), g2_planes([(sig, bad, sig)[i % 3] for i in range(n)])
    for lib in libs.values():
        lib.lt_host_warp_order(order)
        lib.lt_host_rounds(), lib.lt_host_fp_muls()  # the counters are the library's: drain another test's
    mil = libs["miller"]
    f1, f2 = i32(12, LY.NL, n), i32(12, LY.NL, n)
    assert mil.lt_miller_loop(p1.data_ptr(), q1.data_ptr(), f1.data_ptr(), n, None) == 0
    assert mil.lt_miller_loop(p2.data_ptr(), q2.data_ptr(), f2.data_ptr(), n, None) == 0
    assert mil.lt_host_rounds() == 2 * n * KV.ROUNDS_PER_LANE["miller_loop"]
    assert mil.lt_host_fp_muls() == 2 * n * KV.FP_MULS_PER_LANE["miller_loop"]
    assert_last_launch(mil, "miller_loop", progs["miller"], n)
    assert torch.equal(f1, KV.miller_loop_plain(p1, q1))
    assert torch.equal(f2, KV.miller_loop_plain(p2, q2))
    live = torch.tensor([[int(i % 3 != 2) for i in range(n)]], dtype=torch.int32)
    ok = i32(1, n)
    fin = libs["final"]
    assert fin.lt_each_final(live.data_ptr(), f1.data_ptr(), f2.data_ptr(), ok.data_ptr(), n, None) == 0
    assert fin.lt_host_rounds() == n * KV.ROUNDS_PER_LANE["each_final"]
    assert fin.lt_host_fp_muls() == n * KV.FP_MULS_PER_LANE["each_final"]
    assert_last_launch(fin, "each_final", progs["final"], n)
    assert ok.tolist() == [[(1, 0, 1)[i % 3] for i in range(n)]]
    assert torch.equal(ok, KV.each_final_plain(live, f1, f2))
    a_inf = torch.tensor([[int(i % 3 == 1) for i in range(n)]], dtype=torch.int32)
    tail = libs["tail"]
    assert tail.lt_final_one(a_inf.data_ptr(), f1.data_ptr(), f2.data_ptr(), ok.data_ptr(), n, None) == 0
    assert tail.lt_host_rounds() == n * KV.ROUNDS_PER_LANE["final_one"]
    assert tail.lt_host_fp_muls() == n * KV.FP_MULS_PER_LANE["final_one"]
    assert_last_launch(tail, "final_one", progs["tail"], n)
    assert ok.tolist() == [[int(i % 3 != 1) for i in range(n)]]  # A = O leaves e(pk, H) alone: not one
    assert torch.equal(ok, KV.final_one_plain(a_inf, f1, f2))
    for lib in libs.values():
        lib.lt_host_warp_order(0)


@pytest.mark.parametrize("order", ORDERS)
def test_warp_final_exponentiation_value_equals_oracle(libs, relation, order):
    """The value, not only its is-one bit: f^(3 (p^12 - 1) / r) for a
    Miller value and a random Fp12 element, against the oracle's final
    exponentiation cubed."""
    pk, h, _, _ = relation
    rand12 = tuple(tuple((rand_fp(), rand_fp()) for _ in range(3)) for _ in range(2))
    vals = [GP.miller_loop(pk, h), rand12]
    f = fp12_planes(vals)
    r = i32(12, LY.NL, 2)
    fin = libs["final"]
    fin.lt_host_rounds(), fin.lt_host_fp_muls()  # the counters are the library's: drain another test's
    fin.lt_host_warp_order(order)
    assert fin.lt_host_final_exp(f.data_ptr(), r.data_ptr(), 2) == 0
    fin.lt_host_warp_order(0)
    assert fin.lt_host_rounds() == 2 * KV.ROUNDS_PER_LANE["each_final"]
    fin.lt_host_fp_muls()
    for got, v in zip(fp12_values(r), vals):
        e = GP.final_exponentiation(v)
        assert got == GT.fp12_mul(GT.fp12_sqr(e), e)


def test_euclid_inverse_equals_fermat(libs):
    """The programs' inversion (the variable-time binary GCD, then times
    R^3) equals fp_inv (a^(p-2)) on 1, p - 1, 0, small and large values,
    values whose Montgomery form is 1 or p - 1, and random values, and is
    the field inverse."""
    r_inv = pow(1 << 384, -1, P)
    vals = [1, P - 1, 0, 2, 3, (P - 1) // 2, (P + 1) // 2, P - 2, r_inv, P - r_inv, 1 << 380, (1 << 64) - 1]
    vals += [rand_fp() for _ in range(500)]
    a = torch.from_numpy(LY.encode_batch(vals)).contiguous()
    r1, r2 = i32(LY.NL, len(vals)), i32(LY.NL, len(vals))
    fin = libs["final"]
    assert fin.lt_host_fp_inv_var(a.data_ptr(), r1.data_ptr(), len(vals)) == 0
    assert fin.lt_host_fp_inv(a.data_ptr(), r2.data_ptr(), len(vals)) == 0
    fin.lt_host_fp_muls()
    assert torch.equal(r1, r2)
    assert LY.decode_batch(r1.numpy()) == [pow(v, -1, P) if v else 0 for v in vals]


def test_round_counts_are_the_schedules():
    """ROUNDS_PER_LANE and FP_MULS_PER_LANE are the generated programs'
    counts."""
    mil, fin, rsig = W.miller_program(), W.final_program(), W.rsig_program()
    assert (rsig.rounds, rsig.fp_muls) == (KV.ROUNDS_PER_LANE["g2_rsig_sub"], KV.FP_MULS_PER_LANE["g2_rsig_sub"])
    assert (mil.rounds, mil.fp_muls) == (KV.ROUNDS_PER_LANE["miller_loop"], KV.FP_MULS_PER_LANE["miller_loop"])
    for name in ("each_final", "final_one"):
        assert (fin.rounds, fin.fp_muls) == (KV.ROUNDS_PER_LANE[name], KV.FP_MULS_PER_LANE[name])


@pytest.mark.parametrize("reverse", [False, True])
def test_schedule_simulation_equals_plain(reverse):
    """The programs run on Python integers, thread by thread in either
    order, give the plain torch engine's Miller value and final
    exponentiation."""
    mil, fin = W.miller_program(), W.final_program()
    pk = GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, scalar())
    q = GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, scalar())
    z = rand_fp()
    p = g1_planes([pk], [z])
    qq = g2_planes([q])
    ints = [LY.decode_plain_batch(p[i].numpy())[0] for i in range(3)]
    ints += [LY.decode_plain_batch(qq[c, k].numpy())[0] for c in range(2) for k in range(2)]
    out = mil.run({mil.io["P"] + i: v for i, v in enumerate(ints)}, reverse)
    f = [out[mil.io["F"] + k] for k in range(12)]
    want = KV.miller_loop_plain(p, qq)
    assert f == [LY.decode_plain_batch(want[k].numpy())[0] for k in range(12)]
    one = LY.decode_plain_batch(LY.encode_batch([1]))[0]
    state = {fin.io["A"] + k: v for k, v in enumerate(f)}
    state.update({fin.io["B"] + k: one if k == 0 else 0 for k in range(12)})
    out = fin.run(state, reverse)
    e = GP.final_exponentiation(fp12_values(want)[0])
    cube = fp12_planes([GT.fp12_mul(GT.fp12_sqr(e), e)])
    assert [out[fin.io["OUT"] + k] for k in range(12)] == [LY.decode_plain_batch(cube[k].numpy())[0]
                                                           for k in range(12)]
