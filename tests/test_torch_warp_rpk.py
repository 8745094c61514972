"""The r pk program on the warp engine (`csrc/randmul.cu lt_g1_rpk`), on
the host.

`kernels/warp_schedule.py rpk_program` is `rsig_program`'s scalar
multiplication over Fp (JAX `scalar_mul_window_jac` over FP_OPS, 128-bit
scalars in 4-bit windows) without the subgroup chain; the kernel runs it
under the same window loop (`w_scalar_windows`), which moves the digit's
table entry and keeps the window's result between segments.  Here the
program, run on Python integers through the same loop steps (`drive`),
and the host build (a warp's 32 virtual threads forwards or reversed,
`lt_host_warp_order`) are held bit for bit against the plain version
`kernels/verify.py g1_rpk_plain` and, at two lanes, against the JAX
package's value function itself.  The round and product counts are
pinned to `verify.ROUNDS_PER_LANE` and `FP_MULS_PER_LANE`, and each
launch's shape, as the library reports it by the kernel's name
(`lt_warp_last_launch`), to its program's.
"""

import ctypes
import dataclasses
import functools
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lodestar_tpu.crypto import curves as GC
from lodestar_tpu.crypto import fields as GT
from lodestar_tpu.kernels import curve as JCV
from lodestar_tpu.kernels import layout as JL
from lodestar_tpu_torch.kernels import build as B
from lodestar_tpu_torch.kernels import layout as LY
from lodestar_tpu_torch.kernels import verify as KV
from lodestar_tpu_torch.kernels import warp_schedule as W

P = GT.P
RNG = np.random.default_rng(0x4B1D)
ORDERS = [0, 1]  # virtual threads forwards, reversed


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
    return B.load_host("randmul")


@pytest.fixture(scope="module")
def prog():
    return W.rpk_program()


def rand_fp():
    return int.from_bytes(RNG.bytes(48), "little") % P


def jac_cols(pt, z):
    """Affine G1 point -> Jacobian (X, Y, Z) with the given Z."""
    (x, y) = pt
    return (x * z * z % P, y * z * z * z % P, z)


def g1_planes(cols):
    return torch.from_numpy(np.stack([LY.encode_batch([c[i] for c in cols]) for i in range(3)])).contiguous()


def words(ks):
    """128-bit scalars -> randomizer word planes int32 [4, n]."""
    w = np.array([[(k >> (32 * (3 - i))) & 0xFFFFFFFF for k in ks] for i in range(4)], np.uint32)
    return torch.from_numpy(w.view(np.int32)).contiguous()


@functools.lru_cache(maxsize=None)
def base_cases():
    """(Jacobian P, scalar, infinity flag): a random odd scalar on a point
    with Z != 1 (as agg_pk gives it), the zero scalar, a scalar whose
    digits are all 15, a scalar whose leading windows are zero (the
    accumulator stays infinity, then takes a table entry), a pubkey
    flagged infinity, and a point with Z = 1 (as the table gives it)."""
    pts = [GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, k) for k in (0xA11CE, 0xB0B, 0xC0FFEE, 0xD1CE, 0xE66, 0xF00)]
    return (
        (jac_cols(pts[0], rand_fp()), int.from_bytes(RNG.bytes(16), "big") | 1, 0),
        (jac_cols(pts[1], rand_fp()), 0, 0),
        (jac_cols(pts[2], rand_fp()), (1 << 128) - 1, 0),
        (jac_cols(pts[3], rand_fp()), (0x9 << 68) | 0x5A5A5, 0),
        (jac_cols(pts[4], rand_fp()), int.from_bytes(RNG.bytes(16), "big"), 1),
        (jac_cols(pts[5], 1), int.from_bytes(RNG.bytes(16), "big"), 0),
    )


def cases(n):
    """n lanes cycling through `base_cases()`."""
    base = base_cases()
    pick = [base[i % len(base)] for i in range(n)]
    return pick, g1_planes([c[0] for c in pick]), torch.tensor([[c[2] for c in pick]], dtype=torch.int32), words(
        [c[1] for c in pick])


N_MAX = 7


@pytest.fixture(scope="module")
def plain():
    """The plain version on `cases(N_MAX)`: lanes are independent, so a
    slice of it is the plain version of the slice."""
    _, p, inf, rw = cases(N_MAX)
    return KV.g1_rpk_plain(p, inf, rw)


def drive(prog, p_ints, p_inf, k, reverse=False):
    """The program run on Python integers through csrc/randmul.cu
    w_scalar_windows's steps: the table segment, then per window the
    digit's entry copied to ADD, the window's segment, and DBL (digit 0)
    or ADD (accumulator still infinity) kept in place of the sum.
    -> (T's three Fp values, infinity)."""
    io = prog.io
    state = {io["P"] + i: v for i, v in enumerate(p_ints)}

    def segment(i):
        nonlocal state
        state = W.simulate(prog.segs, [prog.order[i]], prog.nslots, prog.consts, state, reverse)

    def copy(dst, src):
        for i in range(3):
            state[dst + i] = state[src + i]

    segment(0)
    t_inf = True
    for t in range(W.WINDOWS):
        d = (k >> (W.RAND_BITS - W.WINDOW * (t + 1))) & 15
        copy(io["ADD"], io["TBL"] + 3 * max(d - 1, 0))
        segment(1 + t)
        nxt = io["T0"] if t % 2 else io["T1"]
        if d == 0:
            copy(nxt, io["DBL"])
        elif t_inf:
            copy(nxt, io["ADD"])
        t_inf = t_inf and d == 0
    return [state[io["T0"] + i] for i in range(3)], t_inf or p_inf


def mont_ints(planes):
    """Planes [..., 12, n] -> per lane the Montgomery integers of the leading entries."""
    flat = planes.reshape(-1, LY.NL, planes.shape[-1])
    cols = [LY.decode_plain_batch(flat[i].numpy()) for i in range(flat.shape[0])]
    return [[c[j] for c in cols] for j in range(planes.shape[-1])]


@pytest.mark.parametrize("reverse", [False, True])
def test_program_simulation_equals_plain(prog, plain, reverse):
    """The program on Python integers, thread by thread in either order,
    through the window loop's steps, equals the plain version lane by
    lane: the zero scalar returns the placeholder 2^128 P's bits, the
    flagged lane comes out as infinity."""
    pick, p, _, _ = cases(N_MAX)
    out, out_inf = plain
    want = mont_ints(out)
    for j, (p_ints, c) in enumerate(zip(mont_ints(p), pick)):
        got, t_inf = drive(prog, p_ints, bool(c[2]), c[1], reverse)
        assert got == want[j], j
        assert int(t_inf) == out_inf[0, j].item(), j
    assert out_inf.tolist() == [[0, 1, 0, 0, 1, 0, 0]]


def assert_last_launch(lib, name, prog, n):
    """The last launch of the library's kernel `name`: n lanes, 4 per block
    of 128 threads, the program's slots, constants, phases and rounds."""
    shape = (ctypes.c_int * 8)()
    assert lib.lt_warp_last_launch(name, shape) == 0
    smem = LY.NL * 4 * (4 * prog.nslots + len(prog.consts))
    assert list(shape) == [n, (n + 3) // 4, 128, 4, smem, prog.nslots, prog.phases, prog.rounds]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("n", [1, 4, N_MAX])
def test_host_build_equals_plain(lib, prog, plain, n, order):
    """The host build, its warps' threads forwards or reversed, at 1, 4
    and 7 lanes (7: the second block's lane 3 idle) equals the plain
    version bit for bit; its finite outputs are the oracle's r P."""
    pick, p, inf, rw = cases(n)
    out, out_inf = torch.empty((3, LY.NL, n), dtype=torch.int32), torch.empty_like(inf)
    lib.lt_host_rounds(), lib.lt_host_fp_muls()  # the counters are the library's: drain another test's
    lib.lt_host_warp_order(order)
    assert lib.lt_g1_rpk(p.data_ptr(), inf.data_ptr(), rw.data_ptr(), out.data_ptr(), out_inf.data_ptr(), n, None) == 0
    lib.lt_host_warp_order(0)
    assert lib.lt_host_rounds() == n * KV.ROUNDS_PER_LANE["g1_rpk"]
    assert lib.lt_host_fp_muls() == n * KV.FP_MULS_PER_LANE["g1_rpk"]
    assert_last_launch(lib, b"g1_rpk", prog, n)
    assert torch.equal(out, plain[0][..., :n]) and torch.equal(out_inf, plain[1][..., :n])
    coords = [LY.decode_batch(out[c].numpy()) for c in range(3)]
    for j, ((x, y, z), k, _) in enumerate(pick):
        if not out_inf[0, j]:
            pt = GC._to_affine(GC.FP_OPS, (x, y, z))
            assert GC._to_affine(GC.FP_OPS, tuple(coords[c][j] for c in range(3))) == GC.scalar_mul(GC.FP_OPS, pt, k)


def test_launch_records_name_their_kernel(lib):
    """randmul holds two warp kernels: each keeps its own last launch, so
    a launch of one never reads as the other's; an unknown name gives 1
    and zeros."""
    _, p, inf, rw = cases(3)
    out, out_inf = torch.empty((3, LY.NL, 3), dtype=torch.int32), torch.empty_like(inf)
    assert lib.lt_g1_rpk(p.data_ptr(), inf.data_ptr(), rw.data_ptr(), out.data_ptr(), out_inf.data_ptr(), 3, None) == 0
    g = GC.G2_GEN
    q = torch.from_numpy(np.stack([np.stack([LY.encode_plain_batch([g[c][k]] * 2) for k in range(2)])
                                   for c in range(2)]))
    q, msg = q.contiguous(), torch.zeros_like(q)  # the decoded path's plain operands: the full program
    q_inf, qrw = torch.zeros((1, 2), dtype=torch.int32), rw[:, :2].contiguous()
    qout, qout_inf, sub = torch.empty((3, 2, LY.NL, 2), dtype=torch.int32), torch.empty_like(q_inf), torch.empty_like(q_inf)
    msg_out = torch.empty_like(msg)
    assert lib.lt_g2_rsig_sub(q.data_ptr(), q_inf.data_ptr(), msg.data_ptr(), qrw.data_ptr(), qout.data_ptr(),
                              qout_inf.data_ptr(), sub.data_ptr(), msg_out.data_ptr(), 2, None) == 0
    lib.lt_host_rounds(), lib.lt_host_fp_muls()
    assert_last_launch(lib, b"g1_rpk", W.rpk_program(), 3)
    assert_last_launch(lib, b"g2_rsig_sub", W.rsig_program(), 2)
    shape = (ctypes.c_int * 8)(*range(8))
    assert lib.lt_warp_last_launch(b"miller_loop", shape) == 1 and list(shape) == [0] * 8


@pytest.fixture()
def jax_eager_loops(monkeypatch):
    """The JAX value function as written, with its loops (`fori_loop`,
    `cond`) run as Python loops and each Fp operation of FP_OPS jitted
    alone."""
    fo = JCV.FP_OPS
    ops = JCV.FieldOps(**{f.name: jax.jit(getattr(fo, f.name), static_argnums=(1,) if f.name == "mul_small" else ())
                          for f in dataclasses.fields(fo)})

    def fori_loop(lo, hi, body, init):
        v = init
        for i in range(lo, hi):
            v = body(i, v)
        return v

    def cond(pred, true_fn, false_fn, *operands):
        return true_fn(*operands) if bool(pred) else false_fn(*operands)

    monkeypatch.setattr(JCV.lax, "fori_loop", fori_loop)
    monkeypatch.setattr(JCV.lax, "cond", cond)
    return ops


def test_host_build_equals_jax_value_function(lib, jax_eager_loops):
    """Two lanes (a point with Z != 1 and a random scalar; a point with a
    scalar of leading zero windows): the host build's Jacobian triple and
    infinity flag equal JAX `scalar_mul_window_jac(FP_OPS, ...)`."""
    base = base_cases()
    cols = [base[0][0], base[3][0]]
    ks = [base[0][1], base[3][1]]
    p, rw = g1_planes(cols), words(ks)
    inf = torch.zeros((1, 2), dtype=torch.int32)
    out, out_inf = torch.empty((3, LY.NL, 2), dtype=torch.int32), torch.empty_like(inf)
    assert lib.lt_g1_rpk(p.data_ptr(), inf.data_ptr(), rw.data_ptr(), out.data_ptr(), out_inf.data_ptr(), 2, None) == 0
    lib.lt_host_rounds(), lib.lt_host_fp_muls()
    fo = jax_eager_loops
    jp = tuple(jnp.asarray(JL.encode_batch([c[i] for c in cols])) for i in range(3))
    digits = [jnp.asarray([(k >> (124 - 4 * t)) & 15 for k in ks], jnp.int32) for t in range(32)]
    (X, Y, Z), t_inf = JCV.scalar_mul_window_jac(fo, jp, jnp.zeros(2, bool), lambda t: digits[t], 128, 4)
    for c, coord in enumerate((X, Y, Z)):
        assert LY.decode_batch(out[c].numpy()) == JL.decode_batch(np.asarray(coord)), c
    assert out_inf[0].tolist() == np.asarray(t_inf).astype(int).tolist() == [0, 0]


def test_rpk_counts_are_the_program(prog):
    """ROUNDS_PER_LANE and FP_MULS_PER_LANE of g1_rpk are the generated
    program's: the table (7 doublings, 7 full additions, P's Z^2 made
    once for all seven) then 32 windows of 4 doublings and one full
    addition; the bound counts the same products; every segment passes
    check_hazards; the generated header gives the window loop each
    segment's first phase."""
    assert (prog.rounds, prog.fp_muls) == (KV.ROUNDS_PER_LANE["g1_rpk"], KV.FP_MULS_PER_LANE["g1_rpk"])
    assert KV.FP_MULS_NEEDED["g1_rpk"] == prog.fp_muls
    table = 7 * KV.DBL_MULS + 7 * KV.ADD_MULS - 6
    assert prog.fp_muls == table + W.WINDOWS * (W.WINDOW * KV.DBL_MULS + KV.ADD_MULS)
    for seg in prog.segs:
        W.check_hazards(seg)
    starts = [0]
    for i in prog.order:
        starts.append(starts[-1] + len(prog.segs[i].phases))
    assert len(prog.order) == 1 + W.WINDOWS and starts[-1] == prog.phases
    assert f"LT_RPK_SEG[{2 + W.WINDOWS}] = {W._words(starts)};" in W.cuda_programs()
    assert prog.nslots + len(prog.consts) < W.MAX_SLOTS
