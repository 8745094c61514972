"""The r sig program on the warp engine (`csrc/randmul.cu lt_g2_rsig_sub`),
on the host.

`kernels/warp_schedule.py rsig_program` packs the RLC batch's r_i sig_i
(JAX `scalar_mul_window_jac` over Fp2, 128-bit scalars in 4-bit windows)
and the G2 subgroup check (`g2_subgroup_check`) into segments that the
kernel's window loop runs one at a time, moving the digit's table entry and
keeping the window's result between them.  Here the program, run on
Python integers through the same loop steps (`drive`), and the host
build (`kernels/build.py build_host`: a warp's 32 virtual threads
forwards or reversed, `lt_host_warp_order`) are held bit for bit against
the plain version `kernels/verify.py g2_rsig_sub_plain` and, at two lanes,
against the JAX package's value functions themselves.  The round and
product counts are pinned to `verify.ROUNDS_PER_LANE` and
`FP_MULS_PER_LANE`, and each launch's shape, as the library reports it
(`lt_warp_last_launch`), to the program's.  The program's first segment
is the decoded batch path's Montgomery ingest (the plain signature and
message converted in one round, the Montgomery message stored); a launch
on a Montgomery signature (the wire paths') skips it.  Both kinds of
launch are held here.
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
from lodestar_tpu.crypto import hash_to_curve as GH
from lodestar_tpu.kernels import curve as JCV
from lodestar_tpu.kernels import layout as JL
from lodestar_tpu_torch.kernels import build as B
from lodestar_tpu_torch.kernels import layout as LY
from lodestar_tpu_torch.kernels import verify as KV
from lodestar_tpu_torch.kernels import warp_schedule as W

P = GT.P
RNG = np.random.default_rng(0x5165)
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
    return W.rsig_program()


def g2_planes(pts):
    return torch.from_numpy(
        np.stack([np.stack([LY.encode_batch([q[c][k] for q in pts]) for k in range(2)]) for c in range(2)])
    ).contiguous()


def words(ks):
    """128-bit scalars -> randomizer word planes int32 [4, n]."""
    w = np.array([[(k >> (32 * (3 - i))) & 0xFFFFFFFF for k in ks] for i in range(4)], np.uint32)
    return torch.from_numpy(w.view(np.int32)).contiguous()


def outside_g2(tag: bytes):
    u = GH.hash_to_field_fp2(tag, 1, b"torch-warp-rsig")[0]
    pt = GH.map_to_curve_svdw(GC.FP2_OPS, u)
    assert GC.is_on_curve(GC.FP2_OPS, pt) and not GC.g2_subgroup_check(pt)
    return pt


@functools.lru_cache(maxsize=None)
def base_cases():
    """(point, scalar, infinity flag): a random odd scalar on a point of
    G2, the zero scalar, a scalar whose leading windows are zero (the
    accumulator stays infinity, then takes a table entry), a signature
    flagged infinity, and a point on the twist outside G2 (sub false)."""
    return (
        (GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, 0xA11CE), int.from_bytes(RNG.bytes(16), "big") | 1, 0),
        (GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, 0xB0B), 0, 0),
        (GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, 0xC0FFEE), (0x9 << 68) | 0x5A5A5, 0),
        (GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, 0xD1CE), (1 << 128) - 1, 1),
        (outside_g2(b"outside"), int.from_bytes(RNG.bytes(16), "big"), 0),
    )


def cases(n):
    """n lanes cycling through `base_cases()`."""
    base = base_cases()
    pick = [base[i % len(base)] for i in range(n)]
    q = g2_planes([c[0] for c in pick])
    rw = words([c[1] for c in pick])
    inf = torch.tensor([[c[2] for c in pick]], dtype=torch.int32)
    return pick, q, inf, rw


def plain_operands(pick):
    """The decoded path's plain operands of `cases`' points: coordinates
    plus (j % 6) p at lane j (below 2^384: the same field elements) and a
    message of random 384-bit values -> (q [2, 2, 12, n], msg)."""
    n = len(pick)

    def planes(vals):
        return torch.from_numpy(LY.encode_plain_batch(vals)).reshape(LY.NL, n, 2, 2).permute(2, 3, 0, 1).contiguous()

    q = planes([v + (j % 6) * P for j, c in enumerate(pick) for pt in c[0] for v in pt])
    return q, planes([int.from_bytes(RNG.bytes(48), "little") for _ in range(4 * n)])


@pytest.fixture(scope="module")
def plain():
    """The plain version's outputs of `cases(n)` (seconds per call)."""
    out = {}
    for n in (1, 4, 5):
        _, q, inf, rw = cases(n)
        out[n] = KV.g2_rsig_sub_plain(q, inf, rw)
    return out


def drive(prog, q_ints, q_inf, k, reverse=False, msg_ints=None, msg_out=None):
    """The program run on Python integers through csrc/randmul.cu
    g2_rsig_sub_warp's steps: with msg_ints (q_ints plain) the ingest
    segment, its Montgomery message appended to msg_out; the table
    segment, then per window the digit's entry copied to ADD, the window's
    segment, and DBL (digit 0) or ADD (accumulator still infinity) kept in
    place of the sum.  -> (T's six Fp values, t_inf, sub)."""
    io = prog.io
    state = {io["Q"] + i: v for i, v in enumerate(q_ints)}

    def segment(i):
        nonlocal state
        state = W.simulate(prog.segs, [prog.order[i]], prog.nslots, prog.consts, state, reverse)

    def copy(dst, src):
        for i in range(6):
            state[dst + i] = state[src + i]

    if msg_ints is not None:
        state = {**{io["QIN"] + i: v for i, v in enumerate(q_ints)},
                 **{io["MSGIN"] + i: v for i, v in enumerate(msg_ints)}}
        segment(0)
        msg_out.append([state[io["MSG"] + i] for i in range(4)])
    segment(1)
    t_inf = True
    for t in range(W.WINDOWS):
        d = (k >> (W.RAND_BITS - W.WINDOW * (t + 1))) & 15
        copy(io["ADD"], io["TBL"] + 6 * max(d - 1, 0))
        segment(2 + t)
        nxt = io["T0"] if t % 2 else io["T1"]
        if d == 0:
            copy(nxt, io["DBL"])
        elif t_inf:
            copy(nxt, io["ADD"])
        t_inf = t_inf and d == 0
    eq = [state[io["EQ"] + i] for i in range(8)]
    sub = q_inf or (eq[0:2] == eq[2:4] and eq[4:6] == eq[6:8])
    return [state[io["T0"] + i] for i in range(6)], t_inf or q_inf, sub


def mont_ints(planes):
    """Planes [..., 12, n] -> per lane the Montgomery integers of the leading entries."""
    flat = planes.reshape(-1, LY.NL, planes.shape[-1])
    cols = [LY.decode_plain_batch(flat[i].numpy()) for i in range(flat.shape[0])]
    return [[c[j] for c in cols] for j in range(planes.shape[-1])]


@pytest.mark.parametrize("ingest", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_program_simulation_equals_plain(prog, plain, reverse, ingest):
    """The program on Python integers, thread by thread in either order,
    through the window loop's steps, equals the plain version lane by
    lane, from Montgomery points or through the ingest from plain limbs
    (its message then mont_convert_plain's)."""
    pick, q, inf, rw = cases(5)
    out, out_inf, sub = plain[5]
    want = mont_ints(out)
    qp, msg = plain_operands(pick)
    msgs = mont_ints(msg)
    got_msg = []
    for j, (q_ints, c) in enumerate(zip(mont_ints(qp if ingest else q), pick)):
        got, t_inf, ok = drive(prog, q_ints, bool(c[2]), c[1], reverse, msgs[j] if ingest else None, got_msg)
        assert got == want[j], j
        assert (int(t_inf), int(ok)) == (out_inf[0, j].item(), sub[0, j].item()), j
    assert sub.tolist() == [[1, 1, 1, 1, 0]] and out_inf.tolist() == [[0, 1, 0, 1, 0]]
    assert got_msg == (mont_ints(KV.mont_convert_plain(msg)) if ingest else [])


def assert_last_launch(lib, prog, n, ingest=True):
    """The last launch of the library's g2_rsig_sub: n lanes, 4 per block
    of 128 threads, the program's slots, constants, phases and rounds
    (less the ingest's on a Montgomery signature)."""
    shape = (ctypes.c_int * 8)()
    assert lib.lt_warp_last_launch(b"g2_rsig_sub", shape) == 0
    smem = LY.NL * 4 * (4 * prog.nslots + len(prog.consts))
    skip = (0, 0) if ingest else (prog.io["INGEST_PHASES"], prog.io["INGEST_ROUNDS"])
    assert list(shape) == [n, (n + 3) // 4, 128, 4, smem, prog.nslots, prog.phases - skip[0], prog.rounds - skip[1]]


@pytest.mark.parametrize("ingest", [False, True])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("n", [1, 4, 5])
def test_host_build_equals_plain(lib, prog, plain, n, order, ingest):
    """The host build, its warps' threads forwards or reversed, at 1, 4
    and 5 lanes (5: the second block's lanes 1..3 idle) equals the plain
    version bit for bit, on Montgomery signatures or on plain limbs beside
    a message (its Montgomery message then mont_convert_plain's); its
    finite outputs are the oracle's r Q; it runs the program's rounds and
    products, less the ingest's on Montgomery signatures."""
    pick, q, inf, rw = cases(n)
    out, out_inf, sub = torch.empty((3, 2, LY.NL, n), dtype=torch.int32), torch.empty_like(inf), torch.empty_like(inf)
    qp, msg = plain_operands(pick)
    msg_out = torch.full_like(msg, -1)
    lib.lt_host_rounds(), lib.lt_host_fp_muls()  # the counters are the library's: drain another test's
    lib.lt_host_warp_order(order)
    if ingest:
        assert lib.lt_g2_rsig_sub(qp.data_ptr(), inf.data_ptr(), msg.data_ptr(), rw.data_ptr(), out.data_ptr(),
                                  out_inf.data_ptr(), sub.data_ptr(), msg_out.data_ptr(), n, None) == 0
        assert torch.equal(msg_out, KV.mont_convert_plain(msg))
        assert torch.equal(msg_out, KV.g2_rsig_sub_plain(qp, inf, rw, msg)[3])
    else:
        assert lib.lt_g2_rsig_sub(q.data_ptr(), inf.data_ptr(), None, rw.data_ptr(), out.data_ptr(),
                                  out_inf.data_ptr(), sub.data_ptr(), None, n, None) == 0
    lib.lt_host_warp_order(0)
    skip = (0, 0) if ingest else (KV.INGEST_ROUNDS, KV.INGEST_MULS)
    assert lib.lt_host_rounds() == n * (KV.ROUNDS_PER_LANE["g2_rsig_sub"] - skip[0])
    assert lib.lt_host_fp_muls() == n * (KV.FP_MULS_PER_LANE["g2_rsig_sub"] - skip[1])
    assert_last_launch(lib, prog, n, ingest)
    assert all(torch.equal(a, b) for a, b in zip((out, out_inf, sub), plain[n]))
    coords = [[LY.decode_batch(out[c, k].numpy()) for k in range(2)] for c in range(3)]
    for j, (pt, k, _) in enumerate(pick):
        if not out_inf[0, j]:
            x, y, z = (tuple(coords[c][i][j] for i in range(2)) for c in range(3))
            assert GC._to_affine(GC.FP2_OPS, (x, y, z)) == GC.scalar_mul(GC.FP2_OPS, pt, k)


@pytest.fixture()
def jax_eager_loops(monkeypatch):
    """The JAX value functions as written, with their loops (`fori_loop`,
    `cond`) run as Python loops and each Fp2 operation of FP2_OPS jitted
    alone: jitting the 128-bit chain whole takes tens of minutes on a
    CPU, running it op by op without jit several."""
    fo = JCV.FP2_OPS
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
    monkeypatch.setattr(JCV, "FP2_OPS", ops)
    return ops


def test_host_build_equals_jax_value_functions(lib, jax_eager_loops):
    """Two lanes (a point of G2 with a random scalar; a point outside G2
    with a scalar of leading zero windows): the host build's Jacobian
    triple, infinity flag and subgroup bit equal JAX
    `scalar_mul_window_jac(FP2_OPS, ...)` and `g2_subgroup_check`."""
    pts = [GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, 0xF00D), outside_g2(b"jax")]
    ks = [int.from_bytes(RNG.bytes(16), "big"), 0x3 << 80]
    q, rw = g2_planes(pts), words(ks)
    inf = torch.zeros((1, 2), dtype=torch.int32)
    out, out_inf, sub = torch.empty((3, 2, LY.NL, 2), dtype=torch.int32), torch.empty_like(inf), torch.empty_like(inf)
    assert lib.lt_g2_rsig_sub(q.data_ptr(), inf.data_ptr(), None, rw.data_ptr(), out.data_ptr(), out_inf.data_ptr(),
                              sub.data_ptr(), None, 2, None) == 0
    lib.lt_host_rounds(), lib.lt_host_fp_muls()
    fo = jax_eager_loops
    qa = tuple(tuple(jnp.asarray(JL.encode_batch([p[c][k] for p in pts])) for k in range(2)) for c in range(2))
    digits = [jnp.asarray([(k >> (124 - 4 * t)) & 15 for k in ks], jnp.int32) for t in range(32)]
    q_inf = jnp.zeros(2, bool)
    one = JCV._one_plane_like(fo, qa[0])
    (X, Y, Z), t_inf = JCV.scalar_mul_window_jac(fo, (qa[0], qa[1], one), q_inf, lambda t: digits[t], 128, 4)
    jsub = JCV.g2_subgroup_check(qa, q_inf)
    for c, coord in enumerate((X, Y, Z)):
        for k in range(2):
            assert LY.decode_batch(out[c, k].numpy()) == JL.decode_batch(np.asarray(coord[k])), (c, k)
    assert out_inf[0].tolist() == np.asarray(t_inf).astype(int).tolist() == [0, 0]
    assert sub[0].tolist() == np.asarray(jsub).astype(int).tolist() == [1, 0]


def test_rsig_counts_are_the_program():
    """ROUNDS_PER_LANE and FP_MULS_PER_LANE of g2_rsig_sub are the
    generated program's, the program is the ingest (one round of 8
    products by R^2, R^2 the first operand of each), the table then the 32
    windows, the subgroup chain's 63 steps two to a window, and the
    generated header gives the window loop each segment's first phase and
    the kernel the ingest's phases and rounds.  The ingest's registers lie
    in the table's slots: the program keeps its 238 slots."""
    prog = W.rsig_program()
    assert (prog.rounds, prog.fp_muls) == (KV.ROUNDS_PER_LANE["g2_rsig_sub"], KV.FP_MULS_PER_LANE["g2_rsig_sub"])
    starts = [0]
    for i in prog.order:
        starts.append(starts[-1] + len(prog.segs[i].phases))
    assert len(prog.order) == 2 + W.WINDOWS and starts[-1] == prog.phases
    assert f"LT_RSIG_SEG[{3 + W.WINDOWS}] = {W._words(starts)};" in W.cuda_programs()
    ingest = prog.segs[prog.order[0]]
    r2 = W.CONST + prog.consts.index(W.R * W.R % P)
    assert (ingest.rounds, ingest.fp_muls) == (KV.INGEST_ROUNDS, KV.INGEST_MULS)
    assert sorted(op[2] for ph in ingest.phases for q in ph for op in q) == [r2] * KV.INGEST_MULS
    assert (prog.io["INGEST_PHASES"], prog.io["INGEST_ROUNDS"]) == (len(ingest.phases), ingest.rounds)
    tbl = range(prog.io["TBL"], prog.io["TBL"] + 90)
    assert all(prog.io[r] in tbl and prog.io[r] + 3 in tbl for r in ("QIN", "MSGIN", "MSG"))
    assert prog.nslots == 238
    assert [b for t in range(W.WINDOWS) for b in W.subgroup_bits(t)] == list(range(62, -1, -1))
    assert prog.nslots + len(prog.consts) < W.MAX_SLOTS
