"""The per-set G2 subgroup check on the warp engine (`csrc/subgroup.cu
lt_g2_subgroup_check`), on the host.

`kernels/warp_schedule.py sub_program` is the decoded per-set path's
Montgomery ingest (the plain signature and message, any integers below
2^384, converted in one round; skipped on Montgomery points), then one
segment: the static chain [|x|] Q (63 doublings and 5 mixed additions of
Q, the plain version's formulas), psi(Q) and jac_eq's cross products of
psi(Q) against -[|x|] Q, which the kernel compares on a warp vote; a lane
at infinity passes.  Here the program, run on Python integers thread by thread in
either order, and the host build (`kernels/build.py build_host`: a warp's
32 virtual threads forwards or reversed) are held against the plain
version `kernels/verify.py g2_subgroup_check_plain`, the crypto oracle
and, at two lanes, the JAX package's `g2_subgroup_check` itself: points
of G2, twist points outside it (the cofactor not cleared), lanes flagged
infinity (outside points among them), the generator as the per-set
path's padding lanes put it, and the zero pair, given in Montgomery form
or as plain limbs (some plus multiples of p) beside plain messages, whose
Montgomery planes the kernel writes equal to `mont_convert_plain`'s.  The
round and product counts are pinned to `verify.ROUNDS_PER_LANE` and
`FP_MULS_PER_LANE`, and each launch, as the library reports it, to the
program's.
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
from lodestar_tpu_torch.crypto import curves as TC
from lodestar_tpu_torch.kernels import build as B
from lodestar_tpu_torch.kernels import layout as LY
from lodestar_tpu_torch.kernels import verify as KV
from lodestar_tpu_torch.kernels import warp_schedule as W

P = GT.P
RNG = np.random.default_rng(0x5B6)
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
    return B.load_host("subgroup")


@pytest.fixture(scope="module")
def prog():
    return W.sub_program()


def g2_planes(pts):
    return torch.from_numpy(
        np.stack([np.stack([LY.encode_batch([q[c][k] for q in pts]) for k in range(2)]) for c in range(2)])
    ).contiguous()


def outside_g2(tag: bytes):
    u = GH.hash_to_field_fp2(tag, 1, b"torch-warp-sub")[0]
    pt = GH.map_to_curve_svdw(GC.FP2_OPS, u)
    assert GC.is_on_curve(GC.FP2_OPS, pt) and not GC.g2_subgroup_check(pt)
    return pt


def scalar():
    return int.from_bytes(RNG.bytes(32), "little") % (GT.R - 2) + 2


@functools.lru_cache(maxsize=None)
def base_cases():
    """(affine point, infinity flag, the flag the check must give): a point
    of G2, a twist point outside it, an outside point flagged infinity, the
    generator (a padding lane of the per-set path), the zero pair flagged
    infinity, a point of G2 flagged infinity, another outside point."""
    return (
        (GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, scalar()), 0, 1),
        (outside_g2(b"outside-1"), 0, 0),
        (outside_g2(b"outside-2"), 1, 1),
        (GC.G2_GEN, 0, 1),
        (((0, 0), (0, 0)), 1, 1),
        (GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, scalar()), 1, 1),
        (outside_g2(b"outside-3"), 0, 0),
    )


def cases(n):
    """n lanes cycling through `base_cases()`: (planes, q_inf, wanted flags)."""
    base = base_cases()
    pick = [base[i % len(base)] for i in range(n)]
    q = g2_planes([c[0] for c in pick])
    inf = torch.tensor([[c[1] for c in pick]], dtype=torch.int32)
    return q, inf, [c[2] for c in pick]


def plain_g2_planes(vals, n):
    """Plain limb planes [2, 2, 12, n] of 4 n integers below 2^384, value
    4 j + 2 c + k at lane j, coordinate (c, k)."""
    return torch.from_numpy(LY.encode_plain_batch(vals)).reshape(LY.NL, n, 2, 2).permute(2, 3, 0, 1).contiguous()


@functools.lru_cache(maxsize=None)
def plain_cases(n):
    """`cases(n)` as the decoded path gives them to the ingest: the points
    as plain limbs, lane j's coordinates plus (j % 7) p (below 2^384: the
    same field elements), and a message of random 384-bit values ->
    (plain q, q_inf, msg, wanted flags)."""
    q, inf, want = cases(n)
    ints = mont_ints(q)
    vals = [v * W.R_INV % P + (j % 7) * P for j in range(n) for v in ints[j]]
    msg = plain_g2_planes([int.from_bytes(RNG.bytes(48), "little") for _ in range(4 * n)], n)
    return plain_g2_planes(vals, n), inf, msg, want


@functools.lru_cache(maxsize=None)
def plain(n):
    q, inf, _ = cases(n)
    return KV.g2_subgroup_check_plain(q, inf)


def mont_ints(planes):
    """Planes [..., 12, n] -> per lane the integers of the leading entries'
    limbs (Montgomery or plain, as the planes hold them)."""
    flat = planes.reshape(-1, LY.NL, planes.shape[-1])
    cols = [LY.decode_plain_batch(flat[i].numpy()) for i in range(flat.shape[0])]
    return [[c[j] for c in cols] for j in range(planes.shape[-1])]


def test_sub_program_is_pinned(prog):
    """The ingest segment (one round: the signature's and the message's 8
    products by R^2, R^2 the first operand of each), then one segment of
    206 rounds: the 1,181 Fp products of the check (63 doublings of 16, 5
    mixed additions of 29, psi's two Fp2 products and jac_eq's 22), all of
    them needed, no inversion; the kernel's pinned counts, and its header
    compiles no inversion and gives the ingest's phases and rounds."""
    assert (prog.rounds, prog.fp_muls, prog.phases, prog.nslots) == (
        KV.ROUNDS_PER_LANE["g2_subgroup_check"], KV.FP_MULS_PER_LANE["g2_subgroup_check"], 1316, 57)
    x = -GT.X_PARAM
    steps = (x.bit_length() - 1) * KV.DBL2_MULS + (bin(x).count("1") - 1) * (7 * 3 + 4 * 2)
    assert KV.FP_MULS_PER_LANE["g2_subgroup_check"] == KV.FP_MULS_NEEDED["g2_subgroup_check"] == (
        steps + 6 + 22 + KV.INGEST_MULS)
    ingest, check = (prog.segs[i] for i in prog.order)
    assert (ingest.rounds, ingest.fp_muls, check.rounds) == (KV.INGEST_ROUNDS, KV.INGEST_MULS, 206)
    assert (prog.io["INGEST_PHASES"], prog.io["INGEST_ROUNDS"]) == (len(ingest.phases), KV.INGEST_ROUNDS)
    r2 = W.CONST + prog.consts.index(W.R * W.R % P)
    assert sorted(op[2] for ph in ingest.phases for q in ph for op in q) == [r2] * KV.INGEST_MULS
    for seg in (ingest, check):
        assert not any(op[0] == W.INV for ph in seg.phases for q in ph for op in q)
        W.check_hazards(seg)
    header = W.cuda_programs()
    sub = header[header.index("#ifdef LT_WANT_SUB\n"):header.index("#endif  // LT_WANT_SUB\n")]
    assert "LT_WANT_INV" not in sub and f"#define LT_SUB_ROUNDS {prog.rounds}" in sub
    assert f"#define LT_SUB_INGEST_ROUNDS {KV.INGEST_ROUNDS}" in sub


def drive(prog, q_ints, q_inf, reverse=False, msg_ints=None):
    """The program on Python integers and csrc/subgroup.cu's comparison:
    with msg_ints, q_ints are plain and the ingest runs first -> (flag,
    the Montgomery q and msg); else q_ints are Montgomery -> flag."""
    io = prog.io
    if msg_ints is None:
        out = W.simulate(prog.segs, prog.order[1:], prog.nslots, prog.consts,
                         {io["Q"] + i: v for i, v in enumerate(q_ints)}, reverse)
    else:
        out = prog.run({**{io["QIN"] + i: v for i, v in enumerate(q_ints)},
                        **{io["MSGIN"] + i: v for i, v in enumerate(msg_ints)}}, reverse)
    eq = [out[io["EQ"] + i] for i in range(8)]
    flag = int(bool(q_inf) or (eq[0:2] == eq[2:4] and eq[4:6] == eq[6:8]))
    if msg_ints is None:
        return flag
    return flag, [out[io["Q"] + i] for i in range(4)], [out[io["MSG"] + i] for i in range(4)]


@pytest.mark.parametrize("ingest", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_program_simulation_equals_plain_and_oracle(prog, reverse, ingest):
    """The program on Python integers, thread by thread in either order,
    gives the plain version's flag on every kind of lane, and the oracle's
    (crypto/ and the port's copy) where the lane is not flagged; given
    plain limbs, its ingest gives the plain version's Montgomery points."""
    n = len(base_cases())
    q, inf, want = cases(n)
    if ingest:
        qp, inf, msg, want = plain_cases(n)
        runs = [drive(prog, qi, inf[0, j].item(), reverse, mi)
                for j, (qi, mi) in enumerate(zip(mont_ints(qp), mont_ints(msg)))]
        got = [r[0] for r in runs]
        assert [r[1] for r in runs] == mont_ints(q)
        assert [r[2] for r in runs] == mont_ints(KV.mont_convert_plain(msg))
    else:
        got = [drive(prog, ints, inf[0, j].item(), reverse) for j, ints in enumerate(mont_ints(q))]
    assert got == plain(n)[0].tolist() == want
    for (pt, flag, _), g in zip(base_cases(), got):
        if not flag and pt != ((0, 0), (0, 0)):
            assert g == int(GC.g2_subgroup_check(pt)) == int(TC.g2_subgroup_check(pt))


def assert_last_launch(lib, prog, n, ingest=True):
    """The last launch: n lanes, 4 per block of 128 threads, the program's
    slots, constants, phases and rounds (less the ingest's on Montgomery
    points)."""
    shape = (ctypes.c_int * 8)()
    assert lib.lt_warp_last_launch(b"g2_subgroup_check", shape) == 0
    smem = LY.NL * 4 * (4 * prog.nslots + len(prog.consts))
    skip = (0, 0) if ingest else (prog.io["INGEST_PHASES"], prog.io["INGEST_ROUNDS"])
    assert list(shape) == [n, (n + 3) // 4, 128, 4, smem, prog.nslots, prog.phases - skip[0], prog.rounds - skip[1]]


@pytest.mark.parametrize("ingest", [False, True])
@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("n", [1, 4, 5, 7])
def test_host_build_equals_plain(lib, prog, n, order, ingest):
    """The host build, its warps' threads forwards or reversed, at 1, 4, 5
    (the second block's lanes 1..3 idle) and 7 lanes equals the plain
    version's flags, on Montgomery points or on plain limbs beside a
    message (the Montgomery planes it writes then equal the plain
    version's, mont_convert_plain's); it runs the program's rounds and
    products per lane, less the ingest's on Montgomery points."""
    q, inf, want = cases(n)
    out = torch.full((1, n), -1, dtype=torch.int32)
    conv = torch.full((2, 2, 2, LY.NL, n), -1, dtype=torch.int32)
    lib.lt_host_rounds(), lib.lt_host_fp_muls()  # the counters are the library's: drain another test's
    lib.lt_host_warp_order(order)
    if ingest:
        qp, inf, msg, want = plain_cases(n)
        assert lib.lt_g2_subgroup_check(qp.data_ptr(), inf.data_ptr(), msg.data_ptr(), out.data_ptr(),
                                        conv.data_ptr(), n, None) == 0
        flags, q_m, msg_m = KV.g2_subgroup_check_plain(qp, inf, msg)
        assert torch.equal(flags, plain(n)) and torch.equal(q_m, q)
        assert torch.equal(conv[0], q_m) and torch.equal(conv[1], msg_m)
        assert torch.equal(msg_m, KV.mont_convert_plain(msg))
    else:
        assert lib.lt_g2_subgroup_check(q.data_ptr(), inf.data_ptr(), None, out.data_ptr(), None, n, None) == 0
    lib.lt_host_warp_order(0)
    assert torch.equal(out, plain(n)) and out[0].tolist() == want
    skip = (0, 0) if ingest else (KV.INGEST_ROUNDS, KV.INGEST_MULS)
    assert lib.lt_host_rounds() == n * (KV.ROUNDS_PER_LANE["g2_subgroup_check"] - skip[0])
    assert lib.lt_host_fp_muls() == n * (KV.FP_MULS_PER_LANE["g2_subgroup_check"] - skip[1])
    assert_last_launch(lib, prog, n, ingest)


@pytest.fixture()
def jax_eager_loops(monkeypatch):
    """JAX's g2_subgroup_check as written, its loop (`fori_loop`, `cond`)
    run in Python and each Fp2 operation of FP2_OPS jitted alone (a jit of
    the whole chain, or a `cond` traced at every step, takes minutes on a
    CPU)."""
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


def test_host_build_equals_jax(lib, jax_eager_loops):
    """Two lanes (a point of G2, a point outside it): the host build's
    flags equal JAX `g2_subgroup_check`'s."""
    pts = [GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, scalar()), outside_g2(b"jax")]
    q = g2_planes(pts)
    inf = torch.zeros((1, 2), dtype=torch.int32)
    out = torch.empty((1, 2), dtype=torch.int32)
    assert lib.lt_g2_subgroup_check(q.data_ptr(), inf.data_ptr(), None, out.data_ptr(), None, 2, None) == 0
    lib.lt_host_rounds(), lib.lt_host_fp_muls()
    qa = tuple(tuple(jnp.asarray(JL.encode_batch([p[c][k] for p in pts])) for k in range(2)) for c in range(2))
    jsub = JCV.g2_subgroup_check(qa, jnp.zeros(2, bool))
    assert out[0].tolist() == np.asarray(jsub).astype(int).tolist() == [1, 0]
