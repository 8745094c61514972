"""The per-set G2 subgroup check on the warp engine (`csrc/subgroup.cu
lt_g2_subgroup_check`), on the host.

`kernels/warp_schedule.py sub_program` is one segment: the static chain
[|x|] Q (63 doublings and 5 mixed additions of Q, the plain version's
formulas), psi(Q) and jac_eq's cross products of psi(Q) against
-[|x|] Q, which the kernel compares on a warp vote; a lane at infinity
passes.  Here the program, run on Python integers thread by thread in
either order, and the host build (`kernels/build.py build_host`: a warp's
32 virtual threads forwards or reversed) are held against the plain
version `kernels/verify.py g2_subgroup_check_plain`, the crypto oracle
and, at two lanes, the JAX package's `g2_subgroup_check` itself: points
of G2, twist points outside it (the cofactor not cleared), lanes flagged
infinity (outside points among them), the generator as the per-set
path's padding lanes put it, and the zero pair.  The round and product
counts are pinned to `verify.ROUNDS_PER_LANE` and `FP_MULS_PER_LANE`,
and each launch, as the library reports it, to the program's.
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


@functools.lru_cache(maxsize=None)
def plain(n):
    q, inf, _ = cases(n)
    return KV.g2_subgroup_check_plain(q, inf)


def mont_ints(planes):
    flat = planes.reshape(-1, LY.NL, planes.shape[-1])
    cols = [LY.decode_plain_batch(flat[i].numpy()) for i in range(flat.shape[0])]
    return [[c[j] for c in cols] for j in range(planes.shape[-1])]


def test_sub_program_is_pinned(prog):
    """One segment of 206 rounds: the 1,181 Fp products of the check (63
    doublings of 16, 5 mixed additions of 29, psi's two Fp2 products and
    jac_eq's 22), all of them needed, no inversion; the kernel's pinned
    counts, and its header compiles no inversion."""
    assert (prog.rounds, prog.fp_muls, prog.phases, prog.nslots) == (
        KV.ROUNDS_PER_LANE["g2_subgroup_check"], KV.FP_MULS_PER_LANE["g2_subgroup_check"], 1315, 53)
    x = -GT.X_PARAM
    steps = (x.bit_length() - 1) * KV.DBL2_MULS + (bin(x).count("1") - 1) * (7 * 3 + 4 * 2)
    assert KV.FP_MULS_PER_LANE["g2_subgroup_check"] == KV.FP_MULS_NEEDED["g2_subgroup_check"] == steps + 6 + 22
    assert len(prog.order) == 1 and not any(op[0] == W.INV for ph in prog.segs[0].phases for q in ph for op in q)
    W.check_hazards(prog.segs[0])
    header = W.cuda_programs()
    sub = header[header.index("#ifdef LT_WANT_SUB\n"):header.index("#endif  // LT_WANT_SUB\n")]
    assert "LT_WANT_INV" not in sub and f"#define LT_SUB_ROUNDS {prog.rounds}" in sub


def drive(prog, q_ints, q_inf, reverse=False):
    """The program on Python integers and csrc/subgroup.cu's comparison."""
    out = prog.run({prog.io["Q"] + i: v for i, v in enumerate(q_ints)}, reverse)
    eq = [out[prog.io["EQ"] + i] for i in range(8)]
    return int(bool(q_inf) or (eq[0:2] == eq[2:4] and eq[4:6] == eq[6:8]))


@pytest.mark.parametrize("reverse", [False, True])
def test_program_simulation_equals_plain_and_oracle(prog, reverse):
    """The program on Python integers, thread by thread in either order,
    gives the plain version's flag on every kind of lane, and the oracle's
    (crypto/ and the port's copy) where the lane is not flagged."""
    n = len(base_cases())
    q, inf, want = cases(n)
    got = [drive(prog, ints, inf[0, j].item(), reverse) for j, ints in enumerate(mont_ints(q))]
    assert got == plain(n)[0].tolist() == want
    for (pt, flag, _), g in zip(base_cases(), got):
        if not flag and pt != ((0, 0), (0, 0)):
            assert g == int(GC.g2_subgroup_check(pt)) == int(TC.g2_subgroup_check(pt))


def assert_last_launch(lib, prog, n):
    """The last launch: n lanes, 4 per block of 128 threads, the program's
    slots, constants, phases and rounds."""
    shape = (ctypes.c_int * 8)()
    assert lib.lt_warp_last_launch(b"g2_subgroup_check", shape) == 0
    smem = LY.NL * 4 * (4 * prog.nslots + len(prog.consts))
    assert list(shape) == [n, (n + 3) // 4, 128, 4, smem, prog.nslots, prog.phases, prog.rounds]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("n", [1, 4, 5, 7])
def test_host_build_equals_plain(lib, prog, n, order):
    """The host build, its warps' threads forwards or reversed, at 1, 4, 5
    (the second block's lanes 1..3 idle) and 7 lanes equals the plain
    version's flags; it runs the program's rounds and products per lane."""
    q, inf, want = cases(n)
    out = torch.full((1, n), -1, dtype=torch.int32)
    lib.lt_host_rounds(), lib.lt_host_fp_muls()  # the counters are the library's: drain another test's
    lib.lt_host_warp_order(order)
    assert lib.lt_g2_subgroup_check(q.data_ptr(), inf.data_ptr(), out.data_ptr(), n, None) == 0
    lib.lt_host_warp_order(0)
    assert torch.equal(out, plain(n)) and out[0].tolist() == want
    assert lib.lt_host_rounds() == n * KV.ROUNDS_PER_LANE["g2_subgroup_check"]
    assert lib.lt_host_fp_muls() == n * KV.FP_MULS_PER_LANE["g2_subgroup_check"]
    assert_last_launch(lib, prog, n)


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
    assert lib.lt_g2_subgroup_check(q.data_ptr(), inf.data_ptr(), out.data_ptr(), 2, None) == 0
    lib.lt_host_rounds(), lib.lt_host_fp_muls()
    qa = tuple(tuple(jnp.asarray(JL.encode_batch([p[c][k] for p in pts])) for k in range(2)) for c in range(2))
    jsub = JCV.g2_subgroup_check(qa, jnp.zeros(2, bool))
    assert out[0].tolist() == np.asarray(jsub).astype(int).tolist() == [1, 0]
