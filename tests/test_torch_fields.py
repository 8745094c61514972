"""The port's plain field engine (lodestar_tpu_torch.kernels core, fp2,
tower) held against the JAX package's value-level functions and the
crypto oracle.

The JAX functions run as plain eager jnp (no Pallas, no jit: eager ops
compile once per primitive, a jit of a tower function compiles for tens
of seconds on this host).  The JAX side returns redundant limbs, so both
sides are compared as canonical field integers.  Every comparison is
exact.  Functions built on a fori_loop in the JAX package (inversion,
cyclotomic powers) are compared with the oracle only here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lodestar_tpu.crypto import fields as GT
from lodestar_tpu.kernels import core as JC
from lodestar_tpu.kernels import fp2 as JF2
from lodestar_tpu.kernels import layout as JL
from lodestar_tpu.kernels import tower as JT
from lodestar_tpu_torch.kernels import build as PB
from lodestar_tpu_torch.kernels import core as C
from lodestar_tpu_torch.kernels import fp2 as F2
from lodestar_tpu_torch.kernels import layout as LY
from lodestar_tpu_torch.kernels import tower as TW
from lodestar_tpu_torch.kernels import verify as KV

P = GT.P
RNG = np.random.default_rng(0x70C4F1E1D5)
EDGE = [0, 1, 2, P - 1, P - 2, (P - 1) // 2, LY.R_MOD_P, JL.R_MOD_P]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain engine's tensors are small, and
    parallel test workers must not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand_fp(n):
    return [int.from_bytes(RNG.bytes(48), "little") % P for _ in range(n)]


N = 8  # lanes of every JAX comparison: one shape, so eager ops compile once


def fp_cases():
    """Edge values against random ones, in both operand positions."""
    xs = EDGE[:4] + rand_fp(4)
    ys = rand_fp(4) + EDGE[4:]
    return xs, ys


def r2():
    return tuple(rand_fp(2))


def r6():
    return (r2(), r2(), r2())


def r12():
    return (r6(), r6())


# -- port tensors: Fp [ND, n], Fp2 [2, ND, n], Fp6 [3, ...], Fp12 [2, 3, ...]


def t1(xs):
    return LY.encode_digits(xs)


def t2(vals):
    return torch.stack([t1([v[0] for v in vals]), t1([v[1] for v in vals])])


def t6(vals):
    return torch.stack([t2([v[i] for v in vals]) for i in range(3)])


def t12(vals):
    return torch.stack([t6([v[h] for v in vals]) for h in range(2)])


def d1(t):
    return LY.decode_digits(t)


def d2(t):
    return list(zip(d1(t[0]), d1(t[1])))


def d6(t):
    return list(zip(*[d2(t[i]) for i in range(3)]))


def d12(t):
    return list(zip(*[d6(t[h]) for h in range(2)]))


# -- JAX values: tuples of [33, n] planes


def j1(xs):
    return jnp.asarray(JL.encode_batch(xs))


def j2(vals):
    return (j1([v[0] for v in vals]), j1([v[1] for v in vals]))


def j6(vals):
    return tuple(j2([v[i] for v in vals]) for i in range(3))


def j12(vals):
    return tuple(j6([v[h] for v in vals]) for h in range(2))


def jd1(x):
    return JL.decode_batch(np.asarray(x))


def jd2(x):
    return list(zip(jd1(x[0]), jd1(x[1])))


def jd6(x):
    return list(zip(*[jd2(c) for c in x]))


def jd12(x):
    return list(zip(*[jd6(c) for c in x]))


def is_canonical(t):
    """Digits of a canonical value: each in [0, 2^24), value below p."""
    vals = [
        sum(int(d) << (LY.DIGIT_BITS * k) for k, d in enumerate(col))
        for col in t.reshape(-1, LY.ND, t.shape[-1]).permute(0, 2, 1).reshape(-1, LY.ND).tolist()
    ]
    return bool(((t >= 0) & (t <= LY.DIGIT_MASK)).all()) and all(v < P for v in vals)


# ---------------------------------------------------------------------------
# layout and codecs
# ---------------------------------------------------------------------------


def test_codecs_roundtrip():
    vals = [0, 1, P - 1, P, 2 * P, (1 << 384) - 1] + [
        int.from_bytes(RNG.bytes(48), "little") for _ in range(10)
    ]
    for v in vals:
        assert LY.from_limbs(LY.to_limbs(v)) == v
    planes = LY.encode_plain_batch(vals)
    assert planes.dtype == np.int32 and planes.shape == (LY.NL, len(vals))
    assert LY.decode_plain_batch(planes) == vals
    pt = torch.from_numpy(planes)
    dg = LY.planes_to_digits(pt)
    assert bool(((dg >= 0) & (dg <= LY.DIGIT_MASK)).all())
    assert torch.equal(LY.digits_to_planes(dg), pt)
    assert LY.decode_batch(LY.encode_batch(vals)) == [v % P for v in vals]
    assert d1(t1(vals)) == [v % P for v in vals]


def test_from_jax_planes_is_exact():
    xs = EDGE + rand_fp(20)
    jax_planes = JL.encode_batch(xs)  # R = 2^396, 33 x 12-bit limbs
    padded = np.concatenate([jax_planes, np.zeros((JL.NL, 3), np.int32)], axis=1)
    port = LY.from_jax_planes(padded, len(xs))
    assert np.array_equal(port, LY.encode_batch(xs))
    assert LY.decode_batch(port) == [x % P for x in xs]


def test_constants_header_is_generated():
    """csrc/constants.cuh is the text layout.cuda_constants() makes."""
    committed = (PB.CSRC / "constants.cuh").read_text()
    assert committed == LY.cuda_constants()


# ---------------------------------------------------------------------------
# Fp
# ---------------------------------------------------------------------------

FP_OPS = {
    "mul": (C.mont_mul, JC.mont_mul, lambda x, y: x * y % P),
    "sqr": (lambda a, b: C.mont_sqr(a), lambda a, b: JC.mont_sqr(a), lambda x, y: x * x % P),
    "add": (C.add, JC.add, lambda x, y: (x + y) % P),
    "sub": (C.sub, JC.sub, lambda x, y: (x - y) % P),
    "neg": (lambda a, b: C.neg(a), lambda a, b: JC.neg(a), lambda x, y: -x % P),
    "mul_small_3": (
        lambda a, b: C.mul_small(a, 3), lambda a, b: JC.mul_small(a, 3), lambda x, y: 3 * x % P
    ),
    "mul_small_8": (
        lambda a, b: C.mul_small(a, 8), lambda a, b: JC.mul_small(a, 8), lambda x, y: 8 * x % P
    ),
}


@pytest.mark.parametrize("op", sorted(FP_OPS))
def test_fp_op_matches_jax_and_oracle(op):
    port, jax_fn, oracle = FP_OPS[op]
    xs, ys = fp_cases()
    out = port(t1(xs), t1(ys))
    assert is_canonical(out)
    want = [oracle(x, y) for x, y in zip(xs, ys)]
    assert d1(out) == want
    assert jd1(jax_fn(j1(xs), j1(ys))) == want


def test_mont_convert_admits_any_384_bit_value():
    """The one non-canonical input the port takes: plain limbs of any
    integer below 2^384, the Montgomery ingest that the paths' heading
    kernels make (their message operand; on CPU tensors their plain
    versions, through `mont_convert_plain`), equal to JAX's conversion."""
    vals = [0, 1, P - 1, P, P + 1, 2 * P, 9 * P, (1 << 384) - 1] + [
        int.from_bytes(RNG.bytes(48), "little") for _ in range(8)
    ]
    planes = torch.from_numpy(LY.encode_plain_batch(vals))
    out = KV.mont_convert_plain(planes)
    assert LY.decode_batch(out.numpy()) == [v % P for v in vals]
    assert is_canonical(LY.planes_to_digits(out))
    msg = planes.reshape(LY.NL, 2, 2, 4).permute(1, 2, 0, 3).contiguous()  # [2, 2, 12, 4]
    x, flags = torch.zeros((2, LY.NL, 4), dtype=torch.int32), torch.tensor([[0] * 4, [1] * 4], dtype=torch.int32)
    KV.reset_launches()
    _, _, msg_out = KV.g2_decompress(x, flags, msg)
    assert KV.LAUNCHES["g2_decompress"] == 0  # CPU tensors take the plain version
    assert torch.equal(msg_out.permute(2, 0, 1, 3).reshape(LY.NL, 16), out)
    jax_plain = jnp.asarray(JL.encode_plain_batch(vals))
    r2_limbs = [int(v) for v in JL.MONT_R2]
    assert jd1(JC.redc(JC.mul_cols_shared(jax_plain, r2_limbs, JL.NC))) == [v % P for v in vals]


def test_fp_predicates_and_select():
    xs = [0, P - 1, 5, 5, 0, 12345, 7, 8]
    ys = [0, P - 1, 5, 6, 1, 12345, 7, 9]
    a, b = t1(xs), t1(ys)
    want_eq = [x == y for x, y in zip(xs, ys)]
    want_zero = [x == 0 for x in xs]
    assert C.eq_modp(a, b).tolist() == want_eq
    assert C.is_zero_modp(a).tolist() == want_zero
    assert list(np.asarray(JC.eq_modp(j1(xs), j1(ys)))) == want_eq
    assert list(np.asarray(JC.is_zero_modp(j1(xs)))) == want_zero
    # non-canonical values below 2^384 that are zero mod p
    raw = torch.tensor([LY.int_to_digits(v) for v in (P, 2 * P, 9 * P, P + 1)]).T
    assert C.is_zero_modp(raw).tolist() == [True, True, True, False]
    mask = torch.tensor([True, False, True, False, False, True, False, True])
    sel = d1(C.select(mask, a, b))
    assert sel == [x if m else y for x, y, m in zip(xs, ys, mask.tolist())]


def test_fp_lazy_chain_matches_jax_and_oracle():
    """The JAX package's lazy chain, and a 60-step mixed chain."""
    xs, ys, zs = rand_fp(N), rand_fp(N), rand_fp(N)
    a, b, c = t1(xs), t1(ys), t1(zs)

    def chain(M, add, sub, neg, a, b, c):
        t = M(add(a, b), sub(b, neg(c)))
        u = sub(M(t, t), add(c, add(a, M(b, c))))
        return M(u, sub(u, a))

    got = d1(chain(C.mont_mul, C.add, C.sub, C.neg, a, b, c))
    want = []
    for x, y, z in zip(xs, ys, zs):
        t = (x + y) * (y + z) % P
        u = (t * t - (z + x + y * z)) % P
        want.append(u * (u - x) % P)
    assert got == want
    assert jd1(chain(JC.mont_mul, JC.add, JC.sub, JC.neg, j1(xs), j1(ys), j1(zs))) == want

    steps = RNG.integers(0, 5, size=60)
    acc, accv = a, list(xs)
    for s in steps:
        if s == 0:
            acc, accv = C.mont_mul(acc, b), [u * v % P for u, v in zip(accv, ys)]
        elif s == 1:
            acc, accv = C.mont_sqr(acc), [u * u % P for u in accv]
        elif s == 2:
            acc, accv = C.sub(acc, c), [(u - v) % P for u, v in zip(accv, zs)]
        elif s == 3:
            acc, accv = C.add(acc, acc), [2 * u % P for u in accv]
        else:
            acc, accv = C.neg(acc), [-u % P for u in accv]
        assert is_canonical(acc)
    assert d1(acc) == accv


# ---------------------------------------------------------------------------
# Fp2
# ---------------------------------------------------------------------------

FP2_OPS = {
    "mul2": (F2.mul2, JF2.mul2, GT.fp2_mul),
    "sqr2": (lambda a, b: F2.sqr2(a), lambda a, b: JF2.sqr2(a), lambda x, y: GT.fp2_sqr(x)),
    "mul2_xi": (lambda a, b: F2.mul2_xi(a), lambda a, b: JF2.mul2_xi(a), lambda x, y: GT.fp2_mul_xi(x)),
    "conj2": (lambda a, b: F2.conj2(a), lambda a, b: JF2.conj2(a), lambda x, y: GT.fp2_conj(x)),
    "add2": (F2.add2, JF2.add2, GT.fp2_add),
    "sub2": (F2.sub2, JF2.sub2, GT.fp2_sub),
    "neg2": (lambda a, b: F2.neg2(a), lambda a, b: JF2.neg2(a), lambda x, y: GT.fp2_neg(x)),
    "mul2_fp": (
        lambda a, b: F2.mul2_fp(a, b[0]),
        lambda a, b: JF2.mul2_fp(a, b[0]),
        lambda x, y: GT.fp2_mul_fp(x, y[0]),
    ),
}


@pytest.mark.parametrize("op", sorted(FP2_OPS))
def test_fp2_op_matches_jax_and_oracle(op):
    port, jax_fn, oracle = FP2_OPS[op]
    xs = [(0, 0), (1, 0), (0, 1), (P - 1, P - 1)] + [r2() for _ in range(4)]
    ys = [r2() for _ in range(4)] + [(P - 1, 1), (0, 0), (1, 0), (P - 1, P - 1)]
    out = port(t2(xs), t2(ys))
    assert is_canonical(out)
    want = [oracle(x, y) for x, y in zip(xs, ys)]
    assert d2(out) == want
    assert jd2(jax_fn(j2(xs), j2(ys))) == want


# ---------------------------------------------------------------------------
# Fp6 / Fp12
# ---------------------------------------------------------------------------


def test_fp6_mul_sqr_match_jax_and_oracle():
    xs, ys = [r6() for _ in range(N)], [r6() for _ in range(N)]
    m, s = TW.mul6(t6(xs), t6(ys)), TW.sqr6(t6(xs))
    assert d6(m) == [GT.fp6_mul(x, y) for x, y in zip(xs, ys)]
    assert d6(s) == [GT.fp6_sqr(x) for x in xs]
    assert jd6(JT.mul6(j6(xs), j6(ys))) == d6(m)
    assert jd6(JT.sqr6(j6(xs))) == d6(s)
    assert d6(TW.mul6_by_v(t6(xs))) == [GT.fp6_mul_by_v(x) for x in xs]


def test_fp12_mul_sqr_deep_chain_matches_jax_and_oracle():
    xs, ys = [r12() for _ in range(N)], [r12() for _ in range(N)]
    a, b = t12(xs), t12(ys)
    m = TW.mul12(a, b)
    chain = TW.mul12(TW.sqr12(m), TW.conj12(a))
    want_m = [GT.fp12_mul(u, w) for u, w in zip(xs, ys)]
    want = [GT.fp12_mul(GT.fp12_sqr(wm), GT.fp12_conj(u)) for wm, u in zip(want_m, xs)]
    assert d12(m) == want_m
    assert d12(chain) == want
    assert is_canonical(chain)
    ja, jb = j12(xs), j12(ys)
    jm = JT.mul12(ja, jb)
    assert jd12(JT.mul12(JT.sqr12(jm), JT.conj12(ja))) == want


@pytest.mark.parametrize("power", [1, 2, 3])
def test_fp12_frobenius_matches_jax_and_oracle(power):
    xs = [r12() for _ in range(N)]
    got = d12(TW.frob12(t12(xs), power))
    assert got == [GT.fp12_frobenius(u, power) for u in xs]
    assert jd12(JT.frob12(j12(xs), power)) == got


def test_is_one_and_select():
    xs = [r12() for _ in range(6)]
    vals = xs[:2] + [GT.FP12_ONE] * 2 + xs[2:]
    a = t12(vals)
    assert TW.is_one12(a).tolist() == [False, False, True, True] + [False] * 4
    mask = torch.tensor([True, False, True, False, True, False, True, False])
    sel = TW.select(mask, a, TW.one12(N, a.device))
    assert TW.is_one12(sel).tolist() == [False, True, True, True, False, True, False, True]
    assert list(np.asarray(JT.is_one12(j12(vals)))) == TW.is_one12(a).tolist()


def _cyclotomic_sample(n):
    """Random elements of the cyclotomic subgroup: f^((p^6-1)(p^2+1))."""
    out = []
    for _ in range(n):
        f = r12()
        m = GT.fp12_mul(GT.fp12_conj(f), GT.fp12_inv(f))
        out.append(GT.fp12_mul(GT.fp12_frobenius(m, 2), m))
    return out


def test_cyclotomic_square_and_pow_x():
    cs = _cyclotomic_sample(N)
    a = t12(cs)
    s = TW.cyclo_sqr(a)
    assert d12(s) == [GT.fp12_sqr(u) for u in cs]
    assert jd12(JT.cyclo_sqr(j12(cs))) == d12(s)
    px = TW.cyclo_pow_x_neg(a)
    assert d12(px) == [GT.fp12_conj(GT.fp12_pow(u, -GT.X_PARAM)) for u in cs]


def test_inversion_chain():
    xs = [0, 1, P - 1] + rand_fp(3)
    assert d1(TW.inv_fp(t1(xs))) == [pow(x, P - 2, P) for x in xs]
    x2 = [r2() for _ in range(3)] + [(1, 0), (0, P - 1)]
    x6, x12 = [r6() for _ in range(2)], [r12() for _ in range(2)]
    assert d2(TW.inv2(t2(x2))) == [GT.fp2_inv(u) for u in x2]
    assert d6(TW.inv6(t6(x6))) == [GT.fp6_inv(u) for u in x6]
    assert d12(TW.inv12(t12(x12))) == [GT.fp12_inv(u) for u in x12]
