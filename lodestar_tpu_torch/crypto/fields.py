"""BLS12-381 field towers over Python ints — the CPU ground truth.

This module is the reference ("ground truth") arithmetic that the JAX/TPU
kernels in `lodestar_tpu.ops` are validated against.  It is written from
first principles (standard BLS12-381 parameters and tower construction):

    Fp   = GF(p)
    Fp2  = Fp[u]  / (u^2 + 1)
    Fp6  = Fp2[v] / (v^3 - xi),  xi = u + 1
    Fp12 = Fp6[w] / (w^2 - v)

Elements are represented as plain ints / nested tuples so the module has
zero dependencies and is trivially picklable:

    Fp   : int
    Fp2  : (int, int)                      # c0 + c1*u
    Fp6  : (Fp2, Fp2, Fp2)                 # a0 + a1*v + a2*v^2
    Fp12 : (Fp6, Fp6)                      # b0 + b1*w

Role in the reference architecture: this is the equivalent of the CPU
fallback implementation selected by the `@chainsafe/bls` facade
(reference: packages/beacon-node/src/chain/bls/multithread/index.ts:127-132
chooses blst-native vs herumi); the TPU build keeps a CPU path for ground
truth, decompression, and latency-critical small verifications.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# Parameters.  x is the BLS12-381 curve parameter; p and r derive from it.
# ---------------------------------------------------------------------------

X_PARAM = -0xD201000000010000  # "z", the BLS parameter (negative)

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# Self-checks that the parameterisation is internally consistent.
_ax = -X_PARAM
assert R == X_PARAM**4 - X_PARAM**2 + 1
assert P == (X_PARAM - 1) ** 2 * R // 3 + X_PARAM
assert P % 4 == 3  # used by sqrt
H1_COFACTOR = (X_PARAM - 1) ** 2 // 3  # G1 cofactor

# ---------------------------------------------------------------------------
# Fp
# ---------------------------------------------------------------------------


def fp_add(a: int, b: int) -> int:
    return (a + b) % P


def fp_sub(a: int, b: int) -> int:
    return (a - b) % P


def fp_mul(a: int, b: int) -> int:
    return (a * b) % P


def fp_neg(a: int) -> int:
    return (-a) % P


def fp_inv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("inverse of 0 in Fp")
    return pow(a, P - 2, P)


def fp_sqrt(a: int):
    """Square root in Fp (p % 4 == 3), or None if a is not a QR."""
    a %= P
    cand = pow(a, (P + 1) // 4, P)
    return cand if cand * cand % P == a else None


def fp_sgn(a: int) -> int:
    """1 if a > p - a (i.e. a is the 'larger' root), else 0.  a != 0."""
    return 1 if a > P - a else 0


# ---------------------------------------------------------------------------
# Fp2 = Fp[u]/(u^2+1)
# ---------------------------------------------------------------------------

FP2_ZERO = (0, 0)
FP2_ONE = (1, 0)
XI = (1, 1)  # the Fp6 non-residue, u + 1


def fp2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fp2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fp2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fp2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = a0 * b0
    t1 = a1 * b1
    # (a0+a1)(b0+b1) - t0 - t1 = a0*b1 + a1*b0  (Karatsuba)
    t2 = (a0 + a1) * (b0 + b1) - t0 - t1
    return ((t0 - t1) % P, t2 % P)


def fp2_sqr(a):
    a0, a1 = a
    # (a0+a1)(a0-a1), 2*a0*a1
    return ((a0 + a1) * (a0 - a1) % P, 2 * a0 * a1 % P)


def fp2_mul_fp(a, k: int):
    return (a[0] * k % P, a[1] * k % P)


def fp2_conj(a):
    """Frobenius x -> x^p on Fp2: conjugation."""
    return (a[0] % P, (-a[1]) % P)


def fp2_inv(a):
    a0, a1 = a
    n = (a0 * a0 + a1 * a1) % P
    ninv = fp_inv(n)
    return (a0 * ninv % P, (-a1) * ninv % P)


def fp2_mul_xi(a):
    """Multiply by xi = u + 1:  (c0 + c1 u)(1 + u) = (c0 - c1) + (c0 + c1) u."""
    a0, a1 = a
    return ((a0 - a1) % P, (a0 + a1) % P)


def fp2_eq(a, b) -> bool:
    return a[0] % P == b[0] % P and a[1] % P == b[1] % P


def fp2_is_zero(a) -> bool:
    return a[0] % P == 0 and a[1] % P == 0


def fp2_pow(a, e: int):
    result = FP2_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fp2_mul(result, base)
        base = fp2_sqr(base)
        e >>= 1
    return result


def fp2_sqrt(a):
    """Square root in Fp2 via the norm ('complex') method, or None."""
    a0, a1 = a[0] % P, a[1] % P
    if a1 == 0:
        s = fp_sqrt(a0)
        if s is not None:
            return (s, 0)
        # a0 is a non-residue in Fp; sqrt is of the form x1*u.
        s = fp_sqrt((-a0) % P)  # (x1*u)^2 = -x1^2  => x1^2 = -a0
        if s is None:
            return None
        return (0, s)
    n = (a0 * a0 + a1 * a1) % P  # norm, always a QR in Fp if a is a square
    d = fp_sqrt(n)
    if d is None:
        return None
    inv2 = fp_inv(2)
    x0sq = (a0 + d) * inv2 % P
    x0 = fp_sqrt(x0sq)
    if x0 is None:
        x0sq = (a0 - d) * inv2 % P
        x0 = fp_sqrt(x0sq)
        if x0 is None:
            return None
    x1 = a1 * fp_inv(2 * x0 % P) % P
    cand = (x0, x1)
    return cand if fp2_eq(fp2_sqr(cand), (a0, a1)) else None


def fp2_sgn(a) -> int:
    """Lexicographic 'is larger than its negation' flag, c1 compared first.

    Matches the ZCash compressed-point sort order used for G2 y-coordinates.
    """
    a0, a1 = a[0] % P, a[1] % P
    if a1 != 0:
        return fp_sgn(a1)
    if a0 != 0:
        return fp_sgn(a0)
    return 0


# ---------------------------------------------------------------------------
# Fp6 = Fp2[v]/(v^3 - xi)
# ---------------------------------------------------------------------------

FP6_ZERO = (FP2_ZERO, FP2_ZERO, FP2_ZERO)
FP6_ONE = (FP2_ONE, FP2_ZERO, FP2_ZERO)


def fp6_add(a, b):
    return (fp2_add(a[0], b[0]), fp2_add(a[1], b[1]), fp2_add(a[2], b[2]))


def fp6_sub(a, b):
    return (fp2_sub(a[0], b[0]), fp2_sub(a[1], b[1]), fp2_sub(a[2], b[2]))


def fp6_neg(a):
    return (fp2_neg(a[0]), fp2_neg(a[1]), fp2_neg(a[2]))


def fp6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fp2_mul(a0, b0)
    t1 = fp2_mul(a1, b1)
    t2 = fp2_mul(a2, b2)
    # c0 = t0 + xi*((a1+a2)(b1+b2) - t1 - t2)
    c0 = fp2_add(
        t0,
        fp2_mul_xi(
            fp2_sub(fp2_sub(fp2_mul(fp2_add(a1, a2), fp2_add(b1, b2)), t1), t2)
        ),
    )
    # c1 = (a0+a1)(b0+b1) - t0 - t1 + xi*t2
    c1 = fp2_add(
        fp2_sub(fp2_sub(fp2_mul(fp2_add(a0, a1), fp2_add(b0, b1)), t0), t1),
        fp2_mul_xi(t2),
    )
    # c2 = (a0+a2)(b0+b2) - t0 - t2 + t1
    c2 = fp2_add(
        fp2_sub(fp2_sub(fp2_mul(fp2_add(a0, a2), fp2_add(b0, b2)), t0), t2), t1
    )
    return (c0, c1, c2)


def fp6_sqr(a):
    return fp6_mul(a, a)


def fp6_mul_by_v(a):
    """Multiply by v: (a0 + a1 v + a2 v^2) * v = xi*a2 + a0 v + a1 v^2."""
    return (fp2_mul_xi(a[2]), a[0], a[1])


def fp6_mul_fp2(a, k):
    return (fp2_mul(a[0], k), fp2_mul(a[1], k), fp2_mul(a[2], k))


def fp6_inv(a):
    a0, a1, a2 = a
    # Standard cubic-extension inversion.
    c0 = fp2_sub(fp2_sqr(a0), fp2_mul_xi(fp2_mul(a1, a2)))
    c1 = fp2_sub(fp2_mul_xi(fp2_sqr(a2)), fp2_mul(a0, a1))
    c2 = fp2_sub(fp2_sqr(a1), fp2_mul(a0, a2))
    t = fp2_add(
        fp2_mul_xi(fp2_add(fp2_mul(a2, c1), fp2_mul(a1, c2))), fp2_mul(a0, c0)
    )
    tinv = fp2_inv(t)
    return (fp2_mul(c0, tinv), fp2_mul(c1, tinv), fp2_mul(c2, tinv))


def fp6_eq(a, b) -> bool:
    return all(fp2_eq(a[i], b[i]) for i in range(3))


def fp6_is_zero(a) -> bool:
    return all(fp2_is_zero(a[i]) for i in range(3))


# ---------------------------------------------------------------------------
# Fp12 = Fp6[w]/(w^2 - v)
# ---------------------------------------------------------------------------

FP12_ZERO = (FP6_ZERO, FP6_ZERO)
FP12_ONE = (FP6_ONE, FP6_ZERO)


def fp12_add(a, b):
    return (fp6_add(a[0], b[0]), fp6_add(a[1], b[1]))


def fp12_sub(a, b):
    return (fp6_sub(a[0], b[0]), fp6_sub(a[1], b[1]))


def fp12_neg(a):
    return (fp6_neg(a[0]), fp6_neg(a[1]))


def fp12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fp6_mul(a0, b0)
    t1 = fp6_mul(a1, b1)
    # c0 = t0 + v*t1 ; c1 = (a0+a1)(b0+b1) - t0 - t1
    c0 = fp6_add(t0, fp6_mul_by_v(t1))
    c1 = fp6_sub(fp6_sub(fp6_mul(fp6_add(a0, a1), fp6_add(b0, b1)), t0), t1)
    return (c0, c1)


def fp12_sqr(a):
    return fp12_mul(a, a)


def fp12_conj(a):
    """x -> x^(p^6): the quadratic-twist conjugation (negate the w part)."""
    return (a[0], fp6_neg(a[1]))


def fp12_inv(a):
    a0, a1 = a
    t = fp6_sub(fp6_sqr(a0), fp6_mul_by_v(fp6_sqr(a1)))
    tinv = fp6_inv(t)
    return (fp6_mul(a0, tinv), fp6_neg(fp6_mul(a1, tinv)))


def fp12_eq(a, b) -> bool:
    return fp6_eq(a[0], b[0]) and fp6_eq(a[1], b[1])


def fp12_pow(a, e: int):
    if e < 0:
        return fp12_pow(fp12_inv(a), -e)
    result = FP12_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fp12_mul(result, base)
        base = fp12_sqr(base)
        e >>= 1
    return result


# ---------------------------------------------------------------------------
# Frobenius endomorphism on Fp12 (x -> x^p), via precomputed constants.
#
# In the tower, Frobenius acts on an Fp2 coefficient c of v^i * w^j as
# conj(c) * gamma, with gamma = xi^((i*2 + j)*(p-1)/6) collected below.
# ---------------------------------------------------------------------------

# gamma_k = xi^(k*(p-1)/6) for k = 0..5; v^i w^j contributes k = 2i + j.
_GAMMA = [fp2_pow(XI, k * (P - 1) // 6) for k in range(6)]


def _frob_fp6(a, is_w_part: bool):
    """Frobenius of the Fp6 element `a` sitting on w^j, j = 1 if is_w_part."""
    j = 1 if is_w_part else 0
    out = []
    for i in range(3):
        k = 2 * i + j
        out.append(fp2_mul(fp2_conj(a[i]), _GAMMA[k]))
    return tuple(out)


def fp12_frobenius(a, power: int = 1):
    """x -> x^(p^power).  Applies single-power Frobenius `power` times."""
    result = a
    for _ in range(power % 12):
        result = (_frob_fp6(result[0], False), _frob_fp6(result[1], True))
    return result


# Sanity: Frobenius really is x -> x^p (checked once at import on a cheap case).
def _selfcheck_frobenius() -> None:
    a = ((( 3, 5), (7, 11), (13, 17)), ((19, 23), (29, 31), (37, 41)))
    lhs = fp12_frobenius(a)
    rhs = fp12_pow(a, P)
    assert fp12_eq(lhs, rhs), "Frobenius constants are wrong"


_selfcheck_frobenius()
