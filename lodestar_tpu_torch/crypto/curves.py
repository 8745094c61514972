"""BLS12-381 curve groups G1 (over Fp) and G2 (over Fp2) — CPU ground truth.

G1:  E  /Fp : y^2 = x^3 + 4
G2:  E' /Fp2: y^2 = x^3 + 4*(u+1)     (sextic twist of E)

Points are affine tuples (x, y) with `None` as the point at infinity; the
internal fast paths use jacobian (X, Y, Z) with the usual x = X/Z^2,
y = Y/Z^3 convention.  Generic over the field via a tiny field-ops record so
G1/G2 share one implementation (the JAX ops mirror this structure in
`lodestar_tpu.ops.curve`).

Serialization follows the ZCash/ETH2 compressed format (48B G1 / 96B G2,
flag bits in the top 3 bits of the first byte) as consumed by the
reference's pubkey/signature byte surfaces (reference:
packages/state-transition/src/cache/pubkeyCache.ts:29-47 stores
deserialized pubkeys; packages/beacon-node/src/chain/bls/multithread/index.ts:177
ships {pubkey, signingRoot, signature} bytes per set).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

from . import fields as F

# ---------------------------------------------------------------------------
# Field-ops records (duck-typed namespaces for generic EC formulas)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FieldOps:
    add: Callable
    sub: Callable
    mul: Callable
    sqr: Callable
    neg: Callable
    inv: Callable
    eq: Callable
    is_zero: Callable
    zero: Any
    one: Any
    mul_small: Callable  # multiply by a small Python int
    b_coeff: Any  # curve b coefficient in this field


def _fp_sqr(a):
    return a * a % F.P


def _fp_is_zero(a):
    return a % F.P == 0


def _fp_eq(a, b):
    return a % F.P == b % F.P


def _fp_mul_small(a, k):
    return a * k % F.P


def _fp2_mul_small(a, k):
    return (a[0] * k % F.P, a[1] * k % F.P)


FP_OPS = FieldOps(
    add=F.fp_add, sub=F.fp_sub, mul=F.fp_mul, sqr=_fp_sqr, neg=F.fp_neg,
    inv=F.fp_inv, eq=_fp_eq, is_zero=_fp_is_zero, zero=0, one=1,
    mul_small=_fp_mul_small, b_coeff=4,
)

FP2_OPS = FieldOps(
    add=F.fp2_add, sub=F.fp2_sub, mul=F.fp2_mul, sqr=F.fp2_sqr,
    neg=F.fp2_neg, inv=F.fp2_inv, eq=F.fp2_eq, is_zero=F.fp2_is_zero,
    zero=F.FP2_ZERO, one=F.FP2_ONE, mul_small=_fp2_mul_small,
    b_coeff=F.fp2_mul_fp(F.XI, 4),  # 4*(u+1)
)

# ---------------------------------------------------------------------------
# Generic affine/jacobian arithmetic
# ---------------------------------------------------------------------------

Affine = Optional[Tuple[Any, Any]]  # None = infinity


def is_on_curve(fo: FieldOps, pt: Affine) -> bool:
    if pt is None:
        return True
    x, y = pt
    return fo.eq(fo.sqr(y), fo.add(fo.mul(fo.sqr(x), x), fo.b_coeff))


def affine_neg(fo: FieldOps, pt: Affine) -> Affine:
    if pt is None:
        return None
    return (pt[0], fo.neg(pt[1]))


def affine_eq(fo: FieldOps, a: Affine, b: Affine) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return fo.eq(a[0], b[0]) and fo.eq(a[1], b[1])


def _jac_dbl(fo: FieldOps, pt):
    X, Y, Z = pt
    if fo.is_zero(Z) or fo.is_zero(Y):
        return (fo.one, fo.one, fo.zero)
    A = fo.sqr(X)
    B = fo.sqr(Y)
    C = fo.sqr(B)
    # D = 2*((X+B)^2 - A - C)
    D = fo.mul_small(fo.sub(fo.sub(fo.sqr(fo.add(X, B)), A), C), 2)
    E = fo.mul_small(A, 3)
    Fv = fo.sqr(E)
    X3 = fo.sub(Fv, fo.mul_small(D, 2))
    Y3 = fo.sub(fo.mul(E, fo.sub(D, X3)), fo.mul_small(C, 8))
    Z3 = fo.mul_small(fo.mul(Y, Z), 2)
    return (X3, Y3, Z3)


def _jac_add(fo: FieldOps, a, b):
    X1, Y1, Z1 = a
    X2, Y2, Z2 = b
    if fo.is_zero(Z1):
        return b
    if fo.is_zero(Z2):
        return a
    Z1Z1 = fo.sqr(Z1)
    Z2Z2 = fo.sqr(Z2)
    U1 = fo.mul(X1, Z2Z2)
    U2 = fo.mul(X2, Z1Z1)
    S1 = fo.mul(fo.mul(Y1, Z2), Z2Z2)
    S2 = fo.mul(fo.mul(Y2, Z1), Z1Z1)
    if fo.eq(U1, U2):
        if fo.eq(S1, S2):
            return _jac_dbl(fo, a)
        return (fo.one, fo.one, fo.zero)  # P + (-P) = O
    H = fo.sub(U2, U1)
    I = fo.sqr(fo.mul_small(H, 2))
    J = fo.mul(H, I)
    Rv = fo.mul_small(fo.sub(S2, S1), 2)
    V = fo.mul(U1, I)
    X3 = fo.sub(fo.sub(fo.sqr(Rv), J), fo.mul_small(V, 2))
    Y3 = fo.sub(fo.mul(Rv, fo.sub(V, X3)), fo.mul_small(fo.mul(S1, J), 2))
    Z3 = fo.mul_small(fo.mul(fo.mul(Z1, Z2), H), 2)
    return (X3, Y3, Z3)


def _to_jac(fo: FieldOps, pt: Affine):
    if pt is None:
        return (fo.one, fo.one, fo.zero)
    return (pt[0], pt[1], fo.one)


def _to_affine(fo: FieldOps, pt) -> Affine:
    X, Y, Z = pt
    if fo.is_zero(Z):
        return None
    zinv = fo.inv(Z)
    zinv2 = fo.sqr(zinv)
    return (fo.mul(X, zinv2), fo.mul(Y, fo.mul(zinv2, zinv)))


def affine_add(fo: FieldOps, a: Affine, b: Affine) -> Affine:
    return _to_affine(fo, _jac_add(fo, _to_jac(fo, a), _to_jac(fo, b)))


def affine_dbl(fo: FieldOps, a: Affine) -> Affine:
    return _to_affine(fo, _jac_dbl(fo, _to_jac(fo, a)))


def scalar_mul(fo: FieldOps, pt: Affine, k: int) -> Affine:
    """k * pt via jacobian double-and-add (left-to-right)."""
    if k < 0:
        return scalar_mul(fo, affine_neg(fo, pt), -k)
    if k == 0 or pt is None:
        return None
    acc = (fo.one, fo.one, fo.zero)
    base = _to_jac(fo, pt)
    for bit in bin(k)[2:]:
        acc = _jac_dbl(fo, acc)
        if bit == "1":
            acc = _jac_add(fo, acc, base)
    return _to_affine(fo, acc)


def multi_add(fo: FieldOps, pts) -> Affine:
    """Sum of a list of affine points (jacobian accumulation)."""
    acc = (fo.one, fo.one, fo.zero)
    for pt in pts:
        if pt is not None:
            acc = _jac_add(fo, acc, _to_jac(fo, pt))
    return _to_affine(fo, acc)


# ---------------------------------------------------------------------------
# Generators (standard BLS12-381 constants)
# ---------------------------------------------------------------------------

G1_GEN: Affine = (
    0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
)

G2_GEN: Affine = (
    (
        0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
    ),
    (
        0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
    ),
)

assert is_on_curve(FP_OPS, G1_GEN), "G1 generator not on curve"
assert is_on_curve(FP2_OPS, G2_GEN), "G2 generator not on curve"

# ---------------------------------------------------------------------------
# Twist order / G2 cofactor, derived (not hard-coded) from the parameters.
#
# t = x + 1 (trace of E/Fp); #E(Fp2) = p^2 + 1 - t2 with t2 = t^2 - 2p.
# The right sextic twist order among the candidates (p^2 + 1 - t') for
# t' in {(±3v ± t)/2, ±t2, ...} is the one divisible by r that kills the
# known generator; we find it by search once at import.
# ---------------------------------------------------------------------------


def _derive_g2_cofactor() -> int:
    t = F.X_PARAM + 1
    p = F.P
    t2 = t * t - 2 * p  # trace of Frobenius on E(Fp2)
    # t^2 - 4p = -3 v^2  over Fp; then t2^2 - 4p^2 = -3 (t*v)^2.
    vsq = (4 * p - t * t) // 3
    v = _isqrt(vsq)
    assert v * v == vsq, "v derivation failed"
    v2 = t * v
    candidates = []
    for tp in (
        t2,
        -t2,
        (t2 + 3 * v2) // 2,
        (t2 - 3 * v2) // 2,
        (-t2 + 3 * v2) // 2,
        (-t2 - 3 * v2) // 2,
    ):
        n = p * p + 1 - tp
        if n % F.R == 0:
            candidates.append(n)
    # G2_GEN has order r and r divides several candidates, so the
    # annihilation test must use a generic point of E'(Fp2): take the first
    # x = (k, 1) that lands on the curve via a y = sqrt(x^3 + b').
    probe = None
    k = 0
    while probe is None:
        k += 1
        x = (k, 1)
        y2 = F.fp2_add(F.fp2_mul(F.fp2_sqr(x), x), FP2_OPS.b_coeff)
        y = F.fp2_sqrt(y2)
        if y is not None:
            probe = (x, y)
    for n in candidates:
        if scalar_mul(FP2_OPS, probe, n) is None:
            return n // F.R
    raise AssertionError("could not derive G2 cofactor")


def _isqrt(n: int) -> int:
    import math

    return math.isqrt(n)


H2_COFACTOR = _derive_g2_cofactor()

# r*G = O sanity for both groups
assert scalar_mul(FP_OPS, G1_GEN, F.R) is None
assert scalar_mul(FP2_OPS, G2_GEN, F.R) is None


def g1_subgroup_check(pt: Affine) -> bool:
    return scalar_mul(FP_OPS, pt, F.R) is None


def g2_subgroup_check(pt: Affine) -> bool:
    return scalar_mul(FP2_OPS, pt, F.R) is None


def g2_clear_cofactor(pt: Affine) -> Affine:
    return scalar_mul(FP2_OPS, pt, H2_COFACTOR)


def g1_clear_cofactor(pt: Affine) -> Affine:
    return scalar_mul(FP_OPS, pt, F.H1_COFACTOR)


# ---------------------------------------------------------------------------
# ZCash-format point compression
# ---------------------------------------------------------------------------

_COMP = 0x80
_INF = 0x40
_SIGN = 0x20


def g1_compress(pt: Affine) -> bytes:
    if pt is None:
        return bytes([_COMP | _INF]) + b"\x00" * 47
    x, y = pt
    flags = _COMP | (_SIGN if F.fp_sgn(y) else 0)
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= flags
    return bytes(out)


def g1_decompress(data: bytes) -> Affine:
    if len(data) != 48:
        raise ValueError("G1 compressed point must be 48 bytes")
    flags = data[0]
    if not flags & _COMP:
        raise ValueError("uncompressed G1 not supported")
    if flags & _INF:
        if any(data[1:]) or flags & _SIGN or data[0] & 0x1F:
            raise ValueError("malformed infinity encoding")
        return None
    x = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
    if x >= F.P:
        raise ValueError("x not in field")
    y2 = (x * x % F.P * x + 4) % F.P
    y = F.fp_sqrt(y2)
    if y is None:
        raise ValueError("x not on curve")
    if F.fp_sgn(y) != (1 if flags & _SIGN else 0):
        y = F.fp_neg(y)
    return (x, y)


def g2_compress(pt: Affine) -> bytes:
    if pt is None:
        return bytes([_COMP | _INF]) + b"\x00" * 95
    (x0, x1), y = pt
    flags = _COMP | (_SIGN if F.fp2_sgn(y) else 0)
    out = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    out[0] |= flags
    return bytes(out)


def g2_decompress(data: bytes) -> Affine:
    if len(data) != 96:
        raise ValueError("G2 compressed point must be 96 bytes")
    flags = data[0]
    if not flags & _COMP:
        raise ValueError("uncompressed G2 not supported")
    if flags & _INF:
        if any(data[1:]) or flags & _SIGN or data[0] & 0x1F:
            raise ValueError("malformed infinity encoding")
        return None
    x1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:], "big")
    if x0 >= F.P or x1 >= F.P:
        raise ValueError("x not in field")
    x = (x0, x1)
    y2 = F.fp2_add(F.fp2_mul(F.fp2_sqr(x), x), FP2_OPS.b_coeff)
    y = F.fp2_sqrt(y2)
    if y is None:
        raise ValueError("x not on curve")
    if F.fp2_sgn(y) != (1 if flags & _SIGN else 0):
        y = F.fp2_neg(y)
    return (x, y)
