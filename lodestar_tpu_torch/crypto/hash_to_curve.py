"""Hash-to-G2 (and G1) for BLS signatures — CPU ground truth.

`hash_to_g2` implements the spec ciphersuite BLS12381G2_XMD:SHA-256_SSWU_RO_
(RFC 9380 section 8.8.2): `expand_message_xmd` (SHA-256) -> `hash_to_field`
(two Fp2 elements) -> simplified-SWU on the 3-isogenous curve -> 3-isogeny
back to E2 -> effective-cofactor clearing.  The isogeny coefficient table
and SSWU parameters are verified at import by polynomial identities (see
`_selfcheck_sswu`); byte-level known-answer vectors from
ethereum/bls12-381-tests additionally gate the suite when fixture files
are present (tests/test_hash_to_curve.py).

The earlier Shallue–van de Woestijne map is kept as `map_to_curve_svdw`
— tests use it as a source of on-curve but out-of-subgroup points.
The reference consumes hashing inside blst's `verify`
(packages/beacon-node/src/chain/bls/multithread/worker.ts:30-106).
"""

from __future__ import annotations

import hashlib
from typing import List, Tuple

from . import fields as F
from .curves import (
    FP2_OPS,
    FP_OPS,
    Affine,
    FieldOps,
    affine_add,
    g1_clear_cofactor,
    is_on_curve,
)

# The standard Ethereum beacon-chain ciphersuite DST.
DST_G2 = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"

_HASH = hashlib.sha256
_B_IN_BYTES = 32  # sha256 output
_R_IN_BYTES = 64  # sha256 block size
_L = 64  # ceil((381 + 128) / 8)


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """RFC 9380 section 5.3.1, H = SHA-256."""
    if len(dst) > 255:
        dst = _HASH(b"H2C-OVERSIZE-DST-" + dst).digest()
    ell = (len_in_bytes + _B_IN_BYTES - 1) // _B_IN_BYTES
    if ell > 255:
        raise ValueError("len_in_bytes too large")
    dst_prime = dst + len(dst).to_bytes(1, "big")
    z_pad = b"\x00" * _R_IN_BYTES
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    b0 = _HASH(z_pad + msg + l_i_b_str + b"\x00" + dst_prime).digest()
    b1 = _HASH(b0 + b"\x01" + dst_prime).digest()
    blocks = [b1]
    for i in range(2, ell + 1):
        prev = blocks[-1]
        xored = bytes(x ^ y for x, y in zip(b0, prev))
        blocks.append(_HASH(xored + i.to_bytes(1, "big") + dst_prime).digest())
    return b"".join(blocks)[:len_in_bytes]


def hash_to_field_fp2(msg: bytes, count: int, dst: bytes) -> List[Tuple[int, int]]:
    """RFC 9380 hash_to_field with m=2 (Fp2), L=64."""
    len_in_bytes = count * 2 * _L
    uniform = expand_message_xmd(msg, dst, len_in_bytes)
    out = []
    for i in range(count):
        coords = []
        for j in range(2):
            offset = _L * (j + i * 2)
            tv = uniform[offset : offset + _L]
            coords.append(int.from_bytes(tv, "big") % F.P)
        out.append((coords[0], coords[1]))
    return out


def hash_to_field_fp(msg: bytes, count: int, dst: bytes) -> List[int]:
    len_in_bytes = count * _L
    uniform = expand_message_xmd(msg, dst, len_in_bytes)
    return [
        int.from_bytes(uniform[_L * i : _L * (i + 1)], "big") % F.P
        for i in range(count)
    ]


# ---------------------------------------------------------------------------
# Shallue–van de Woestijne map for y^2 = x^3 + b  (j = 0)
# ---------------------------------------------------------------------------


def _g(fo: FieldOps, x):
    return fo.add(fo.mul(fo.sqr(x), x), fo.b_coeff)


def _sqrt(fo: FieldOps, a):
    if fo is FP_OPS:
        return F.fp_sqrt(a)
    return F.fp2_sqrt(a)


def _sgn(fo: FieldOps, a) -> int:
    if fo is FP_OPS:
        return F.fp_sgn(a)
    return F.fp2_sgn(a)


def _embed(fo: FieldOps, k: int):
    if fo is FP_OPS:
        return k % F.P
    return (k % F.P, 0)


def _sqrt_m3(fo: FieldOps):
    s = _sqrt(fo, _embed(fo, -3))
    assert s is not None, "-3 must be a QR (p = 1 mod 3)"
    return s


_SQRT_M3 = {id(FP_OPS): _sqrt_m3(FP_OPS), id(FP2_OPS): _sqrt_m3(FP2_OPS)}


def map_to_curve_svdw(fo: FieldOps, t) -> Affine:
    """Deterministic map K -> E(K) for E: y^2 = x^3 + b (char K != 2,3).

    Fouque–Tibouchi parameterisation of the Shallue–van de Woestijne
    construction; one of the three candidate x's is always on the curve.
    """
    s3 = _SQRT_M3[id(fo)]
    one = fo.one
    # degenerate inputs map to the curve point derived from t = 1
    if fo.is_zero(t):
        t = one
    denom = fo.add(fo.add(one, fo.b_coeff), fo.sqr(t))
    if fo.is_zero(denom):
        t = fo.add(t, one)
        denom = fo.add(fo.add(one, fo.b_coeff), fo.sqr(t))
    w = fo.mul(fo.mul(s3, t), fo.inv(denom))
    # x1 = (-1 + s3)/2 - t*w
    half = fo.inv(_embed(fo, 2))
    x1 = fo.sub(fo.mul(fo.sub(s3, one), half), fo.mul(t, w))
    # x2 = -1 - x1
    x2 = fo.sub(fo.neg(one), x1)
    # x3 = 1 + 1/w^2
    x3 = fo.add(one, fo.inv(fo.sqr(w)))
    sign = _sgn(fo, t)
    for x in (x1, x2, x3):
        y = _sqrt(fo, _g(fo, x))
        if y is not None:
            if _sgn(fo, y) != sign:
                y = fo.neg(y)
            return (x, y)
    raise AssertionError("SvdW: no candidate x was on the curve")


# ---------------------------------------------------------------------------
# RFC 9380 section 8.8.2: BLS12381G2_XMD:SHA-256_SSWU_RO_
#
# Simplified SWU on the 3-isogenous curve E2': y^2 = x^3 + A'x + B', then
# the 3-isogeny back to E2, then effective-cofactor clearing.  The isogeny
# coefficient table (appendix E.3) is verified at import time by a
# polynomial identity over random E2' points — any wrong constant makes
# mapped points miss E2, so the check is decisive.
# ---------------------------------------------------------------------------

_A2 = (0, 240)            # A' = 240 * I
_B2 = (1012, 1012)        # B' = 1012 * (1 + I)
_Z2 = F.fp2_neg((2, 1))   # Z  = -(2 + I)

# Effective cofactor for G2 (RFC 9380 section 8.8.2).
H_EFF_G2 = 0xBC69F08F2EE75B3584C6A0EA91B352888E2A8E9145AD7689986FF031508FFE1329C2F178731DB956D82BF015D1212B02EC0EC69D7477C1AE954CBC06689F6A359894C0ADEBBF6B4E8020005AAA95551

# 3-isogeny map coefficients (RFC 9380 appendix E.3), verified below.
_ISO3_XNUM = (
    (0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6,
     0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97D6),
    (0,
     0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71A),
    (0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71E,
     0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38D),
    (0x171D6541FA38CCFAED6DEA691F5FB614CB14B4E7F4E810AA22D6108F142B85757098E38D0F671C7188E2AAAAAAAA5ED1,
     0),
)
_ISO3_XDEN = (
    (0,
     0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA63),
    (0xC,
     0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA9F),
    (1, 0),
)
_ISO3_YNUM = (
    (0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706,
     0x1530477C7AB4113B59A4C18B076D11930F7DA5D4A07F649BF54439D87D27E500FC8C25EBF8C92F6812CFC71C71C6D706),
    (0,
     0x5C759507E8E333EBB5B7A9A47D7ED8532C52D39FD3A042A88B58423C50AE15D5C2638E343D9C71C6238AAAAAAAA97BE),
    (0x11560BF17BAA99BC32126FCED787C88F984F87ADF7AE0C7F9A208C6B4F20A4181472AAA9CB8D555526A9FFFFFFFFC71C,
     0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38F),
    (0x124C9AD43B6CF79BFBF7043DE3811AD0761B0F37A1E26286B0E977C69AA274524E79097A56DC4BD9E1B371C71C718B10,
     0),
)
_ISO3_YDEN = (
    (0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB,
     0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA8FB),
    (0,
     0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFA9D3),
    (0x12,
     0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAA99),
    (1, 0),
)


def _sgn0_fp2(x) -> int:
    """RFC 9380 section 4.1 sgn0 for m = 2."""
    x0, x1 = x
    sign_0 = x0 % 2
    zero_0 = x0 == 0
    return sign_0 | (zero_0 and (x1 % 2))


def _poly_eval(coeffs, x):
    acc = F.FP2_ZERO
    for c in reversed(coeffs):
        acc = F.fp2_add(F.fp2_mul(acc, x), c)
    return acc


def map_to_curve_sswu_g2(u) -> Affine:
    """Simplified SWU for E2' (RFC 9380 section 6.6.2, straight-line)."""
    A, B, Z = _A2, _B2, _Z2
    zu2 = F.fp2_mul(Z, F.fp2_sqr(u))
    tv1 = F.fp2_add(F.fp2_sqr(zu2), zu2)  # Z^2 u^4 + Z u^2
    if F.fp2_is_zero(tv1):
        # exceptional case: x1 = B / (Z A)
        x1 = F.fp2_mul(B, F.fp2_inv(F.fp2_mul(Z, A)))
    else:
        # x1 = (-B/A) * (1 + 1/tv1)
        x1 = F.fp2_mul(
            F.fp2_mul(F.fp2_neg(B), F.fp2_inv(A)),
            F.fp2_add((1, 0), F.fp2_inv(tv1)),
        )
    gx1 = F.fp2_add(F.fp2_mul(F.fp2_add(F.fp2_sqr(x1), A), x1), B)
    y1 = F.fp2_sqrt(gx1)
    if y1 is not None:
        x, y = x1, y1
    else:
        x2 = F.fp2_mul(zu2, x1)
        gx2 = F.fp2_add(F.fp2_mul(F.fp2_add(F.fp2_sqr(x2), A), x2), B)
        y2 = F.fp2_sqrt(gx2)
        assert y2 is not None, "SSWU: neither gx1 nor gx2 is square"
        x, y = x2, y2
    if _sgn0_fp2(u) != _sgn0_fp2(y):
        y = F.fp2_neg(y)
    return (x, y)


def iso3_map(pt: Affine) -> Affine:
    """The 3-isogeny E2' -> E2 (appendix E.3)."""
    if pt is None:
        return None
    x, y = pt
    xden = _poly_eval(_ISO3_XDEN, x)
    yden = _poly_eval(_ISO3_YDEN, x)
    if F.fp2_is_zero(xden) or F.fp2_is_zero(yden):
        return None  # kernel points map to the identity
    xn = F.fp2_mul(_poly_eval(_ISO3_XNUM, x), F.fp2_inv(xden))
    yn = F.fp2_mul(
        F.fp2_mul(y, _poly_eval(_ISO3_YNUM, x)), F.fp2_inv(yden)
    )
    return (xn, yn)


def clear_cofactor_g2(q: Affine) -> Affine:
    """h_eff scalar multiplication (RFC 9380 section 8.8.2)."""
    from .curves import scalar_mul

    return scalar_mul(FP2_OPS, q, H_EFF_G2)


def hash_to_g2(msg: bytes, dst: bytes = DST_G2) -> Affine:
    """BLS12381G2_XMD:SHA-256_SSWU_RO_ (RFC 9380) into the G2 subgroup."""
    u0, u1 = hash_to_field_fp2(msg, 2, dst)
    q0 = iso3_map(map_to_curve_sswu_g2(u0))
    q1 = iso3_map(map_to_curve_sswu_g2(u1))
    q = affine_add(FP2_OPS, q0, q1)
    p = clear_cofactor_g2(q)
    assert p is not None and is_on_curve(FP2_OPS, p)
    return p


# ---------------------------------------------------------------------------
# Import-time verification of the SSWU/isogeny constants: mapped points
# must satisfy both curve equations — a polynomial identity that any
# wrong coefficient breaks.
# ---------------------------------------------------------------------------


def _selfcheck_sswu() -> None:
    # One iteration suffices: the on-curve identities are polynomial in the
    # constants, so any wrong coefficient fails with probability ~1 on a
    # single pseudorandom point (more iterations live in the test suite).
    from .curves import g2_subgroup_check

    for i in range(1):
        (u,) = hash_to_field_fp2(b"sswu-selfcheck-%d" % i, 1, b"SELFTEST")
        xp, yp = map_to_curve_sswu_g2(u)
        # on E2': y^2 = x^3 + A'x + B'
        lhs = F.fp2_sqr(yp)
        rhs = F.fp2_add(
            F.fp2_mul(F.fp2_add(F.fp2_sqr(xp), _A2), xp), _B2
        )
        assert F.fp2_eq(lhs, rhs), "SSWU output not on E2'"
        pt = iso3_map((xp, yp))
        assert pt is not None and is_on_curve(FP2_OPS, pt), (
            "isogeny constants are wrong (mapped point off E2)"
        )
        cleared = clear_cofactor_g2(pt)
        assert cleared is not None and g2_subgroup_check(cleared), (
            "h_eff does not clear the G2 cofactor"
        )


_selfcheck_sswu()


def hash_to_g1(msg: bytes, dst: bytes) -> Affine:
    u0, u1 = hash_to_field_fp(msg, 2, dst)
    q0 = map_to_curve_svdw(FP_OPS, u0)
    q1 = map_to_curve_svdw(FP_OPS, u1)
    q = affine_add(FP_OPS, q0, q1)
    p = g1_clear_cofactor(q)
    assert p is not None and is_on_curve(FP_OPS, p)
    return p
