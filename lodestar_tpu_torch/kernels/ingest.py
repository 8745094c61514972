"""Device ingest: G2 decompression, SSWU hash-to-G2 and G1 KeyValidate,
the plain torch engine and its CUDA twin.

Counterpart of the value-level functions of `lodestar_tpu/kernels/
ingest.py`; the CUDA device functions are in `csrc/ingest.cu` and
`csrc/keyvalidate.cu`, and the kernel wrappers (`g2_decompress`,
`hash_g2`, `g1_keyvalidate`) with their plain versions in
`kernels/verify.py`.  Same steps, constants and selects as the JAX
package, so the points (and the Jacobian coordinates of the hash) equal
the JAX functions' exactly:

  - `g2_decompress_y`: y from x and the wire sign bit (one Fp2 sqrt);
  - `sswu_map_g2`, `iso3_map`, `clear_cofactor_g2_jac`,
    `hash_to_g2_values`: the map of RFC 9380 for G2; expand_message_xmd
    and hash_to_field stay on the host, which ships u as plain limbs and
    its sgn0 bit;
  - `g1_keyvalidate`: a compressed pubkey's y (one Fp sqrt) and the
    on-curve and [r]P subgroup checks of blst KeyValidate.

Fp2 values are digit tensors [..., 2, ND, N]; the two SSWU maps of a
message run as one batched call on a leading axis.
"""

from __future__ import annotations

import torch

from ..crypto import curves as GC
from ..crypto import fields as GT
from ..crypto import hash_to_curve as HC
from . import canonical as CN
from . import core as C
from . import curve as CV
from . import fp2 as F2
from . import sqrt as SQ
from . import tower as TW

_MINUS_B_OVER_A = GT.fp2_mul(GT.fp2_neg(HC._B2), GT.fp2_inv(HC._A2))
_B_OVER_ZA = GT.fp2_mul(HC._B2, GT.fp2_inv(GT.fp2_mul(HC._Z2, HC._A2)))


def _c2(v, like):
    """An Fp2 constant broadcast to the shape of `like`."""
    return F2.const2(v, like.device).expand_as(like)


def _g2_rhs(x):
    """x^3 + 4(1 + i) on E2."""
    return F2.add2(F2.mul2(F2.sqr2(x), x), _c2(GC.FP2_OPS.b_coeff, x))


def g2_decompress_y(x, sign):
    """(y, on-curve) for compressed (x, sign) on E2; the root whose
    fp2_sgn equals the wire's sign bit (bool [..., N])."""
    y, ok = SQ.fp2_sqrt(_g2_rhs(x))
    flip = CN.fp2_sgn(y) != sign
    return TW.select(flip, F2.neg2(y), y), ok


def sswu_map_g2(u, u_sgn0):
    """Simplified SWU on E2' for Fp2 values u, branch-free; u_sgn0 is the
    host's RFC 9380 sgn0(u) (bool [..., N]).  Returns affine (x, y)."""
    A = _c2(HC._A2, u)
    B = _c2(HC._B2, u)
    zu2 = F2.mul2(F2.sqr2(u), _c2(HC._Z2, u))
    tv1 = F2.add2(F2.sqr2(zu2), zu2)
    one = _c2(GT.FP2_ONE, u)
    x1 = F2.mul2(F2.add2(one, TW.inv2(tv1)), _c2(_MINUS_B_OVER_A, u))  # inv2(0) = 0
    x1 = TW.select(F2.is_zero2(tv1), _c2(_B_OVER_ZA, u), x1)

    def g_iso(x):
        return F2.add2(F2.mul2(F2.add2(F2.sqr2(x), A), x), B)

    x2 = F2.mul2(zu2, x1)
    # both candidates' roots in one batched square root
    y12, ok12 = SQ.fp2_sqrt(torch.stack([g_iso(x1), g_iso(x2)]))
    ok1 = ok12[0]
    x = TW.select(ok1, x1, x2)
    y = TW.select(ok1, y12[0], y12[1])
    flip = CN.fp2_sgn0(y) != u_sgn0
    return x, TW.select(flip, F2.neg2(y), y)


def _poly2(coeffs, x):
    """Horner with host Fp2 coefficients (constant term first), from 0."""
    acc = torch.zeros_like(x)
    for c in reversed(coeffs):
        acc = F2.add2(F2.mul2(acc, x), _c2(c, x))
    return acc


def iso3_map(pt):
    """The 3-isogeny E2' -> E2: ((x, y), ok), ok False where a denominator
    vanishes (the JAX guard)."""
    x, y = pt
    xden = _poly2(HC._ISO3_XDEN, x)
    yden = _poly2(HC._ISO3_YDEN, x)
    ok = ~F2.is_zero2(xden) & ~F2.is_zero2(yden)
    xn = F2.mul2(_poly2(HC._ISO3_XNUM, x), TW.inv2(xden))
    yn = F2.mul2(F2.mul2(y, _poly2(HC._ISO3_YNUM, x)), TW.inv2(yden))
    return (xn, yn), ok


def clear_cofactor_g2_jac(q_jac):
    """[H_EFF] Q for a Jacobian Q: double, then the generic addition of Q
    where the bit of H_EFF is set (MSB first)."""
    T = q_jac
    for bit in bin(HC.H_EFF_G2)[3:]:
        T = CV.jac_dbl(CV.FP2_OPS, T)
        if bit == "1":
            T = CV.jac_add_mixed_or_full(CV.FP2_OPS, T, q_jac)
    return T


def hash_to_g2_values(u, u_sgn0):
    """map_to_curve of one message per lane: u [2, ..., 2, ND, N] holds
    (u0, u1) and u_sgn0 [2, ..., N] their sgn0 bits.  Two SSWU points
    through iso3, added, cofactor-cleared -> (Jacobian G2, ok = both iso3
    maps ok)."""
    q, ok = iso3_map(sswu_map_g2(u, u_sgn0))
    (x0, x1), (y0, y1) = (c.unbind(0) for c in q)
    one = CV.FP2_OPS.one(x0.shape[-1], x0.device).expand_as(x0)
    s = CV.jac_add_mixed(CV.FP2_OPS, (x0, y0, one), (x1, y1))
    return clear_cofactor_g2_jac(s), ok[0] & ok[1]


def g1_keyvalidate(x, sign):
    """((x, y), ok) for Montgomery x [ND, N] and the sort-flag sign bits
    (bool [N]): y = sqrt(x^3 + 4) with fp_sgn(y) == sign, ok = on the
    curve and [r]P = O.  The subgroup check is a full [r]P by MSB-first
    double-and-add with the COMPLETE addition and the infinity flag
    carried through the chain: a key of small order (x = 0 gives (0, +-2),
    of order 3) meets T == +-P mid-chain, which the exact-zero dispatch of
    `jac_add_full` handles; doubling keeps Z = 0 at infinity."""
    rhs = C.add(C.mont_mul(C.mont_sqr(x), x), C.const_digits(GC.FP_OPS.b_coeff, x.device))
    y, on_curve = SQ.fp_sqrt(rhs)
    flip = CN.fp_sgn(y) != sign
    y = C.select(flip, C.neg(y), y)
    base = (x, y, CV.FP_OPS.one(x.shape[-1], x.device))
    no_inf = torch.zeros(x.shape[-1], dtype=torch.bool, device=x.device)

    def dbl(st):
        return CV.jac_dbl(CV.FP_OPS, st[0]), st[1]

    def add(st, _base):
        return CV.jac_add_full(CV.FP_OPS, st[0], st[1], base, no_inf)

    T, t_inf = C.pow_static((base, no_inf), GT.R, dbl, add)
    return (x, y), on_curve & (t_inf | C.is_zero_modp(T[2]))
