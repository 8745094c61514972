"""Device ingest: G2 decompression, SSWU hash-to-G2 and G1 KeyValidate,
the plain torch engine and its CUDA twin.

Counterpart of the value-level functions of `lodestar_tpu/kernels/
ingest.py`; the CUDA device functions are in `csrc/ingest.cu` and
`csrc/keyvalidate.cu`, and the kernel wrappers (`g2_decompress`,
`hash_g2`, `g1_keyvalidate`) with their plain versions in
`kernels/verify.py`.  Same steps, constants and selects as the JAX
package, so the points (and, but for the hash, the Jacobian
coordinates) equal the JAX functions' exactly:

  - `g2_decompress_y`: y from x and the wire sign bit (one Fp2 sqrt);
  - `sswu_map_g2`, `iso3_map_jac`, `clear_cofactor_g2_psi`,
    `hash_to_g2_values`: the map of RFC 9380 for G2; expand_message_xmd
    and hash_to_field stay on the host, which ships u as plain limbs and
    its sgn0 bit.  Where the JAX package inverts the iso3 denominators and
    clears the cofactor by the 636-bit H_EFF chain, the port writes the
    isogeny's image in Jacobian form and clears by psi (RFC 9380 appendix
    G.3): the same points, other Jacobian triples, which the CUDA kernel
    equals bit for bit;
  - `g1_keyvalidate`: a compressed pubkey's y (one Fp sqrt) and the
    on-curve and [r]P subgroup checks of blst KeyValidate; the CUDA
    kernel decides membership by sigma(P) = [-z^2] P instead
    (`kernels/kv_program.py`), the same verdict.

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


def iso3_map_jac(pt):
    """The 3-isogeny E2' -> E2 straight into Jacobian form, with no
    inversion: Z = xden yden, X = xnum xden yden^2, Y = y ynum xden^3
    yden^2, so X / Z^2 = xnum / xden and Y / Z^3 = y ynum / yden.  Z is 0
    exactly where a denominator vanishes (the JAX guard's ok flag is
    Z != 0)."""
    x, y = pt
    xn, xd, yn, yd = (_poly2(c, x) for c in (HC._ISO3_XNUM, HC._ISO3_XDEN, HC._ISO3_YNUM, HC._ISO3_YDEN))
    yd2 = F2.sqr2(yd)
    xd3 = F2.mul2(F2.sqr2(xd), xd)
    return F2.mul2(F2.mul2(xn, xd), yd2), F2.mul2(F2.mul2(y, yn), F2.mul2(xd3, yd2)), F2.mul2(xd, yd)


def _add_complete(p, q):
    """P + Q by `jac_add_full`, the point at infinity being Z = 0 in and
    out (a doubling where P == Q, Z = 0 where P == -Q)."""
    f = CV.FP2_OPS
    return CV.jac_add_full(f, p, f.is_zero(p[2]), q, f.is_zero(q[2]))[0]


def _mul_x_abs(p):
    """[|x|] P: 63 doublings and 5 generic additions of P (the static
    chain of the subgroup check, P Jacobian)."""
    f, T = CV.FP2_OPS, p
    for bit in bin(-GT.X_PARAM)[3:]:
        T = CV.jac_dbl(f, T)
        if bit == "1":
            T = CV.jac_add_mixed_or_full(f, T, p)
    return T


def clear_cofactor_g2_psi(p):
    """[h_eff] P for a Jacobian P on E2 by the psi endomorphism, as RFC
    9380 appendix G.3 writes it (c1 = x < 0, so [x] Q = -[|x|] Q):
    t1 = [x] P, t2 = psi(P), t3 = psi^2(2P) - t2, t2 = [x](t1 + t2), then
    ((t3 + t2) - t1) - P, every addition complete.  The same point as the
    636-bit H_EFF chain of the JAX package, in two 64-bit chains."""
    f = CV.FP2_OPS
    t1 = CV.jac_neg(f, _mul_x_abs(p))
    t2 = CV.g2_psi(p)
    t3 = _add_complete(CV.g2_psi(CV.g2_psi(CV.jac_dbl(f, p))), CV.jac_neg(f, t2))
    t2 = CV.jac_neg(f, _mul_x_abs(_add_complete(t1, t2)))
    return _add_complete(_add_complete(_add_complete(t3, t2), CV.jac_neg(f, t1)), CV.jac_neg(f, p))


def hash_to_g2_values(u, u_sgn0):
    """map_to_curve of one message per lane: u [2, ..., 2, ND, N] holds
    (u0, u1) and u_sgn0 [2, ..., N] their sgn0 bits.  Two SSWU points
    through iso3 into Jacobian form, added by the complete addition, the
    cofactor cleared by psi -> (Jacobian G2, ok = both iso3 denominators
    nonzero); csrc/ingest.cu makes the same curve operations in the same
    order."""
    q = iso3_map_jac(sswu_map_g2(u, u_sgn0))
    ok = ~F2.is_zero2(q[2])
    p = _add_complete(tuple(c[0] for c in q), tuple(c[1] for c in q))
    return clear_cofactor_g2_psi(p), ok[0] & ok[1]


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
