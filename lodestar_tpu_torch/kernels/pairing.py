"""Optimal ate pairing: the plain torch engine and its CUDA twin.

Counterpart of `lodestar_tpu/kernels/pairing.py`; the CUDA device
functions are in `csrc/pairing.cuh`.  The formulas are the JAX
package's: P (G1) stays Jacobian and enters through the planes
(Y, X*Z, Z^3) of `_p_planes`, the accumulator T on the twist is
Jacobian, Q stays affine, and the loop value is conjugated at the end
(x < 0).  With the same line scalings the Miller value itself (not only
its final exponentiation) equals `lodestar_tpu.kernels.pairing.
miller_loop`'s as canonical Fp12 integers.

The final exponentiation keeps the JAX package's cube:
f^(3 (p^12 - 1) / r), through the (x-1)^2 (x+p) (x^2+p^2-1) + 3 chain.
The RLC batch adds the lane product `product12_lanes` and the one
inversion of the path, `to_affine_g2`.
"""

from __future__ import annotations

import torch

from ..crypto import fields as GT
from . import core as C
from . import curve as CV
from . import fp2 as F2
from . import tower as TW

_X_ABS = -GT.X_PARAM
_ATE_BITS = bin(_X_ABS)[3:]  # MSB-first; the leading 1 is T = Q


def _mul12_sparse(f, line):
    """f * (a0 + b1 vw + b2 v^2 w).  The plain engine multiplies by the
    line as a dense Fp12 (the product is exact, so the integers equal the
    CUDA twin's 15-product sparse formula)."""
    a0, b1, b2 = line
    z = torch.zeros_like(a0)
    dense = torch.stack([torch.stack([a0, z, z], -4), torch.stack([z, b1, b2], -4)], -5)
    return TW.mul12(f, dense)


def _p_planes(p_jac):
    """Per-pairing constants (Y1, X1*Z1, Z1^3) replacing (yP, xP, 1)."""
    X1, Y1, Z1 = p_jac
    return (Y1, C.mont_mul(X1, Z1), C.mont_mul(C.mont_sqr(Z1), Z1))


def _line(e0, e1, e2, pw):
    w_y, w_x, w_1 = pw
    return (F2.mul2_fp(e0, w_y), F2.mul2_fp(e1, w_1), F2.mul2_fp(e2, w_x))


def _dbl_step(T, pw):
    """Tangent line at T evaluated at P, and 2T."""
    X, Y, Z = T
    A = F2.sqr2(X)
    B = F2.sqr2(Y)
    CC = F2.sqr2(B)
    D = F2.double2(F2.sub2(F2.sub2(F2.sqr2(F2.add2(X, B)), A), CC))
    E = F2.mul2_small(A, 3)
    F = F2.sqr2(E)
    X3 = F2.sub2(F, F2.double2(D))
    Y3 = F2.sub2(F2.mul2(E, F2.sub2(D, X3)), F2.mul2_small(CC, 8))
    Z3 = F2.double2(F2.mul2(Y, Z))

    Z2 = F2.sqr2(Z)
    Z3p = F2.mul2(Z2, Z)
    X3p = F2.mul2(A, X)
    e0 = F2.mul2_xi(F2.double2(F2.mul2(Y, Z3p)))  # 2 xi Y Z^3
    e1 = F2.sub2(F2.mul2_small(X3p, 3), F2.double2(B))  # 3X^3 - 2Y^2
    e2 = F2.neg2(F2.mul2_small(F2.mul2(A, Z2), 3))  # -3 X^2 Z^2
    return _line(e0, e1, e2, pw), (X3, Y3, Z3)


def _add_step(T, q_aff, pw):
    """Chord line through T and Q evaluated at P, and T + Q."""
    X1, Y1, Z1 = T
    x2, y2 = q_aff
    Z1Z1 = F2.sqr2(Z1)
    Z1c = F2.mul2(Z1, Z1Z1)
    U2 = F2.mul2(x2, Z1Z1)
    S2 = F2.mul2(y2, Z1c)
    H = F2.sub2(U2, X1)
    J = F2.sub2(S2, Y1)
    HH = F2.sqr2(H)
    I = F2.mul2_small(HH, 4)
    JJ = F2.mul2(H, I)
    rr = F2.double2(J)
    V = F2.mul2(X1, I)
    X3 = F2.sub2(F2.sub2(F2.sqr2(rr), JJ), F2.double2(V))
    Y3 = F2.sub2(F2.mul2(rr, F2.sub2(V, X3)), F2.double2(F2.mul2(Y1, JJ)))
    Z3 = F2.sub2(F2.sub2(F2.sqr2(F2.add2(Z1, H)), Z1Z1), HH)

    e0 = F2.mul2_xi(F2.mul2(H, Z1c))  # xi H Z^3
    e1 = F2.sub2(F2.mul2(J, X1), F2.mul2(H, Y1))  # J X - H Y
    e2 = F2.neg2(F2.mul2(J, Z1Z1))  # -J Z^2
    return _line(e0, e1, e2, pw), (X3, Y3, Z3)


def miller_loop(p_jac, q_aff):
    """f_{|x|,Q}(P) conjugated (x < 0), up to subfield factors.

    p_jac: Jacobian G1 point (X, Y, Z) of Fp tensors [ND, N], not O.
    q_aff: affine G2 point (x, y) of Fp2 tensors [2, ND, N], not O.
    Returns Fp12 [2, 3, 2, ND, N]; meaningful through the final
    exponentiation (and equal to the JAX package's value)."""
    pw = _p_planes(p_jac)
    n = q_aff[0].shape[-1]
    T = (q_aff[0], q_aff[1], CV.FP2_OPS.one(n, q_aff[0].device))
    f = TW.one12(n, q_aff[0].device)
    for bit in _ATE_BITS:
        line, T = _dbl_step(T, pw)
        f = _mul12_sparse(TW.sqr12(f), line)
        if bit == "1":
            line, T = _add_step(T, q_aff, pw)
            f = _mul12_sparse(f, line)
    return TW.conj12(f)


def product12_lanes(f, valid, width: int = 128):
    """Product of the valid lanes of f [2, 3, 2, ND, N] -> [..., 1].

    The order of csrc/reduce.cu (`width` slots folding lanes j, j + width,
    ..., then a tree); Fp12 values are canonical, so every order gives
    these integers and the JAX package's `product12_lanes` too."""
    n = f.shape[-1]
    f = TW.select(valid, f, TW.one12(n, f.device))
    tiles = max(1, -(-n // width))
    f = torch.cat([f, TW.one12(tiles * width - n, f.device)], -1)
    acc = f[..., :width]
    for t in range(1, tiles):
        acc = TW.mul12(acc, f[..., t * width : (t + 1) * width])
    s = width // 2
    while s >= 1:
        acc = torch.cat([TW.mul12(acc[..., :s], acc[..., s : 2 * s]), acc[..., s:]], -1)
        s //= 2
    return acc[..., :1]


def to_affine_g2(pt_jac):
    """Jacobian -> affine on the twist by one Fp2 inversion.  Returns
    ((x, y), inf mask: Z == 0); an infinity lane's (x, y) is garbage for
    the caller to replace (`lodestar_tpu/kernels/pairing.py:235`)."""
    X, Y, Z = pt_jac
    inf = F2.is_zero2(Z)
    zi = TW.inv2(Z)
    zi2 = F2.sqr2(zi)
    return (F2.mul2(X, zi2), F2.mul2(Y, F2.mul2(zi2, zi))), inf


def final_exponentiation(f):
    """f^(3 (p^12 - 1) / r)."""
    # easy part: m = (conj(f) * f^-1)^(p^2) * (conj(f) * f^-1)
    g = TW.mul12(TW.conj12(f), TW.inv12(f))
    m = TW.mul12(TW.frob12(g, 2), g)
    # hard part: (x-1)^2 (x+p) (x^2+p^2-1) + 3
    t0 = TW.cyclo_sqr(m)  # m^2
    t1 = TW.cyclo_pow_x_neg(m)  # m^x
    t1 = TW.mul12(t1, TW.conj12(m))  # m^(x-1)
    t2 = TW.cyclo_pow_x_neg(t1)
    t1 = TW.mul12(TW.conj12(t1), t2)  # m^((x-1)^2)
    t2 = TW.cyclo_pow_x_neg(t1)
    t1 = TW.frob12(t1, 1)
    t1 = TW.mul12(t1, t2)  # m^((x-1)^2 (p+x))
    m3 = TW.mul12(m, t0)  # m^3
    t0 = TW.cyclo_pow_x_neg(t1)
    t2 = TW.cyclo_pow_x_neg(t0)
    t0 = TW.frob12(t1, 2)
    t1 = TW.mul12(TW.conj12(t1), t2)  # ^(x^2 - 1)
    t1 = TW.mul12(t1, t0)  # ^(x^2 + p^2 - 1)
    return TW.mul12(t1, m3)
