"""Fp6 / Fp12 tower: the plain torch engine and its CUDA twin.

Counterpart of `lodestar_tpu/kernels/tower.py`; on the card the tower's
formulas run as warp programs (`kernels/warp_schedule.py Tower`, traced
from the same formulas).  The tower is the one of the host ground truth
(`crypto/fields.py`):

    Fp2  = Fp[u]/(u^2 + 1)
    Fp6  = Fp2[v]/(v^3 - xi),  xi = 1 + u
    Fp12 = Fp6[w]/(w^2 - v)

An Fp6 element is one tensor ``[..., 3, 2, ND, N]`` (coefficients of
1, v, v^2) and an Fp12 element ``[..., 2, 3, 2, ND, N]`` (halves of 1, w),
so that all the Fp2 products of a tower multiply go through ONE batched
`fp2.mul2` call.  Flattening the leading ``2, 3, 2`` axes gives the twelve
Fp planes in the JAX package's leaf order.

Every function returns canonical values.  A squaring here is the
multiply with itself: the products are exact, so any correct formula
gives the same integers as the CUDA twin's dedicated squarings.
"""

from __future__ import annotations

import torch

from ..crypto import fields as GT
from . import core as C
from . import fp2 as F2

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def lane_mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a lane mask [..., N] over the trailing element axes of
    `like` (leading axes of the mask align with leading axes of like)."""
    extra = like.dim() - mask.dim()
    return mask.reshape(*mask.shape[:-1], *([1] * extra), mask.shape[-1])


def select(mask, a, b):
    """Lane select for any element tensor (Fp, Fp2, Fp6, Fp12)."""
    return torch.where(lane_mask(mask, a), a, b)


def _xi_raw(x):
    """x * xi without reduction: (x0 - x1, x0 + x1) on axis -3."""
    x0, x1 = x.unbind(-3)
    return torch.stack([x0 - x1, x0 + x1], -3)


# ---------------------------------------------------------------------------
# Fp6
# ---------------------------------------------------------------------------


def mul6_by_v(a):
    """(c0, c1, c2) * v = (xi c2, c0, c1)."""
    a0, a1, a2 = a.unbind(-4)
    return torch.stack([F2.mul2_xi(a2), a0, a1], -4)


def mul6(a, b):
    """Karatsuba Fp6 product: six Fp2 products in one batched call.

    Operands may be sums of two canonical values (components below 2p)."""
    a0, a1, a2 = a.unbind(-4)
    b0, b1, b2 = b.unbind(-4)
    sa = torch.stack(torch.broadcast_tensors(a0, a1, a2, a1 + a2, a0 + a1, a0 + a2), -4)
    sb = torch.stack(torch.broadcast_tensors(b0, b1, b2, b1 + b2, b0 + b1, b0 + b2), -4)
    t0, t1, t2, m12, m01, m02 = F2.mul2(sa, sb).unbind(-4)
    c0 = t0 + _xi_raw(m12 - t1 - t2)  # components in (-4p, 4p)
    c1 = m01 - t0 - t1 + _xi_raw(t2)  # (-3p, 3p)
    c2 = m02 - t0 - t2 + t1  # (-2p, 2p)
    return C.canonical(torch.stack([c0, c1, c2], -4), -4, 3)


def sqr6(a):
    return mul6(a, a)


# ---------------------------------------------------------------------------
# Fp12
# ---------------------------------------------------------------------------


def conj12(a):
    """The p^6 Frobenius; for cyclotomic elements this is the inverse."""
    a0, a1 = a.unbind(-5)
    return torch.stack([a0, C.neg(a1)], -5)


def mul12(a, b):
    """Karatsuba Fp12 product: three Fp6 products in one batched call."""
    a0, a1 = a.unbind(-5)
    b0, b1 = b.unbind(-5)
    sa = torch.stack(torch.broadcast_tensors(a0, a1, C.add(a0, a1)), -5)
    sb = torch.stack(torch.broadcast_tensors(b0, b1, C.add(b0, b1)), -5)
    t0, t1, tm = mul6(sa, sb).unbind(-5)
    u0, u1, u2 = t1.unbind(-4)
    lo = t0 + torch.stack([_xi_raw(u2), u0, u1], -4)  # (-p, 3p)
    hi = tm - t0 - t1  # (-2p, p)
    return C.canonical(torch.stack([lo, hi], -5), -2, 2)


def sqr12(a):
    return mul12(a, a)


def one12(n: int, device, lead=()) -> torch.Tensor:
    """The Fp12 one for n lanes."""
    out = torch.zeros(*lead, 2, 3, 2, C.ND, n, dtype=torch.int64, device=device)
    out[..., 0, 0, 0, :, :] = C._const("one", device)
    return out


def is_one12(a) -> torch.Tensor:
    """Exact equality with one (canonical input) -> bool [..., N]."""
    one = one12(a.shape[-1], a.device)
    return (a == one).flatten(-5, -2).all(-2)


# ---------------------------------------------------------------------------
# Frobenius (x -> x^(p^n), n in {1, 2, 3}) via constants
# ---------------------------------------------------------------------------

# gamma_n[k] = xi^(k (p^n - 1) / 6); slot k = 2i + j for coefficient v^i w^j.
_G_INT = {
    n: [GT.fp2_pow(GT.XI, k * (GT.P**n - 1) // 6) for k in range(6)]
    for n in (1, 2, 3)
}


def _gamma(power: int, device) -> torch.Tensor:
    key = ("gamma", power, str(device))
    t = C._CACHE.get(key)
    if t is None:
        g = _G_INT[power]
        t = torch.stack(
            [
                torch.stack([F2.const2(g[2 * i + j], device) for i in range(3)])
                for j in range(2)
            ]
        )  # [2, 3, 2, ND, 1]
        C._CACHE[key] = t
    return t


def frob12(a, power: int):
    """x -> x^(p^power) for static power in {1, 2, 3}."""
    assert power in (1, 2, 3)
    if power % 2:
        a = F2.conj2(a)
    return F2.mul2(a, _gamma(power, a.device))


# ---------------------------------------------------------------------------
# Cyclotomic subgroup ops (Granger-Scott), valid after the easy part
# ---------------------------------------------------------------------------


def cyclo_sqr(a):
    """Granger-Scott cyclotomic square: nine Fp2 squarings in one call.

    Equals a^2 for elements of the cyclotomic subgroup (a^(p^6+1) = 1)."""
    (a0, a1, a2), (b0, b1, b2) = (h.unbind(-4) for h in a.unbind(-5))
    z0 = torch.stack([a0, b0, a1], -4)
    z1 = torch.stack([b1, a2, b2], -4)
    sq = F2.sqr2(torch.stack([z0, z1, z0 + z1], -5))
    t0, t1, tm = sq.unbind(-5)
    r = C.canonical(t0 + _xi_raw(t1), -1, 2)  # z0^2 + xi z1^2
    c = C.canonical(tm - t0 - t1, -2, 0)  # 2 z0 z1
    r00, r01, r02 = r.unbind(-4)
    c00, c01, c02 = c.unbind(-4)
    lo = 3 * torch.stack([r00, r01, r02], -4) - 2 * torch.stack([a0, a1, a2], -4)
    hi = 3 * torch.stack([F2.mul2_xi(c02), c00, c01], -4) + 2 * torch.stack(
        [b0, b1, b2], -4
    )
    return C.canonical(torch.stack([lo, hi], -5), -2, 4)


_X_ABS = -GT.X_PARAM  # 0xd201000000010000


def cyclo_pow_x_neg(a):
    """a^x for the negative BLS parameter x, a cyclotomic: a^|x| by
    cyclotomic squarings, then the conjugate (the inverse there)."""
    return conj12(C.pow_static(a, _X_ABS, cyclo_sqr, mul12))


# ---------------------------------------------------------------------------
# Inversion chain: Fp -> Fp2 -> Fp6 -> Fp12 (one Fp exponentiation)
# ---------------------------------------------------------------------------


def inv_fp(a):
    """a^(p-2): the one genuine inversion under everything."""
    return C.pow_static(a, GT.P - 2, C.mont_sqr, C.mont_mul)


def inv2(a):
    """(a0 + a1 u)^-1 = conj(a) / (a0^2 + a1^2)."""
    sq = C.mont_sqr(a)
    ninv = inv_fp(C.add(sq[..., 0, :, :], sq[..., 1, :, :]))
    return F2.conj2(F2.mul2_fp(a, ninv))


def inv6(a):
    """Fp6 inversion via the adjoint/norm method."""
    a0, a1, a2 = a.unbind(-4)
    c0 = F2.sub2(F2.sqr2(a0), F2.mul2_xi(F2.mul2(a1, a2)))
    c1 = F2.sub2(F2.mul2_xi(F2.sqr2(a2)), F2.mul2(a0, a1))
    c2 = F2.sub2(F2.sqr2(a1), F2.mul2(a0, a2))
    norm = F2.add2(
        F2.mul2(a0, c0),
        F2.mul2_xi(F2.add2(F2.mul2(a2, c1), F2.mul2(a1, c2))),
    )
    ninv = inv2(norm)
    return F2.mul2(torch.stack([c0, c1, c2], -4), ninv.unsqueeze(-4))


def inv12(a):
    """Fp12 inversion: (a0 - a1 w) / (a0^2 - v a1^2)."""
    a0, a1 = a.unbind(-5)
    norm = C.sub(sqr6(a0), mul6_by_v(sqr6(a1)))
    ninv = inv6(norm)
    return conj12(mul6(a, ninv.unsqueeze(-5)))
