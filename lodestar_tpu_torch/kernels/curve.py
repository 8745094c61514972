"""Jacobian curve arithmetic (G1 over Fp, G2 over Fp2): plain torch
engine and its CUDA twin.

Counterpart of the subset of `lodestar_tpu/kernels/curve.py` that the
per-set and RLC batch paths need; the CUDA device functions are in
`csrc/curve.cuh`.  Points are (X, Y, Z) tuples of field tensors; the
point at infinity travels as an explicit boolean lane mask beside the
point (`curve.py:102` and `:461` of the JAX package), so the hot loops
carry no exact zero tests.  The formulas are the JAX package's, so the
Jacobian coordinates (not only the points) agree; the lane sum keeps
the port's own order of additions (`sum_points_lanes`), so there only
the points agree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..crypto import fields as GT
from . import core as C
from . import fp2 as F2
from . import layout as LY
from . import tower as TW


@dataclass(frozen=True)
class FieldOps:
    mul: Callable
    sqr: Callable
    add: Callable
    sub: Callable
    neg: Callable
    double: Callable
    mul_small: Callable
    is_zero: Callable
    eq: Callable
    one: Callable  # (n lanes, device) -> the field one


FP_OPS = FieldOps(
    mul=C.mont_mul,
    sqr=C.mont_sqr,
    add=C.add,
    sub=C.sub,
    neg=C.neg,
    double=lambda a: C.mul_small(a, 2),
    mul_small=C.mul_small,
    is_zero=C.is_zero_modp,
    eq=C.eq_modp,
    one=lambda n, dev: C._const("one", dev).expand(LY.ND, n).clone(),
)

FP2_OPS = FieldOps(
    mul=F2.mul2,
    sqr=F2.sqr2,
    add=F2.add2,
    sub=F2.sub2,
    neg=F2.neg2,
    double=F2.double2,
    mul_small=F2.mul2_small,
    is_zero=F2.is_zero2,
    eq=F2.eq2,
    one=lambda n, dev: torch.stack(
        [C._const("one", dev).expand(LY.ND, n), torch.zeros(LY.ND, n, dtype=torch.int64, device=dev)]
    ),
)


def select_pt(mask, p, q):
    return tuple(TW.select(mask, a, b) for a, b in zip(p, q))


# ---------------------------------------------------------------------------
# Group law (a = 0 short Weierstrass)
# ---------------------------------------------------------------------------


def jac_dbl(fo: FieldOps, p):
    """2P, 2M + 5S.  Maps infinity (Z = 0) to infinity."""
    X, Y, Z = p
    A = fo.sqr(X)
    B = fo.sqr(Y)
    CC = fo.sqr(B)
    D = fo.double(fo.sub(fo.sub(fo.sqr(fo.add(X, B)), A), CC))
    E = fo.mul_small(A, 3)
    F = fo.sqr(E)
    X3 = fo.sub(F, fo.double(D))
    Y3 = fo.sub(fo.mul(E, fo.sub(D, X3)), fo.mul_small(CC, 8))
    Z3 = fo.double(fo.mul(Y, Z))
    return (X3, Y3, Z3)


def _add_core(fo: FieldOps, p, q):
    """P + Q for Jacobian P and Q, 12M + 4S, and the H and R of the
    formula (H == R == 0 means P == Q, H == 0 alone P == -Q)."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = fo.sqr(Z1)
    Z2Z2 = fo.sqr(Z2)
    U1 = fo.mul(X1, Z2Z2)
    U2 = fo.mul(X2, Z1Z1)
    S1 = fo.mul(fo.mul(Y1, Z2), Z2Z2)
    S2 = fo.mul(fo.mul(Y2, Z1), Z1Z1)
    H = fo.sub(U2, U1)
    R = fo.sub(S2, S1)
    HH = fo.sqr(H)
    HHH = fo.mul(H, HH)
    V = fo.mul(U1, HH)
    X3 = fo.sub(fo.sub(fo.sqr(R), HHH), fo.double(V))
    Y3 = fo.sub(fo.mul(R, fo.sub(V, X3)), fo.mul(S1, HHH))
    Z3 = fo.mul(fo.mul(Z1, Z2), H)
    return (X3, Y3, Z3), H, R


def jac_add_mixed_or_full(fo: FieldOps, p, q):
    """P + Q inside the windowed scalar multiplication: the generic
    Jacobian addition without the equal/infinity dispatch (callers rule
    those out).  `lodestar_tpu/kernels/curve.py:305`."""
    return _add_core(fo, p, q)[0]


def jac_add_full(fo: FieldOps, p, p_inf, q, q_inf):
    """(P + Q, inf mask): P = O and Q = O through the masks, P == Q by an
    exact zero test dispatching to doubling, P == -Q giving infinity."""
    s, H, R = _add_core(fo, p, q)
    h_zero = fo.is_zero(H)
    r_zero = fo.is_zero(R)
    out = select_pt(h_zero & r_zero, jac_dbl(fo, p), s)
    out = select_pt(q_inf, p, out)
    out = select_pt(p_inf, q, out)
    out_inf = (p_inf & q_inf) | (h_zero & ~r_zero & ~p_inf & ~q_inf)
    return out, out_inf


def jac_add_mixed(fo: FieldOps, p, q_aff):
    """P + Q with Q affine, 7M + 4S.  No infinity or equal handling:
    callers guarantee P != O and P != +-Q."""
    X1, Y1, Z1 = p
    X2, Y2 = q_aff
    Z1Z1 = fo.sqr(Z1)
    U2 = fo.mul(X2, Z1Z1)
    S2 = fo.mul(fo.mul(Y2, Z1), Z1Z1)
    H = fo.sub(U2, X1)
    HH = fo.sqr(H)
    I = fo.mul_small(HH, 4)
    J = fo.mul(H, I)
    rr = fo.double(fo.sub(S2, Y1))
    V = fo.mul(X1, I)
    X3 = fo.sub(fo.sub(fo.sqr(rr), J), fo.double(V))
    Y3 = fo.sub(fo.mul(rr, fo.sub(V, X3)), fo.double(fo.mul(Y1, J)))
    Z3 = fo.sub(fo.sub(fo.sqr(fo.add(Z1, H)), Z1Z1), HH)
    return (X3, Y3, Z3)


def jac_neg(fo: FieldOps, p):
    return (p[0], fo.neg(p[1]), p[2])


def jac_eq(fo: FieldOps, p, p_inf, q, q_inf):
    """Equality of Jacobian points (cross-multiplied), infinity-aware."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = fo.sqr(Z1)
    Z2Z2 = fo.sqr(Z2)
    ex = fo.eq(fo.mul(X1, Z2Z2), fo.mul(X2, Z1Z1))
    ey = fo.eq(fo.mul(fo.mul(Y1, Z2), Z2Z2), fo.mul(fo.mul(Y2, Z1), Z1Z1))
    return (p_inf & q_inf) | (~p_inf & ~q_inf & ex & ey)


def scalar_mul_static(fo: FieldOps, q_aff, k: int):
    """k*Q for a static scalar 2 <= k < 2^64, Q affine and not O: double,
    then mixed-add where the (static) bit is set.  An add always follows
    a doubling, so the accumulator is an even multiple and never +-Q."""
    assert 2 <= k < 1 << 64
    n = q_aff[0].shape[-1]
    T = (q_aff[0], q_aff[1], fo.one(n, q_aff[0].device))
    for bit in bin(k)[3:]:
        T = jac_dbl(fo, T)
        if bit == "1":
            T = jac_add_mixed(fo, T, q_aff)
    return T


def scalar_mul_window_jac(fo: FieldOps, q, q_inf, get_digit, nbits: int, w: int = 4):
    """(k Q, inf mask) for per-lane scalars k read as MSB-first w-bit
    window digits: `get_digit(t)` -> int [N] digit of window t.

    The recurrence of `lodestar_tpu/kernels/curve.py:238`, so the Jacobian
    coordinates (not only the points) equal the JAX function's: a table
    {Q .. (2^w - 1) Q} whose even entries double the half entry and odd
    entries add Q; then per window w doublings and one addition of the
    digit's entry, always computed and kept where the digit is nonzero.
    Until the first nonzero digit the accumulator is infinity (T is a
    placeholder) and the entry is assigned directly.  q: Jacobian
    (X, Y, Z); q_inf: bool [N]."""
    assert nbits % w == 0 and w >= 1, (nbits, w)
    tbl = [q]
    for m in range(2, 1 << w):
        if m % 2 == 0:
            tbl.append(jac_dbl(fo, tbl[m // 2 - 1]))
        else:
            tbl.append(jac_add_mixed_or_full(fo, tbl[m - 2], q))
    # the table as one tensor per coordinate: [2^w - 1, ..., N]
    stacked = [torch.stack([e[c] for e in tbl]) for c in range(3)]
    T = q
    t_inf = torch.ones_like(q_inf, dtype=torch.bool)
    for t in range(nbits // w):
        for _ in range(w):
            T = jac_dbl(fo, T)
        d = get_digit(t).to(torch.int64)
        pick = (d - 1).clamp(min=0)  # digit 0 reads entry 1 and is discarded
        add = tuple(_take_lanes(s, pick) for s in stacked)
        cand = select_pt(t_inf, add, jac_add_mixed_or_full(fo, T, add))
        nz = d != 0
        T = select_pt(nz, cand, T)
        t_inf = t_inf & ~nz
    return T, t_inf | q_inf


def _take_lanes(table, idx):
    """Per lane n, entry idx[n] of a table [E, ..., N]."""
    shape = (1,) + tuple(table.shape[1:-1]) + (idx.shape[-1],)
    i = idx.reshape((1,) + (1,) * (table.dim() - 2) + (-1,)).expand(shape)
    return torch.gather(table, 0, i)[0]


def sum_points_axis0(fo: FieldOps, pts, inf):
    """Tree sum over a leading axis: points [K, ..., N], inf [K, N] ->
    [..., N], in the order of `lodestar_tpu/kernels/curve.py:380` (and of
    csrc/aggpk.cu): half = (k + 1) // 2, row i added to row i + half, an
    odd middle row passed through, until one row is left.  The Jacobian
    coordinates depend on that order, so it is kept exactly."""
    k = inf.shape[0]
    while k > 1:
        half = (k + 1) // 2
        n = k - half
        s, s_inf = jac_add_full(
            fo, tuple(c[:n] for c in pts), inf[:n], tuple(c[half:k] for c in pts), inf[half:k]
        )
        pts = tuple(torch.cat([a, c[n:half]]) for a, c in zip(s, pts))
        inf = torch.cat([s_inf, inf[n:half]])
        k = half
    return tuple(c[0] for c in pts), inf[0]


def sum_points_lanes(fo: FieldOps, pts, inf, width: int = 128):
    """(sum of the lanes not flagged infinity, its inf flag) -> [..., 1].

    The port's order of additions (csrc/reduce.cu): `width` slots, slot j
    folding lanes j, j + width, ... in sequence, then slots j and j + s
    combined for s = width / 2, .., 1.  Slots beyond N start as infinity
    with zero coordinates.  Jacobian coordinates depend on the order, so
    this is the order the kernel keeps; the point equals any order's."""
    n = inf.shape[-1]
    tiles = max(1, -(-n // width))
    pad = tiles * width - n
    real = torch.arange(tiles * width, device=inf.device) < n
    pts = tuple(torch.nn.functional.pad(c, (0, pad)) for c in pts)
    inf = torch.cat([inf, torch.ones(pad, dtype=torch.bool, device=inf.device)])

    def tile(x, t):
        return x[..., t * width : (t + 1) * width]

    acc, acc_inf = tuple(tile(c, 0) for c in pts), tile(inf, 0)
    for t in range(1, tiles):
        s, s_inf = jac_add_full(fo, acc, acc_inf, tuple(tile(c, t) for c in pts), tile(inf, t))
        keep = tile(real, t)
        acc, acc_inf = select_pt(keep, s, acc), torch.where(keep, s_inf, acc_inf)
    s = width // 2
    while s >= 1:
        lo = tuple(c[..., :s] for c in acc)
        hi = tuple(c[..., s : 2 * s] for c in acc)
        r, r_inf = jac_add_full(fo, lo, acc_inf[..., :s], hi, acc_inf[..., s : 2 * s])
        acc = tuple(torch.cat([a, c[..., s:]], -1) for a, c in zip(r, acc))
        acc_inf = torch.cat([r_inf, acc_inf[..., s:]], -1)
        s //= 2
    return tuple(c[..., :1] for c in acc), acc_inf[..., :1]


# ---------------------------------------------------------------------------
# psi endomorphism + G2 subgroup check (Scott's test)
# ---------------------------------------------------------------------------

_U = (0, 1)
_CX_INT = GT.fp2_mul(_U, GT.fp2_pow(GT.XI, 2 * (GT.P - 1) // 3))
_CY_INT = GT.fp2_mul(_U, GT.fp2_pow(GT.XI, (GT.P - 1) // 2))
_X_ABS = -GT.X_PARAM


def g2_psi(q):
    """psi on Jacobian twist coordinates."""
    X, Y, Z = q
    dev = X.device
    return (
        F2.mul2(F2.conj2(X), F2.const2(_CX_INT, dev)),
        F2.mul2(F2.conj2(Y), F2.const2(_CY_INT, dev)),
        F2.conj2(Z),
    )


def g2_subgroup_check(q_aff, q_inf):
    """Q in G2 <=> psi(Q) == [x]Q = -[|x|]Q.  O is in the subgroup.

    q_aff: (x, y) Fp2 tensors [2, ND, N]; q_inf: bool [N]."""
    n = q_aff[0].shape[-1]
    q_jac = (q_aff[0], q_aff[1], FP2_OPS.one(n, q_aff[0].device))
    zq = scalar_mul_static(FP2_OPS, q_aff, _X_ABS)
    lhs = g2_psi(q_jac)
    return jac_eq(FP2_OPS, lhs, q_inf, jac_neg(FP2_OPS, zq), q_inf) | q_inf
