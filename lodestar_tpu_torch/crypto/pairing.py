"""Optimal ate pairing on BLS12-381 — CPU ground truth.

e(P, Q) for P in G1(Fp), Q in G2(Fp2), computed the straightforward way:
untwist Q into E(Fp12) and run an *affine* Miller loop over |x| with generic
Fp12 arithmetic, then the full final exponentiation.  Slow (tens of ms per
pairing) but structurally simple — this is the oracle the optimized JAX
Miller loop (twisted line evaluation, shared final exp, 3d exponent trick)
is tested against.

The verification relation implemented on top (`lodestar_tpu.crypto.bls`)
mirrors blst's `verifyMultipleSignatures` random-linear-combination batch
(reference: packages/beacon-node/src/chain/bls/multithread/worker.ts:52-96,
maybeBatch.ts:16-27).
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

from . import fields as F
from .curves import FP2_OPS, FP_OPS, Affine, is_on_curve

# Miller loop runs over |x|; x < 0 is handled by a final conjugation.
ATE_LOOP = -F.X_PARAM
ATE_BITS = bin(ATE_LOOP)[2:]  # MSB first

# Hard-part exponent of the final exponentiation.
HARD_EXP = (F.P**4 - F.P**2 + 1) // F.R
assert (F.P**4 - F.P**2 + 1) % F.R == 0

# The (x-1)^2 * (x+p) * (x^2+p^2-1) + 3 identity used by the fast chain on
# the TPU side (which therefore computes e(P,Q)^3 — still a perfectly good
# pairing for equality-with-one checks since gcd(3, r) = 1).
assert 3 * HARD_EXP == (F.X_PARAM - 1) ** 2 * (F.X_PARAM + F.P) * (
    F.X_PARAM**2 + F.P**2 - 1
) + 3


# ---------------------------------------------------------------------------
# Untwist E'(Fp2) -> E(Fp12)
# ---------------------------------------------------------------------------

_XI_INV = F.fp2_inv(F.XI)


def untwist(q: Affine):
    """Map (x, y) on E'/Fp2 to E/Fp12 via X = x/w^2, Y = y/w^3.

    With the tower w^2 = v, v^3 = xi:  1/w^2 = v^2/xi and 1/w^3 = (v/xi)*w.
    """
    if q is None:
        return None
    x, y = q
    X = (
        (F.FP2_ZERO, F.FP2_ZERO, F.fp2_mul(x, _XI_INV)),
        F.FP6_ZERO,
    )
    Y = (
        F.FP6_ZERO,
        (F.FP2_ZERO, F.fp2_mul(y, _XI_INV), F.FP2_ZERO),
    )
    return (X, Y)


def embed_fp(a: int):
    """Embed an Fp scalar into Fp12."""
    return (((a % F.P, 0), F.FP2_ZERO, F.FP2_ZERO), F.FP6_ZERO)


# Self-check: the untwisted G2 generator satisfies Y^2 = X^3 + 4.
def _selfcheck_untwist() -> None:
    from .curves import G2_GEN

    X, Y = untwist(G2_GEN)
    lhs = F.fp12_sqr(Y)
    rhs = F.fp12_add(F.fp12_mul(F.fp12_sqr(X), X), embed_fp(4))
    assert F.fp12_eq(lhs, rhs), "untwist map is wrong"


_selfcheck_untwist()


# ---------------------------------------------------------------------------
# Affine Miller loop in Fp12
# ---------------------------------------------------------------------------


def _line(t, q, p_emb):
    """Evaluate the line through t and q (or tangent if t == q) at p_emb.

    All points are affine over Fp12.  Returns (value, t + q).
    """
    xt, yt = t
    xp, yp = p_emb
    if F.fp12_eq(xt, q[0]) and F.fp12_eq(yt, q[1]):
        # tangent: lambda = 3 x^2 / 2 y
        num = F.fp12_mul(embed_fp(3), F.fp12_sqr(xt))
        den = F.fp12_mul(embed_fp(2), yt)
    elif F.fp12_eq(xt, q[0]):
        # t == -q: the ate loop never reaches this for points in the proper
        # subgroups; reaching it means a bad input slipped past the callers.
        raise ValueError("degenerate line (t == -q): input not in G2 subgroup")
    else:
        num = F.fp12_sub(q[1], yt)
        den = F.fp12_sub(q[0], xt)
    lam = F.fp12_mul(num, F.fp12_inv(den))
    # l(P) = (y_p - y_t) - lambda * (x_p - x_t)
    val = F.fp12_sub(F.fp12_sub(yp, yt), F.fp12_mul(lam, F.fp12_sub(xp, xt)))
    # chord/tangent addition
    x3 = F.fp12_sub(F.fp12_sub(F.fp12_sqr(lam), xt), q[0])
    y3 = F.fp12_sub(F.fp12_mul(lam, F.fp12_sub(xt, x3)), yt)
    return val, (x3, y3)


def miller_loop(p: Affine, q: Affine):
    """f_{|x|,Q}(P), conjugated for the negative parameter.  Fp12 result."""
    if p is None or q is None:
        return F.FP12_ONE
    q_tw = untwist(q)
    p_emb = (embed_fp(p[0]), embed_fp(p[1]))
    f = F.FP12_ONE
    t = q_tw
    for bit in ATE_BITS[1:]:
        val, t = _line(t, t, p_emb)
        f = F.fp12_mul(F.fp12_sqr(f), val)
        if bit == "1":
            val, t = _line(t, q_tw, p_emb)
            f = F.fp12_mul(f, val)
    return F.fp12_conj(f)  # x < 0


def final_exponentiation(f):
    """f^((p^12 - 1)/r)."""
    # easy part: f^((p^6 - 1)(p^2 + 1))
    m = F.fp12_mul(F.fp12_conj(f), F.fp12_inv(f))
    m = F.fp12_mul(F.fp12_frobenius(m, 2), m)
    # hard part
    return F.fp12_pow(m, HARD_EXP)


def pairing(p: Affine, q: Affine, check: bool = True):
    if check:
        assert is_on_curve(FP_OPS, p), "P not on G1 curve"
        assert is_on_curve(FP2_OPS, q), "Q not on G2 curve"
    return final_exponentiation(miller_loop(p, q))


def multi_pairing(pairs: Sequence[Tuple[Affine, Affine]]):
    """prod_i e(P_i, Q_i) with a single shared final exponentiation."""
    f = F.FP12_ONE
    for p, q in pairs:
        f = F.fp12_mul(f, miller_loop(p, q))
    return final_exponentiation(f)


def multi_pairing_is_one(pairs: Sequence[Tuple[Affine, Affine]]) -> bool:
    return F.fp12_eq(multi_pairing(pairs), F.FP12_ONE)
