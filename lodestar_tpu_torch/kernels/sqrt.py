"""Square roots in Fp and Fp2, branch-free: the plain torch engine and its
CUDA twin.

Counterpart of `lodestar_tpu/kernels/sqrt.py`; the CUDA device functions
are `fp_sqrt_cand` in `csrc/fp.cuh` and `fp2_sqrt` in `csrc/fp2.cuh`.
p = 3 (mod 4), so the Fp candidate root is a^((p + 1) / 4).  Fp2 uses the
norm method with every branch flattened to selects, and validity is the
one final check cand^2 == a, as in the JAX package, so the root (not only
its square) is the JAX function's.  Independent exponentiations run as one
batched chain here (stacked on a leading axis); the values are the same.
"""

from __future__ import annotations

import torch

from . import core as C
from . import fp2 as F2
from . import layout as LY
from . import tower as TW

_EXP_SQRT = (LY.P + 1) // 4
_INV2 = pow(2, LY.P - 2, LY.P)


def fp_sqrt_cand(a):
    """The candidate root a^((p+1)/4); a root of a iff its square is a."""
    return C.pow_static(a, _EXP_SQRT, C.mont_sqr, C.mont_mul)


def fp_sqrt(a):
    """(root, ok): lanes with ok carry a root of a; the others garbage."""
    cand = fp_sqrt_cand(a)
    return cand, C.eq_modp(C.mont_sqr(cand), a)


def fp2_sqrt(a):
    """(root, ok) of Fp2 values a [..., 2, ND, N] by the norm method:
    d = sqrt(a0^2 + a1^2), x0 = sqrt((a0 +- d) / 2), x1 = a1 / (2 x0); for
    a1 == 0 the root is (sqrt(a0), 0) or (0, sqrt(-a0))."""
    a0, a1 = a[..., 0, :, :], a[..., 1, :, :]
    half = C.const_digits(_INV2, a.device)
    n = C.add(C.mont_sqr(a0), C.mont_sqr(a1))
    # d, s_p = sqrt(a0) and s_m = sqrt(-a0) in one chain
    d, s_p, s_m = fp_sqrt_cand(torch.stack([n, a0, C.neg(a0)])).unbind(0)
    x0sq = C.mont_mul(torch.stack([C.add(a0, d), C.sub(a0, d)]), half)
    r_p, r_m = fp_sqrt_cand(x0sq).unbind(0)
    p_ok = C.eq_modp(C.mont_sqr(r_p), x0sq[0])
    x0 = C.select(p_ok, r_p, r_m)
    x1 = C.mont_mul(a1, TW.inv_fp(C.mul_small(x0, 2)))
    sp_ok = C.eq_modp(C.mont_sqr(s_p), a0)
    zero = torch.zeros_like(s_p)
    a1z = C.is_zero_modp(a1)
    cand = torch.stack(
        [
            C.select(a1z, C.select(sp_ok, s_p, zero), x0),
            C.select(a1z, C.select(sp_ok, zero, s_m), x1),
        ],
        -3,
    )
    return cand, F2.eq2(F2.sqr2(cand), a)
