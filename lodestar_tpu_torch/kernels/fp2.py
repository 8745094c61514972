"""Fp2 arithmetic (u^2 = -1): the plain torch engine and its CUDA twin.

Counterpart of `lodestar_tpu/kernels/fp2.py`; the CUDA device functions
are in `csrc/fp2.cuh`.  An Fp2 element a0 + a1*u is ONE tensor
``[..., 2, ND, N]`` (component axis before the digit axis), so the
linear ops are the Fp ops applied to the whole tensor and a batch of
Fp2 products is one call.

`mul2` is Karatsuba in column space: three digit products, two
Montgomery reductions.  Its operands may be sums of two canonical
values (value < 2p): the reduction's range covers them.
"""

from __future__ import annotations

import torch

from . import core as C


def add2(a, b):
    return C.add(a, b)


def sub2(a, b):
    return C.sub(a, b)


def neg2(a):
    return C.neg(a)


def double2(a):
    return C.mul_small(a, 2)


def mul2_small(a, k: int):
    return C.mul_small(a, k)


def conj2(a):
    """a0 - a1*u == a^p (the Fp2 Frobenius)."""
    return torch.stack([a[..., 0, :, :], C.neg(a[..., 1, :, :])], -3)


def mul2_xi(a):
    """Multiply by xi = 1 + u: (a0 - a1) + (a0 + a1) u."""
    a0, a1 = a[..., 0, :, :], a[..., 1, :, :]
    return C.canonical(torch.stack([a0 - a1, a0 + a1], -3), -1, 1)


def cols2(a, b):
    """The two pre-reduction column vectors of a*b: [..., 2, 2ND, N]."""
    a0, a1 = a[..., 0, :, :], a[..., 1, :, :]
    b0, b1 = b[..., 0, :, :], b[..., 1, :, :]
    sa = torch.stack(torch.broadcast_tensors(a0, a1, a0 + a1), -3)
    sb = torch.stack(torch.broadcast_tensors(b0, b1, b0 + b1), -3)
    t = C.cols(sa, sb)
    t00, t11, tm = t[..., 0, :, :], t[..., 1, :, :], t[..., 2, :, :]
    return torch.stack([t00 - t11, tm - t00 - t11], -3)


def mul2(a, b):
    """Fp2 product: 3 digit products, 2 reductions."""
    return C.redc(cols2(a, b))


def sqr2(a):
    """(a0 + a1 u)^2 = (a0 + a1)(a0 - a1) + 2 a0 a1 u."""
    a0, a1 = a[..., 0, :, :], a[..., 1, :, :]
    t = C.cols(torch.stack([a0 + a1, a0], -3), torch.stack([a0 - a1, a1], -3))
    return C.redc(torch.stack([t[..., 0, :, :], 2 * t[..., 1, :, :]], -3))


def mul2_fp(a, k):
    """Fp2 times an Fp element k [..., ND, N]."""
    return C.redc(C.cols(a, k.unsqueeze(-3)))


def const2(v, device) -> torch.Tensor:
    """Host (x0, x1) int pair -> Montgomery Fp2 constant [2, ND, 1]."""
    return torch.stack([C.const_digits(v[0], device), C.const_digits(v[1], device)])


def is_zero2(a):
    return C.is_zero_modp(a).all(-2)


def eq2(a, b):
    return C.eq_modp(a, b).all(-2)
