"""Signs of field values: the plain torch engine and its CUDA twin.

Counterpart of `lodestar_tpu/kernels/canonical.py`; the CUDA device
functions are in `csrc/canonical.cuh`.  The port's values are canonical
Montgomery residues, so a sign is a REDC out of Montgomery form (a
product with the plain integer 1) and a compare with (p - 1) / 2 or a
parity bit; the JAX package's V1 offset, which exists for its signed
12-bit limbs, has no counterpart.

  fp_sgn    x > (p - 1) / 2 (the ZCash sort flag; False for 0)
  fp_sgn0   x mod 2 (RFC 9380 sgn0, m = 1)
  fp2_sgn   fp_sgn of the imaginary part, of the real part if that is 0
  fp2_sgn0  sgn0(x0) | (x0 == 0 & sgn0(x1)) (RFC 9380, m = 2)

Inputs are Montgomery digit tensors [..., ND, N] (Fp) or [..., 2, ND, N]
(Fp2); results are bool [..., N].
"""

from __future__ import annotations

import torch

from . import core as C
from . import layout as LY

_HALF_P = (LY.P - 1) // 2


def _digits(x: int, device) -> torch.Tensor:
    return torch.tensor(LY.int_to_digits(x), dtype=torch.int64, device=device)[:, None]


def from_mont(x):
    """x R mod p -> x (canonical digits)."""
    return C.redc(C.cols(x, _digits(1, x.device)))


def _gt_half(v):
    """v > (p - 1) / 2 for canonical digits: v - (p + 1) / 2 >= 0."""
    _, carry = C.normalize(v - _digits(_HALF_P + 1, v.device))
    return carry >= 0


def _odd(v):
    return (v[..., 0, :] & 1) != 0


def _zero(v):
    return (v == 0).all(-2)


def fp_sgn(x):
    return _gt_half(from_mont(x))


def fp_sgn0(x):
    return _odd(from_mont(x))


def fp2_sgn(x):
    v = from_mont(x)
    s = _gt_half(v)
    return torch.where(_zero(v[..., 1, :, :]), s[..., 0, :], s[..., 1, :])


def fp2_sgn0(x):
    v = from_mont(x)
    v0, v1 = v[..., 0, :, :], v[..., 1, :, :]
    return _odd(v0) | (_zero(v0) & _odd(v1))
