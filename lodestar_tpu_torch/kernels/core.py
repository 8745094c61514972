"""GF(p) Montgomery arithmetic: the plain torch engine and its CUDA twin.

Counterpart of `lodestar_tpu/kernels/core.py`.  Every function here is
the plain PyTorch version of a CUDA device function in `csrc/fp.cuh`;
both compute the same canonical integers (see `kernels/layout.py`).

The torch engine works on digit tensors ``[..., ND, N]`` int64 (16
digits of 24 bits, canonical value in [0, p), Montgomery radix
R = 2^384), vectorised over the lanes N and over any leading dims, so a
tower multiply is one batched call instead of a Python loop.  Inside a
multiply, values are exact linear combinations of digit products
("columns", < 2^60 in int64); `redc` maps columns back to a canonical
element in one pass:

  * m = (T mod R) * (-p^-1) mod R from carry-folded low columns (the
    folds drop carries out of the top digit, i.e. reduce mod R);
  * U = T + m * p is divisible by R; the carry out of its low half is
    recovered exactly as round(sum_k U_k 2^(24k - 384)) in float64 (the
    sum is an integer below 2^40 and the rounding error is below 2^-14);
  * the high half plus that carry is U / R; `canonical` resolves its
    carries exactly and subtracts the right multiple of p.

Operands are canonical unless a function says otherwise.  Sums of two
canonical values (digits < 2^25, value < 2p) are accepted as multiply
inputs, which lets the tower skip reductions before its products.
"""

from __future__ import annotations

import torch

from . import layout as LY

ND = LY.ND
DB = LY.DIGIT_BITS
MASK = LY.DIGIT_MASK
P = LY.P

_CACHE: dict = {}


def _const(name: str, device) -> torch.Tensor:
    key = (name, str(device))
    t = _CACHE.get(key)
    if t is None:
        if name == "idx":
            t = torch.tensor(
                [i + j for i in range(ND) for j in range(ND)], dtype=torch.int64
            )
        elif name == "w":
            t = torch.tensor(
                [2.0 ** (DB * k - LY.R_BITS) for k in range(ND)],
                dtype=torch.float64,
            )[:, None]
        else:
            val = {
                "p": P,
                "nprime": LY.NPRIME,
                "one": LY.R_MOD_P,
                "r2": LY.R2,
            }[name]
            t = torch.tensor(LY.int_to_digits(val), dtype=torch.int64)[:, None]
        t = t.to(device)
        _CACHE[key] = t
    return t


def const_digits(x: int, device) -> torch.Tensor:
    """A field int as a canonical Montgomery digit column [ND, 1]."""
    key = ("mont", x % P, str(device))
    t = _CACHE.get(key)
    if t is None:
        t = torch.tensor(
            LY.int_to_digits(x % P * LY.R_MOD_P % P), dtype=torch.int64
        )[:, None].to(device)
        _CACHE[key] = t
    return t


# ---------------------------------------------------------------------------
# Columns, carries, reduction
# ---------------------------------------------------------------------------


def cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook digit columns: [..., ND, N] x [..., ND, N] -> [..., 2ND, N].

    Broadcasts over leading dims and N.  Digits up to 2^27 in magnitude
    keep every column below 2^59."""
    prod = a.unsqueeze(-2) * b.unsqueeze(-3)  # [..., ND, ND, N]
    lead = prod.shape[:-3]
    n = prod.shape[-1]
    prod = prod.reshape(*lead, ND * ND, n)
    out = torch.zeros(*lead, 2 * ND, n, dtype=torch.int64, device=prod.device)
    out.index_add_(len(lead), _const("idx", prod.device), prod)
    return out


def _fold_mod_r(t: torch.Tensor) -> torch.Tensor:
    """One carry fold that drops the carry out of the top digit (mod R)."""
    out = t & MASK
    out[..., 1:, :] += (t >> DB)[..., :-1, :]
    return out


def normalize(x: torch.Tensor):
    """Exact carry resolution: digits [..., ND, N] (any int64 values) ->
    (digits in [0, 2^24), carry out of the top digit as [..., N]).
    The value is digits + carry * R; the carry is negative iff the
    value is."""
    parts = x.unbind(-2)
    outs = []
    c = None
    for v in parts:
        if c is not None:
            v = v + c
        outs.append(v & MASK)
        c = v >> DB
    return torch.stack(outs, -2), c


def canonical(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """The canonical residue of x, whose value is known to lie in
    [lo*p, (hi+1)*p).  Tries x - j*p for j in lo..hi at once and keeps
    the last nonnegative one."""
    p = _const("p", x.device)
    js = torch.arange(lo, hi + 1, dtype=torch.int64, device=x.device)
    js = js.reshape(-1, *([1] * x.dim()))
    cand, carry = normalize(x.unsqueeze(0) - js * p)
    nonneg = (carry >= 0).to(torch.int64)  # [J, ..., N]
    pick = nonneg.sum(0) - 1  # index of x - j*p in [0, p)
    sel = torch.arange(hi - lo + 1, device=x.device).reshape(
        -1, *([1] * (x.dim() - 1))
    ) == pick.unsqueeze(0)
    return (cand * sel.unsqueeze(-2).to(torch.int64)).sum(0)


def redc(t: torch.Tensor, lo: int = -1, hi: int = 1) -> torch.Tensor:
    """Montgomery reduction: columns [..., 2ND, N] of value T ->
    canonical T / R mod p.  [lo, hi] bounds the multiple of p that
    T / R + m p / R can reach (default: |T| < p^2 * 9, from products of
    operands below 2p)."""
    low = _fold_mod_r(_fold_mod_r(t[..., :ND, :]))
    m = cols(low, _const("nprime", t.device))[..., :ND, :]
    m = _fold_mod_r(_fold_mod_r(m))
    u = t + cols(m, _const("p", t.device))
    carry = torch.round(
        (u[..., :ND, :].to(torch.float64) * _const("w", t.device)).sum(-2)
    ).to(torch.int64)
    x = u[..., ND:, :].clone()
    x[..., 0, :] += carry
    return canonical(x, lo, hi)


# ---------------------------------------------------------------------------
# Field ops (fp.cuh: fp_mul, fp_sqr, fp_add, fp_sub, fp_neg, ...)
# ---------------------------------------------------------------------------


def mont_mul(a, b):
    """a * b / R mod p."""
    return redc(cols(a, b))


def mont_sqr(a):
    return redc(cols(a, a))


def mont_convert(x):
    """Plain digits of any integer below 2^384 -> Montgomery form x*R mod p.
    (x < 2^384 < 10p, so T = x * R2 < 10 p^2 and T / R stays below 2p.)"""
    return redc(cols(x, _const("r2", x.device)), -1, 2)


def add(a, b):
    return canonical(a + b, 0, 1)


def sub(a, b):
    return canonical(a - b, -1, 0)


def neg(a):
    return canonical(-a, -1, 0)


def mul_small(a, k: int):
    assert 1 <= k <= 16
    return canonical(a * k, 0, k - 1)


def select(mask, a, b):
    """Lane select: mask [..., N] bool (broadcast over the digit axis)."""
    return torch.where(mask.unsqueeze(-2), a, b)


def is_zero_modp(x):
    """x == 0 (mod p) for any nonnegative value below 2^384 -> bool [..., N]."""
    return (canonical(x, 0, 9) == 0).all(-2)


def eq_modp(a, b):
    return (canonical(a, 0, 9) == canonical(b, 0, 9)).all(-2)


def pow_static(x, e: int, sqr_fn, mul_fn):
    """x^e for a static python int e >= 1, MSB-first square-and-multiply
    (the bit pattern is static, so the branch is a Python `if`)."""
    assert e >= 1
    acc = x
    for bit in bin(e)[3:]:
        acc = sqr_fn(acc)
        if bit == "1":
            acc = mul_fn(acc, x)
    return acc
