"""Limb layout, Montgomery constants and host codecs of the port.

Representation
--------------
A GF(p) element on the device is 12 little-endian limbs of 32 bits,
stored as int32 bit patterns in planes ``[..., NL, N]``: the limb axis
second to last and the batch (one lane per set) last, the shape
convention of the JAX package.  Montgomery radix R = 2^384 (NL * 32).
Every value the kernels produce is CANONICAL: its limbs spell the unique
integer in [0, p) of the Montgomery residue x*R mod p.  The only inputs a
kernel takes that may be non-canonical are the plain-limb planes of the
Montgomery ingest (any integers below 2^384: the decoded paths' signature
and message, which `verify.g2_subgroup_check` or `g2_rsig_sub` converts,
and the wire paths' message, which `verify.g2_decompress` converts).

The plain torch engine (`kernels/core.py` and up) computes the same
canonical integers in a second form, "digits": ``[..., ND, N]`` int64
holding 16 digits of 24 bits, so that a digit product (< 2^48) and a
column of 16 of them (< 2^52) stay exact in int64.  `planes_to_digits`
and `digits_to_planes` convert between the two; the conversion is a bit
shuffle, so a kernel and its plain version compare bit for bit.

Host codecs here are numpy-only, so tests and the verifier can use them
without a device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..crypto import fields as GT

NL = 12  # 32-bit limbs per element on the device
LIMB_BITS = 32
ND = 16  # 24-bit digits per element in the plain torch engine
DIGIT_BITS = 24
DIGIT_MASK = (1 << DIGIT_BITS) - 1
R_BITS = NL * LIMB_BITS  # 384
assert ND * DIGIT_BITS == R_BITS

P = GT.P
R = 1 << R_BITS
R_MOD_P = R % P
R2 = R * R % P
R_INV = pow(R, -1, P)
NPRIME = (-pow(P, -1, R)) % R  # -p^-1 mod R
N0 = (-pow(P, -1, 1 << 32)) % (1 << 32)  # -p^-1 mod 2^32 (word-serial REDC)

# The JAX package's device form: 33 signed 12-bit limbs, R = 2^396
# (lodestar_tpu/kernels/layout.py).  Only `from_jax_planes` reads it.
JAX_NL = 33
JAX_LIMB_BITS = 12
JAX_R_INV = pow(1 << (JAX_NL * JAX_LIMB_BITS), -1, P)


# ---------------------------------------------------------------------------
# Host codecs (numpy, int32 planes)
# ---------------------------------------------------------------------------


def to_limbs(x: int) -> np.ndarray:
    """Nonnegative int < 2^384 -> int32[NL] limb bit patterns."""
    assert 0 <= x < R
    return np.frombuffer(x.to_bytes(4 * NL, "little"), "<u4").astype(np.uint32).view(np.int32)


def from_limbs(arr) -> int:
    """int32[NL] limb bit patterns -> int."""
    a = np.ascontiguousarray(np.asarray(arr, np.int32)).view(np.uint32)
    return int.from_bytes(a.astype("<u4").tobytes(), "little")


def encode_plain_batch(vals) -> np.ndarray:
    """Ints < 2^384 -> PLAIN (non-Montgomery) planes int32[NL, n].

    The ingest form: the device converts to Montgomery form (the paths'
    heading kernels; `verify.mont_convert_plain` is the plain version)."""
    buf = b"".join(int(v).to_bytes(4 * NL, "little") for v in vals)
    words = np.frombuffer(buf, "<u4").reshape(len(vals), NL)
    return words.T.copy().view(np.int32)


def encode_batch(xs) -> np.ndarray:
    """Field ints -> canonical Montgomery planes int32[NL, n]."""
    return encode_plain_batch([x % P * R_MOD_P % P for x in xs])


def decode_plain_batch(arr) -> list:
    """Planes [NL, n] -> the ints their limbs spell."""
    a = np.asarray(arr)
    return [from_limbs(a[:, j]) for j in range(a.shape[-1])]


def decode_batch(arr) -> list:
    """Montgomery planes [NL, n] -> field ints."""
    return [v * R_INV % P for v in decode_plain_batch(arr)]


def from_jax_planes(host: np.ndarray, n: int) -> np.ndarray:
    """A JAX-package Montgomery plane (int32[33, cap], signed 12-bit limbs,
    R = 2^396) -> the port's canonical planes int32[NL, n] holding the
    same field elements.  Exact integer map: decode the limbs, multiply
    by 2^-396 mod p, re-encode with R = 2^384."""
    h = np.asarray(host)
    assert h.shape[0] == JAX_NL, h.shape
    vals = []
    for j in range(n):
        v = sum(int(h[i, j]) << (JAX_LIMB_BITS * i) for i in range(JAX_NL))
        vals.append(v * JAX_R_INV % P)
    return encode_batch(vals)


# ---------------------------------------------------------------------------
# Planes <-> digits (torch)
# ---------------------------------------------------------------------------


def planes_to_digits(x: torch.Tensor) -> torch.Tensor:
    """int32 planes [..., NL, N] -> int64 digits [..., ND, N] (same integer)."""
    assert x.dtype == torch.int32 and x.shape[-2] == NL, (x.dtype, x.shape)
    w = x.to(torch.int64) & 0xFFFFFFFF
    w = w.reshape(*x.shape[:-2], NL // 3, 3, x.shape[-1])
    l0, l1, l2 = w[..., 0, :], w[..., 1, :], w[..., 2, :]
    d = torch.stack(
        [
            l0 & DIGIT_MASK,
            (l0 >> 24) | ((l1 & 0xFFFF) << 8),
            (l1 >> 16) | ((l2 & 0xFF) << 16),
            l2 >> 8,
        ],
        dim=-2,
    )
    return d.reshape(*x.shape[:-2], ND, x.shape[-1])


def digits_to_planes(d: torch.Tensor) -> torch.Tensor:
    """Normalized int64 digits [..., ND, N] -> int32 planes [..., NL, N]."""
    assert d.dtype == torch.int64 and d.shape[-2] == ND, (d.dtype, d.shape)
    g = d.reshape(*d.shape[:-2], ND // 4, 4, d.shape[-1])
    d0, d1, d2, d3 = (g[..., k, :] for k in range(4))
    w = torch.stack(
        [
            d0 | ((d1 & 0xFF) << 24),
            (d1 >> 8) | ((d2 & 0xFFFF) << 16),
            (d2 >> 16) | (d3 << 8),
        ],
        dim=-2,
    ).reshape(*d.shape[:-2], NL, d.shape[-1])
    w = torch.where(w >= 1 << 31, w - (1 << 32), w)
    return w.to(torch.int32)


def int_to_digits(x: int) -> list:
    """Int < 2^384 -> ND python-int digits."""
    return [(x >> (DIGIT_BITS * k)) & DIGIT_MASK for k in range(ND)]


def encode_digits(xs, device=None) -> torch.Tensor:
    """Field ints -> canonical Montgomery digits int64[ND, n]."""
    rows = [int_to_digits(x % P * R_MOD_P % P) for x in xs]
    return torch.tensor(rows, dtype=torch.int64, device=device).T.contiguous()


def decode_digits(d: torch.Tensor) -> list:
    """Digits [ND, n] (any digit values) -> field ints."""
    a = d.detach().cpu().tolist()
    n = len(a[0])
    return [
        sum(int(a[k][j]) << (DIGIT_BITS * k) for k in range(ND)) * R_INV % P
        for j in range(n)
    ]


# ---------------------------------------------------------------------------
# CUDA constants header
# ---------------------------------------------------------------------------


def _fp_words(x: int) -> str:
    return "{" + ", ".join(f"0x{int(w) & 0xFFFFFFFF:08x}u" for w in to_limbs(x)) + "}"


def _fp2_words(v) -> str:
    return "{" + _fp_words(v[0]) + ", " + _fp_words(v[1]) + "}"


@functools.lru_cache(maxsize=None)
def g1_beta() -> int:
    """The cube root of unity beta of sigma(x, y) = (beta x, y) for which
    sigma(P) = [-z^2] P on G1 (z = crypto/fields.py X_PARAM < 0): of the
    two nontrivial roots, 2^((p - 1) / 3) and its square, the one the G1
    generator pins (sigma acts on G1 as one of the two roots of
    l^2 + l + 1 mod r, -z^2 being one of them)."""
    from ..crypto import curves as CU

    w = pow(2, (P - 1) // 3, P)
    assert w != 1 and pow(w, 3, P) == 1
    want = CU.affine_neg(CU.FP_OPS, CU.scalar_mul(CU.FP_OPS, CU.G1_GEN, GT.X_PARAM ** 2))
    (beta,) = [b for b in (w, w * w % P) if (CU.G1_GEN[0] * b % P, CU.G1_GEN[1]) == want]
    return beta


def cuda_constants() -> str:
    """Text of csrc/constants.cuh: every constant the CUDA field engine
    needs, in Montgomery form, generated from this module and the host
    ground truth so the two cannot drift (tests compare the committed
    file with this text)."""
    from ..crypto import curves as CU
    from ..crypto import fields as F

    mont = lambda v: v % P * R_MOD_P % P  # noqa: E731
    mont2 = lambda v: (mont(v[0]), mont(v[1]))  # noqa: E731
    lines = [
        "// Generated by lodestar_tpu_torch/kernels/layout.py cuda_constants();",
        "// do not edit.  Regenerate with",
        "//   python -m lodestar_tpu_torch.kernels.layout > "
        "lodestar_tpu_torch/kernels/csrc/constants.cuh",
        "#pragma once",
        "",
        f"#define LT_N0 0x{N0:08x}u",
        f"LT_CONST uint32_t LT_P[12] = {_fp_words(P)};",
        f"LT_CONST uint32_t LT_ONE[12] = {_fp_words(R_MOD_P)};",
        f"LT_CONST uint32_t LT_R2[12] = {_fp_words(R2)};",
        f"LT_CONST uint32_t LT_P_MINUS_2[12] = {_fp_words(P - 2)};",
        f"LT_CONST uint32_t LT_G2X[2][12] = {_fp2_words(mont2(CU.G2_GEN[0]))};",
        f"LT_CONST uint32_t LT_G2Y[2][12] = {_fp2_words(mont2(CU.G2_GEN[1]))};",
    ]
    # ingest: square roots, signs, decompression
    sqrt_exp = (P + 1) // 4
    lines += [
        f"#define LT_SQRT_TOP {sqrt_exp.bit_length() - 1}",
        f"LT_CONST uint32_t LT_SQRT_EXP[12] = {_fp_words(sqrt_exp)};",
        f"LT_CONST uint32_t LT_INV2[12] = {_fp_words(mont(pow(2, P - 2, P)))};",
        f"LT_CONST uint32_t LT_HALF_P[12] = {_fp_words((P - 1) // 2)};",
        f"LT_CONST uint32_t LT_G2_B[2][12] = {_fp2_words(mont2(CU.FP2_OPS.b_coeff))};",
    ]
    # G1 KeyValidate: E1's b = 4, and the subgroup test sigma(P) = [-z^2] P:
    # sigma's beta and |z|, whose bits the lane program's chains follow
    lines += [
        f"LT_CONST uint32_t LT_G1_B[12] = {_fp_words(mont(CU.FP_OPS.b_coeff))};",
        f"LT_CONST uint32_t LT_G1_BETA[12] = {_fp_words(mont(g1_beta()))};",
        f"#define LT_Z_ABS 0x{-F.X_PARAM:016x}ull",
    ]
    return "\n".join(lines) + "\n"


if __name__ == "__main__":
    import sys

    sys.stdout.write(cuda_constants())
