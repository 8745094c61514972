"""G1 KeyValidate's lane program (`csrc/keyvalidate.cu`, one thread per lane).

A lane decompresses one pubkey and decides whether it is in G1.  Its Fp
values live in `SLOTS` slots of the block's shared memory (no stack); it
runs the straight-line program that `program()` writes here, one Fp
operation at a time, through a single Montgomery product in the kernel's
interpreter loop.  The program has four segments, and the
kernel does the few per-lane steps between them that read or write the
planes (`HOOKS` below):

  rhs     x -> Montgomery, rhs = x^3 + 4;
  sqrt    y = rhs^((p + 1) / 4) by a sliding window of WIDTH bits over a
          table of the 8 odd powers, then y^2 (the on-curve test), -y and
          y out of Montgomery form (the sign);
  chains  A = [|z|] P, then B = [|z|] A = [z^2] P (z < 0): 63 doublings and
          5 additions each, MSB first over |z|'s bits; the additions in A's
          chain are mixed (P affine), those in B's generic;
  final   Z_B^2, Z_B^3, beta x Z_B^2 and Y_B + y Z_B^3 for the test
          sigma(P) = -B, sigma(x, y) = (beta x, y).

P is in G1 iff sigma(P) = [-z^2] P (Scott, "A note on group membership
tests for G1, G2 and GT on BLS pairing-friendly curves", ePrint 2021/1130;
Bowe, ePrint 2019/814): exact on BLS12-381's E(Fp), beta the cube root of
unity that `layout.g1_beta` pairs with the sign.  The additions are not
complete, and the verdict is exact all the same:
  * A key of G1 has order r > 2^65, so T = [k]P (k < 2^64) in A's chain
    is never O or +-P, nor is [k]A O or +-A in B's: no addition of a key
    of G1 meets its exceptional case (H = U2 - U1 = 0: T = +-addend).
  * An addition that meets it makes Z = 0 (the mixed one's Z3 is
    2 Z1 H, the generic one's Z1 Z2 H), and Z = 0 stays 0 through every
    later doubling (2 Y Z) and addition, so Z_B = 0 and the test refuses
    the lane (the x = 0 key of order 3 meets T = 2P = -P at A's first
    addition).
  * Without one, every addition is exact, no T is O (E(Fp) has odd
    order: no doubling meets y = 0), and the sigma test decides.

Every value is canonical, so (x, y) equal the plain version's
(`kernels/ingest.py g1_keyvalidate`, the [r]P design of the JAX package)
bit for bit; `simulate` runs the program on integers for the tests.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

from ..crypto import fields as GT
from . import layout as LY

P = GT.P
Z_ABS = -GT.X_PARAM
SQRT_EXP = (P + 1) // 4
WIDTH = 4  # the square root's window: a table of 2^(WIDTH - 1) = 8 odd powers

# operation kinds, as the program's words carry them (kind << 30 | dst << 20 | a << 10 | b)
MUL, ADD, SUB = 0, 1, 2
SLOTS = 9
CONSTS = ("ZERO", "ONE_PLAIN", "R2", "G1_B", "BETA")  # operand SLOTS + i is CONSTS[i]
SEGMENTS = ("rhs", "sqrt", "chains", "final")

# the slots the kernel reads or writes between segments
T = (0, 1, 2)  # the chains' running point (Jacobian); B after them
Q = (3, 4, 5)  # P = (x, y) in A's chain, A in B's; (x, y) again for the final segment
TMP = (6, 7, 8)
HOOKS = {
    "XIN": 0,  # in: the plain x
    "X": 1,  # after rhs: x in Montgomery form, stored to the planes
    "RHS": 0, "Y": 8, "YSQ": 1, "NY": 2, "YPLAIN": 3,  # after sqrt
    "TX": T[0], "TY": T[1], "TZ": T[2], "QX": Q[0], "QY": Q[1],  # set before chains and final
    "BX": 8, "SUM": 7,  # after final: beta x Z_B^2, Y_B + y Z_B^3
}


def mont(v: int) -> int:
    return v % P * LY.R_MOD_P % P


@functools.lru_cache(maxsize=None)
def const_values() -> Dict[str, int]:
    """The constants' canonical limbs' integers (Montgomery form but for
    ZERO and ONE_PLAIN, the plain 1 whose product leaves Montgomery form)."""
    return {"ZERO": 0, "ONE_PLAIN": 1, "R2": LY.R2, "G1_B": mont(4), "BETA": mont(LY.g1_beta())}


def windows(e: int, width: int = WIDTH) -> List[Tuple[int, int]]:
    """e > 0 MSB first as (squarings, odd digit) steps of a sliding window
    of at most `width` bits (the first step's squarings 0), and a last
    step (trailing zeros, 0): the chain of warp_schedule.pow_window."""
    bits, out, i, sq = bin(e)[2:], [], 0, 0
    while i < len(bits):
        if bits[i] == "0":
            sq, i = sq + 1, i + 1
            continue
        j = min(i + width, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        out.append((sq + (j - i) if out else 0, int(bits[i:j], 2)))
        sq, i = 0, j
    return out + [(sq, 0)]


class Program:
    def __init__(self):
        self.ops: List[Tuple[int, int, int, int]] = []
        self.starts = [0]  # each segment's first operation, and the end

    def c(self, name: str) -> int:
        return SLOTS + CONSTS.index(name)

    def op(self, kind, d, a, b):
        assert 0 <= d < SLOTS and all(0 <= s < SLOTS + len(CONSTS) for s in (a, b))
        self.ops.append((kind, d, a, b))

    def mul(self, d, a, b):
        self.op(MUL, d, a, b)

    def add(self, d, a, b):
        self.op(ADD, d, a, b)

    def sub(self, d, a, b):
        self.op(SUB, d, a, b)

    def end_segment(self):
        self.starts.append(len(self.ops))

    @property
    def fp_muls(self) -> int:
        return sum(op[0] == MUL for op in self.ops)


def _dbl(p: Program) -> None:
    """T = 2T in place (dbl-2009-l, 2M + 5S)."""
    (x, y, z), (a, b, c) = T, TMP
    p.mul(a, y, z)
    p.add(z, a, a)  # Z3 = 2 Y Z
    p.mul(a, x, x)  # A
    p.mul(b, y, y)  # B
    p.mul(y, b, b)  # C
    p.add(c, x, b)
    p.mul(c, c, c)
    p.sub(c, c, a)
    p.sub(c, c, y)
    p.add(c, c, c)  # D = 2((X + B)^2 - A - C)
    p.add(b, a, a)
    p.add(a, b, a)  # E = 3A
    p.mul(b, a, a)  # F = E^2
    p.sub(x, b, c)
    p.sub(x, x, c)  # X3 = F - 2D
    p.sub(c, c, x)
    p.mul(c, a, c)  # E (D - X3)
    for _ in range(3):
        p.add(y, y, y)  # 8C
    p.sub(y, c, y)  # Y3


def _add_mixed(p: Program) -> None:
    """T = T + (Q.x, Q.y) in place (madd-2007-bl, 7M + 4S)."""
    (x, y, z), (qx, qy, _), (a, b, c) = T, Q, TMP
    p.mul(a, z, z)  # Z1Z1
    p.mul(b, qx, a)  # U2
    p.mul(c, qy, z)
    p.mul(c, c, a)  # S2
    p.sub(b, b, x)  # H
    p.sub(c, c, y)
    p.add(c, c, c)  # r = 2 (S2 - Y1)
    p.add(z, z, b)
    p.mul(z, z, z)
    p.sub(z, z, a)
    p.mul(a, b, b)  # HH
    p.sub(z, z, a)  # Z3 = (Z1 + H)^2 - Z1Z1 - HH
    p.add(a, a, a)
    p.add(a, a, a)  # I = 4 HH
    p.mul(b, b, a)  # J = H I
    p.mul(a, x, a)  # V = X1 I
    p.mul(x, c, c)
    p.sub(x, x, b)
    p.sub(x, x, a)
    p.sub(x, x, a)  # X3 = r^2 - J - 2V
    p.sub(a, a, x)
    p.mul(a, c, a)  # r (V - X3)
    p.mul(b, y, b)
    p.add(b, b, b)  # 2 Y1 J
    p.sub(y, a, b)  # Y3


def _add(p: Program) -> None:
    """T = T + Q in place, both Jacobian (add-2007-bl, 12M + 4S)."""
    (x, y, z), (qx, qy, qz), (a, b, c) = T, Q, TMP
    p.mul(a, z, z)  # Z1Z1
    p.mul(b, qz, qz)  # Z2Z2
    p.mul(x, x, b)  # U1
    p.mul(y, y, qz)
    p.mul(y, y, b)  # S1 = Y1 Z2 Z2Z2
    p.mul(b, qx, a)  # U2
    p.mul(c, qy, z)
    p.mul(c, c, a)  # S2 = Y2 Z1 Z1Z1
    p.mul(z, z, qz)  # Z1 Z2
    p.sub(b, b, x)  # H
    p.sub(c, c, y)  # R
    p.mul(z, z, b)  # Z3 = Z1 Z2 H
    p.mul(a, b, b)  # HH
    p.mul(b, b, a)  # HHH
    p.mul(a, x, a)  # V = U1 HH
    p.mul(x, c, c)
    p.sub(x, x, b)
    p.sub(x, x, a)
    p.sub(x, x, a)  # X3 = R^2 - HHH - 2V
    p.sub(a, a, x)
    p.mul(a, c, a)  # R (V - X3)
    p.mul(b, y, b)  # S1 HHH
    p.sub(y, a, b)  # Y3


def _chain(p: Program, add) -> None:
    """T = [|z|] T0 for T0 = T = the addend, MSB first over |z|'s bits."""
    for bit in range(Z_ABS.bit_length() - 2, -1, -1):
        _dbl(p)
        if Z_ABS >> bit & 1:
            add(p)


@functools.lru_cache(maxsize=None)
def program() -> Program:
    p, h = Program(), HOOKS
    # rhs: x -> Montgomery (R^2 first: the product's first operand must be
    # canonical, the plain x need only be below 2^384), rhs = x^3 + 4
    p.mul(h["X"], p.c("R2"), h["XIN"])
    p.mul(2, h["X"], h["X"])
    p.mul(2, 2, h["X"])
    p.add(h["RHS"], 2, p.c("G1_B"))
    p.end_segment()
    # sqrt: slot j holds rhs^(2j + 1), the slot after the table the running power
    acc = 2 ** (WIDTH - 1)
    assert acc < SLOTS and h["RHS"] == 0
    p.mul(acc, 0, 0)
    for j in range(1, acc):
        p.mul(j, j - 1, acc)
    cur = None
    for sq, digit in windows(SQRT_EXP):
        for _ in range(sq):
            p.mul(acc, cur, cur)
            cur = acc
        if digit and cur is None:
            cur = (digit - 1) // 2
        elif digit:
            p.mul(acc, cur, (digit - 1) // 2)
    assert cur == h["Y"]
    p.mul(h["YSQ"], h["Y"], h["Y"])
    p.sub(h["NY"], p.c("ZERO"), h["Y"])
    p.mul(h["YPLAIN"], h["Y"], p.c("ONE_PLAIN"))
    p.end_segment()
    # chains: T = P = Q at the start (written by the kernel)
    _chain(p, _add_mixed)
    for t, q in zip(T, Q):
        p.add(q, t, p.c("ZERO"))  # Q = A
    _chain(p, _add)
    p.end_segment()
    # final: (x, y) in Q's first two slots again (written by the kernel)
    a, b, c = TMP
    p.mul(a, T[2], T[2])  # Z_B^2
    p.mul(b, a, T[2])  # Z_B^3
    p.mul(c, Q[0], p.c("BETA"))
    p.mul(c, c, a)  # beta x Z_B^2
    p.mul(b, Q[1], b)
    p.add(b, T[1], b)  # Y_B + y Z_B^3
    assert (c, b) == (h["BX"], h["SUM"])
    p.end_segment()
    return p


# ---------------------------------------------------------------------------
# The program on integers (tests), and the CUDA table
# ---------------------------------------------------------------------------


def run(p: Program, seg: int, slots: List[int]) -> None:
    """Segment `seg` on the canonical integers in `slots` (in place)."""
    cv = [const_values()[k] for k in CONSTS]
    val = lambda s: slots[s] if s < SLOTS else cv[s - SLOTS]  # noqa: E731
    for kind, d, a, b in p.ops[p.starts[seg] : p.starts[seg + 1]]:
        if kind == MUL:
            slots[d] = val(a) * val(b) * LY.R_INV % P
        elif kind == ADD:
            slots[d] = (val(a) + val(b)) % P
        else:
            slots[d] = (val(a) - val(b)) % P


def simulate(x_plain: int, sign: int) -> Tuple[int, int, bool, bool]:
    """(x, y) in Montgomery form, the lane's verdict (the flag of
    infinity aside) and whether Z_B = 0 (an addition met its exceptional
    case), as csrc/keyvalidate.cu computes them."""
    p, h = program(), HOOKS
    s = [0] * SLOTS
    s[h["XIN"]] = x_plain
    run(p, 0, s)
    x = s[h["X"]]
    run(p, 1, s)
    on_curve = s[h["YSQ"]] == s[h["RHS"]]
    y = s[h["Y"]] if (s[h["YPLAIN"]] > (P - 1) // 2) == bool(sign) else s[h["NY"]]
    s[h["TX"]], s[h["TY"]], s[h["TZ"]], s[h["QX"]], s[h["QY"]] = x, y, LY.R_MOD_P, x, y
    run(p, 2, s)
    s[h["QX"]], s[h["QY"]] = x, y
    run(p, 3, s)
    in_g1 = s[h["BX"]] == s[h["TX"]] and s[h["SUM"]] == 0 and s[h["TZ"]] != 0
    return x, y, on_curve and in_g1, s[h["TZ"]] == 0


def cuda_program() -> str:
    """Text of kv_prog.cuh (`kernels/build.py` writes it beside the build)."""
    p = program()
    words = [k << 30 | d << 20 | a << 10 | b for k, d, a, b in p.ops]
    lines = [
        "// Written at build time by kernels/build.py from",
        "// kernels/kv_program.py cuda_program().",
        "#pragma once",
        "",
        f"// {len(p.ops)} operations, {p.fp_muls} Fp products per lane",
        f"#define LT_KV_SLOTS {SLOTS}",
        f"#define LT_KV_SEGS {len(SEGMENTS)}",
        f"#define LT_KV_Z_ABS 0x{Z_ABS:016x}ull",
        f"#define LT_KV_OP_MUL {MUL}u",
        f"#define LT_KV_OP_ADD {ADD}u",
        f"#define LT_KV_OP_SUB {SUB}u",
    ]
    lines += [f"#define LT_KV_C_{k} {i}u" for i, k in enumerate(CONSTS)]
    lines += [f"#define LT_KV_{k} {v}" for k, v in HOOKS.items()]
    body = ",\n    ".join(", ".join(f"0x{w:08x}u" for w in words[i : i + 8]) for i in range(0, len(words), 8))
    lines += [
        f"LT_PROG uint32_t LT_KV_SEG[{len(p.starts)}] = {{{', '.join(map(str, p.starts))}}};",
        f"LT_PROG uint32_t LT_KV_PROG[{len(words)}] = {{\n    {body}}};",
        "",
    ]
    return "\n".join(lines)
