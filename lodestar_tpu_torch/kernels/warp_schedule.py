"""Warp-per-lane schedules of the Miller loop, the final exponentiation
and the RLC batch's r sig with its G2 subgroup check.

The CUDA pairing kernels (`csrc/miller.cu`, `csrc/final.cu`, `csrc/tail.cu`
`lt_final_one`) and `csrc/randmul.cu lt_g2_rsig_sub` give each lane one
warp.  The lane's values live
in shared memory as Fp "slots"; a kernel runs a program of *phases*, and
in each phase every thread of the warp that has work performs one Fp
operation from operand slots to a result slot, then the warp meets at
`__syncwarp()`.  A *round* is a phase of Montgomery products (at most 32,
one per thread); the adds, subtractions and xi-multiplications between
products run as linear phases, spread over the threads the same way; an
inversion phase runs the one Fp inversion of the final exponentiation on
one thread.

This module writes those programs.  It traces the formulas of the JAX
package's tower, Miller steps, final exponentiation and G2 curve
operations (`lodestar_tpu/kernels/tower.py`, `pairing.py` and
`curve.py`: Karatsuba products, CH-SQR2, Granger-Scott squarings, the
doubling and addition steps with their line scalings, the Jacobian
doubling and additions) into a graph of Fp operations, rebuilds each sum
as a shallow tree (`rebalance`), packs the graph into phases (list
scheduling, the longest chain of products first), gives every value a
slot (a value written in a phase never takes a slot that any operation
of the same phase reads), and emits the tables of `warp_prog.cuh`, the
header that `kernels/build.py` writes from `cuda_programs()` at every
build.
Every Fp value is canonical, so any schedule of the same field
operations gives the same limbs: the formulas fix the Miller value
(which is defined only up to the line scalings) and the Jacobian
triples, and nothing here can change them.

A program is a list of *segments* (straight-line code on fixed slots,
named registers) in the order they run: the final exponentiation
repeats two segments, a cyclotomic squaring and a product by the base,
315 and 25 times; the Miller loop pipelines each bit's line products
with the next bit's doubling step; the r sig kernel's window loop runs it a
segment (a window) at a time and moves the digit's table entry between
them.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Sequence, Tuple

from ..crypto import fields as GT

P = GT.P
R = 1 << 384
R_INV = pow(R, -1, P)
X_ABS = -GT.X_PARAM
WARP = 32

# operation kinds, as the instruction words carry them
MUL, ADD, SUB, INV = 0, 1, 2, 3
SLOT_BITS = 10  # operand and result fields of an instruction word
MAX_SLOTS = 1 << SLOT_BITS
COUNT_BITS, OFFSET_BITS = 11, 21  # fields of a phase word


def mont(v: int) -> int:
    return v % P * R % P


# ---------------------------------------------------------------------------
# Tracing: Fp operations on value ids
# ---------------------------------------------------------------------------


class Trace:
    """A graph of Fp operations.  Values are ints: inputs and results of
    operations count up from 0, constants are negative (-1 - index)."""

    def __init__(self, consts: Dict[str, int]):
        self.const_names = list(consts)
        self.const_vals = [consts[k] for k in self.const_names]
        self.kind: List[int] = []  # -1 for an input
        self.args: List[Tuple[int, int]] = []
        self.seen: Dict[tuple, int] = {}

    def const(self, name: str) -> int:
        return -1 - self.const_names.index(name)

    def input(self) -> int:
        return self._new(-1, (0, 0))

    def _new(self, kind, args) -> int:
        if kind >= 0:  # one value per distinct operation (commuted operands included)
            key = (kind, args if kind == SUB else tuple(sorted(args)))
            if key in self.seen:
                return self.seen[key]
        self.kind.append(kind)
        self.args.append(args)
        if kind >= 0:
            self.seen[key] = len(self.kind) - 1
        return len(self.kind) - 1

    def mul(self, a, b):
        return self._new(MUL, (a, b))

    def add(self, a, b):
        return self._new(ADD, (a, b))

    def sub(self, a, b):
        return self._new(SUB, (a, b))

    def inv_raw(self, a):
        """The plain inverse of a's canonical integer (0 for 0)."""
        return self._new(INV, (a, a))


def apply(kind: int, a: int, b: int) -> int:
    """An operation on Montgomery-form integers (the Python runs' values)."""
    if kind == MUL:
        return a * b * R_INV % P
    if kind == ADD:
        return (a + b) % P
    if kind == SUB:
        return (a - b) % P
    return pow(a, -1, P) if a else 0


# ---------------------------------------------------------------------------
# The tower over a trace (the formulas of lodestar_tpu/kernels/tower.py)
# ---------------------------------------------------------------------------


class Tower:
    """Fp2 = (a0, a1), Fp6 = three Fp2, Fp12 = two Fp6, of value ids."""

    def __init__(self, t: Trace):
        self.t = t
        self.zero = t.const("zero")
        self.one = t.const("one")

    # Fp2
    def add2(self, a, b):
        return (self.t.add(a[0], b[0]), self.t.add(a[1], b[1]))

    def sub2(self, a, b):
        return (self.t.sub(a[0], b[0]), self.t.sub(a[1], b[1]))

    def neg2(self, a):
        return (self.t.sub(self.zero, a[0]), self.t.sub(self.zero, a[1]))

    def dbl2(self, a):
        return self.add2(a, a)

    def conj2(self, a):
        return (a[0], self.t.sub(self.zero, a[1]))

    def xi2(self, a):
        return (self.t.sub(a[0], a[1]), self.t.add(a[0], a[1]))

    def small2(self, a, k):
        if k == 3:
            return self.add2(self.dbl2(a), a)
        acc = a
        while k > 1:
            acc, k = self.dbl2(acc), k >> 1
        return acc

    def mul2(self, a, b):
        t = self.t
        t0, t1 = t.mul(a[0], b[0]), t.mul(a[1], b[1])
        t2 = t.mul(t.add(a[0], a[1]), t.add(b[0], b[1]))
        return (t.sub(t0, t1), t.sub(t.sub(t2, t0), t1))

    def sqr2(self, a):
        t = self.t
        m = t.mul(a[0], a[1])
        return (t.mul(t.add(a[0], a[1]), t.sub(a[0], a[1])), t.add(m, m))

    def mul2_fp(self, a, k):
        return (self.t.mul(a[0], k), self.t.mul(a[1], k))

    def const2(self, name):
        return (self.t.const(name + ".0"), self.t.const(name + ".1"))

    # Fp6
    def add6(self, a, b):
        return tuple(self.add2(x, y) for x, y in zip(a, b))

    def sub6(self, a, b):
        return tuple(self.sub2(x, y) for x, y in zip(a, b))

    def neg6(self, a):
        return tuple(self.neg2(x) for x in a)

    def by_v6(self, a):
        return (self.xi2(a[2]), a[0], a[1])

    def mul6(self, a, b):
        t0, t1, t2 = self.mul2(a[0], b[0]), self.mul2(a[1], b[1]), self.mul2(a[2], b[2])
        m12 = self.mul2(self.add2(a[1], a[2]), self.add2(b[1], b[2]))
        m01 = self.mul2(self.add2(a[0], a[1]), self.add2(b[0], b[1]))
        m02 = self.mul2(self.add2(a[0], a[2]), self.add2(b[0], b[2]))
        c0 = self.add2(t0, self.xi2(self.sub2(self.sub2(m12, t1), t2)))
        c1 = self.add2(self.sub2(self.sub2(m01, t0), t1), self.xi2(t2))
        c2 = self.add2(self.sub2(self.sub2(m02, t0), t2), t1)
        return (c0, c1, c2)

    def sqr6(self, a):
        s0 = self.sqr2(a[0])
        s1 = self.dbl2(self.mul2(a[0], a[1]))
        s2 = self.sqr2(self.add2(self.sub2(a[0], a[1]), a[2]))
        s3 = self.dbl2(self.mul2(a[1], a[2]))
        s4 = self.sqr2(a[2])
        c0 = self.add2(s0, self.xi2(s3))
        c1 = self.add2(s1, self.xi2(s4))
        c2 = self.sub2(self.sub2(self.add2(self.add2(s1, s2), s3), s0), s4)
        return (c0, c1, c2)

    # Fp12
    def one12(self):
        z = (self.zero, self.zero)
        return (((self.one, self.zero), z, z), (z, z, z))

    def mul12(self, a, b):
        t0, t1 = self.mul6(a[0], b[0]), self.mul6(a[1], b[1])
        x = self.mul6(self.add6(a[0], a[1]), self.add6(b[0], b[1]))
        return (self.add6(t0, self.by_v6(t1)), self.sub6(self.sub6(x, t0), t1))

    def sqr12(self, a):
        t = self.mul6(a[0], a[1])
        x = self.mul6(self.add6(a[0], a[1]), self.add6(a[0], self.by_v6(a[1])))
        return (self.sub6(self.sub6(x, t), self.by_v6(t)), self.add6(t, t))

    def conj12(self, a):
        return (a[0], self.neg6(a[1]))

    def frob12(self, a, power):
        """Coefficient of v^i w^j times gamma[2 i + j] (conjugated first
        for odd powers)."""
        out = [[None] * 3 for _ in range(2)]
        for i in range(3):
            for j in range(2):
                c = a[j][i]
                if power & 1:
                    c = self.conj2(c)
                out[j][i] = self.mul2(c, self.const2(f"frob{power}.{2 * i + j}"))
        return (tuple(out[0]), tuple(out[1]))

    def fp4_sqr(self, z0, z1):
        t0, t1 = self.sqr2(z0), self.sqr2(z1)
        tm = self.sqr2(self.add2(z0, z1))
        return self.add2(t0, self.xi2(t1)), self.sub2(self.sub2(tm, t0), t1)

    def cyclo_sqr12(self, a):
        (a0, a1, a2), (b0, b1, b2) = a
        r00, c00 = self.fp4_sqr(a0, b1)
        r01, c01 = self.fp4_sqr(b0, a2)
        r02, c02 = self.fp4_sqr(a1, b2)

        def tsd(t, x):  # 3 t - 2 x
            return self.add2(self.dbl2(self.sub2(t, x)), t)

        def tad(t, x):  # 3 t + 2 x
            return self.add2(self.dbl2(self.add2(t, x)), t)

        lo = (tsd(r00, a0), tsd(r01, a1), tsd(r02, a2))
        hi = (tad(self.xi2(c02), b0), tad(c00, b1), tad(c01, b2))
        return (lo, hi)

    def inv_fp(self, a):
        """a^-1 in Montgomery form: the plain inverse of a R, times R^3."""
        return self.t.mul(self.t.inv_raw(a), self.t.const("r3"))

    def inv2(self, a):
        t = self.t
        n = t.add(t.mul(a[0], a[0]), t.mul(a[1], a[1]))
        ni = self.inv_fp(n)
        return (t.mul(a[0], ni), t.sub(self.zero, t.mul(a[1], ni)))

    def inv6(self, a):
        c0 = self.sub2(self.sqr2(a[0]), self.xi2(self.mul2(a[1], a[2])))
        c1 = self.sub2(self.xi2(self.sqr2(a[2])), self.mul2(a[0], a[1]))
        c2 = self.sub2(self.sqr2(a[1]), self.mul2(a[0], a[2]))
        n = self.add2(self.mul2(a[0], c0), self.xi2(self.add2(self.mul2(a[2], c1), self.mul2(a[1], c2))))
        ni = self.inv2(n)
        return (self.mul2(c0, ni), self.mul2(c1, ni), self.mul2(c2, ni))

    def inv12(self, a):
        t0 = self.inv6(self.sub6(self.sqr6(a[0]), self.by_v6(self.sqr6(a[1]))))
        return (self.mul6(a[0], t0), self.neg6(self.mul6(a[1], t0)))

    # The Miller loop's steps (csrc pairing formulas, after JAX's
    # pairing.py:81 and :109): a sparse line a0 + b1 v w + b2 v^2 w
    def mul_sparse(self, f, line):
        a0, b1, b2 = line
        (f00, f01, f02), (f10, f11, f12) = f
        f0a = (self.mul2(f00, a0), self.mul2(f01, a0), self.mul2(f02, a0))
        f1b = (
            self.xi2(self.add2(self.mul2(f11, b2), self.mul2(f12, b1))),
            self.add2(self.xi2(self.mul2(f12, b2)), self.mul2(f10, b1)),
            self.add2(self.mul2(f10, b2), self.mul2(f11, b1)),
        )
        fm = self.mul6(self.add6(f[0], f[1]), (a0, b1, b2))
        return (self.add6(f0a, self.by_v6(f1b)), self.sub6(self.sub6(fm, f0a), f1b))

    def line_eval(self, e0, e1, e2, pw):
        wy, wx, w1 = pw
        return (self.mul2_fp(e0, wy), self.mul2_fp(e1, w1), self.mul2_fp(e2, wx))

    def dbl_step(self, T, pw):
        X, Y, Z = T
        A, B = self.sqr2(X), self.sqr2(Y)
        CC = self.sqr2(B)
        D = self.dbl2(self.sub2(self.sub2(self.sqr2(self.add2(X, B)), A), CC))
        E = self.small2(A, 3)
        F = self.sqr2(E)
        Z2 = self.sqr2(Z)
        e0 = self.xi2(self.dbl2(self.mul2(Y, self.mul2(Z2, Z))))
        e1 = self.sub2(self.small2(self.mul2(A, X), 3), self.dbl2(B))
        e2 = self.neg2(self.small2(self.mul2(A, Z2), 3))
        ox = self.sub2(F, self.dbl2(D))
        oy = self.sub2(self.mul2(E, self.sub2(D, ox)), self.small2(CC, 8))
        oz = self.dbl2(self.mul2(Y, Z))
        return self.line_eval(e0, e1, e2, pw), (ox, oy, oz)

    def add_step(self, T, q, pw):
        X, Y, Z = T
        Z1Z1 = self.sqr2(Z)
        Z1c = self.mul2(Z, Z1Z1)
        U2, S2 = self.mul2(q[0], Z1Z1), self.mul2(q[1], Z1c)
        H, J = self.sub2(U2, X), self.sub2(S2, Y)
        HH = self.sqr2(H)
        I = self.small2(HH, 4)  # noqa: E741
        JJ = self.mul2(H, I)
        rr = self.dbl2(J)
        V = self.mul2(X, I)
        e0 = self.xi2(self.mul2(H, Z1c))
        e1 = self.sub2(self.mul2(J, X), self.mul2(H, Y))
        e2 = self.neg2(self.mul2(J, Z1Z1))
        ox = self.sub2(self.sub2(self.sqr2(rr), JJ), self.dbl2(V))
        oy = self.sub2(self.mul2(rr, self.sub2(V, ox)), self.dbl2(self.mul2(Y, JJ)))
        oz = self.sub2(self.sub2(self.sqr2(self.add2(Z, H)), Z1Z1), HH)
        return self.line_eval(e0, e1, e2, pw), (ox, oy, oz)

    # G2 curve formulas (lodestar_tpu/kernels/curve.py over FP2_OPS): they
    # fix the Jacobian triples, so they are traced as written there
    def jac_dbl(self, p):  # curve.py jac_dbl
        X, Y, Z = p
        A, B = self.sqr2(X), self.sqr2(Y)
        CC = self.sqr2(B)
        D = self.dbl2(self.sub2(self.sub2(self.sqr2(self.add2(X, B)), A), CC))
        E = self.small2(A, 3)
        X3 = self.sub2(self.sqr2(E), self.dbl2(D))
        Y3 = self.sub2(self.mul2(E, self.sub2(D, X3)), self.small2(CC, 8))
        return (X3, Y3, self.dbl2(self.mul2(Y, Z)))

    def jac_add(self, p, q):  # curve.py jac_add_mixed_or_full: no dispatch
        (X1, Y1, Z1), (X2, Y2, Z2) = p, q
        Z1Z1, Z2Z2 = self.sqr2(Z1), self.sqr2(Z2)
        U1, U2 = self.mul2(X1, Z2Z2), self.mul2(X2, Z1Z1)
        S1 = self.mul2(self.mul2(Y1, Z2), Z2Z2)
        S2 = self.mul2(self.mul2(Y2, Z1), Z1Z1)
        H, R = self.sub2(U2, U1), self.sub2(S2, S1)
        HH = self.sqr2(H)
        HHH, V = self.mul2(H, HH), self.mul2(U1, HH)
        X3 = self.sub2(self.sub2(self.sqr2(R), HHH), self.dbl2(V))
        Y3 = self.sub2(self.mul2(R, self.sub2(V, X3)), self.mul2(S1, HHH))
        return (X3, Y3, self.mul2(self.mul2(Z1, Z2), H))

    def jac_add_mixed(self, p, q):  # curve.py jac_add_mixed, q affine
        (X1, Y1, Z1), (X2, Y2) = p, q
        Z1Z1 = self.sqr2(Z1)
        U2 = self.mul2(X2, Z1Z1)
        S2 = self.mul2(self.mul2(Y2, Z1), Z1Z1)
        H = self.sub2(U2, X1)
        HH = self.sqr2(H)
        I = self.small2(HH, 4)  # noqa: E741
        J = self.mul2(H, I)
        rr = self.dbl2(self.sub2(S2, Y1))
        V = self.mul2(X1, I)
        X3 = self.sub2(self.sub2(self.sqr2(rr), J), self.dbl2(V))
        Y3 = self.sub2(self.mul2(rr, self.sub2(V, X3)), self.dbl2(self.mul2(Y1, J)))
        return (X3, Y3, self.sub2(self.sub2(self.sqr2(self.add2(Z1, H)), Z1Z1), HH))

    def psi(self, p):  # curve.py g2_psi
        X, Y, Z = p
        return (self.mul2(self.conj2(X), self.const2("psi_cx")), self.mul2(self.conj2(Y), self.const2("psi_cy")),
                self.conj2(Z))

    def jac_eq_terms(self, p, q):
        """curve.py jac_eq's cross products (X1 Z2^2, X2 Z1^2, Y1 Z2^3,
        Y2 Z1^3): the points are equal iff the pairs are."""
        (X1, Y1, Z1), (X2, Y2, Z2) = p, q
        Z1Z1, Z2Z2 = self.sqr2(Z1), self.sqr2(Z2)
        return (self.mul2(X1, Z2Z2), self.mul2(X2, Z1Z1), self.mul2(self.mul2(Y1, Z2), Z2Z2),
                self.mul2(self.mul2(Y2, Z1), Z1Z1))


def flat12(f) -> List[int]:
    """Fp12 value ids in the JAX package's leaf order k = 6 h + 2 i + j."""
    return [f[h][i][j] for h in range(2) for i in range(3) for j in range(2)]


def unflat12(v: Sequence[int]):
    return tuple(tuple((v[6 * h + 2 * i], v[6 * h + 2 * i + 1]) for i in range(3)) for h in range(2))


def _consts(with_frob: bool) -> Dict[str, int]:
    c = {"zero": 0, "one": mont(1)}
    if with_frob:
        c["r3"] = mont(R * R % P)  # R^3 mod p: the inverse's conversion
        for power in (1, 2):
            for k in range(6):
                g = GT.fp2_pow(GT.XI, k * (P**power - 1) // 6)
                c[f"frob{power}.{k}.0"], c[f"frob{power}.{k}.1"] = mont(g[0]), mont(g[1])
    return c


# ---------------------------------------------------------------------------
# Scheduling and slot allocation
# ---------------------------------------------------------------------------


class Segment:
    """One straight-line program on fixed slots.  A phase is WARP queues,
    one per thread, of (kind, dst, a, b) slot operations that the thread
    runs in order; operands >= `CONST` are constants (index operand -
    CONST)."""

    def __init__(self, name, phases, temps):
        self.name, self.phases, self.temps = name, phases, temps

    def _ops(self, ph):
        return [op for q in ph for op in q]

    @property
    def rounds(self) -> int:
        return sum(1 for ph in self.phases if any(op[0] in (MUL, INV) for op in self._ops(ph)))

    @property
    def fp_muls(self) -> int:
        return sum(1 for ph in self.phases for op in self._ops(ph) if op[0] == MUL)


CONST = 1 << 20  # operand tag of a constant until the slot count is known


PRODUCT_DEPTH = 6  # a product's latency in linear operations (~3,000 against ~500 cycles on the H100)


def rebalance(t: Trace, ins: Dict[int, int], outs: Sequence[Tuple[int, int]]):
    """The same values with shallower chains of adds: (trace, ins, outs).

    A linear value that something other than one linear operation reads
    (a product or the inversion, an output, two or more operations) is a
    root; every root is rebuilt from its leaves (products, inversions,
    inputs, constants and other roots) as a signed sum with integer
    coefficients, combined earliest-ready pair first, so a root waits on
    log2 of its terms rather than the formula's chain.  The sums are the
    same field elements, and every value is canonical, so the limbs do not
    change."""
    n = len(t.kind)
    need = [False] * n
    stack = [v for v, _ in outs if v >= 0]
    while stack:
        v = stack.pop()
        if not need[v]:
            need[v] = True
            if t.kind[v] >= 0:
                stack.extend(a for a in t.args[v] if a >= 0)
    linear = lambda v: v >= 0 and t.kind[v] in (ADD, SUB)  # noqa: E731
    readers = [0] * n
    root = [False] * n
    for v in range(n):
        if need[v] and t.kind[v] >= 0:
            for a in set(t.args[v]):
                if a >= 0:
                    readers[a] += 1
                    if not linear(v):
                        root[a] = True
    for v, _ in outs:
        if v >= 0:
            root[v] = True
    for v in range(n):
        root[v] = root[v] or readers[v] > 1
    new = Trace(dict(zip(t.const_names, t.const_vals)))
    zero = new.const("zero")
    vmap: Dict[int, int] = {}
    level: Dict[int, int] = {}

    def mapped(a):
        return a if a < 0 else vmap[a]

    def lvl(a):
        return 0 if a < 0 else level.get(a, 0)

    combos: Dict[int, Dict[int, int]] = {}

    def combo(v) -> Dict[int, int]:
        """v's signed sum over leaves (old ids, constants negative)."""
        if not linear(v) or (root[v] and v in vmap):
            return {v: 1}
        if v not in combos:
            a, b = (combo(x) for x in t.args[v])
            out = dict(a)
            for leaf, c in b.items():
                out[leaf] = out.get(leaf, 0) + (c if t.kind[v] == ADD else -c)
            combos[v] = {k: c for k, c in out.items() if c and k != zero}
        return combos[v]

    def build(terms: Dict[int, int]) -> int:
        heap, count = [], 0
        for leaf, c in sorted(terms.items()):
            for _ in range(abs(c)):
                heap.append((lvl(mapped(leaf)), count, c > 0, mapped(leaf)))
                count += 1
        if not heap:
            return zero
        heapq.heapify(heap)
        while len(heap) > 1:
            la, _, pa, a = heapq.heappop(heap)
            lb, _, pb, b = heapq.heappop(heap)
            if pa == pb:
                v, pos = new.add(a, b), pa
            else:
                v, pos = (new.sub(a, b), True) if pa else (new.sub(b, a), True)
            level[v] = max(la, lb) + 1
            heapq.heappush(heap, (level[v], count, pos, v))
            count += 1
        lv, _, pos, v = heap[0]
        if not pos:
            v = new.sub(zero, v)
            level[v] = lv + 1
        return v

    for v in range(n):
        if not need[v]:
            continue
        if t.kind[v] < 0:
            vmap[v] = new.input()
        elif not linear(v):
            a, b = (mapped(x) for x in t.args[v])
            vmap[v] = new._new(t.kind[v], (a, b))
            level[vmap[v]] = max(lvl(a), lvl(b)) + PRODUCT_DEPTH
        elif root[v]:
            vmap[v] = build(combo(v))
    return (new, {vmap[v]: s for v, s in ins.items() if need[v]},
            [(mapped(v), s) for v, s in outs])


def schedule(name: str, t: Trace, ins: Dict[int, int], outs: Sequence[Tuple[int, int]], nfix: int) -> Segment:
    """Phases and slots of the trace's operations that the outputs need.

    ins: input value -> its fixed slot; outs: (value, fixed slot) pairs;
    slots below `nfix` are fixed (the program's state, never temporaries).

    The graph is first rebalanced (`rebalance`).  A phase then takes
    every ready linear operation, spread over the threads (a thread runs
    its share in order), or, when there is none, the inversion or up to
    WARP ready products, one per thread, the longest chain of products to
    an output first.  (Running a chain of adds on one thread within a
    product's phase saves a phase but lengthens that thread: on the H100 a
    linear operation costs ~500 cycles, a product ~2,950, and the card
    times of both programs were best without it.)"""
    t, ins, outs = rebalance(t, ins, outs)
    n = len(t.kind)
    need = [False] * n
    stack = [v for v, _ in outs if v >= 0]
    while stack:
        v = stack.pop()
        if need[v]:
            continue
        need[v] = True
        if t.kind[v] >= 0:
            stack.extend(a for a in t.args[v] if a >= 0)
    users: List[List[int]] = [[] for _ in range(n)]
    for v in range(n):
        if need[v] and t.kind[v] >= 0:
            for a in set(t.args[v]):
                if a >= 0:
                    users[a].append(v)
    # height: the longest chain of products (and the inversion) to an output
    height = [0] * n
    for v in range(n - 1, -1, -1):
        if need[v] and users[v]:
            height[v] = max(height[u] + (t.kind[u] in (MUL, INV)) for u in users[v])
    lane = lambda kind: ADD if kind in (ADD, SUB) else kind  # noqa: E731
    waiting = [0] * n
    ready: Dict[int, list] = {MUL: [], ADD: [], INV: []}
    for v in range(n):
        if not need[v]:
            continue
        if t.kind[v] < 0:
            assert v in ins, f"{name}: input {v} has no slot"
            continue
        waiting[v] = sum(1 for a in set(t.args[v]) if a >= 0 and t.kind[a] >= 0)
        if waiting[v] == 0:
            heapq.heappush(ready[lane(t.kind[v])], (-height[v], v))
    phase_of = {v: -1 for v in ins}
    phases: List[List[List[int]]] = []

    def take(kind, limit=None):
        q, out = ready[kind], []
        while q and (limit is None or len(out) < limit):
            out.append(heapq.heappop(q)[1])
        return out

    while any(ready.values()):
        # every ready linear operation first, then the inversion, then a
        # round of products; operation i of a phase runs on thread i % WARP
        ops = take(ADD) or take(INV) or take(MUL, WARP)
        phases.append([ops[th::WARP] for th in range(WARP)])
        for v in ops:
            phase_of[v] = len(phases) - 1
        for v in ops:
            for u in users[v]:
                waiting[u] -= 1
                if waiting[u] == 0:
                    heapq.heappush(ready[lane(t.kind[u])], (-height[u], u))
    assert all(v in phase_of for v in range(n) if need[v]), f"{name}: unscheduled operations"

    # slots: a value lives from the phase that writes it to its last read
    end = len(phases)
    last = {v: phase_of[v] for v in phase_of}
    for v, k in phase_of.items():
        if t.kind[v] >= 0:
            for a in t.args[v]:
                if a >= 0:
                    last[a] = max(last[a], k)
    out_slots: Dict[int, List[int]] = {}
    for v, s in outs:
        out_slots.setdefault(v, []).append(s)
        if v >= 0:
            last[v] = end
    slot_of = dict(ins)
    fixed_free = {s: 0 for s in range(nfix)}  # first phase each fixed slot may be written in
    for v, s in ins.items():
        fixed_free[s] = last[v] + 1
    temp_free: List[int] = []  # the same for each temporary
    for k, queues in enumerate(phases):
        for q in queues:
            for v in q:
                placed_at = None
                for s in out_slots.get(v, []):
                    if placed_at is None and fixed_free[s] <= k:
                        placed_at = s
                        fixed_free[s] = end + 1
                if placed_at is None:
                    i = next((i for i, free in enumerate(temp_free) if free <= k), len(temp_free))
                    if i == len(temp_free):
                        temp_free.append(0)
                    placed_at = nfix + i
                    temp_free[i] = last[v] + 1
                slot_of[v] = placed_at

    def operand(v):
        return CONST + (-1 - v) if v < 0 else slot_of[v]

    prog = [[[(t.kind[v], slot_of[v], operand(t.args[v][0]), operand(t.args[v][1])) for v in q] for q in queues]
            for queues in phases]
    # the outputs not made in place, as parallel copies (x + 0): a copy
    # whose target another pending copy still reads waits; a cycle goes
    # through a temporary
    zero = operand(t.const("zero"))
    pending = [(s, operand(v)) for v, slots in out_slots.items() for s in slots if v < 0 or slot_of[v] != s]
    while pending:
        srcs = {src for _, src in pending}
        now = [(d, src) for d, src in pending if d not in srcs]
        if not now:
            src = pending[0][1]
            tmp = nfix + len(temp_free)
            temp_free.append(0)
            now, pending = [(tmp, src)], [(d, tmp if x == src else x) for d, x in pending]
        else:
            pending = [m for m in pending if m not in now]
        prog.append([[(ADD, d, src, zero) for d, src in now[th::WARP]] for th in range(WARP)])
    seg = Segment(name, prog, len(temp_free))
    check_hazards(seg)
    return seg


def check_hazards(seg: Segment) -> None:
    """No thread of a phase writes a slot that another thread of the
    phase reads or writes, and no slot is written twice in a phase: the
    threads may run in any order."""
    for k, ph in enumerate(seg.phases):
        writes = [d for q in ph for _, d, _, _ in q]
        assert len(set(writes)) == len(writes), f"{seg.name} phase {k}: two writes to one slot"
        for th, q in enumerate(ph):
            mine = {d for _, d, _, _ in q}
            others = {x for o, q2 in enumerate(ph) if o != th for op in q2 for x in op[1:]}
            assert not mine & others, f"{seg.name} phase {k}: thread {th} writes a slot another thread uses"
        assert sum(op[0] == MUL for q in ph for op in q[:1]) == sum(op[0] == MUL for q in ph for op in q)


def simulate(segs: Sequence[Segment], order: Sequence[int], nslots: int, consts: Sequence[int],
             state: Dict[int, int], reverse: bool = False) -> Dict[int, int]:
    """Run the segments `order` on slot values (Python ints), one virtual
    thread after another, forwards or reversed."""
    slots = [0] * nslots
    for s, v in state.items():
        slots[s] = v
    get = lambda x: consts[x - CONST] if x >= CONST else slots[x]  # noqa: E731
    for i in order:
        for ph in segs[i].phases:
            for q in (reversed(ph) if reverse else ph):
                for kind, d, a, b in q:
                    slots[d] = apply(kind, get(a), get(b))
    return {s: slots[s] for s in range(nslots)}


# ---------------------------------------------------------------------------
# The two programs
# ---------------------------------------------------------------------------


class Program:
    """Segments, the order they run in, slot counts and the state map."""

    def __init__(self, name, trace_consts, segs, order, nfix, io):
        self.name = name
        self.consts = trace_consts
        self.segs, self.order, self.nfix, self.io = segs, order, nfix, io
        self.nslots = nfix + max(s.temps for s in segs)
        assert self.nslots + len(self.consts) < MAX_SLOTS  # all ones is the empty place (NOP)

    @property
    def rounds(self) -> int:
        return sum(self.segs[i].rounds for i in self.order)

    @property
    def fp_muls(self) -> int:
        return sum(self.segs[i].fp_muls for i in self.order)

    @property
    def phases(self) -> int:
        return sum(len(self.segs[i].phases) for i in self.order)

    def run(self, state: Dict[int, int], reverse=False) -> Dict[int, int]:
        return simulate(self.segs, self.order, self.nslots, self.consts, state, reverse)


class _Segments:
    """Segments over named registers: `layout` gives each register's
    first fixed slot and its number of Fp values."""

    def __init__(self, consts: Dict[str, int], layout: Dict[str, Tuple[int, int]]):
        self.consts, self.layout = consts, layout
        self.nfix = max(a + n for a, n in layout.values())
        self.segs: List[Segment] = []
        self.index: Dict[str, int] = {}

    def add(self, name, body, ins, outs):
        """body(tower, {register: [value ids]}) -> {register: [value ids]}."""
        t = Trace(self.consts)
        regs = {r: [t.input() for _ in range(self.layout[r][1])] for r in ins}
        result = body(Tower(t), regs)
        assert sorted(result) == sorted(outs), name
        smap = {v: self.layout[r][0] + k for r in ins for k, v in enumerate(regs[r])}
        omap = [(v, self.layout[r][0] + k) for r, vals in result.items() for k, v in enumerate(vals)]
        self.index[name] = len(self.segs)
        self.segs.append(schedule(name, t, smap, omap, self.nfix))

    def program(self, name, order, io) -> Program:
        return Program(name, list(self.consts.values()), self.segs, [self.index[s] for s in order], self.nfix,
                       {k: self.layout[r][0] if isinstance(r, str) else r for k, r in io.items()})


def _pairs(v):
    return tuple((v[2 * i], v[2 * i + 1]) for i in range(len(v) // 2))


def _flat(pairs):
    return [x for pair in pairs for x in pair]


MILLER_LAYOUT = {"P": (0, 3), "Q": (3, 4), "W": (7, 2), "F0": (9, 12), "T0": (21, 6), "L0": (27, 6),
                 "F1": (33, 12), "T1": (45, 6), "L1": (51, 6)}


def miller_program() -> Program:
    """f_{|x|,Q}(P) conjugated: 63 doubling steps and 5 addition steps
    (lodestar_tpu/kernels/pairing.py's loop), software-pipelined over
    segments: the segment of bit b squares f and multiplies in bit b's
    doubling line (and runs the addition step if b is set) while it makes
    bit b - 1's doubling line, so the line's chain of products overlaps
    the accumulator's.  Registers: P (X, Y, Z), Q (x, y), f, T, the
    pending line L, and W = (X Z, Z^3) of the line evaluation."""
    sg = _Segments(_consts(False), MILLER_LAYOUT)

    def pw(r):
        return (r["P"][1], r["W"][0], r["W"][1])  # (Y1, X1 Z1, Z1^3)

    def dbl(tw, T, r):
        line, T = tw.dbl_step(_pairs(T), pw(r))
        return _flat(line), _flat(T)

    def pro(tw, r):
        px, _, pz = r["P"]
        r = dict(r, W=[tw.t.mul(px, pz), tw.t.mul(tw.t.mul(pz, pz), pz)])
        line, T = dbl(tw, r["Q"] + [tw.one, tw.zero], r)
        return {"W": r["W"], "T": T, "L": line, "F": flat12(tw.one12())}

    def step(tw, r, add):
        f = tw.mul_sparse(tw.sqr12(unflat12(r["F"])), _pairs(r["L"]))
        T = r["T"]
        if add:
            line, T = tw.add_step(_pairs(T), _pairs(r["Q"]), pw(r))
            f, T = tw.mul_sparse(f, line), _flat(T)
        line, T = dbl(tw, T, r)
        return {"F": flat12(f), "T": T, "L": line}

    def epi(tw, r):
        return {"F": flat12(tw.conj12(tw.mul_sparse(tw.sqr12(unflat12(r["F"])), _pairs(r["L"]))))}

    def renamed(body, src, dst):
        """body on registers F, T, L read from parity src, written to dst."""
        def run(tw, r):
            r = {(k[0] if k[:1] in ("F", "T", "L") else k): v for k, v in r.items()}
            return {(k + dst if k in ("F", "T", "L") else k): v for k, v in body(tw, r).items()}
        return run

    sg.add("pro", renamed(pro, "0", "0"), ("P", "Q"), ("W", "T0", "L0", "F0"))
    for src, dst in (("0", "1"), ("1", "0")):
        state = ("F" + src, "T" + src, "L" + src)
        sg.add("dbl" + src, renamed(lambda tw, r: step(tw, r, False), src, dst), state + ("P", "W"),
               ("F" + dst, "T" + dst, "L" + dst))
        sg.add("dbl_add" + src, renamed(lambda tw, r: step(tw, r, True), src, dst), state + ("P", "Q", "W"),
               ("F" + dst, "T" + dst, "L" + dst))
    sg.add("epi", renamed(epi, "0", "0"), ("F0", "L0"), ("F0",))
    # f, T and the pending line alternate between two sets of registers, so
    # a step writes its results in place of nothing it reads (no copies)
    order, parity = ["pro"], 0
    for b in range(62, 0, -1):
        order.append(("dbl_add" if (X_ABS >> b) & 1 else "dbl") + str(parity))
        parity ^= 1
    assert parity == 0 and not X_ABS & 1
    return sg.program("MILLER", order + ["epi"], {"P": "P", "Q": "Q", "F": "F0"})


# the final exponentiation's Fp12 registers (12 fixed slots each)
FINAL_LAYOUT = {r: (12 * i, 12) for i, r in enumerate(("A", "B", "M", "ACC", "BASE", "T1", "ACC1"))}
FINAL_LAYOUT["OUT"] = FINAL_LAYOUT["A"]


def final_program() -> Program:
    """(A B)^(3 (p^12 - 1) / r): the easy part, then the hard part's
    (x-1)^2 (x+p) (x^2+p^2-1) + 3 chain, in segments over Fp12 registers
    (lodestar_tpu/kernels/pairing.py's final_exponentiation).  Each
    power by x is a setup (ACC = BASE = its base), 63 cyclotomic squarings
    of ACC with 5 products ACC * BASE, and the conjugate."""
    consts = _consts(True)
    sg = _Segments(consts, FINAL_LAYOUT)

    def seg(name, body, ins, outs):
        def flat_body(tw, r):
            return {k: flat12(v) for k, v in body(tw, {k: unflat12(v) for k, v in r.items()}).items()}
        sg.add(name, flat_body, ins, outs)

    def easy(tw, r):
        f = tw.mul12(r["A"], r["B"])
        g = tw.mul12(tw.conj12(f), tw.inv12(f))
        m = tw.mul12(tw.frob12(g, 2), g)
        return {"M": m, "ACC": m, "BASE": m}

    def g1(tw, r):  # m^(x-1)
        t1 = tw.mul12(tw.conj12(r["ACC"]), tw.conj12(r["M"]))
        return {"T1": t1, "ACC": t1, "BASE": t1}

    def g2(tw, r):  # m^((x-1)^2)
        t1 = tw.mul12(tw.conj12(r["T1"]), tw.conj12(r["ACC"]))
        return {"T1": t1, "ACC": t1, "BASE": t1}

    def g3(tw, r):  # m^((x-1)^2 (p+x))
        t1 = tw.mul12(tw.frob12(r["T1"], 1), tw.conj12(r["ACC"]))
        return {"T1": t1, "ACC": t1, "BASE": t1}

    def g4(tw, r):  # t1^x
        t0 = tw.conj12(r["ACC"])
        return {"ACC": t0, "BASE": t0}

    def g5(tw, r):  # t1^(x^2 + p^2 - 1) m^3
        t1 = tw.mul12(tw.mul12(tw.conj12(r["T1"]), tw.conj12(r["ACC"])), tw.frob12(r["T1"], 2))
        m3 = tw.mul12(r["M"], tw.cyclo_sqr12(r["M"]))
        return {"OUT": tw.mul12(t1, m3)}

    seg("easy", easy, ("A", "B"), ("M", "ACC", "BASE"))
    # the power's accumulator alternates between ACC and ACC1, so a step
    # writes its result in place of nothing it reads (no copies)
    for src, dst in (("ACC", "ACC1"), ("ACC1", "ACC")):
        seg("cyclo_sqr_" + src, lambda tw, r, src=src, dst=dst: {dst: tw.cyclo_sqr12(r[src])}, (src,), (dst,))
        seg("mul_base_" + src, lambda tw, r, src=src, dst=dst: {dst: tw.mul12(r[src], r["BASE"])}, (src, "BASE"),
            (dst,))
    seg("g1", g1, ("ACC", "M"), ("T1", "ACC", "BASE"))
    seg("g2", g2, ("ACC", "T1"), ("T1", "ACC", "BASE"))
    seg("g3", g3, ("ACC", "T1"), ("T1", "ACC", "BASE"))
    seg("g4", g4, ("ACC",), ("ACC", "BASE"))
    seg("g5", g5, ("ACC", "T1", "M"), ("OUT",))
    pow_x, acc = [], "ACC"
    for bit in range(62, -1, -1):
        for step in ("cyclo_sqr", "mul_base") if (X_ABS >> bit) & 1 else ("cyclo_sqr",):
            pow_x.append(f"{step}_{acc}")
            acc = "ACC1" if acc == "ACC" else "ACC"
    assert acc == "ACC"  # 68 steps: the power ends where it began
    order = ["easy"]
    for glue in ("g1", "g2", "g3", "g4", "g5"):
        order += pow_x + [glue]
    return sg.program("FINAL", order, {"A": "A", "B": "B", "OUT": "OUT", "R3": list(consts).index("r3")})


RAND_BITS, WINDOW = 128, 4  # the RLC scalars (kernels/verify.py)
WINDOWS = RAND_BITS // WINDOW
# the r sig program's registers: the affine signature Q, the table
# {Q .. 15 Q}, the accumulator T (two sets, alternating), the window's
# addend, T after the window's doublings, the subgroup check's chain S
# (alternating) and jac_eq's cross products
RSIG_LAYOUT = {"Q": (0, 4), "TBL": (4, 90), "T0": (94, 6), "T1": (100, 6), "ADD": (106, 6), "DBL": (112, 6),
               "S0": (118, 6), "S1": (124, 6), "EQ": (130, 8)}


def _psi_consts() -> Dict[str, int]:
    u = (0, 1)
    c = {}
    for name, e in (("psi_cx", 2 * (P - 1) // 3), ("psi_cy", (P - 1) // 2)):
        v = GT.fp2_mul(u, GT.fp2_pow(GT.XI, e))
        c[name + ".0"], c[name + ".1"] = mont(v[0]), mont(v[1])
    return c


def subgroup_bits(t: int) -> List[int]:
    """The bits of |x| whose steps (a doubling, then a mixed addition of Q
    where the bit is set) window t of the r sig program runs: two per
    window from bit 62 down, the last window bit 0 alone."""
    return [b for b in (62 - 2 * t, 61 - 2 * t) if b >= 0]


def rsig_program() -> Program:
    """r Q for a lane's 128-bit scalar r (lodestar_tpu/kernels/curve.py
    scalar_mul_window_jac over Fp2, 4-bit windows) and the G2 subgroup
    check of Q (g2_subgroup_check), as segments that the kernel's
    window loop (csrc/randmul.cu) runs one at a time: the table {Q .. 15 Q}, then for
    each of the 32 windows one segment of four doublings of T and the
    addition of the window's entry (which the loop copies into ADD
    beforehand, by the lane's digit), writing T doubled to DBL and the sum
    to the other T register; the loop then keeps DBL (digit 0), ADD (the
    accumulator still infinity) or the sum.  The subgroup check's static
    chain by |x| (63 doublings, 5 mixed additions) rides in the windows'
    idle threads, two steps per window (`subgroup_bits`); the last window
    adds psi(Q) and jac_eq's cross products against -[|x|] Q, which the
    kernel compares."""
    sg = _Segments(dict(_consts(False), **_psi_consts()), RSIG_LAYOUT)

    def q_jac(tw, r):
        x, y = _pairs(r["Q"])
        return (x, y, (tw.one, tw.zero))

    def table(tw, r):
        q = q_jac(tw, r)
        tbl = [q]
        for m in range(2, 1 << WINDOW):
            tbl.append(tw.jac_dbl(tbl[m // 2 - 1]) if m % 2 == 0 else tw.jac_add(tbl[m - 2], q))
        return {"TBL": [x for e in tbl for x in _flat(e)], "T0": _flat(q), "S0": _flat(q)}

    def window(src, dst, bits, last):
        def body(tw, r):
            T = _pairs(r["T" + src])
            for _ in range(WINDOW):
                T = tw.jac_dbl(T)
            out = {"DBL": _flat(T), "T" + dst: _flat(tw.jac_add(T, _pairs(r["ADD"])))}
            S, qa = _pairs(r["S" + src]), _pairs(r["Q"])
            for b in bits:
                S = tw.jac_dbl(S)
                if (X_ABS >> b) & 1:
                    S = tw.jac_add_mixed(S, qa)
            if last:
                neg = (S[0], tw.neg2(S[1]), S[2])
                out["EQ"] = _flat(tw.jac_eq_terms(tw.psi(q_jac(tw, r)), neg))
            else:
                out["S" + dst] = _flat(S)
            return out
        return body

    sg.add("table", table, ("Q",), ("TBL", "T0", "S0"))
    order = ["table"]
    for t in range(WINDOWS):
        src, dst = str(t % 2), str(1 - t % 2)
        bits, last = subgroup_bits(t), t == WINDOWS - 1
        name = f"win{src}_" + ("fin" if last else "".join("a" if (X_ABS >> b) & 1 else "d" for b in bits))
        if name not in sg.index:
            outs = ("DBL", "T" + dst) + (("EQ",) if last else ("S" + dst,))
            sg.add(name, window(src, dst, bits, last), ("T" + src, "ADD", "S" + src, "Q"), outs)
        order.append(name)
    assert X_ABS >> 63 == 1 and sum(len(subgroup_bits(t)) for t in range(WINDOWS)) == 63
    return sg.program("RSIG", order, {r: r for r in RSIG_LAYOUT})


def programs() -> List[Program]:
    return [miller_program(), final_program(), rsig_program()]


# ---------------------------------------------------------------------------
# The CUDA tables
# ---------------------------------------------------------------------------


NOP = 0xFFFFFFFF  # an empty place in a phase's rows


def encode(prog: Program) -> Tuple[List[int], List[int]]:
    """Phase words (count << 21 | offset) in the order they run, and the
    instruction words (kind << 30 | dst << 20 | a << 10 | b) of each
    distinct segment once.  A phase's words are rows of WARP: thread t
    runs words t, t + WARP, ... (NOP where its queue is shorter)."""
    ins, seg_phases = [], []
    for seg in prog.segs:
        words = []
        for ph in seg.phases:
            rows = max(len(q) for q in ph)
            last = max(th for th, q in enumerate(ph) if len(q) == rows)
            count = (rows - 1) * WARP + last + 1
            words.append(count << OFFSET_BITS | len(ins))
            for i in range(count):
                r, th = divmod(i, WARP)
                if r < len(ph[th]):
                    kind, d, a, b = ph[th][r]
                    a, b = (x - CONST + prog.nslots if x >= CONST else x for x in (a, b))
                    ins.append(kind << 30 | d << 20 | a << 10 | b)
                else:
                    ins.append(NOP)
        seg_phases.append(words)
    assert len(ins) < 1 << OFFSET_BITS
    assert max(w >> OFFSET_BITS for ws in seg_phases for w in ws) < 1 << COUNT_BITS
    return [w for i in prog.order for w in seg_phases[i]], ins


def _words(ws, per_line=8) -> str:
    rows = [", ".join(f"0x{w:08x}u" for w in ws[i:i + per_line]) for i in range(0, len(ws), per_line)]
    return "{\n    " + ",\n    ".join(rows) + "}"


def cuda_programs() -> str:
    """Text of warp_prog.cuh (`kernels/build.py` writes it beside the
    build).  A kernel source defines LT_WANT_MILLER, LT_WANT_FINAL or
    LT_WANT_RSIG before including it and compiles that program's tables
    only."""
    lines = [
        "// Written at build time by kernels/build.py from",
        "// kernels/warp_schedule.py cuda_programs().",
        "#pragma once",
        "",
    ]
    for prog in programs():
        phases, ins = encode(prog)
        n = prog.name
        lines += [
            f"// {n}: {prog.rounds} rounds ({prog.fp_muls} Fp products) in {prog.phases} phases per lane",
            f"#ifdef LT_WANT_{n}",
            f"#define LT_{n}_SLOTS {prog.nslots}",
            f"#define LT_{n}_CONSTS {len(prog.consts)}",
            f"#define LT_{n}_PHASES {len(phases)}",
            f"#define LT_{n}_ROUNDS {prog.rounds}",
        ]
        lines += [f"#define LT_{n}_{k} {v}" for k, v in prog.io.items()]
        body = ", ".join("{" + ", ".join(f"0x{(c >> (32 * i)) & 0xFFFFFFFF:08x}u" for i in range(12)) + "}"
                         for c in prog.consts)
        lines += [
            f"LT_PROG uint32_t LT_{n}_CONST[{len(prog.consts)}][12] = {{{body}}};",
            f"LT_PROG uint32_t LT_{n}_PHASE[{len(phases)}] = {_words(phases)};",
            f"LT_PROG uint32_t LT_{n}_INS[{len(ins)}] = {_words(ins)};",
        ]
        starts = [0]  # where each segment's phases start, in the order they run, and the end
        for i in prog.order:
            starts.append(starts[-1] + len(prog.segs[i].phases))
        lines.append(f"LT_PROG uint32_t LT_{n}_SEG[{len(starts)}] = {_words(starts)};")
        lines += [f"#endif  // LT_WANT_{n}", ""]
    return "\n".join(lines)

