"""BLS verification on the device: the kernels and the paths that drive
them.

Counterpart of `lodestar_tpu/kernels/verify.py` and of the kernels of
`lodestar_tpu/kernels/ingest.py`.  The per-set path, `verify_each_device`
(`:922`, `_each_core` `:1092`): one job of N padded sets, H(m) and sig
as plain limbs, runs

    [gather]           K = 1: pubkey rows, torch.index_select  (_gather_pk)
    agg_pk             K > 1: masked sum of each set's K keys  (_k_agg_pk)
    [substitute]       dead lanes -> generators, torch.where   (_j_substitute)
    g2_subgroup_check  H(m), sig -> Montgomery                 (_k_mont8)
                       and psi(sig) == -[|x|] sig per lane     (_k_sub_only)
    miller_loop x 2    (pk, H(m)) and (-G1, sig) per lane      (_k_miller)
    each_final         f1 f2 -> final exp -> is-one per lane   (_k_each_final)

The RLC batch path, `verify_batch_device` (`:383`, `_batch_core` `:615`):
one multi-pairing check prod_i e(r_i pk_i, H_i) e(-G1, sum_i r_i sig_i)
== 1 with random odd 128-bit r_i, N + 1 Miller lanes and one final
exponentiation:

    [gather] or agg_pk, [substitute]   as above
    g1_rpk             r_i pk_i per lane                      (_k_g1_rpk)
    g2_rsig_sub        H(m), sig -> Montgomery                (_k_mont8)
                       r_i sig_i and the subgroup check       (_k_g2_rsig_sub)
    sum_g2             sum of the live r_i sig_i -> A         (_k_sum_g2 + _j_sum_lanes)
    miller_loop        (r_i pk_i, H_i), N lanes               (_k_miller)
    prod12             product of the live lanes              (_k_prod + _j_product12)
    affine_g2          A -> affine, O -> generator            (_k_affine_g2)
    miller_loop        (-G1, A), ONE lane                     (_k_miller)
    final_one          prod f_A -> final exp -> is-one        (_k_final_one)
    [verdict]          torch ops                              (_j_batch_verdict)

The wire paths, `verify_batch_device_wire` (`:417`) and
`verify_each_device_wire` (`:945`), take the signatures as they arrive
(the compressed x and the sign and infinity bits) and run before the
paths above

    g2_decompress      4 planes of H(m) -> Montgomery          (_k_mont4)
                       wire x -> (x, y) by an Fp2 square root  (_k_g2_decompress)

the paths above then taking Montgomery points (g2_subgroup_check and
g2_rsig_sub skip their ingest), and `hash_g2` (`_k_hash_g2`) hashes signing roots to G2 for
`bls/ingest.py MessageCache`.

The message-grouped wire batch, `verify_batch_device_wire_grouped`
(`:804`, `_batch_local_grouped` `:739`), takes a job sorted by signing
root and replaces the N-lane Miller loop by one per distinct root:

    seg_sum_g1         r_i pk_i summed per message group        (_j_seg_sum_g1)
    [group heads]      totals and messages onto one BT-lane tile (_j_group_heads)
    miller_loop        (group total, H(m)), BT lanes             (_k_miller)

Pre-verify signature aggregation, `aggregate_g2_sum_device` (`:883`):

    g2_decompress      wire x -> (x, y), no messages            (_k_g2_decompress)
    seg_sum_g2         signatures summed per group               (_j_seg_sum_g2)
    [agg heads]        group totals onto one BT-lane tile        (_j_agg_heads)
    affine_g2          totals -> affine                          (_k_affine_g2)

and `g1_keyvalidate` (`_k_g1_keyvalidate`) decompresses and validates
pubkeys for `bls/pubkey_table.py PubkeyTable.register_compressed`.

Each kernel wrapper checks its operands, then runs the hand-written CUDA
kernel (`csrc/*.cu`) for CUDA tensors or the kernel's plain torch version
for CPU tensors; any other device raises.  There is no fallback from one
to the other.  `LAUNCHES[name]` counts the wrapper's kernel launches (the
segmented sums once per round of their scan, `seg_rounds(N)`, and
`sum_g2` and `prod12` once per reduction of their elements by 32, as
their entry points report).

Planes are int32 ``[..., 12, N]`` (`kernels/layout.py`), the batch on the
last axis; an Fp2 value is ``[2, 12, N]``, an affine G2 point
``[2, 2, 12, N]`` (x, y), a Jacobian G1 point ``[3, 12, N]``, a Jacobian
G2 point ``[3, 2, 12, N]`` and an Fp12 value ``[12, 12, N]`` in the JAX
package's leaf order.  Lane flags are int32 ``[1, N]`` rows, as in the
JAX kernels.  Randomizers are int32 ``[4, N]`` big-endian words
(`bls/rand.py make_rand_words`).  Table rows are int32 ``idx [N, K]``
with ``kmask [N, K]`` (1 where the row is one of the set's keys).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ..crypto import curves as GC
from ..crypto import fields as GT
from . import build as B
from . import core as C
from . import curve as CV
from . import ingest as IG
from . import kv_program as KVP
from . import layout as LY
from . import pairing as KP
from . import tower as TW
from . import warp_schedule as W

NL = LY.NL
ND = LY.ND
RAND_BITS = 128  # RLC randomizer width (bls/rand.py)
RAND_WORDS = RAND_BITS // 32
WINDOW = 4  # scalar-multiplication window; divides 32
BT = 128  # the JAX lane tile: the grouped paths' Miller tile and the hash batches' multiple
AGG_CHUNK = 32  # rows of one tree of the pubkey aggregation (csrc/aggpk.cu)
AGG_BATCH = 16  # chunks whose trees one agg_pk block runs at once
AGG_THREADS = 256  # most threads of an agg_pk block

LAUNCHES: Dict[str, int] = {
    "g2_subgroup_check": 0,
    "miller_loop": 0,
    "each_final": 0,
    "g1_rpk": 0,
    "g2_rsig_sub": 0,
    "sum_g2": 0,
    "prod12": 0,
    "affine_g2": 0,
    "final_one": 0,
    "g2_decompress": 0,
    "hash_g2": 0,
    "agg_pk": 0,
    "g1_keyvalidate": 0,
    "seg_sum_g1": 0,
    "seg_sum_g2": 0,
}

# Fp multiplications per lane of each kernel (per combine for the
# reductions sum_g2 and prod12, which
# make N - 1 of them; per addition for agg_pk, which needs
# one per live row after a lane's first, and for the segmented sums,
# which make one per lane and round where neither operand is infinity
# (`seg_additions`) and need one per live lane after its group's first),
# from the structure of csrc/*.cuh and the warp programs;
# tests/test_torch_csrc_host.py checks them against a count taken by the
# host build: the work each kernel does (FP_MULS_NEEDED below is the
# work its function needs).  A 12-limb CIOS Montgomery product takes 12
# rows x (4 x 12 multiply-adds + 1 multiply).
FP_MULS_PER_LANE = {
    "g2_subgroup_check": 1189,
    "miller_loop": 7834,
    "each_final": 7730,
    "g1_rpk": 1563,
    "g2_rsig_sub": 5053,
    "sum_g2": 60,
    "prod12": 54,
    "affine_g2": 16,
    "final_one": 7730,
    "g2_decompress": 1868,
    "hash_g2": 10412,
    "agg_pk": 23,
    "g1_keyvalidate": 1488,
    "seg_sum_g1": 23,
    "seg_sum_g2": 60,
}
IMAD_PER_FP_MUL = 12 * (4 * 12 + 1)
# Rounds per lane of the warp-per-lane kernels (csrc/warp12.cuh): phases
# of up to 32 independent Fp products, one per thread, and the programs'
# inversions (the final exponentiation's, affine_g2's, hash_g2's two in one
# phase); sum_g2's and the segmented sums' per addition, prod12's per
# product (kernels/warp_schedule.py; the host build counts them,
# tests/test_torch_warp_{pairing,rsig,rpk,decompress,sum,hash,sub,segsum}.py)
ROUNDS_PER_LANE = {"miller_loop": 275, "each_final": 396, "final_one": 396, "g2_rsig_sub": 534, "g1_rpk": 533,
                   "g2_decompress": 899, "sum_g2": 5, "affine_g2": 7, "hash_g2": 1361, "prod12": 2,
                   "g2_subgroup_check": 207, "seg_sum_g1": 5, "seg_sum_g2": 5}
# The Montgomery ingest of the job's planes rides in the kernel that heads
# each path (_k_mont8 / _k_mont4, once launches of their own).
# g2_subgroup_check and g2_rsig_sub, given a decoded job's plain signature
# and message, convert both in their programs' first segment: the counts
# above hold these INGEST_ROUNDS and INGEST_MULS per lane, which a launch
# on Montgomery points (the wire paths) skips.  g2_decompress converts the
# wire paths' 4 message planes in its first round beside the wire x: its
# counts hold those 4 products, which it makes (on zeros) without messages
# too.
INGEST_ROUNDS, INGEST_MULS = 1, 8

# Fp products of the curve operations of csrc/curve.cuh (an Fp2 product
# is 3 Fp products, an Fp2 square 2): jac_dbl (2M + 5S), jac_add_core
# (12M + 4S) and jac_add_mixed (7M + 4S) over Fp, jac_dbl and
# jac_add_core over Fp2.  jac_add_full makes a doubling beside its
# addition and selects it only where P == Q.
DBL_MULS, ADD_MULS, MADD_MULS = 7, 16, 11
DBL2_MULS, ADD2_MULS = 16, 44
# KeyValidate's subgroup test (kernels/kv_program.py): two chains over
# |z|, each started by its top bit, 63 doublings and one addition for each
# of the 5 lower bits that are set (mixed in the first, whose addend P is
# affine; generic in the second); its square root's 4-bit sliding window:
# the table's 8 products, then a squaring per bit and a product per window
# after the first.  The kernel makes just these: FP_MULS_NEEDED is its count.
# Beside them 10 products: x to Montgomery, x^3 (2), the square check and
# the sign's conversion; the test's Z^2, Z^3, beta x, beta x Z^2, y Z^3.
Z_DOUBLINGS, Z_ADDITIONS = 63, 5
KV_SQRT_MULS = 2 ** (KVP.WIDTH - 1) + sum(sq + (d != 0) for sq, d in KVP.windows(KVP.SQRT_EXP)[1:])
KV_EDGE_MULS = 10
# The [r]P design it replaced needed 3,852 (5 beside the chain, the binary
# ladder's 606, r's 254 doublings and 133 mixed additions): the yardstick
# of the bound before (chip_smoke.py reports the bound both ways)
R_CHAIN_NEEDED = 5 + 606 + 254 * DBL_MULS + 133 * MADD_MULS

# The Fp products the function needs where the kernel makes more; the
# bound counts these.  A sum of distinct points never takes the doubling
# jac_add_full makes, and a sum whose addend is affine (agg_pk's table
# rows) needs only the mixed addition.  affine_g2 needs all
# of its 16 products and, beside them, its one Fp inversion, which both
# counts leave out: the bound adds the binary GCD's multiplies on the
# call's data (GCD_IMAD_PER_STEP, affine_g2_gcd_steps).  hash_g2 (the psi
# clearing) needs its program's products but the doublings made beside its
# six complete additions (HASH_ADDITIONS) and its square roots' chains, its
# two inversions per lane counted as affine_g2's (hash_g2_gcd_steps).  The
# program runs the norm method's four chains (HASH_ROOT_MULS) for all four
# candidates gx1, gx2 of u0 and u1 in the same rounds; the function needs,
# per u, gx1's norm chain (whether gx1 is a square), gx2's where it is not,
# and the chosen candidate's root: sp where its imaginary part is 0, else rp
# and, where rp^2 != xp, rm.  The bound adds those on the call's data
# (hash_g2_root_muls).  The candidates' few other products (gx2, the
# halves, the root's second half and sign) stay counted for all four.
HASH_ADDITIONS = 6


def _pow_window_muls(e: int) -> int:
    """Fp products of warp_schedule.pow_window's chain for the static e."""
    t = W.Trace({})
    W.pow_window(t, t.input(), e)
    return sum(k == W.MUL for k in t.kind)


# Fp products of each chain of the norm method with the products that only
# it feeds: the norm (2) and d; sp and sp^2; rp = t xp, 1 / rp (2) and rp^2;
# rm and 1 / rm (2).  d and sp are powers by (p + 1) / 4, rp and rm by
# (p - 3) / 4 (and one product).
_POW_S, _POW_T = _pow_window_muls(W.SQRT_EXP), _pow_window_muls((GT.P - 3) // 4)
HASH_ROOT_MULS = {"norm": 2 + _POW_S, "sp": _POW_S + 1, "rp": _POW_T + 4, "rm": _POW_T + 3}
FP_MULS_NEEDED = dict(
    FP_MULS_PER_LANE,
    g1_keyvalidate=KV_EDGE_MULS + KV_SQRT_MULS + 2 * Z_DOUBLINGS * DBL_MULS + Z_ADDITIONS * (MADD_MULS + ADD_MULS),
    agg_pk=MADD_MULS,
    sum_g2=ADD2_MULS,
    seg_sum_g1=ADD_MULS,
    seg_sum_g2=ADD2_MULS,
    hash_g2=FP_MULS_PER_LANE["hash_g2"] - HASH_ADDITIONS * DBL2_MULS - 4 * sum(HASH_ROOT_MULS.values()),
)

# The programs' Fp inversion, csrc/warp12.cuh fp_inv_var: outer steps of
# GCD_STEPS binary-GCD steps on 62-bit approximations of a and b (no
# multiply), each then applied by two w_gcd_lin (a, b: 24 products of 32 x
# 32 bits) and two w_gcd_mod (u, v: 36 such products and 3 low ones).  A
# 64-bit product counts two IMAD and a low one one, as in IMAD_PER_FP_MUL
# (whose count leaves out the additions too).  The steps depend on the
# value: gcd_steps counts them as fp_inv_var runs them.
GCD_STEPS = 30
GCD_IMAD_PER_STEP = 2 * (24 * 2) + 2 * (36 * 2 + 3)


def gcd_steps(x: int) -> int:
    """Outer steps of fp_inv_var on the integer 0 <= x < p (0 takes none)."""
    a, b, steps = x, LY.P, 0
    mask = (1 << GCD_STEPS) - 1
    while a:
        s = max((a | b).bit_length(), 2 * GCD_STEPS + 2) - 32
        xa = ((a >> s) & 0xFFFFFFFF) << GCD_STEPS | (a & mask)
        xb = ((b >> s) & 0xFFFFFFFF) << GCD_STEPS | (b & mask)
        f0, g0, f1, g1 = 1, 0, 0, 1
        for _ in range(GCD_STEPS):
            if xa & 1:
                if xa < xb:
                    xa, xb, f0, f1, g0, g1 = xb, xa, f1, f0, g1, g0
                xa, f0, g0 = xa - xb, f0 - f1, g0 - g1
            xa, f1, g1 = xa >> 1, 2 * f1, 2 * g1
        a, b = abs((a * f0 + b * g0) >> GCD_STEPS), abs((a * f1 + b * g1) >> GCD_STEPS)
        steps += 1
    return steps


def affine_g2_gcd_steps(p: torch.Tensor) -> int:
    """Outer steps of affine_g2's inversions on Jacobian G2 planes
    [3, 2, 12, N]: each lane inverts the norm of its Z, Z0^2 + Z1^2 in
    Montgomery form, flagged lanes too."""
    z = p[2].cpu().to(torch.int64) & 0xFFFFFFFF
    zm = [[sum(int(z[c, i, j]) << (32 * i) for i in range(NL)) for j in range(p.shape[-1])] for c in range(2)]
    return sum(gcd_steps((z0 * z0 + z1 * z1) * LY.R_INV % LY.P) for z0, z1 in zip(*zm))


def _hash_u(u: torch.Tensor):
    """Plain (u0, u1) planes [2, 2, 12, N] -> the Fp2 values u0 of every
    lane, then u1 of every lane."""
    planes = u.cpu().to(torch.int64) & 0xFFFFFFFF
    for i in range(2):
        c = [[sum(int(planes[i, k, w, j]) << (32 * w) for w in range(NL)) for j in range(u.shape[-1])]
             for k in range(2)]
        yield from zip(*c)


def _sswu_tv1(uu):
    from ..crypto import hash_to_curve as HC

    zu2 = GT.fp2_mul(HC._Z2, GT.fp2_sqr(uu))
    return zu2, GT.fp2_add(GT.fp2_sqr(zu2), zu2)


def hash_g2_gcd_steps(u: torch.Tensor) -> int:
    """Outer steps of hash_g2's inversions on plain (u0, u1) planes
    [2, 2, 12, N]: each lane inverts, for u0 and u1, the norm of SSWU's
    tv1 = Z^2 u^4 + Z u^2 in Montgomery form."""
    steps = 0
    for uu in _hash_u(u):
        tv1 = _sswu_tv1(uu)[1]
        steps += gcd_steps((tv1[0] * tv1[0] + tv1[1] * tv1[1]) * LY.R % LY.P)
    return steps


def hash_g2_root_muls(u: torch.Tensor) -> int:
    """The Fp products of the square roots' chains (HASH_ROOT_MULS) that
    hash_g2's function needs on plain (u0, u1) planes [2, 2, 12, N]: per
    u, gx1's norm chain, gx2's where gx1 is not a square, and the chosen
    candidate's root chains, as the kernel selects them (a square in Fp2
    has a square norm; rp^2 == xp where xp is a square)."""
    from ..crypto import hash_to_curve as HC

    p, a, b = LY.P, HC._A2, HC._B2
    mba = GT.fp2_mul(GT.fp2_neg(b), GT.fp2_inv(a))
    muls = 0
    for uu in _hash_u(u):
        zu2, tv1 = _sswu_tv1(uu)
        if GT.fp2_is_zero(tv1):
            x = GT.fp2_mul(b, GT.fp2_inv(GT.fp2_mul(HC._Z2, a)))
        else:
            x = GT.fp2_mul(mba, GT.fp2_add((1, 0), GT.fp2_inv(tv1)))
        for cand in range(2):
            g = GT.fp2_add(GT.fp2_mul(GT.fp2_add(GT.fp2_sqr(x), a), x), b)
            n = (g[0] * g[0] + g[1] * g[1]) % p
            d = pow(n, W.SQRT_EXP, p)
            muls += HASH_ROOT_MULS["norm"]
            if d * d % p == n:
                break
            x = GT.fp2_mul(zu2, x)
        if g[1] == 0:
            muls += HASH_ROOT_MULS["sp"]
        else:
            xp = (g[0] + d) * pow(2, -1, p) % p
            muls += HASH_ROOT_MULS["rp"] + (HASH_ROOT_MULS["rm"] if pow(xp, W.SQRT_EXP, p) ** 2 % p != xp else 0)
    return muls


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Operand checks and launch
# ---------------------------------------------------------------------------


def _on_cpu(*ts: torch.Tensor) -> bool:
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"operands on different devices: {t.device} vs {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"expected int32 planes, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        # the kernels launch on the current device's current stream
        if dev.index != torch.cuda.current_device():
            raise ValueError(f"operands on {dev}, current CUDA device is {torch.cuda.current_device()}")
        return False
    raise ValueError(f"unsupported device {dev}")


def _shape(t: torch.Tensor, shape, what: str) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def _launch(name: str, source: str, symbol: str, *args, launches=1) -> None:
    """Call a kernel's C entry point on the current stream; `launches` is
    the number of kernel launches it makes, or a ctypes int that the entry
    point sets to it (sum_g2 and prod12 relaunch on their partials until
    one is left, the segmented sums launch once per round)."""
    fn = getattr(B.load(source), symbol)
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, stream)
    LAUNCHES[name] += launches if isinstance(launches, int) else launches.value
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")


# ---------------------------------------------------------------------------
# Montgomery ingest (_k_mont8 / _k_mont4): no kernel of its own; the kernel
# that heads each path converts the job's plain planes (g2_subgroup_check
# and g2_rsig_sub on the decoded paths, g2_decompress on the wire paths)
# ---------------------------------------------------------------------------


def mont_convert_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain limb planes [..., 12, N] (any integers below 2^384) ->
    canonical Montgomery planes x * R mod p: the conversion the heading
    kernels make, and their plain versions' first step."""
    return LY.digits_to_planes(C.mont_convert(LY.planes_to_digits(x)))


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# K2: G2 subgroup check (_k_sub_only), with the decoded per-set path's
# Montgomery ingest (_k_mont8)
# ---------------------------------------------------------------------------


def g2_subgroup_check_plain(q: torch.Tensor, q_inf: torch.Tensor, msg: torch.Tensor | None = None):
    if msg is not None:
        qm, mm = mont_convert_plain(q), mont_convert_plain(msg)
        return g2_subgroup_check_plain(qm, q_inf), qm, mm
    d = LY.planes_to_digits(q)
    ok = CV.g2_subgroup_check((d[0], d[1]), q_inf[0] != 0)
    return ok.to(torch.int32)[None, :]


def g2_subgroup_check(q: torch.Tensor, q_inf: torch.Tensor, msg: torch.Tensor | None = None):
    """Affine G2 points [2, 2, 12, N] and infinity flags [1, N] -> int32
    [1, N], 1 where psi(Q) == -[|x|]Q or Q is infinity.

    With msg (the decoded per-set path): q and msg [2, 2, 12, N] are plain
    limbs of any integers below 2^384, which the kernel converts to
    Montgomery form first; -> (the flags, q and msg in Montgomery form).
    Without: q is in Montgomery form."""
    n = q.shape[-1]
    _shape(q, (2, 2, NL, n), "g2_subgroup_check q")
    _shape(q_inf, (1, n), "g2_subgroup_check q_inf")
    ops = (q, q_inf) if msg is None else (q, q_inf, msg)
    if msg is not None:
        _shape(msg, (2, 2, NL, n), "g2_subgroup_check msg")
    if _on_cpu(*ops):
        return g2_subgroup_check_plain(*ops)
    out = torch.empty((1, n), dtype=torch.int32, device=q.device)
    conv = None if msg is None else torch.empty((2, 2, 2, NL, n), dtype=torch.int32, device=q.device)
    _launch(
        "g2_subgroup_check", "subgroup", "lt_g2_subgroup_check",
        q.data_ptr(), q_inf.data_ptr(), _ptr(msg), out.data_ptr(), _ptr(conv), n,
    )
    return out if msg is None else (out, conv[0], conv[1])


# ---------------------------------------------------------------------------
# K3: Miller loop (_k_miller)
# ---------------------------------------------------------------------------


def miller_loop_plain(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    pd, qd = LY.planes_to_digits(p), LY.planes_to_digits(q)
    f = KP.miller_loop((pd[0], pd[1], pd[2]), (qd[0], qd[1]))
    return LY.digits_to_planes(f.reshape(12, ND, f.shape[-1]))


def miller_loop(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Jacobian G1 [3, 12, N] x affine G2 [2, 2, 12, N] -> Fp12 [12, 12, N]
    (the conjugated Miller value of `lodestar_tpu/kernels/pairing.py`)."""
    n = p.shape[-1]
    _shape(p, (3, NL, n), "miller_loop p")
    _shape(q, (2, 2, NL, n), "miller_loop q")
    if _on_cpu(p, q):
        return miller_loop_plain(p, q)
    f = torch.empty((12, NL, n), dtype=torch.int32, device=p.device)
    _launch("miller_loop", "miller", "lt_miller_loop", p.data_ptr(), q.data_ptr(), f.data_ptr(), n)
    return f


# ---------------------------------------------------------------------------
# K4: per-lane product, final exponentiation, is-one (_k_each_final)
# ---------------------------------------------------------------------------


def each_final_plain(live: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    n = f1.shape[-1]
    a = LY.planes_to_digits(f1).reshape(2, 3, 2, ND, n)
    b = LY.planes_to_digits(f2).reshape(2, 3, 2, ND, n)
    f = TW.mul12(a, b)
    f = TW.select(live[0] != 0, f, TW.one12(n, f.device))
    return TW.is_one12(KP.final_exponentiation(f)).to(torch.int32)[None, :]


def each_final(live: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor) -> torch.Tensor:
    """Per lane: f1 f2 (dead lanes -> 1), final exponentiation, is-one ->
    int32 [1, N]."""
    n = f1.shape[-1]
    _shape(live, (1, n), "each_final live")
    _shape(f1, (12, NL, n), "each_final f1")
    _shape(f2, (12, NL, n), "each_final f2")
    if _on_cpu(live, f1, f2):
        return each_final_plain(live, f1, f2)
    ok = torch.empty((1, n), dtype=torch.int32, device=f1.device)
    _launch(
        "each_final", "final", "lt_each_final",
        live.data_ptr(), f1.data_ptr(), f2.data_ptr(), ok.data_ptr(), n,
    )
    return ok


# ---------------------------------------------------------------------------
# K5, K6: randomized scalar multiplications (_k_g1_rpk, _k_g2_rsig_sub)
# ---------------------------------------------------------------------------


def _word_digit(rwords: torch.Tensor, t: int) -> torch.Tensor:
    """Window digit t (MSB-first) of each lane's scalar, from the packed
    big-endian words int32 [RAND_WORDS, N] -> int64 [N].  WINDOW divides
    32, so a digit never straddles two words (`csrc/randmul.cu
    w_digit`, JAX `_word_digit` `:130`)."""
    pos = RAND_BITS - WINDOW - WINDOW * t  # LSB offset of the digit
    word = rwords[RAND_WORDS - 1 - (pos >> 5)].to(torch.int64) & 0xFFFFFFFF
    return (word >> (pos & 31)) & ((1 << WINDOW) - 1)


def _scalar_mul(fo, q, q_inf, rwords):
    return CV.scalar_mul_window_jac(
        fo, q, q_inf[0] != 0, lambda t: _word_digit(rwords, t), RAND_BITS, WINDOW
    )


def g1_rpk_plain(p, p_inf, rwords):
    d = LY.planes_to_digits(p)
    pt, inf = _scalar_mul(CV.FP_OPS, (d[0], d[1], d[2]), p_inf, rwords)
    return LY.digits_to_planes(torch.stack(pt)), inf.to(torch.int32)[None, :]


def g1_rpk(p: torch.Tensor, p_inf: torch.Tensor, rwords: torch.Tensor):
    """Jacobian G1 [3, 12, N], infinity flags [1, N], randomizer words
    [4, N] -> (r_i P_i as Jacobian [3, 12, N], infinity flags [1, N])."""
    n = p.shape[-1]
    _shape(p, (3, NL, n), "g1_rpk p")
    _shape(p_inf, (1, n), "g1_rpk p_inf")
    _shape(rwords, (RAND_WORDS, n), "g1_rpk rwords")
    if _on_cpu(p, p_inf, rwords):
        return g1_rpk_plain(p, p_inf, rwords)
    out = torch.empty_like(p)
    out_inf = torch.empty_like(p_inf)
    _launch(
        "g1_rpk", "randmul", "lt_g1_rpk",
        p.data_ptr(), p_inf.data_ptr(), rwords.data_ptr(), out.data_ptr(), out_inf.data_ptr(), n,
    )
    return out, out_inf


def g2_rsig_sub_plain(q, q_inf, rwords, msg=None):
    if msg is not None:
        return (*g2_rsig_sub_plain(mont_convert_plain(q), q_inf, rwords), mont_convert_plain(msg))
    d = LY.planes_to_digits(q)
    n = q.shape[-1]
    q_jac = (d[0], d[1], CV.FP2_OPS.one(n, q.device))
    pt, inf = _scalar_mul(CV.FP2_OPS, q_jac, q_inf, rwords)
    sub = CV.g2_subgroup_check((d[0], d[1]), q_inf[0] != 0)
    return (
        LY.digits_to_planes(torch.stack(pt)),
        inf.to(torch.int32)[None, :],
        sub.to(torch.int32)[None, :],
    )


def g2_rsig_sub(q: torch.Tensor, q_inf: torch.Tensor, rwords: torch.Tensor, msg: torch.Tensor | None = None):
    """Affine G2 [2, 2, 12, N], infinity flags [1, N], randomizer words
    [4, N] -> (r_i Q_i as Jacobian [3, 2, 12, N], its infinity flags
    [1, N], subgroup flags [1, N]: 1 where Q_i is in G2 or infinity).

    With msg (the decoded batch path): q and msg [2, 2, 12, N] are plain
    limbs of any integers below 2^384, which the kernel converts to
    Montgomery form first; the Montgomery msg is a fourth output.
    Without: q is in Montgomery form."""
    n = q.shape[-1]
    _shape(q, (2, 2, NL, n), "g2_rsig_sub q")
    _shape(q_inf, (1, n), "g2_rsig_sub q_inf")
    _shape(rwords, (RAND_WORDS, n), "g2_rsig_sub rwords")
    ops = (q, q_inf, rwords) if msg is None else (q, q_inf, rwords, msg)
    if msg is not None:
        _shape(msg, (2, 2, NL, n), "g2_rsig_sub msg")
    if _on_cpu(*ops):
        return g2_rsig_sub_plain(*ops)
    out = torch.empty((3, 2, NL, n), dtype=torch.int32, device=q.device)
    out_inf = torch.empty_like(q_inf)
    sub = torch.empty_like(q_inf)
    msg_out = None if msg is None else torch.empty_like(msg)
    _launch(
        "g2_rsig_sub", "randmul", "lt_g2_rsig_sub",
        q.data_ptr(), q_inf.data_ptr(), _ptr(msg), rwords.data_ptr(), out.data_ptr(), out_inf.data_ptr(),
        sub.data_ptr(), _ptr(msg_out), n,
    )
    return (out, out_inf, sub) if msg is None else (out, out_inf, sub, msg_out)


# ---------------------------------------------------------------------------
# K7, K8: lane reductions (_k_sum_g2 + _j_sum_lanes, _k_prod + _j_product12)
# ---------------------------------------------------------------------------


def sum_g2_plain(pts, excl):
    d = LY.planes_to_digits(pts)
    s, s_inf = CV.sum_points_lanes(CV.FP2_OPS, (d[0], d[1], d[2]), excl[0] != 0)
    return LY.digits_to_planes(torch.stack(s)), s_inf.to(torch.int32)[None, :]


def sum_g2(pts: torch.Tensor, excl: torch.Tensor):
    """Jacobian G2 [3, 2, 12, N], exclusion flags [1, N] -> (the sum of
    the lanes not excluded as Jacobian [3, 2, 12, 1], its infinity flag
    [1, 1]), in the order of `curve.sum_points_lanes` (a pairwise tree
    over the lanes).  N = 0 gives the zero point flagged infinity."""
    n = pts.shape[-1]
    _shape(pts, (3, 2, NL, n), "sum_g2 pts")
    _shape(excl, (1, n), "sum_g2 excl")
    if _on_cpu(pts, excl):
        return sum_g2_plain(pts, excl)
    out = torch.zeros((3, 2, NL, 1), dtype=torch.int32, device=pts.device)
    out_inf = torch.ones((1, 1), dtype=torch.int32, device=pts.device)
    if n == 0:
        return out, out_inf
    lanes = B.load("reduce").lt_tree_scratch_lanes(n)
    scr = torch.empty((3 * 2 * NL * lanes,), dtype=torch.int32, device=pts.device)
    scr_inf = torch.empty((lanes,), dtype=torch.int32, device=pts.device)
    made = ctypes.c_int(0)
    _launch(
        "sum_g2", "reduce", "lt_sum_g2",
        pts.data_ptr(), excl.data_ptr(), scr.data_ptr(), scr_inf.data_ptr(), out.data_ptr(), out_inf.data_ptr(), n,
        ctypes.addressof(made), launches=made,
    )
    return out, out_inf


def prod12_plain(live, f):
    n = f.shape[-1]
    a = LY.planes_to_digits(f).reshape(2, 3, 2, ND, n)
    prod = KP.product12_lanes(a, live[0] != 0, BT)
    return LY.digits_to_planes(prod.reshape(12, ND, 1))


def prod12(live: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Live flags [1, N], Fp12 [12, 12, N] -> the product of the live
    lanes, Fp12 [12, 12, 1] (a pairwise tree over the lanes, relaunched on
    its partials as sum_g2's is; any order gives these integers).  N = 0
    gives the Fp12 one."""
    n = f.shape[-1]
    _shape(live, (1, n), "prod12 live")
    _shape(f, (12, NL, n), "prod12 f")
    if _on_cpu(live, f):
        return prod12_plain(live, f)
    if n == 0:
        return LY.digits_to_planes(TW.one12(1, f.device).reshape(12, ND, 1)).to(torch.int32)
    lanes = B.load("reduce").lt_tree_scratch_lanes(n)
    scr = torch.empty((12 * NL * lanes,), dtype=torch.int32, device=f.device)
    out = torch.empty((12, NL, 1), dtype=torch.int32, device=f.device)
    made = ctypes.c_int(0)
    _launch("prod12", "reduce", "lt_prod12", live.data_ptr(), f.data_ptr(), scr.data_ptr(), out.data_ptr(), n,
            ctypes.addressof(made), launches=made)
    return out


# ---------------------------------------------------------------------------
# K9, K10: the batch tail (_k_affine_g2, _k_final_one)
# ---------------------------------------------------------------------------


def affine_g2_plain(p, p_inf):
    d = LY.planes_to_digits(p)
    (x, y), z_inf = KP.to_affine_g2((d[0], d[1], d[2]))
    inf = (p_inf[0] != 0) | z_inf
    g2 = LY.planes_to_digits(_const_planes(p.device)["g2"])
    aff = TW.select(inf, g2, torch.stack([x, y]))
    return LY.digits_to_planes(aff), inf.to(torch.int32)[None, :]


def affine_g2(p: torch.Tensor, p_inf: torch.Tensor):
    """Jacobian G2 [3, 2, 12, N], infinity flags [1, N] -> (affine
    [2, 2, 12, N], flags [1, N]); infinity (flagged or Z = 0) gives the
    generator and flag 1."""
    n = p.shape[-1]
    _shape(p, (3, 2, NL, n), "affine_g2 p")
    _shape(p_inf, (1, n), "affine_g2 p_inf")
    if _on_cpu(p, p_inf):
        return affine_g2_plain(p, p_inf)
    a = torch.empty((2, 2, NL, n), dtype=torch.int32, device=p.device)
    a_inf = torch.empty_like(p_inf)
    _launch(
        "affine_g2", "tail", "lt_affine_g2",
        p.data_ptr(), p_inf.data_ptr(), a.data_ptr(), a_inf.data_ptr(), n,
    )
    return a, a_inf


def final_one_plain(a_inf, prod, fa):
    n = prod.shape[-1]
    a = LY.planes_to_digits(prod).reshape(2, 3, 2, ND, n)
    b = LY.planes_to_digits(fa).reshape(2, 3, 2, ND, n)
    b = TW.select(a_inf[0] != 0, TW.one12(n, b.device), b)
    f = TW.mul12(a, b)
    return TW.is_one12(KP.final_exponentiation(f)).to(torch.int32)[None, :]


def final_one(a_inf: torch.Tensor, prod: torch.Tensor, fa: torch.Tensor) -> torch.Tensor:
    """Per lane: prod * (a_inf ? 1 : fA), final exponentiation, is-one ->
    int32 [1, N]."""
    n = prod.shape[-1]
    _shape(a_inf, (1, n), "final_one a_inf")
    _shape(prod, (12, NL, n), "final_one prod")
    _shape(fa, (12, NL, n), "final_one fa")
    if _on_cpu(a_inf, prod, fa):
        return final_one_plain(a_inf, prod, fa)
    ok = torch.empty((1, n), dtype=torch.int32, device=prod.device)
    _launch(
        "final_one", "tail", "lt_final_one",
        a_inf.data_ptr(), prod.data_ptr(), fa.data_ptr(), ok.data_ptr(), n,
    )
    return ok


# ---------------------------------------------------------------------------
# K11, K12: wire ingest (_k_g2_decompress with the wire paths' _k_mont4,
# _k_hash_g2)
# ---------------------------------------------------------------------------


def g2_decompress_plain(x, flags, msg=None):
    xm = C.mont_convert(LY.planes_to_digits(x))
    y, ok = IG.g2_decompress_y(xm, flags[0] != 0)
    ok = ok | (flags[1] != 0)
    out = LY.digits_to_planes(torch.stack([xm, y])), ok.to(torch.int32)[None, :]
    return out if msg is None else (*out, mont_convert_plain(msg))


def g2_decompress(x: torch.Tensor, flags: torch.Tensor, msg: torch.Tensor | None = None):
    """Wire x as plain limb planes [2, 12, N] (x0, x1) and the (sign,
    infinity) bits [2, N] -> (Montgomery affine (x, y) [2, 2, 12, N],
    ok [1, N]: 1 where x is on the curve or the lane is flagged infinity).
    y is the root of x^3 + 4(1 + i) whose fp2_sgn is the sign bit.

    With msg (the wire paths): the job's H(m) as plain limb planes
    [2, 2, 12, N] of any integers below 2^384, converted to Montgomery
    form in the kernel's first round; a third output."""
    n = x.shape[-1]
    _shape(x, (2, NL, n), "g2_decompress x")
    _shape(flags, (2, n), "g2_decompress flags")
    ops = (x, flags) if msg is None else (x, flags, msg)
    if msg is not None:
        _shape(msg, (2, 2, NL, n), "g2_decompress msg")
    if _on_cpu(*ops):
        return g2_decompress_plain(*ops)
    xy = torch.empty((2, 2, NL, n), dtype=torch.int32, device=x.device)
    ok = torch.empty((1, n), dtype=torch.int32, device=x.device)
    msg_out = None if msg is None else torch.empty_like(msg)
    _launch("g2_decompress", "ingest", "lt_g2_decompress", x.data_ptr(), flags.data_ptr(), _ptr(msg),
            xy.data_ptr(), _ptr(msg_out), ok.data_ptr(), n)
    return (xy, ok) if msg is None else (xy, ok, msg_out)


def hash_g2_plain(u, sgn):
    ud = C.mont_convert(LY.planes_to_digits(u))
    pt, ok = IG.hash_to_g2_values(ud, sgn != 0)
    return LY.digits_to_planes(torch.stack(pt)), ok.to(torch.int32)[None, :]


def hash_g2(u: torch.Tensor, sgn: torch.Tensor):
    """map_to_curve of one message per lane: u = (u0, u1) from the host's
    hash_to_field as plain limb planes [2, 2, 12, N] and their RFC 9380
    sgn0 bits [2, N] -> (Jacobian G2 [3, 2, 12, N], ok [1, N]: both iso3
    denominators nonzero)."""
    n = u.shape[-1]
    _shape(u, (2, 2, NL, n), "hash_g2 u")
    _shape(sgn, (2, n), "hash_g2 sgn")
    if _on_cpu(u, sgn):
        return hash_g2_plain(u, sgn)
    out = torch.empty((3, 2, NL, n), dtype=torch.int32, device=u.device)
    ok = torch.empty((1, n), dtype=torch.int32, device=u.device)
    _launch("hash_g2", "ingest", "lt_hash_g2", u.data_ptr(), sgn.data_ptr(), out.data_ptr(),
            ok.data_ptr(), n)
    return out, ok


# ---------------------------------------------------------------------------
# K13: pubkey aggregation (_k_agg_pk with _gather_pk's gather)
# ---------------------------------------------------------------------------


def agg_pk_plain(table_x, table_y, idx, kmask):
    n, k = idx.shape
    kc = min(k, AGG_CHUNK)
    # a row outside [0, V) is read as row 0 and counted as infinity
    in_range = (idx >= 0) & (idx < table_x.shape[1])
    bad = ((kmask != 0) & ~in_range).any(dim=1)
    rows = torch.where(in_range, idx, 0).t().reshape(-1).to(torch.int64)  # row k of every lane, k-major

    def gather(table):  # -> [kc, K / kc, ND, N]: chunk c holds rows c kc ..
        d = LY.planes_to_digits(torch.index_select(table, 1, rows)).reshape(ND, k // kc, kc, n)
        return d.permute(2, 1, 0, 3)

    x, y = gather(table_x), gather(table_y)
    one = torch.broadcast_to(CV.FP_OPS.one(n, x.device), x.shape)
    inf = ((kmask == 0) | ~in_range).t().reshape(k // kc, kc, n).transpose(0, 1)
    # the chunks' trees side by side, then the chunk sums in order
    s, s_inf = CV.sum_points_axis0(CV.FP_OPS, (x, y, one), inf)
    acc, acc_inf = tuple(c[0] for c in s), s_inf[0]
    for c in range(1, k // kc):
        acc, acc_inf = CV.jac_add_full(CV.FP_OPS, acc, acc_inf, tuple(p[c] for p in s), s_inf[c])
    return LY.digits_to_planes(torch.stack(acc)), (acc_inf | bad).to(torch.int32)[None, :]


def agg_pk(table_x: torch.Tensor, table_y: torch.Tensor, idx: torch.Tensor, kmask: torch.Tensor):
    """Montgomery table planes [12, V], rows idx [N, K] and kmask [N, K] ->
    (per lane the Jacobian G1 sum of its rows with kmask 1, [3, 12, N],
    and its infinity flag [1, N]), in the order of `_k_agg_pk`: trees of
    min(K, 32) rows, the chunk sums added in order.  A row outside [0, V)
    counts as infinity, and if its kmask bit is set the lane is flagged
    infinity, so its set fails."""
    if table_x.dim() != 2 or table_x.shape[0] != NL or table_x.shape[1] == 0:
        raise ValueError(f"agg_pk table_x: expected [{NL}, V], V >= 1, got {tuple(table_x.shape)}")
    _shape(table_y, table_x.shape, "agg_pk table_y")
    if idx.dim() != 2 or idx.shape[1] % min(idx.shape[1], AGG_CHUNK) != 0:
        raise ValueError(f"agg_pk idx: expected [N, K], K a multiple of min(K, {AGG_CHUNK}), "
                         f"got {tuple(idx.shape)}")
    _shape(kmask, idx.shape, "agg_pk kmask")
    n, k = idx.shape
    if _on_cpu(table_x, table_y, idx, kmask):
        return agg_pk_plain(table_x, table_y, idx, kmask)
    out = torch.empty((3, NL, n), dtype=torch.int32, device=idx.device)
    out_inf = torch.empty((1, n), dtype=torch.int32, device=idx.device)
    _launch("agg_pk", "aggpk", "lt_agg_pk", table_x.data_ptr(), table_y.data_ptr(), table_x.shape[1],
            idx.data_ptr(), kmask.data_ptr(), k, out.data_ptr(), out_inf.data_ptr(), n)
    return out, out_inf


def agg_launch_shape(n: int, k: int):
    """The launch `csrc/aggpk.cu` makes for agg_pk on [n, k] rows, as
    its lt_agg_last_launch reports it: n blocks (one per set), the
    threads of one batch's first tree level in whole warps (at most
    AGG_THREADS), the static shared bytes (x, y, z limbs and a flag per
    point a batch keeps, a live word per chunk), and a chunk's tree
    levels."""
    kc = min(k, AGG_CHUNK)
    items = min(k // kc, AGG_BATCH) * ((kc + 1) // 2)
    pts = AGG_BATCH * (AGG_CHUNK // 2)
    smem = (3 * NL + 1) * pts * 4 + AGG_BATCH * 4
    return [n, min(AGG_THREADS, -(-items // 32) * 32), smem, (kc - 1).bit_length()]


# ---------------------------------------------------------------------------
# K14: G1 KeyValidate at pubkey registration (_k_g1_keyvalidate)
# ---------------------------------------------------------------------------


def g1_keyvalidate_plain(x, flags):
    xm = C.mont_convert(LY.planes_to_digits(x))
    (_, y), ok = IG.g1_keyvalidate(xm, flags[0] != 0)
    ok = ok & (flags[1] == 0)
    return LY.digits_to_planes(torch.stack([xm, y])), ok.to(torch.int32)[None, :]


def g1_keyvalidate(x: torch.Tensor, flags: torch.Tensor):
    """Compressed pubkeys' x as plain limb planes [12, N] and their (sign,
    infinity) bits [2, N] -> (Montgomery affine (x, y) [2, 12, N], ok
    [1, N]: 1 where the key is on the curve, in G1 and not flagged
    infinity, blst KeyValidate).  y is the root of x^3 + 4 whose fp_sgn is
    the sign bit."""
    n = x.shape[-1]
    _shape(x, (NL, n), "g1_keyvalidate x")
    _shape(flags, (2, n), "g1_keyvalidate flags")
    if _on_cpu(x, flags):
        return g1_keyvalidate_plain(x, flags)
    xy = torch.empty((2, NL, n), dtype=torch.int32, device=x.device)
    ok = torch.empty((1, n), dtype=torch.int32, device=x.device)
    _launch("g1_keyvalidate", "keyvalidate", "lt_g1_keyvalidate", x.data_ptr(), flags.data_ptr(),
            xy.data_ptr(), ok.data_ptr(), n)
    return xy, ok


# ---------------------------------------------------------------------------
# K15, K16: segmented prefix sums (_j_seg_sum_g1, _j_seg_sum_g2)
# ---------------------------------------------------------------------------


def seg_warps(n: int) -> int:
    """Lanes (warps) per block of the scans' launches at n lanes: 4, 8 or
    16, the fewest that keep a launch within 128 blocks (csrc/segsum.cu
    seg_warps, whose launch records the tests and chip_smoke.py hold)."""
    w = 4
    while w < 16 and -(-n // w) > 128:
        w *= 2
    return w


def seg_rounds(n: int) -> int:
    """Rounds of the segmented scan at n lanes, s = 1, 2, 4, .. < n (one
    round that adds nothing at n = 1): the kernel's launches."""
    return max(1, (n - 1).bit_length())


def _seg_scan(fo, pts, inf, group):
    """JAX's scan (`_j_seg_sum_g1` `:686`): in round s every lane adds the
    previous round's value of lane (l - s) mod n, which counts as infinity
    unless l >= s and the two lanes share a group.  -> (points, infinity,
    the additions made where neither operand is infinity: the kernel's,
    whose other lanes only copy)."""
    n = group.shape[0]
    lane = torch.arange(n, device=group.device)
    s, made = 1, 0
    while s < n:
        prev = tuple(torch.roll(a, s, dims=-1) for a in pts)
        ok = (lane >= s) & (torch.roll(group, s) == group)
        q_inf = torch.roll(inf, s) | ~ok
        made += int((~inf & ~q_inf).sum())
        pts, inf = CV.jac_add_full(fo, pts, inf, prev, q_inf)
        s *= 2
    return pts, inf, made


def _seg_g1(pts, dead, group):
    d = LY.planes_to_digits(pts)
    return _seg_scan(CV.FP_OPS, (d[0], d[1], d[2]), dead[0] != 0, group)


def _seg_g2(xy, dead, group):
    d = LY.planes_to_digits(xy)
    one = CV.FP2_OPS.one(xy.shape[-1], xy.device)
    return _seg_scan(CV.FP2_OPS, (d[0], d[1], one), dead[0] != 0, group)


def seg_sum_g1_plain(pts, dead, group):
    s, s_inf, _ = _seg_g1(pts, dead, group)
    return LY.digits_to_planes(torch.stack(s)), s_inf.to(torch.int32)[None, :]


def seg_sum_g2_plain(xy, dead, group):
    s, s_inf, _ = _seg_g2(xy, dead, group)
    return LY.digits_to_planes(torch.stack(s)), s_inf.to(torch.int32)[None, :]


def seg_additions(name: str, pts, dead, group) -> int:
    """The complete additions `seg_sum_g1` or `seg_sum_g2` (name) makes on
    these operands: one per lane and round where neither operand counts
    as infinity (the other lanes copy); each makes FP_MULS_PER_LANE[name]
    Fp products."""
    return (_seg_g1 if name == "seg_sum_g1" else _seg_g2)(pts, dead, group)[2]


def _seg_sum(name, symbol, pts, dead, group, shape):
    n = group.shape[0]
    out = torch.empty(shape, dtype=torch.int32, device=pts.device)
    scr = torch.empty_like(out)
    out_inf = torch.empty((1, n), dtype=torch.int32, device=pts.device)
    scr_inf = torch.empty_like(out_inf)
    made = ctypes.c_int(0)
    _launch(name, "segsum", symbol, pts.data_ptr(), dead.data_ptr(), group.data_ptr(), out.data_ptr(),
            out_inf.data_ptr(), scr.data_ptr(), scr_inf.data_ptr(), n, ctypes.addressof(made), launches=made)
    return out, out_inf


def seg_sum_g1(pts: torch.Tensor, dead: torch.Tensor, group: torch.Tensor):
    """Jacobian G1 [3, 12, N], dead flags [1, N] and nondecreasing group ids
    [N] -> (the inclusive sum of each lane's group up to the lane, dead
    lanes counted as infinity, Jacobian [3, 12, N], and its infinity flags
    [1, N]); the last lane of a group holds the group's total."""
    n = pts.shape[-1]
    _shape(pts, (3, NL, n), "seg_sum_g1 pts")
    _shape(dead, (1, n), "seg_sum_g1 dead")
    _shape(group, (n,), "seg_sum_g1 group")
    if _on_cpu(pts, dead, group):
        return seg_sum_g1_plain(pts, dead, group)
    return _seg_sum("seg_sum_g1", "lt_seg_sum_g1", pts, dead, group, (3, NL, n))


def seg_sum_g2(xy: torch.Tensor, dead: torch.Tensor, group: torch.Tensor):
    """`seg_sum_g1` over affine G2 points [2, 2, 12, N] (Z = 1) -> Jacobian
    [3, 2, 12, N] and infinity flags [1, N]."""
    n = xy.shape[-1]
    _shape(xy, (2, 2, NL, n), "seg_sum_g2 xy")
    _shape(dead, (1, n), "seg_sum_g2 dead")
    _shape(group, (n,), "seg_sum_g2 group")
    if _on_cpu(xy, dead, group):
        return seg_sum_g2_plain(xy, dead, group)
    return _seg_sum("seg_sum_g2", "lt_seg_sum_g2", xy, dead, group, (3, 2, NL, n))


# ---------------------------------------------------------------------------
# The per-set path
# ---------------------------------------------------------------------------

_CONSTS: dict = {}


def _const_planes(device) -> dict:
    """Generator planes [12, 1] (Montgomery) for substitution and -G1, and
    G2's generator as plain limbs ("g2_plain", the decoded paths' dead
    signature lanes, which their heading kernel converts to exactly "g2")."""
    key = str(device)
    c = _CONSTS.get(key)
    if c is None:
        def col(v):
            return torch.from_numpy(LY.encode_batch([v])).to(device)

        g2x, g2y = GC.G2_GEN
        c = {
            "g1x": col(GC.G1_GEN[0]),
            "g1y": col(GC.G1_GEN[1]),
            "neg_g1y": col(GT.fp_neg(GC.G1_GEN[1])),
            "one": col(1),
            "g2": torch.stack(
                [torch.stack([col(g2x[0]), col(g2x[1])]), torch.stack([col(g2y[0]), col(g2y[1])])]
            ),
            "g2_plain": torch.from_numpy(LY.encode_plain_batch([g2x[0], g2x[1], g2y[0], g2y[1]])).to(device)
            .reshape(NL, 2, 2).permute(1, 2, 0)[..., None].contiguous(),
        }
        _CONSTS[key] = c
    return c


def _gather_pk(table_x, table_y, idx, kmask):
    """Per-set pubkey from the device table -> (Jacobian planes
    [3, 12, N], infinity mask bool [N]).  K = 1: the rows by
    torch.index_select with Z = 1 and no infinity (kmask is not read, as
    in the JAX package); K > 1: the masked sum of the K rows (agg_pk)."""
    n, k = idx.shape
    if k > 1:
        pk, pk_inf = agg_pk(table_x, table_y, idx, kmask)
        return pk, pk_inf[0] != 0
    rows = idx[:, 0].to(torch.int64)
    px = torch.index_select(table_x, 1, rows)
    py = torch.index_select(table_y, 1, rows)
    pz = _const_planes(table_x.device)["one"].expand(NL, n)
    return torch.stack([px, py, pz]), torch.zeros(n, dtype=torch.bool, device=table_x.device)


def _substitute(live, pk, sig, plain):
    """Dead lanes -> generator points (keeps every lane on the curve); sig
    as plain limbs where `plain` (the decoded paths, before their heading
    kernel's ingest), else in Montgomery form."""
    c = _const_planes(pk.device)
    g1 = torch.stack([c["g1x"], c["g1y"], c["one"]])
    return torch.where(live, pk, g1), torch.where(live, sig, c["g2_plain" if plain else "g2"])


def _live_lanes(table_x, table_y, idx, kmask, sig, sig_bad, valid, plain):
    """Gather (and aggregate) the pubkeys, mark the live lanes (valid,
    pubkey and signature not infinity) and substitute generators into the
    dead ones -> (live, pk_inf, pk [3, 12, N], sig [2, 2, 12, N])."""
    pk, pk_inf = _gather_pk(table_x, table_y, idx, kmask)
    live = (valid != 0) & ~pk_inf & ~sig_bad
    pk, sig = _substitute(live, pk, sig, plain)
    return live, pk_inf, pk.contiguous(), sig.contiguous()


def _neg_g1(device, n: int) -> torch.Tensor:
    c = _const_planes(device)
    return torch.stack([c["g1x"], c["neg_g1y"], c["one"]]).expand(3, NL, n).contiguous()


def each_operands(table_x, table_y, idx, kmask, msg, sig, sig_bad, valid, plain=False) -> dict:
    """The kernel operands of one per-set job, from message and signature
    points [2, 2, 12, N] (plain limbs where `plain`, the decoded path;
    else Montgomery): gather the pubkeys, substitute generators into dead
    lanes, and lay out the launches.  "sub" is g2_subgroup_check's
    operands: with the message where `plain`, so it returns the
    Montgomery (sig, msg) of the Miller loops (`each_miller_operands`)."""
    n = valid.shape[0]
    live, _, pk, sig = _live_lanes(table_x, table_y, idx, kmask, sig, sig_bad, valid, plain)
    zero = torch.zeros((1, n), dtype=torch.int32, device=pk.device)
    return {
        "live": live,
        "sub": (sig, zero, msg.contiguous()) if plain else (sig, zero),
        "pk": pk,
        "sig": sig,
        "msg": msg.contiguous(),
        "neg_g1": _neg_g1(pk.device, n),
        "live_row": live[None, :].to(torch.int32),
    }


def each_miller_operands(ops: dict, sub):
    """The subgroup flags and the two Miller loops' operands, (pk, H(m))
    and (-G1, sig), from g2_subgroup_check's result on ops["sub"]."""
    if isinstance(sub, tuple):  # the decoded path: the kernel's ingest made the Montgomery points
        sub, sig, msg = sub
    else:
        sig, msg = ops["sig"], ops["msg"]
    return sub, (ops["pk"], msg), (ops["neg_g1"], sig)


def _each_core(table_x, table_y, idx, kmask, msg, sig, sig_bad, valid, plain):
    ops = each_operands(table_x, table_y, idx, kmask, msg, sig, sig_bad, valid, plain)
    sub, miller_pk, miller_sig = each_miller_operands(ops, g2_subgroup_check(*ops["sub"]))
    f1 = miller_loop(*miller_pk)
    f2 = miller_loop(*miller_sig)
    ok = each_final(ops["live_row"], f1, f2)
    return ((ok[0] != 0) & (sub[0] != 0) & ops["live"]) | ~(valid != 0)


def _decoded_inputs(idx, kmask, planes, n):
    """Plain limb planes [8, 12, N] of H(m) and sig -> the two points, still
    plain limbs: the path's heading kernel (g2_subgroup_check or
    g2_rsig_sub) converts them."""
    _shape(idx, (n, idx.shape[-1]), "idx")
    _shape(kmask, idx.shape, "kmask")
    _shape(planes, (8, NL, n), "planes")
    return planes[:4].reshape(2, 2, NL, n), planes[4:].reshape(2, 2, NL, n)


def _wire_inputs(idx, kmask, msg_planes, sig_x, sig_flags, n):
    """Plain limb planes [4, 12, N] of H(m), wire x [2, 12, N] and flags
    [2, N] -> (Montgomery message and signature points, both from
    g2_decompress, sig_bad: the signature is flagged infinity (or
    malformed on the host) or x is not on the curve)."""
    _shape(idx, (n, idx.shape[-1]), "idx")
    _shape(kmask, idx.shape, "kmask")
    _shape(msg_planes, (4, NL, n), "msg planes")
    sig, dec_ok, msg = g2_decompress(sig_x, sig_flags, msg_planes.reshape(2, 2, NL, n))
    return msg, sig, (sig_flags[1] != 0) | (dec_ok[0] == 0)


def verify_each_device(table_x, table_y, idx, kmask, planes, sig_inf, valid):
    """Independent per-set verdicts: e(pk_i, H_i) e(-G1, sig_i) == 1 and
    sig_i in G2, per lane; padding lanes True.

    table_x, table_y: int32 [12, V] Montgomery pubkey planes;
    idx, kmask: int32 [N, K] table rows and their mask (K = 1 or a K
    bucket; a set whose rows are all masked is at infinity and fails);
    planes: int32 [8, 12, N] PLAIN limbs of H(m) x0, x1, y0, y1 and
    sig x0, x1, y0, y1; sig_inf, valid: int32 [N].
    Returns bool [N]: ((ok & sub & live) | ~valid), as `_each_core`.
    """
    n = valid.shape[0]
    msg, sig = _decoded_inputs(idx, kmask, planes, n)
    return _each_core(table_x, table_y, idx, kmask, msg, sig, sig_inf != 0, valid, True)


def verify_each_device_wire(table_x, table_y, idx, kmask, msg_planes, sig_x, sig_flags, valid):
    """Per-set verdicts from WIRE signatures (`:945`): the compressed x as
    plain limbs [2, 12, N] and the (sign, infinity) bits [2, N] are
    decompressed on the card; an x off the curve fails its set.  Other
    operands as `verify_each_device`, with H(m) as [4, 12, N] plain limbs."""
    n = valid.shape[0]
    msg, sig, sig_bad = _wire_inputs(idx, kmask, msg_planes, sig_x, sig_flags, n)
    return _each_core(table_x, table_y, idx, kmask, msg, sig, sig_bad, valid, False)


# ---------------------------------------------------------------------------
# The RLC batch path
# ---------------------------------------------------------------------------


def batch_operands(table_x, table_y, idx, kmask, msg, sig, sig_bad, valid, rwords, plain=False) -> dict:
    """The kernel operands of one RLC batch job (`_batch_local` `:510`):
    the per-set path's gather and substitution, then the two randomized
    scalar multiplications' inputs (no lane flagged infinity: dead lanes
    hold generators).  Where `plain` (the decoded path) g2_rsig_sub takes
    the plain message too and returns it in Montgomery form
    (`batch_msg`)."""
    n = valid.shape[0]
    live, pk_inf, pk, sig = _live_lanes(table_x, table_y, idx, kmask, sig, sig_bad, valid, plain)
    zero = torch.zeros((1, n), dtype=torch.int32, device=pk.device)
    msg = msg.contiguous()
    return {
        "live": live,
        "pk_inf": pk_inf,
        "live_row": live[None, :].to(torch.int32),
        "g1_rpk": (pk, zero, rwords),
        "g2_rsig_sub": (sig, zero, rwords, msg) if plain else (sig, zero, rwords),
        "msg": msg,
    }


def batch_msg(ops: dict, rsig_out) -> torch.Tensor:
    """The Montgomery message of the Miller side: g2_rsig_sub's fourth
    output where it made the ingest, else the operands' own."""
    return rsig_out[3] if len(rsig_out) == 4 else ops["msg"]


def _batch_tail(fprod, jsum, jsum_inf):
    """One lane (`_batch_tail` `:576`): A -> affine, the Miller loop of
    (-G1, A) and the final exponentiation of prod f_A -> ok [1, 1]."""
    a, a_inf = affine_g2(jsum, jsum_inf)
    fa = miller_loop(_neg_g1(a.device, 1), a)
    return final_one(a_inf, fprod, fa)


def _batch_verdict(ok, sub, live, pk_inf, sig_bad, valid):
    """`_j_batch_verdict` (`:499`): a set whose pubkey or signature is
    infinity fails the batch; dead lanes pass the subgroup row."""
    valid = valid != 0
    sub_ok = (sub[0] != 0) | ~live
    batch_ok = (ok[0, 0] != 0) & sub_ok.all() & ~(pk_inf & valid).any() & ~(sig_bad & valid).any()
    return batch_ok, sub_ok


def _group_heads(pts, seg_inf, msg, head_lanes, glive):
    """`_j_group_heads` (`:715`): each group's total (its last lane) and
    its message gathered onto one BT-lane tile; dead group lanes (padding,
    or a total at infinity, whose pairing is 1) get generator pairs and a
    0 in the live row."""
    h = head_lanes.to(torch.int64)
    live = (seg_inf[0].index_select(0, h) == 0) & (glive != 0)
    c = _const_planes(pts.device)
    g1 = torch.stack([c["g1x"], c["g1y"], c["one"]])
    g = torch.where(live, pts.index_select(-1, h), g1)
    q = torch.where(live, msg.index_select(-1, h), c["g2"])
    return g.contiguous(), q.contiguous(), live[None, :].to(torch.int32)


def grouped_operands(ops, msg, rpk, rpk_inf, group, head_lanes, glive) -> dict:
    """The grouped G1 side's operands (`_batch_local_grouped` `:739`), msg
    the Montgomery message planes: the randomized pubkeys of dead lanes
    count as infinity in their group's segmented sum."""
    return {"seg_sum_g1": (rpk, (~ops["live"])[None, :].to(torch.int32) | rpk_inf, group),
            "heads": (msg, head_lanes, glive)}


def _batch_core(table_x, table_y, idx, kmask, msg, sig, sig_bad, rwords, valid, plain, grouping=None):
    """The batch pipeline from the points on (plain limbs where `plain`,
    the decoded path, else Montgomery).  With `grouping`
    (group [N], head_lanes [BT], glive [BT]; `_batch_local_grouped`
    `:739`) the Miller side runs once per distinct message: a segmented
    sum of the r_i pk_i by group, then ONE BT-lane Miller tile of the group
    totals against their messages."""
    ops = batch_operands(table_x, table_y, idx, kmask, msg, sig, sig_bad, valid, rwords, plain)
    rpk, rpk_inf = g1_rpk(*ops["g1_rpk"])
    rs = g2_rsig_sub(*ops["g2_rsig_sub"])
    (rsig, rsig_inf, sub), msg = rs[:3], batch_msg(ops, rs)
    # the aggregate signature point: dead lanes excluded from the sum
    excl = (~ops["live"])[None, :].to(torch.int32) | rsig_inf
    jsum, jsum_inf = sum_g2(rsig, excl)
    if grouping is None:
        fprod = prod12(ops["live_row"], miller_loop(rpk, msg))
    else:
        gops = grouped_operands(ops, msg, rpk, rpk_inf, *grouping)
        pts, seg_inf = seg_sum_g1(*gops["seg_sum_g1"])
        msg_h, head_lanes, glive = gops["heads"]
        g, q, live_row = _group_heads(pts, seg_inf, msg_h, head_lanes, glive)
        fprod = prod12(live_row, miller_loop(g, q))
    ok = _batch_tail(fprod, jsum, jsum_inf)
    return _batch_verdict(ok, sub, ops["live"], ops["pk_inf"], sig_bad, valid)


def verify_batch_device(table_x, table_y, idx, kmask, planes, sig_inf, rwords, valid):
    """RLC batch verification of N padded sets: one multi-pairing check
    prod_i e(r_i pk_i, H_i) e(-G1, sum_i r_i sig_i) == 1.

    Operands as `verify_each_device`, plus rwords: int32 [4, N] the
    randomizers' big-endian words (`bls/rand.py make_rand_words`).
    Returns (batch_ok: bool [], sub_ok: bool [N]) as the JAX package's
    `verify_batch_device`: padding lanes are excluded, and a set whose
    pubkey or signature is infinity fails the batch."""
    n = valid.shape[0]
    _shape(rwords, (RAND_WORDS, n), "verify_batch_device rwords")
    msg, sig = _decoded_inputs(idx, kmask, planes, n)
    return _batch_core(table_x, table_y, idx, kmask, msg, sig, sig_inf != 0, rwords, valid, True)


def verify_batch_device_wire(table_x, table_y, idx, kmask, msg_planes, sig_x, sig_flags, rwords, valid):
    """Batch verification from WIRE signatures (`:417`): operands as
    `verify_each_device_wire` plus rwords.  A signature whose x is off the
    curve fails the batch like an infinity signature, and the caller's
    bisection or per-set retry finds it."""
    n = valid.shape[0]
    _shape(rwords, (RAND_WORDS, n), "verify_batch_device_wire rwords")
    msg, sig, sig_bad = _wire_inputs(idx, kmask, msg_planes, sig_x, sig_flags, n)
    return _batch_core(table_x, table_y, idx, kmask, msg, sig, sig_bad, rwords, valid, False)


def _grouping_shapes(group, head_lanes, glive, n):
    _shape(group, (n,), "group")
    _shape(head_lanes, (BT,), "head_lanes")
    _shape(glive, (BT,), "glive")


def verify_batch_device_wire_grouped(table_x, table_y, idx, kmask, msg_planes, sig_x, sig_flags, group,
                                     head_lanes, glive, rwords, valid):
    """`verify_batch_device_wire` with distinct-message grouping (`:804`):
    the Miller side runs per distinct signing root on one BT-lane tile
    instead of per set.  group: int32 [N] nondecreasing ids, every lane of
    one message in one contiguous run; head_lanes: int32 [BT] the last
    lane of each group (padding entries arbitrary); glive: int32 [BT] 1
    for real groups.  Needs at most BT groups.  Same verdicts as the
    ungrouped path."""
    n = valid.shape[0]
    _shape(rwords, (RAND_WORDS, n), "verify_batch_device_wire_grouped rwords")
    _grouping_shapes(group, head_lanes, glive, n)
    msg, sig, sig_bad = _wire_inputs(idx, kmask, msg_planes, sig_x, sig_flags, n)
    return _batch_core(table_x, table_y, idx, kmask, msg, sig, sig_bad, rwords, valid, False,
                       (group, head_lanes, glive))


# ---------------------------------------------------------------------------
# Pre-verify signature aggregation (`aggregate_g2_sum_device` `:883`)
# ---------------------------------------------------------------------------


def _agg_heads(pts, seg_inf, head_lanes, glive):
    """`_j_agg_heads` (`:870`): each group's Jacobian total (its last lane)
    gathered onto one BT-lane tile, dead group lanes flagged infinity."""
    h = head_lanes.to(torch.int64)
    g_inf = (seg_inf[0].index_select(0, h) != 0) | (glive == 0)
    return pts.index_select(-1, h).contiguous(), g_inf[None, :].to(torch.int32)


def aggregate_g2_sum_device(sig_x, sig_flags, group, head_lanes, glive):
    """The G2 sum of each group of wire signatures, on the device.

    sig_x [2, 12, N] and sig_flags [2, N]: the `encode_wire_planes`
    layout; group, head_lanes, glive as `verify_batch_device_wire_grouped`
    (at most BT groups).  g2_decompress, then `seg_sum_g2` over the
    decompressed points (an infinity or undecodable signature counts as
    infinity), then the group totals onto one BT-lane tile and to affine
    by `affine_g2`.  Returns (affine Montgomery planes [2, 2, 12, BT], one
    aggregate per group, the generator where the total is infinity;
    g_inf [1, BT]: the total is infinity; ok [1, N]: the input decoded,
    so a group with a lane not ok has no aggregate)."""
    n = sig_flags.shape[-1]
    _shape(sig_x, (2, NL, n), "aggregate_g2_sum_device sig_x")
    _grouping_shapes(group, head_lanes, glive, n)
    xy, dec_ok = g2_decompress(sig_x, sig_flags)
    bad = ((sig_flags[1] != 0) | (dec_ok[0] == 0))[None, :].to(torch.int32)
    pts, seg_inf = seg_sum_g2(xy, bad, group)
    heads, h_inf = _agg_heads(pts, seg_inf, head_lanes, glive)
    a, g_inf = affine_g2(heads, h_inf)
    return a, g_inf, 1 - bad
