"""The port's curve and pairing layers (lodestar_tpu_torch.kernels curve,
pairing) held against the JAX package and the crypto oracle.

Loop-free JAX functions (the group law, psi, the Miller steps and the
sparse line product) run as eager jnp and must give the SAME Jacobian
coordinates and line values as the port, not only the same points: that
is what makes the port's Miller value equal the JAX kernel's.  The
loops (scalar_mul_static, the subgroup check, the Miller loop, the final
exponentiation) are held against the oracle here; the direct comparison
with the JAX loops, whose jit takes minutes on this host, is `slow`.
Every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lodestar_tpu.crypto import curves as GC
from lodestar_tpu.crypto import fields as GT
from lodestar_tpu.crypto import hash_to_curve as GH
from lodestar_tpu.crypto import pairing as GP
from lodestar_tpu.kernels import curve as JCV
from lodestar_tpu.kernels import layout as JL
from lodestar_tpu.kernels import pairing as JP
from lodestar_tpu_torch.kernels import curve as CV
from lodestar_tpu_torch.kernels import layout as LY
from lodestar_tpu_torch.kernels import pairing as KP
from lodestar_tpu_torch.kernels import tower as TW

P = GT.P
RNG = np.random.default_rng(0x9A1E)
N = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain engine's tensors are small, and
    parallel test workers must not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scalar():
    return int.from_bytes(RNG.bytes(32), "little") % (GT.R - 2) + 2


def rand_fp():
    return int.from_bytes(RNG.bytes(48), "little") % P


def g1(n):
    return [GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, scalar()) for _ in range(n)]


def g2(n):
    return [GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, scalar()) for _ in range(n)]


def outside_g2(n):
    pts = []
    for j in range(n):
        u = GH.hash_to_field_fp2(b"outside-%d" % j, 1, b"torch-port-test")[0]
        pts.append(GH.map_to_curve_svdw(GC.FP2_OPS, u))
    assert all(GC.is_on_curve(GC.FP2_OPS, q) and not GC.g2_subgroup_check(q) for q in pts)
    return pts


# -- encoders for both packages; "f" is the field (1: Fp, 2: Fp2)


def t_el(vals, f):
    if f == 1:
        return LY.encode_digits(vals)
    return torch.stack([LY.encode_digits([v[0] for v in vals]), LY.encode_digits([v[1] for v in vals])])


def j_el(vals, f):
    if f == 1:
        return jnp.asarray(JL.encode_batch(vals))
    return (j_el([v[0] for v in vals], 1), j_el([v[1] for v in vals], 1))


def d_el(t, f):
    if f == 1:
        return LY.decode_digits(t)
    return list(zip(LY.decode_digits(t[0]), LY.decode_digits(t[1])))


def jd_el(x, f):
    if f == 1:
        return JL.decode_batch(np.asarray(x))
    return list(zip(jd_el(x[0], 1), jd_el(x[1], 1)))


def fops(f):
    return (GC.FP_OPS, CV.FP_OPS, JCV.FP_OPS) if f == 1 else (GC.FP2_OPS, CV.FP2_OPS, JCV.FP2_OPS)


def field_mul(f, a, b):
    return a * b % P if f == 1 else GT.fp2_mul(a, b)


def to_jac(pts, f):
    """Affine points with random Z: (x Z^2, y Z^3, Z), as field values."""
    out = []
    for x, y in pts:
        z = rand_fp() if f == 1 else (rand_fp(), rand_fp())
        z2 = field_mul(f, z, z)
        out.append((field_mul(f, x, z2), field_mul(f, y, field_mul(f, z2, z)), z))
    return out


def enc_jac(jpts, f):
    port = tuple(t_el([p[c] for p in jpts], f) for c in range(3))
    jx = tuple(j_el([p[c] for p in jpts], f) for c in range(3))
    return port, jx


def dec_pt(pt, f):
    return list(zip(*[d_el(c, f) for c in pt]))


def jdec_pt(pt, f):
    return list(zip(*[jd_el(c, f) for c in pt]))


def to_affine(jpts, infs, f):
    gfo = fops(f)[0]
    out = []
    for (x, y, z), inf in zip(jpts, infs):
        out.append(None if inf else GC._to_affine(gfo, (x, y, z)))
    return out


# ---------------------------------------------------------------------------
# curve layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("f", [1, 2])
def test_jac_dbl_and_mixed_add_match_jax(f):
    gfo, tfo, jfo = fops(f)
    ps = g1(N) if f == 1 else g2(N)
    qs = g1(N) if f == 1 else g2(N)
    jp = to_jac(ps, f)
    (tp, jxp) = enc_jac(jp, f)
    q_port = (t_el([q[0] for q in qs], f), t_el([q[1] for q in qs], f))
    q_jax = (j_el([q[0] for q in qs], f), j_el([q[1] for q in qs], f))
    dbl = dec_pt(CV.jac_dbl(tfo, tp), f)
    assert dbl == jdec_pt(JCV.jac_dbl(jfo, jxp), f)
    assert to_affine(dbl, [False] * N, f) == [GC.affine_dbl(gfo, p) for p in ps]
    add = dec_pt(CV.jac_add_mixed(tfo, tp, q_port), f)
    assert add == jdec_pt(JCV.jac_add_mixed(jfo, jxp, q_jax), f)
    assert to_affine(add, [False] * N, f) == [GC.affine_add(gfo, p, q) for p, q in zip(ps, qs)]
    neg = dec_pt(CV.jac_neg(tfo, tp), f)
    assert to_affine(neg, [False] * N, f) == [GC.affine_neg(gfo, p) for p in ps]


@pytest.mark.parametrize("f", [1, 2])
def test_jac_add_full_edge_cases_match_jax(f):
    """Generic, doubling, inverse and infinity lanes in one batch."""
    gfo, tfo, jfo = fops(f)
    a, b, c, d = g1(4) if f == 1 else g2(4)
    na = GC.affine_neg(gfo, a)
    # lanes: a+b, a+a, a+(-a), O+b, a+O, O+O, c+d, d+c
    ps = [a, a, a, a, a, a, c, d]
    qs = [b, a, na, b, b, b, d, c]
    p_inf = [False, False, False, True, False, True, False, False]
    q_inf = [False, False, False, False, True, True, False, False]
    jp, jq = to_jac(ps, f), to_jac(qs, f)
    (tp, jxp), (tq, jxq) = enc_jac(jp, f), enc_jac(jq, f)
    out, inf = CV.jac_add_full(tfo, tp, torch.tensor(p_inf), tq, torch.tensor(q_inf))
    jout, jinf = JCV.jac_add_full(jfo, jxp, jnp.asarray(p_inf), jxq, jnp.asarray(q_inf))
    assert inf.tolist() == list(np.asarray(jinf))
    assert dec_pt(out, f) == jdec_pt(jout, f)
    want = [GC.affine_add(gfo, a, b), GC.affine_dbl(gfo, a), None, b, a, None,
            GC.affine_add(gfo, c, d), GC.affine_add(gfo, d, c)]
    assert to_affine(dec_pt(out, f), inf.tolist(), f) == want
    # jac_eq: equal points under different Z, unequal points, infinity
    eq = CV.jac_eq(tfo, tp, torch.tensor(p_inf), tq, torch.tensor(q_inf))
    jeq = JCV.jac_eq(jfo, jxp, jnp.asarray(p_inf), jxq, jnp.asarray(q_inf))
    assert eq.tolist() == list(np.asarray(jeq))
    assert eq.tolist() == [False, True, False, False, False, True, False, False]


def test_g2_psi_matches_jax():
    qs = g2(N)
    jq = to_jac(qs, 2)
    tq, jxq = enc_jac(jq, 2)
    assert dec_pt(CV.g2_psi(tq), 2) == jdec_pt(JCV.g2_psi(jxq), 2)


def test_scalar_mul_static_matches_oracle():
    ks = [2, 3, 0xD201000000010000, (1 << 64) - 1]
    for f in (1, 2):
        gfo, tfo, _ = fops(f)
        pts = g1(2) if f == 1 else g2(2)
        q = (t_el([p[0] for p in pts], f), t_el([p[1] for p in pts], f))
        for k in ks:
            got = to_affine(dec_pt(CV.scalar_mul_static(tfo, q, k), f), [False, False], f)
            assert got == [GC.scalar_mul(gfo, p, k) for p in pts]


def test_g2_subgroup_check_matches_oracle():
    """Subgroup points pass, on-curve points outside G2 fail, and an
    infinity lane passes whatever its coordinates."""
    pts = g2(4) + outside_g2(4)
    q = (t_el([p[0] for p in pts], 2), t_el([p[1] for p in pts], 2))
    inf = torch.tensor([False] * 7 + [True])
    got = CV.g2_subgroup_check(q, inf).tolist()
    assert got == [GC.g2_subgroup_check(p) for p in pts[:7]] + [True]
    assert got == [True] * 4 + [False] * 3 + [True]


# ---------------------------------------------------------------------------
# pairing layer
# ---------------------------------------------------------------------------


def _fp12_ints(t):
    """Port Fp12 [2, 3, 2, ND, n] -> per lane tuple of 12 ints (leaf order)."""
    flat = t.reshape(12, LY.ND, t.shape[-1])
    cols = [LY.decode_digits(flat[k]) for k in range(12)]
    return list(zip(*cols))


def _jax_fp12_ints(f):
    return list(zip(*[JL.decode_batch(np.asarray(leaf)) for leaf in jax.tree_util.tree_leaves(f)]))


def _oracle_fp12_ints(v):
    return tuple(x for half in v for c in half for x in c)


def _miller_inputs():
    ps, qs = g1(N), g2(N)
    jp = to_jac(ps, 1)
    tp, jxp = enc_jac(jp, 1)
    T = to_jac(g2(N), 2)
    tT, jT = enc_jac(T, 2)
    tq = (t_el([q[0] for q in qs], 2), t_el([q[1] for q in qs], 2))
    jq = (j_el([q[0] for q in qs], 2), j_el([q[1] for q in qs], 2))
    return (ps, qs), (tp, jxp), (tT, jT), (tq, jq)


def test_miller_steps_match_jax():
    """_p_planes, _dbl_step, _add_step and the sparse line product give
    the JAX package's exact values: the same formulas and scalings."""
    _, (tp, jxp), (tT, jT), (tq, jq) = _miller_inputs()
    pw, jpw = KP._p_planes(tp), JP._p_planes(jxp)
    assert [d_el(w, 1) for w in pw] == [jd_el(w, 1) for w in jpw]
    for port_step, jax_step, args, jargs in (
        (KP._dbl_step, JP._dbl_step, (tT, pw), (jT, jpw)),
        (KP._add_step, JP._add_step, (tT, tq, pw), (jT, jq, jpw)),
    ):
        (line, T2), (jline, jT2) = port_step(*args), jax_step(*jargs)
        assert [d_el(c, 2) for c in line] == [jd_el(c, 2) for c in jline]
        assert dec_pt(T2, 2) == jdec_pt(jT2, 2)
    # sparse product of a random Fp12 with the doubling line
    f_vals = [tuple(tuple((rand_fp(), rand_fp()) for _ in range(3)) for _ in range(2)) for _ in range(N)]
    tf = torch.stack([torch.stack([t_el([v[h][i] for v in f_vals], 2) for i in range(3)]) for h in range(2)])
    jf = tuple(tuple(j_el([v[h][i] for v in f_vals], 2) for i in range(3)) for h in range(2))
    line, _ = KP._dbl_step(tT, pw)
    jline, _ = JP._dbl_step(jT, jpw)
    assert _fp12_ints(KP._mul12_sparse(tf, line)) == _jax_fp12_ints(JP._mul12_sparse(jf, jline))


def test_pairing_matches_oracle_cubed():
    """final_exponentiation(miller_loop(P, Q)) == e(P, Q)^3 with P in
    Jacobian form (Z != 1), which exercises the line scaling."""
    ps, qs = g1(2), g2(2)
    tp, _ = enc_jac(to_jac(ps, 1), 1)
    tq = (t_el([q[0] for q in qs], 2), t_el([q[1] for q in qs], 2))
    got = _fp12_ints(KP.final_exponentiation(KP.miller_loop(tp, tq)))
    want = [_oracle_fp12_ints(GT.fp12_pow(GP.pairing(p, q), 3)) for p, q in zip(ps, qs)]
    assert got == want


def test_pairing_is_bilinear_on_the_port():
    """e(aP, Q) == e(P, aQ) and e(P, Q) e(-P, Q) == 1, lane by lane."""
    p, q = GC.G1_GEN, g2(1)[0]
    a = scalar()
    ap = GC.scalar_mul(GC.FP_OPS, p, a)
    aq = GC.scalar_mul(GC.FP2_OPS, q, a)
    negp = GC.affine_neg(GC.FP_OPS, p)
    ps, qs = [ap, p, p, negp], [q, aq, q, q]
    tp = tuple(t_el(c, 1) for c in ([x for x, _ in ps], [y for _, y in ps], [1] * 4))
    tq = (t_el([x for x, _ in qs], 2), t_el([y for _, y in qs], 2))
    f = KP.miller_loop(tp, tq)
    e = _fp12_ints(KP.final_exponentiation(f))
    assert e[0] == e[1]
    assert e[0] != _oracle_fp12_ints(GT.FP12_ONE)
    prod = TW.mul12(f[..., 2:3], f[..., 3:4])
    assert TW.is_one12(KP.final_exponentiation(prod)).tolist() == [True]


# ---------------------------------------------------------------------------
# the JAX loops themselves (jit of the loop bodies: minutes on this host)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_miller_loop_value_equals_jax_kernel_value():
    """The port's Miller value equals lodestar_tpu.kernels.pairing.
    miller_loop's as canonical Fp12 integers, before any final
    exponentiation."""
    (ps, qs), (tp, jxp), _, (tq, jq) = _miller_inputs()
    got = _fp12_ints(KP.miller_loop(tp, tq))
    want = _jax_fp12_ints(jax.jit(JP.miller_loop)(jxp, jq))
    assert got == want


@pytest.mark.slow
def test_g2_subgroup_check_equals_jax():
    pts = g2(4) + outside_g2(4)
    q = (t_el([p[0] for p in pts], 2), t_el([p[1] for p in pts], 2))
    jq = (j_el([p[0] for p in pts], 2), j_el([p[1] for p in pts], 2))
    inf = [False] * 6 + [True, False]
    got = CV.g2_subgroup_check(q, torch.tensor(inf)).tolist()
    want = np.asarray(jax.jit(JCV.g2_subgroup_check)(jq, jnp.asarray(inf))).tolist()
    assert got == want
