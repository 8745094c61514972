"""The port's windowed scalar multiplication (kernels/curve.py
scalar_mul_window_jac, the plain version of the g1_rpk / g2_rsig_sub
kernels) against the JAX package's, as Jacobian integers.

The JAX function runs as its own fast tests run it: under jit at the
narrow window (w = 2, 32 bits, tests/test_kernels_scalar_fast.py:117)
and eagerly at the production window w = 4 over 16 bits, both far
cheaper to trace than w = 4 at 128 bits, which is `slow`.  Equal
Jacobian coordinates (not only points) are what make the port's Miller
loop over r_i pk_i equal the JAX kernel's values.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lodestar_tpu.crypto import curves as GC
from lodestar_tpu.crypto import fields as GT
from lodestar_tpu.kernels import curve as JCV
from lodestar_tpu.kernels import layout as JL
from lodestar_tpu_torch.kernels import curve as CV
from lodestar_tpu_torch.kernels import layout as LY

P = GT.P
B = 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(f, nbits, seed):
    """B lanes: edge scalars 0, 1, 2, 15, 16, all ones, one random scalar,
    and a lane whose base is flagged infinity; bases in Jacobian form
    with random Z."""
    rng = np.random.default_rng(seed)
    top = (1 << nbits) - 1
    ks = [0, 1, 2, 15, 16, top, int.from_bytes(rng.bytes(nbits // 8), "big") | 1, 7]
    inf = [False] * 7 + [True]
    fo = GC.FP_OPS if f == 1 else GC.FP2_OPS
    gen = GC.G1_GEN if f == 1 else GC.G2_GEN
    pts = [GC.scalar_mul(fo, gen, int(k)) for k in rng.integers(2, 1 << 30, B)]

    def rnd():
        v = int.from_bytes(rng.bytes(48), "little") % P
        return v if f == 1 else (v, int.from_bytes(rng.bytes(48), "little") % P)

    mul = (lambda a, b: a * b % P) if f == 1 else GT.fp2_mul
    jac = []
    for x, y in pts:
        z = rnd()
        z2 = mul(z, z)
        jac.append((mul(x, z2), mul(y, mul(z2, z)), z))
    return ks, inf, pts, jac


def _digits(ks, nbits, w):
    return np.array([[(k >> (nbits - w * (t + 1))) & ((1 << w) - 1) for k in ks] for t in range(nbits // w)],
                    np.int32)


def _port(f, vals):
    if f == 1:
        return LY.encode_digits(vals)
    return torch.stack([LY.encode_digits([v[0] for v in vals]), LY.encode_digits([v[1] for v in vals])])


def _jax(f, vals):
    if f == 1:
        return jnp.asarray(JL.encode_batch(vals))
    return tuple(jnp.asarray(JL.encode_batch([v[k] for v in vals])) for k in range(2))


def _dec_port(f, t):
    if f == 1:
        return LY.decode_digits(t)
    return list(zip(LY.decode_digits(t[0]), LY.decode_digits(t[1])))


def _dec_jax(f, x):
    if f == 1:
        return JL.decode_batch(np.asarray(x))
    return list(zip(JL.decode_batch(np.asarray(x[0])), JL.decode_batch(np.asarray(x[1]))))


def _compare(f, nbits, w, seed, jit: bool):
    ks, inf, pts, jac = _inputs(f, nbits, seed)
    digits = _digits(ks, nbits, w)
    q_port = tuple(_port(f, [p[c] for p in jac]) for c in range(3))
    q_jax = tuple(_jax(f, [p[c] for p in jac]) for c in range(3))
    tdig = torch.from_numpy(digits)
    fo_port = CV.FP_OPS if f == 1 else CV.FP2_OPS
    fo_jax = JCV.FP_OPS if f == 1 else JCV.FP2_OPS
    (X, Y, Z), t_inf = CV.scalar_mul_window_jac(fo_port, q_port, torch.tensor(inf), lambda t: tdig[t], nbits, w)

    def run(q, d, i):
        return JCV.scalar_mul_window_jac(fo_jax, q, i, lambda t: d[t], nbits, w)

    if jit:
        (jX, jY, jZ), j_inf = jax.jit(run)(q_jax, jnp.asarray(digits), jnp.asarray(inf))
    else:
        with jax.disable_jit():
            (jX, jY, jZ), j_inf = run(q_jax, jnp.asarray(digits), jnp.asarray(inf))
    assert t_inf.tolist() == np.asarray(j_inf).tolist() == [k == 0 or i for k, i in zip(ks, inf)]
    for port_c, jax_c in ((X, jX), (Y, jY), (Z, jZ)):
        assert _dec_port(f, port_c) == _dec_jax(f, jax_c)
    # and the points are the oracle's k P
    fo = GC.FP_OPS if f == 1 else GC.FP2_OPS
    coords = list(zip(_dec_port(f, X), _dec_port(f, Y), _dec_port(f, Z)))
    for (x, y, z), k, pt, i in zip(coords, ks, pts, t_inf.tolist()):
        if not i:
            assert GC._to_affine(fo, (x, y, z)) == GC.scalar_mul(fo, pt, k)


@pytest.mark.parametrize("f", [1, 2], ids=["G1", "G2"])
def test_window2_32bit_equals_jax_jacobian(f):
    _compare(f, 32, 2, 0xD0CE + f, jit=True)


@pytest.mark.parametrize("f", [1, 2], ids=["G1", "G2"])
def test_window4_16bit_equals_jax_jacobian(f):
    _compare(f, 16, 4, 0xD1CE + f, jit=False)


@pytest.mark.slow
@pytest.mark.parametrize("f", [1, 2], ids=["G1", "G2"])
def test_window4_128bit_equals_jax_jacobian(f):
    """The production configuration, w = 4 over 128 bits (the jit traces
    the 15-entry table: minutes on a CPU host)."""
    _compare(f, 128, 4, 0xD2CE + f, jit=True)
