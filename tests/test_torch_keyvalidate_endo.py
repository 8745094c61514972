"""G1 KeyValidate's subgroup test by the sigma endomorphism
(`csrc/keyvalidate.cu`, its lane program `kernels/kv_program.py`).

The CUDA kernel decides membership by sigma(P) = [-z^2] P with incomplete
additions (an exceptional one zeroes Z for good, and Z_B = 0 refuses the
lane); its plain version (and the JAX package) by [r]P = O.  Here the host build of the kernel (the
same device code compiled with g++) and the program run on integers are
held against the crypto oracle `lodestar_tpu/crypto/curves.py`
(`g1_decompress` + `g1_subgroup_check`, a full [r]P), bit for bit on
(x, y) and the verdict, on keys built from E(Fp)'s cofactor components:
points of each prime order l dividing h1, made as [#E / l^k] Q of a
random curve point Q (l^k the l-part of #E) from a fixed seed, their
sums with a key of G1, the whole cofactor part [r] Q, random curve
points, a key of G1, x = 0, an x off the curve and the infinity flag,
each with both sort flags (infinity has one encoding).  E(Fp) has no point of order l^2 (its l-part
is Z/l x Z/l wherever l^2 divides h1; pinned below), so there is no such
case.
"""

import random
import shutil

import pytest
import torch

from lodestar_tpu.crypto import curves as GC
from lodestar_tpu.crypto import fields as GT
from lodestar_tpu_torch.bls.ingest import encode_pubkey_planes
from lodestar_tpu_torch.kernels import build as B
from lodestar_tpu_torch.kernels import kv_program as KP
from lodestar_tpu_torch.kernels import layout as LY
from lodestar_tpu_torch.kernels import verify as KV

P, R, Z = GT.P, GT.R, GT.X_PARAM
N_E = GT.H1_COFACTOR * R  # #E(Fp)
PRIMES = {3: 1, 11: 2, 10177: 2, 859267: 2, 52437899: 2}  # h1 = prod l^k
CASES = ([f"order_{ell}" for ell in PRIMES] + [f"g1_plus_order_{ell}" for ell in PRIMES]
         + ["cofactor_part", "g1_plus_cofactor_part", "on_curve_0", "on_curve_1", "on_curve_2", "g1_key", "x_zero",
            "off_curve", "infinity"])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: parallel test workers must not oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _on_curve(rng):
    while True:
        x = rng.randrange(P)
        y = GT.fp_sqrt((x * x * x + 4) % P)
        if y is not None:
            return x, y


def _x_key(x: int, sign: int = 0) -> bytes:
    out = bytearray(x.to_bytes(48, "big"))
    out[0] |= 0x80 | (0x20 if sign else 0)
    return bytes(out)


@pytest.fixture(scope="module")
def keys():
    """Case name -> its two compressed keys (both sort flags)."""
    rng = random.Random(0xC0FAC)
    g1 = GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, rng.randrange(1, R))
    pts = {}
    for ell, k in PRIMES.items():
        t = None
        while t is None:  # Q's l-part may be 0
            t = GC.scalar_mul(GC.FP_OPS, _on_curve(rng), N_E // ell**k)
        assert GC.scalar_mul(GC.FP_OPS, t, ell) is None
        pts[f"order_{ell}"] = t
        pts[f"g1_plus_order_{ell}"] = GC.affine_add(GC.FP_OPS, g1, t)
    pts["cofactor_part"] = GC.scalar_mul(GC.FP_OPS, _on_curve(rng), R)
    pts["g1_plus_cofactor_part"] = GC.affine_add(GC.FP_OPS, g1, pts["cofactor_part"])
    for i in range(3):
        pts[f"on_curve_{i}"] = _on_curve(rng)
    pts["g1_key"] = g1
    out = {}
    for name, pt in pts.items():
        c = GC.g1_compress(pt)
        out[name] = [c, bytes([c[0] ^ 0x20]) + c[1:]]
    x_off = 1
    while GT.fp_sqrt((x_off ** 3 + 4) % P) is not None:
        x_off += 1
    out["x_zero"] = [_x_key(0), _x_key(0, 1)]
    out["off_curve"] = [_x_key(x_off), _x_key(x_off, 1)]
    out["infinity"] = [GC.g1_compress(None)] * 2  # its one well-formed encoding
    assert sorted(out) == sorted(CASES)
    return out


def oracle(key: bytes):
    """(point or None, KeyValidate verdict) by the crypto oracle's [r]P."""
    if key[0] & 0x40:
        return None, False
    try:
        pt = GC.g1_decompress(key)
    except ValueError:
        return None, False
    return pt, GC.g1_subgroup_check(pt)


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler to build the CUDA sources for the host")
    return B.load_host("keyvalidate")


def host_keyvalidate(lib, keys_):
    planes, flags, host_bad = encode_pubkey_planes(keys_)
    assert not host_bad.any()
    x, fl = torch.from_numpy(planes), torch.from_numpy(flags)
    n = len(keys_)
    xy, ok = torch.empty((2, LY.NL, n), dtype=torch.int32), torch.empty((1, n), dtype=torch.int32)
    lib.lt_host_fp_muls()
    assert lib.lt_g1_keyvalidate(x.data_ptr(), fl.data_ptr(), xy.data_ptr(), ok.data_ptr(), n, None) == 0
    assert lib.lt_host_fp_muls() == n * KV.FP_MULS_PER_LANE["g1_keyvalidate"]
    return (x, fl), xy, ok


@pytest.mark.parametrize("case", CASES)
def test_host_build_and_program_equal_the_r_oracle(keys, lib, case):
    """Both sort flags of the case: the host-built kernel's (x, y) and ok
    are the oracle's point and [r]P verdict, and the program run on
    integers gives the same; an addition met its exceptional case only
    where the key is outside G1."""
    (x, fl), xy, ok = host_keyvalidate(lib, keys[case])
    xs, ys = LY.decode_batch(xy[0].numpy()), LY.decode_batch(xy[1].numpy())
    for i, key in enumerate(keys[case]):
        pt, want = oracle(key)
        assert ok[0, i].item() == int(want)
        if pt is not None:
            assert (xs[i], ys[i]) == pt
        sx, sy, sok, z_b_zero = KP.simulate(LY.decode_plain_batch(x[:, i : i + 1].numpy())[0], int(fl[0, i]))
        assert (sx, sy) == (KP.mont(xs[i]), KP.mont(ys[i]))
        assert (sok and not fl[1, i]) == bool(want)
        assert not (z_b_zero and want)
    assert (case == "g1_key") == bool(ok.all()) and (case == "g1_key" or not ok.any())


def test_host_build_equals_plain_on_every_case(keys, lib):
    """One plain call ([r]P by the complete addition) over every case's
    lanes: the host build's planes and verdicts, bit for bit."""
    all_keys = [k for case in CASES for k in keys[case]]
    (x, fl), xy, ok = host_keyvalidate(lib, all_keys)
    want = KV.g1_keyvalidate_plain(x, fl)
    assert torch.equal(xy, want[0]) and torch.equal(ok, want[1])
    assert int(ok.sum()) == 2


def test_exceptional_additions_zero_z_for_small_orders():
    """The x = 0 key (order 3) meets T = -P at its first addition, and a
    point of order 11 meets an exceptional addition too: both end with
    Z_B = 0; a key of G1 never does."""
    g1 = GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, 0x5EED)
    assert KP.simulate(0, 0)[3] and KP.simulate(0, 1)[3]
    t = None
    rng = random.Random(11)
    while t is None:
        t = GC.scalar_mul(GC.FP_OPS, _on_curve(rng), N_E // 11**2)
    assert KP.simulate(t[0], 0)[3]
    x, y, ok, z_b_zero = KP.simulate(g1[0], GT.fp_sgn(g1[1]))
    assert ok and not z_b_zero and y == KP.mont(g1[1])


def test_sigma_pins_beta_and_the_other_root_fails():
    """beta = 2^((p - 1) / 3) gives sigma(G) = -[z^2] G; its square, the
    other nontrivial cube root of unity, gives neither -[z^2] G nor
    [z^2] G.  constants.cuh carries beta (Montgomery form) and |z|."""
    w = pow(2, (P - 1) // 3, P)
    assert w != 1 and pow(w, 3, P) == 1
    g = GC.G1_GEN
    z2 = GC.scalar_mul(GC.FP_OPS, g, Z * Z)
    minus_z2 = GC.affine_neg(GC.FP_OPS, z2)
    assert LY.g1_beta() == w
    assert (g[0] * w % P, g[1]) == minus_z2
    other = (g[0] * w * w % P, g[1])
    assert other not in (minus_z2, z2)
    text = (B.CSRC / "constants.cuh").read_text()
    limbs = ", ".join(f"0x{int(v) & 0xFFFFFFFF:08x}u" for v in LY.to_limbs(KP.mont(w)))
    assert f"LT_G1_BETA[12] = {{{limbs}}};" in text
    assert f"#define LT_Z_ABS 0x{-Z:016x}ull" in text


def test_cofactor_has_no_point_of_order_l_squared():
    """For each l with l^2 | h1, E(Fp)'s l-part has exponent l (it is
    Z/l x Z/l): [#E / l] Q = O while [#E / l^2] Q has order l, for random
    Q; 3 divides h1 once."""
    rng = random.Random(0x12)
    assert GT.H1_COFACTOR == 3 * 11**2 * 10177**2 * 859267**2 * 52437899**2
    for ell, k in PRIMES.items():
        for _ in range(2):
            q = _on_curve(rng)
            assert GC.scalar_mul(GC.FP_OPS, q, N_E // ell) is None or k == 1
            t = GC.scalar_mul(GC.FP_OPS, q, N_E // ell**k)
            assert t is None or GC.scalar_mul(GC.FP_OPS, t, ell) is None


def test_program_shape():
    """9 slots; the plain x is read once, as the first product's second
    operand (the product needs its first operand canonical); the
    products are the cost model's."""
    p = KP.program()
    assert p.fp_muls == KV.FP_MULS_PER_LANE["g1_keyvalidate"] == KV.FP_MULS_NEEDED["g1_keyvalidate"]
    assert p.ops[0] == (KP.MUL, KP.HOOKS["X"], p.c("R2"), KP.HOOKS["XIN"])
    for kind, d, a, b in p.ops[1:]:  # until the slot is written again
        assert KP.HOOKS["XIN"] not in (a, b)
        if d == KP.HOOKS["XIN"]:
            break
    assert {op[0] for op in p.ops} == {KP.MUL, KP.ADD, KP.SUB}
    assert all(d < KP.SLOTS for _, d, _, _ in p.ops) and len(p.starts) == len(KP.SEGMENTS) + 1
    text = KP.cuda_program()
    assert f"LT_KV_PROG[{len(p.ops)}]" in text and f"#define LT_KV_SLOTS {KP.SLOTS}" in text
