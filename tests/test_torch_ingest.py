"""The port's ingest slice, module by module: square roots, signs, G2
decompression, hash to G2, pubkey aggregation and the host side of
`bls/ingest.py`.

Each plain torch version (what a wrapper runs on the CPU) and each
host-built CUDA source (`kernels/build.py load_host`: the same device
functions compiled with g++) is held against the crypto oracle
`lodestar_tpu/crypto/` or the JAX package's functions, exactly: integers,
points and booleans.  The host build is also held bit for bit against the
plain version in tests/test_torch_csrc_host.py, which counts its Fp
products; the card runs the CUDA build in tests/test_torch_cuda.py and
chip_smoke.py.  The plain hash costs seconds per call whatever its width,
so one 4-lane hash serves every hash test here.  The comparisons with the
JAX value-level functions and the JAX Pallas `_gather_pk` (interpret
mode) are `slow`.
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lodestar_tpu.bls import ingest as JIN
from lodestar_tpu.crypto import curves as GC
from lodestar_tpu.crypto import fields as GT
from lodestar_tpu.crypto import hash_to_curve as GH
from lodestar_tpu.kernels import curve as JCV
from lodestar_tpu.kernels import layout as JL
from lodestar_tpu_torch.bls import ingest as IN
from lodestar_tpu_torch.kernels import build as B
from lodestar_tpu_torch.kernels import canonical as CN
from lodestar_tpu_torch.kernels import ingest as IG
from lodestar_tpu_torch.kernels import layout as LY
from lodestar_tpu_torch.kernels import sqrt as SQ
from lodestar_tpu_torch.kernels import verify as KV

P = GT.P
RNG = np.random.default_rng(0x16E5)
ROOTS = [b"ingest-root-%d" % i for i in range(4)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: parallel test workers must not oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def libs():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler to build the CUDA sources for the host")
    return {name: B.load_host(name) for name in ("ingest", "aggpk")}


def rand_fp():
    return int.from_bytes(RNG.bytes(48), "little") % P


def i32(*shape):
    return torch.empty(shape, dtype=torch.int32)


def fp2_planes(vals):
    """Fp2 ints -> Montgomery planes int32 [2, 12, n]."""
    return torch.from_numpy(np.stack([LY.encode_batch([v[k] for v in vals]) for k in range(2)])).contiguous()


def fp2_ints(planes):
    """Montgomery planes [2, 12, n] -> Fp2 ints."""
    return list(zip(*(LY.decode_batch(planes[k].numpy()) for k in range(2))))


def digits(planes):
    return LY.planes_to_digits(planes)


def to_affine(x, y, z):
    zi = GT.fp2_inv(z)
    zi2 = GT.fp2_sqr(zi)
    return GT.fp2_mul(x, zi2), GT.fp2_mul(y, GT.fp2_mul(zi2, zi))


# ---------------------------------------------------------------------------
# square roots and signs
# ---------------------------------------------------------------------------


def _sqrt_cases():
    squares = [GT.fp2_sqr((rand_fp(), rand_fp())) for _ in range(4)]
    non = []
    while len(non) < 3:
        a = (rand_fp(), rand_fp())
        if GT.fp2_sqrt(a) is None:
            non.append(a)
    res0 = GT.fp_mul(rand_fp(), rand_fp())
    res0 = res0 * res0 % P  # a residue of Fp
    non0 = next(a for a in range(2, 100) if GT.fp_sqrt(a) is None)
    edge = [(0, 0), (1, 0), (P - 1, 0), (0, P - 1), (P - 1, P - 1), (0, 1), (res0, 0), (non0, 0)]
    return squares + non + edge


def test_fp2_sqrt_plain_and_host_equal_oracle(libs):
    """Residues, non-residues, the a1 = 0 cases (real and imaginary roots),
    0 and p - 1: ok iff the oracle finds a root, and then the same root."""
    vals = _sqrt_cases()
    n = len(vals)
    a = fp2_planes(vals)
    root, ok = SQ.fp2_sqrt(digits(a))
    want = [GT.fp2_sqrt(v) for v in vals]
    assert ok.tolist() == [w is not None for w in want]
    got = fp2_ints(LY.digits_to_planes(root))
    assert [g for g, w in zip(got, want) if w is not None] == [w for w in want if w is not None]
    r, hok = i32(2, LY.NL, n), i32(n)
    assert libs["ingest"].lt_host_fp2_sqrt(a.data_ptr(), r.data_ptr(), hok.data_ptr(), n) == 0
    assert hok.tolist() == [int(v) for v in ok.tolist()]
    assert torch.equal(r, LY.digits_to_planes(root))


def test_signs_plain_and_host_equal_oracle(libs):
    """fp_sgn, sgn0, fp2_sgn and fp2_sgn0 on every pair of the edge values
    0, 1, (p - 1) / 2, (p + 1) / 2, p - 1."""
    edge = [0, 1, (P - 1) // 2, (P + 1) // 2, P - 1]
    vals = [(a, b) for a in edge for b in edge]
    n = len(vals)
    a = fp2_planes(vals)
    d = digits(a)
    want = [
        [GT.fp_sgn(v[0]) for v in vals],
        [v[0] % 2 for v in vals],
        [GT.fp2_sgn(v) for v in vals],
        [GH._sgn0_fp2(v) for v in vals],
    ]
    got = [CN.fp_sgn(d[0]), CN.fp_sgn0(d[0]), CN.fp2_sgn(d), CN.fp2_sgn0(d)]
    assert [g.to(torch.int32).tolist() for g in got] == want
    out = i32(4, n)
    assert libs["ingest"].lt_host_signs(a.data_ptr(), out.data_ptr(), n) == 0
    assert out.tolist() == want


# ---------------------------------------------------------------------------
# G2 decompression
# ---------------------------------------------------------------------------


def _wire_x_cases():
    """(x planes [2, 12, n] plain, flags [2, n], oracle points or the
    strings "inf" / "off")."""
    pts = [GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, int(k)) for k in RNG.integers(2, 1 << 62, size=6)]
    sigs = [GC.g2_compress(p) for p in pts] + [GC.g2_compress(None)]
    want = list(pts) + ["inf"]
    k = 1
    while sum(w == "off" for w in want) < 3:  # x with no y, found by trial
        x = (k, k + 7)
        rhs = GT.fp2_add(GT.fp2_mul(GT.fp2_sqr(x), x), GC.FP2_OPS.b_coeff)
        if GT.fp2_sqrt(rhs) is None:
            sigs.append(bytes([0x80 | (x[1] >> 376)]) + x[1].to_bytes(48, "big")[1:] + x[0].to_bytes(48, "big"))
            want.append("off")
        k += 1
    parsed = [IN.parse_signature_bytes(s) for s in sigs]
    assert all(p[4] for p in parsed) and {p[2] for p in parsed[:6]} == {0, 1}
    x = torch.from_numpy(np.stack([LY.encode_plain_batch([p[i] for p in parsed]) for i in range(2)]))
    flags = torch.tensor([[p[2] for p in parsed], [p[3] for p in parsed]], dtype=torch.int32)
    return x.contiguous(), flags, want, sigs


def test_g2_decompress_plain_and_host_equal_oracle(libs):
    """Valid compressed points of both signs, the infinity encoding and x
    values with no y: (x, y) equals crypto/curves.py g2_decompress, ok is
    1 for points and infinity and 0 off the curve."""
    x, flags, want, sigs = _wire_x_cases()
    n = len(want)
    xy, ok = KV.g2_decompress(x, flags)
    assert ok[0].tolist() == [int(w != "off") for w in want]
    got = list(zip(fp2_ints(xy[0]), fp2_ints(xy[1])))
    for g, w, s in zip(got, want, sigs):
        if w == "off":
            with pytest.raises(ValueError, match="not on curve"):
                GC.g2_decompress(s)
        elif w != "inf":
            assert g == w == GC.g2_decompress(s)
    hxy, hok = i32(2, 2, LY.NL, n), i32(1, n)
    assert libs["ingest"].lt_g2_decompress(x.data_ptr(), flags.data_ptr(), None, hxy.data_ptr(), None,
                                           hok.data_ptr(), n, None) == 0
    assert torch.equal(hxy, xy) and torch.equal(hok, ok)


# ---------------------------------------------------------------------------
# hash to G2
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hashed():
    """One plain hash of the 4 roots through the port's MessageCache (a
    4-lane batch), recording the wrapper's operands and outputs."""
    calls = []
    real = KV.hash_g2

    def recording(u, sgn):
        out = real(u, sgn)
        calls.append((u, sgn) + out)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(IN, "BT", 4)
        mp.setattr(KV, "hash_g2", recording)
        cache = IN.MessageCache(device="cpu")
        pts = cache.get_many(ROOTS)
    assert len(calls) == 1
    return dict(cache=cache, pts=pts, call=calls[0])


def test_hash_g2_plain_and_host_equal_oracle(hashed, libs):
    """The plain hash (inside MessageCache) and the host build give the
    same Jacobian planes, whose affine points are hash_to_g2 of the roots."""
    u, sgn, out, ok = hashed["call"]
    assert ok.tolist() == [[1, 1, 1, 1]]
    jac = [fp2_ints(out[c]) for c in range(3)]
    want = [GH.hash_to_g2(r) for r in ROOTS]
    assert [to_affine(*p) for p in zip(*jac)] == want == hashed["pts"]
    n = len(ROOTS)
    hout, hok = i32(3, 2, LY.NL, n), i32(1, n)
    assert libs["ingest"].lt_hash_g2(u.data_ptr(), sgn.data_ptr(), hout.data_ptr(), hok.data_ptr(), n, None) == 0
    assert torch.equal(hout, out) and torch.equal(hok, ok)


def test_sswu_exceptional_branch_plain_and_host_equal_oracle(libs):
    """tv1 = Z^2 u^4 + Z u^2 = 0 takes x1 = B / (Z A) (u = 0, and a u with
    Z u^2 = -1), beside two ordinary u: the SSWU point equals
    map_to_curve_sswu_g2."""
    u_m1 = GT.fp2_sqrt(GT.fp2_neg(GT.fp2_inv(GH._Z2)))  # Z u^2 = -1
    us = [(0, 0), (rand_fp(), rand_fp()), (rand_fp(), 0)] + ([u_m1] if u_m1 is not None else [])
    n = len(us)
    a = fp2_planes(us)
    sgn = torch.tensor([GH._sgn0_fp2(u) for u in us], dtype=torch.int32)
    x, y = IG.sswu_map_g2(digits(a), sgn != 0)
    got = list(zip(fp2_ints(LY.digits_to_planes(x)), fp2_ints(LY.digits_to_planes(y))))
    assert got == [GH.map_to_curve_sswu_g2(u) for u in us]
    r = i32(2, 2, LY.NL, n)
    assert libs["ingest"].lt_host_sswu(a.data_ptr(), sgn.data_ptr(), r.data_ptr(), n) == 0
    assert torch.equal(r, LY.digits_to_planes(torch.stack([x, y])))


# ---------------------------------------------------------------------------
# pubkey aggregation
# ---------------------------------------------------------------------------


def _agg_case(k):
    """A table of 6 keys and the negation of key 0; 4 lanes: random rows
    with random masks, every row masked, P and -P meeting in the tree's
    first round, and every row live."""
    keys = [GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, int(s)) for s in RNG.integers(2, 1 << 62, size=6)]
    keys.append(GC.affine_neg(GC.FP_OPS, keys[0]))
    n = 4
    idx = RNG.integers(0, 6, size=(n, k)).astype(np.int32)
    kmask = (RNG.random((n, k)) < 0.7).astype(np.int32)
    kmask[1] = 0
    kc = min(k, KV.AGG_CHUNK)
    idx[2, 0], idx[2, (kc + 1) // 2] = 0, 6  # rows 0 and half of the first chunk
    kmask[2, 0] = kmask[2, (kc + 1) // 2] = 1
    kmask[3] = 1
    return keys, idx, kmask


@pytest.fixture(scope="module")
def jax_add():
    """JAX's jac_add_full jitted once at one width: every call's leading
    rows are folded into the lane axis (the addition is lane-wise) and
    padded to 32 x 4 lanes, so the eager tree of sum_points_axis0 below
    compiles one addition instead of one per tree level."""
    real = JCV.jac_add_full
    width = 32 * 4
    add = jax.jit(lambda p, p_inf, q, q_inf: real(JCV.FP_OPS, p, p_inf, q, q_inf))

    def flat(a):  # [..., NL, N] -> [NL, width]
        a = jnp.moveaxis(a, -2, 0).reshape(a.shape[-2], -1)
        return jnp.pad(a, ((0, 0), (0, width - a.shape[1])))

    def lanes(m):
        return jnp.pad(m.reshape(-1), (0, width - m.size))

    def folded(fo, p, p_inf, q, q_inf):
        assert fo is JCV.FP_OPS
        s, s_inf = add(tuple(map(flat, p)), lanes(p_inf), tuple(map(flat, q)), lanes(q_inf))
        shape = p[0].shape
        back = [jnp.moveaxis(c[:, : p_inf.size].reshape(shape[-2], *p_inf.shape), 0, -2) for c in s]
        return tuple(back), s_inf[: p_inf.size].reshape(p_inf.shape)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JCV, "jac_add_full", folded)
        yield


def _jax_agg(keys, idx, kmask):
    """The JAX value-level order of `_k_agg_pk`: a tree per chunk of
    min(K, 32) rows (curve.py sum_points_axis0), the chunk sums added in
    order (jac_add_full)."""
    n, k = idx.shape
    kc = min(k, 32)
    gx = jnp.asarray(np.stack([JL.encode_batch([keys[i][0] for i in idx[:, j]]) for j in range(k)]))
    gy = jnp.asarray(np.stack([JL.encode_batch([keys[i][1] for i in idx[:, j]]) for j in range(k)]))
    one = jnp.asarray(JL.encode_batch([1] * n))
    m = jnp.asarray(kmask.T)
    acc = acc_inf = None
    for c in range(0, k, kc):
        x, y = gx[c : c + kc], gy[c : c + kc]
        s, s_inf = JCV.sum_points_axis0(JCV.FP_OPS, (x, y, jnp.broadcast_to(one, x.shape)), m[c : c + kc] == 0)
        if acc is None:
            acc, acc_inf = s, s_inf
        else:
            acc, acc_inf = JCV.jac_add_full(JCV.FP_OPS, acc, acc_inf, s, s_inf)
    return [JL.decode_batch(np.asarray(c)) for c in acc], np.asarray(acc_inf).tolist()


@pytest.mark.parametrize("k", [4, 64])
def test_agg_pk_plain_and_host_equal_jax(libs, jax_add, k):
    """K = 4 (one chunk) and K = 64 (two chunks of 32): the Jacobian
    integers and infinity flags of the JAX order, and the oracle's sum."""
    keys, idx, kmask = _agg_case(k)
    tx = torch.from_numpy(LY.encode_batch([p[0] for p in keys]))
    ty = torch.from_numpy(LY.encode_batch([p[1] for p in keys]))
    ti, tm = torch.from_numpy(idx), torch.from_numpy(kmask)
    out, out_inf = KV.agg_pk(tx, ty, ti, tm)
    jac, inf = _jax_agg(keys, idx, kmask)
    assert [LY.decode_batch(out[c].numpy()) for c in range(3)] == jac
    assert out_inf[0].tolist() == [int(v) for v in inf]
    for lane in range(idx.shape[0]):
        want = GC.multi_add(GC.FP_OPS, [keys[i] for i, m in zip(idx[lane], kmask[lane]) if m])
        x, y, z = (c[lane] for c in jac)
        got = None if inf[lane] else (x * pow(z, -2, P) % P, y * pow(z, -3, P) % P)
        assert got == want, lane
    assert inf[1]
    n = idx.shape[0]
    hout, hinf = i32(3, LY.NL, n), i32(1, n)
    assert libs["aggpk"].lt_agg_pk(tx.data_ptr(), ty.data_ptr(), len(keys), ti.data_ptr(), tm.data_ptr(), k,
                                   hout.data_ptr(), hinf.data_ptr(), n, None) == 0
    assert torch.equal(hout, out) and torch.equal(hinf, out_inf)


# ---------------------------------------------------------------------------
# bls/ingest.py: wire parsing and the message cache
# ---------------------------------------------------------------------------


def _wire_bytes():
    good = GC.g2_compress(GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, 12345))
    inf = GC.g2_compress(None)
    big = (P + 3).to_bytes(48, "big")
    return [
        good,
        inf,
        good[:95],  # short
        good + b"\x00",  # long
        bytes([good[0] & 0x7F]) + good[1:],  # no compression bit
        bytes([0xE0]) + inf[1:],  # infinity with the sign bit
        bytes([0xC1]) + inf[1:],  # infinity with x bits in the flag byte
        inf[:50] + b"\x01" + inf[51:],  # infinity with a payload
        bytes([0x80 | big[0]]) + big[1:] + good[48:],  # x1 >= p
        good[:48] + P.to_bytes(48, "big"),  # x0 = p
        b"",
    ]


def test_parse_and_encode_wire_equal_jax():
    sigs = _wire_bytes()
    assert [IN.parse_signature_bytes(s) for s in sigs] == [JIN.parse_signature_bytes(s) for s in sigs]
    assert [IN.parse_signature_bytes(s)[4] for s in sigs] == [True, True] + [False] * 9
    n = len(sigs) + 3
    got = IN.encode_wire_planes(sigs, n)
    want = JIN.encode_wire_planes(sigs, n)
    # the flags and host_bad rows are equal; the x planes spell the same
    # integers in each package's limbs (32-bit here, 12-bit in JAX)
    assert all(np.array_equal(g, w) and g.dtype == w.dtype for g, w in zip(got[2:], want[2:]))
    for g, w in zip(got[:2], want[:2]):
        assert LY.decode_plain_batch(g) == [JL.from_limbs(w[:, j]) for j in range(n)]
    assert LY.decode_plain_batch(got[0]) == [p[0] for p in map(IN.parse_signature_bytes, sigs)] + [0] * 3


def test_message_cache_equals_jax_host_hash(hashed):
    """The device-hashed cache equals the JAX cache hashing on the host."""
    jcache = JIN.MessageCache(use_device=False)
    assert hashed["pts"] == jcache.get_many(ROOTS)
    cache = hashed["cache"]
    assert (cache.hits, cache.misses) == (0, len(ROOTS))


def test_message_cache_lru_and_counts_equal_jax(monkeypatch):
    """Hits, misses, the LRU eviction order and repeated roots in one
    lookup, against the JAX cache, with the hash itself stubbed by the
    oracle (the hashing is tested above)."""
    oracle = {}

    def hash_batch(roots):
        for r in roots:
            oracle.setdefault(r, GH.hash_to_g2(r))
        return {r: oracle[r] for r in roots}

    port = IN.MessageCache(max_entries=3, device="cpu")
    monkeypatch.setattr(port, "_hash_batch_device", hash_batch)
    jx = JIN.MessageCache(max_entries=3, use_device=True)
    monkeypatch.setattr(jx, "_hash_batch_device", hash_batch)
    r = [b"lru-%d" % i for i in range(5)]
    for lookup in ([r[0], r[1], r[0]], [r[2]], [r[0], r[3]], [r[1], r[4], r[4]], [r[0]]):
        assert port.get_many(lookup) == jx.get_many(lookup) == [oracle[x] for x in lookup]
        assert (port.hits, port.misses, list(port._cache)) == (jx.hits, jx.misses, list(jx._cache))
    assert (port.hits, port.misses, list(port._cache)) == (1, 7, [r[1], r[4], r[0]])


def test_message_cache_raises_on_a_lane_not_ok(monkeypatch):
    """There is no host hash_to_g2 path: a lane the kernel flags not ok
    raises."""
    n = IN.BT
    monkeypatch.setattr(
        KV, "hash_g2",
        lambda u, sgn: (torch.zeros((3, 2, LY.NL, n), dtype=torch.int32), torch.zeros((1, n), dtype=torch.int32)),
    )
    with pytest.raises(RuntimeError, match="not ok"):
        IN.MessageCache(device="cpu").get_many([b"x"])


# ---------------------------------------------------------------------------
# against the JAX value-level functions and the Pallas aggregation (slow)
# ---------------------------------------------------------------------------


def _jfp2(vals):
    return tuple(jnp.asarray(JL.encode_batch([v[k] for v in vals])) for k in range(2))


def _jints(pair):
    return list(zip(*(JL.decode_batch(np.asarray(c)) for c in pair)))


@pytest.mark.slow
def test_fp2_sqrt_and_decompress_equal_jax_values():
    """SQ.fp2_sqrt and IG.g2_decompress_y of both packages on 4 lanes."""
    from lodestar_tpu.kernels import ingest as JIG
    from lodestar_tpu.kernels import sqrt as JSQ

    vals = _sqrt_cases()[:4] + _sqrt_cases()[4:6]
    root, ok = SQ.fp2_sqrt(digits(fp2_planes(vals)))
    jroot, jok = jax.jit(JSQ.fp2_sqrt)(_jfp2(vals))
    assert ok.tolist() == np.asarray(jok).tolist()
    assert fp2_ints(LY.digits_to_planes(root)) == _jints(jroot)
    x, flags, want, _ = _wire_x_cases()
    xs = fp2_ints(KV.mont_convert_plain(x))
    y, ok = IG.g2_decompress_y(digits(fp2_planes(xs)), flags[0] != 0)
    jy, jok = jax.jit(JIG.g2_decompress_y)(_jfp2(xs), jnp.asarray(flags[0].numpy()))
    assert ok.tolist() == np.asarray(jok).tolist()
    assert fp2_ints(LY.digits_to_planes(y)) == _jints(jy)


@pytest.mark.slow
def test_hash_to_g2_map_equals_jax_values(hashed):
    """IG.hash_to_g2_values of both packages up to the cofactor clearing:
    JAX's sswu_map_g2 (as integers), iso3_map (with its ok flags) and the
    mixed addition of the two points, each under its own jit, against the
    port's SSWU points, its isogeny images in Jacobian form and their
    complete addition, as points (the port's Jacobian triples are its own:
    no inversion in the isogeny, a full addition).  XLA cannot compile
    JAX's 636-bit cofactor chain on a CPU host (past 12 GB under jit;
    compiling its loops one by one crashed jaxlib), and the port clears by
    psi, so the clearing is held at the level of its result (hash_to_g2 of
    the oracle, in the fast tier here and in tests/test_torch_warp_hash.py,
    where the psi clearing is held against [h_eff] P outside G2)."""
    from lodestar_tpu.kernels import ingest as JIG
    from lodestar_tpu_torch.kernels import fp2 as F2

    def affine(p):
        return [to_affine(*v) for v in zip(*(fp2_ints(LY.digits_to_planes(c)) for c in p))]

    u, sgn, _, _ = hashed["call"]
    us = [fp2_ints(KV.mont_convert_plain(u[i])) for i in range(2)]
    sswu, iso = jax.jit(JIG.sswu_map_g2), jax.jit(JIG.iso3_map)
    pts, jpts = [], []
    for i in range(2):
        a = IG.sswu_map_g2(digits(fp2_planes(us[i])), sgn[i] != 0)
        ja = sswu(_jfp2(us[i]), jnp.asarray(sgn[i].numpy()))
        assert [fp2_ints(LY.digits_to_planes(c)) for c in a] == [_jints(c) for c in ja]
        q = IG.iso3_map_jac(a)
        jq, jok = iso(ja)
        assert (~F2.is_zero2(q[2])).tolist() == np.asarray(jok).tolist() == [True] * len(ROOTS)
        assert affine(q) == list(zip(_jints(jq[0]), _jints(jq[1])))
        pts.append(q)
        jpts.append(jq)
    s = IG._add_complete(pts[0], pts[1])
    js = jax.jit(lambda a, b: JCV.jac_add_mixed(JCV.FP2_OPS, (a[0], a[1], JCV._one_plane_like(JCV.FP2_OPS, a[0])), b))(
        jpts[0], jpts[1])
    assert affine(s) == [to_affine(*v) for v in zip(*(_jints(c) for c in js))]


@pytest.mark.slow
def test_agg_pk_equals_pallas_gather_pk():
    """JAX `_gather_pk` with K = 64 (the Pallas `_k_agg_pk` in interpret
    mode) and the port's agg_pk on one 128-lane tile."""
    from lodestar_tpu.kernels import verify as JKV

    keys, idx, kmask = _agg_case(64)
    n = 128
    idx = np.concatenate([idx, np.zeros((n - 4, 64), np.int32)])
    kmask = np.concatenate([kmask, np.zeros((n - 4, 64), np.int32)])
    tx = torch.from_numpy(LY.encode_batch([p[0] for p in keys]))
    ty = torch.from_numpy(LY.encode_batch([p[1] for p in keys]))
    out, out_inf = KV.agg_pk(tx, ty, torch.from_numpy(idx), torch.from_numpy(kmask))
    jt = [jnp.asarray(JL.encode_batch([p[c] for p in keys])) for c in range(2)]
    (X, Y, Z), jinf = JKV._gather_pk(*jt, jnp.asarray(idx), jnp.asarray(kmask))
    assert [LY.decode_batch(out[c].numpy()) for c in range(3)] == [JL.decode_batch(np.asarray(c)) for c in (X, Y, Z)]
    assert out_inf[0].tolist() == np.asarray(jinf).astype(int).tolist()
