"""The port's RLC batch slice: randomizers, the batch kernels' plain
versions, `verify_batch_device` and the verifier's batch routing and
bisection, held against the JAX package and the crypto oracle.

The port runs on the CPU here, so every kernel wrapper takes its plain
torch version (the CUDA sources themselves are held against those in
tests/test_torch_csrc_host.py and, on the card, tests/test_torch_cuda.py).
Every comparison is exact: integers, points and booleans.  The JAX lane
functions run eagerly or under jit as the JAX package's own fast tests
run them; the windowed scalar multiplication against JAX is in
tests/test_torch_rlc_scalar.py, and the comparison with the JAX Pallas
batch pipeline (interpret mode) is `slow`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lodestar_tpu.bls import PubkeyTable as JPubkeyTable
from lodestar_tpu.bls import TpuBlsVerifier
from lodestar_tpu.crypto import bls as GB
from lodestar_tpu.crypto import curves as GC
from lodestar_tpu.crypto import fields as GT
from lodestar_tpu.crypto import hash_to_curve as GH
from lodestar_tpu.crypto import pairing as GP
from lodestar_tpu.kernels import curve as JCV
from lodestar_tpu.kernels import layout as JL
from lodestar_tpu.kernels import pairing as JP
from lodestar_tpu.kernels import verify as JKV
from lodestar_tpu.ops import bls_kernels as BK
from lodestar_tpu_torch.bls import rand as RD
from lodestar_tpu_torch.bls import verifier as VR
from lodestar_tpu_torch.bls.pubkey_table import PubkeyTable
from lodestar_tpu_torch.bls.signature_set import SignatureSet
from lodestar_tpu_torch.kernels import curve as CV
from lodestar_tpu_torch.kernels import layout as LY
from lodestar_tpu_torch.kernels import pairing as KP
from lodestar_tpu_torch.kernels import tower as TW
from lodestar_tpu_torch.kernels import verify as KV

P = GT.P
RNG = np.random.default_rng(0x41C)
N_KEYS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: parallel test workers must not oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scalar():
    return int.from_bytes(RNG.bytes(32), "little") % (GT.R - 2) + 2


def rand_fp():
    return int.from_bytes(RNG.bytes(48), "little") % P


def g2(n):
    return [GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, scalar()) for _ in range(n)]


def jac_g2(pts):
    """Affine G2 points -> field values (x Z^2, y Z^3, Z) with random Z."""
    out = []
    for x, y in pts:
        z = (rand_fp(), rand_fp())
        z2 = GT.fp2_mul(z, z)
        out.append((GT.fp2_mul(x, z2), GT.fp2_mul(y, GT.fp2_mul(z2, z)), z))
    return out


def t_fp2(vals):
    return torch.stack([LY.encode_digits([v[0] for v in vals]), LY.encode_digits([v[1] for v in vals])])


def j_fp2(vals):
    return tuple(jnp.asarray(JL.encode_batch([v[k] for v in vals])) for k in range(2))


def to_affine(x, y, z):
    zi = GT.fp2_inv(z)
    zi2 = GT.fp2_mul(zi, zi)
    return GT.fp2_mul(x, zi2), GT.fp2_mul(y, GT.fp2_mul(zi2, zi))


def port_points(pt):
    """Port Jacobian G2 (X, Y, Z) digit tensors -> per lane (x, y, z) ints."""
    cols = [list(zip(LY.decode_digits(c[0]), LY.decode_digits(c[1]))) for c in pt]
    return list(zip(*cols))


def jax_points(pt):
    cols = [list(zip(JL.decode_batch(np.asarray(c[0])), JL.decode_batch(np.asarray(c[1])))) for c in pt]
    return list(zip(*cols))


# ---------------------------------------------------------------------------
# randomizers and digits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n", [(0, 1), (7, 8), (0xBEEF, 128)])
def test_make_rand_words_equals_jax(seed, n):
    got = RD.make_rand_words(n, np.random.default_rng(seed))
    want = BK.make_rand_words(n, np.random.default_rng(seed))
    assert got.dtype == want.dtype == np.int32 and got.shape == (KV.RAND_WORDS, n)
    assert np.array_equal(got, want)
    fresh = RD.make_rand_words(n)  # the OS CSPRNG
    assert fresh.shape == (4, n) and (fresh[-1] & 1).all()


def test_word_digit_equals_shifts_and_jax():
    words = RD.make_rand_words(8, np.random.default_rng(3))
    words[:, 0] = 0  # scalar 0
    words[:, 1] = -1  # all ones
    scalars = [
        sum((int(words[i, j]) & 0xFFFFFFFF) << (32 * (3 - i)) for i in range(4)) for j in range(8)
    ]
    rw = torch.from_numpy(words)
    for t in range(KV.RAND_BITS // KV.WINDOW):
        want = [(k >> (KV.RAND_BITS - KV.WINDOW * (t + 1))) & 0xF for k in scalars]
        assert KV._word_digit(rw, t).tolist() == want, t
        assert np.asarray(JKV._word_digit(jnp.asarray(words), jnp.int32(t))).tolist() == want, t


# ---------------------------------------------------------------------------
# the windowed scalar multiplication at full width, against the oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("f", [1, 2])
def test_scalar_mul_128_matches_oracle(f):
    """The plain g1_rpk / g2_rsig_sub at w = 4, 128 bits, on edge scalars
    (0, 1, 2, 15, 16, all ones) and random ones, with an infinity base;
    the G2 kernel's subgroup row on an outside point too."""
    ks = [0, 1, 2, 15, 16, (1 << 128) - 1, int.from_bytes(RNG.bytes(16), "big") | 1, 1 << 64]
    n = len(ks)
    words = np.array([[(k >> (32 * (3 - i))) & 0xFFFFFFFF for k in ks] for i in range(4)], np.uint32)
    rw = torch.from_numpy(words.view(np.int32))
    inf = torch.zeros((1, n), dtype=torch.int32)
    inf[0, 7] = 1
    if f == 1:
        pts = [GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, scalar()) for _ in range(n)]
        p = torch.from_numpy(np.stack([LY.encode_batch([x for x, _ in pts]), LY.encode_batch([y for _, y in pts]),
                                       LY.encode_batch([1] * n)]))
        out, out_inf = KV.g1_rpk(p, inf, rw)
        coords = [LY.decode_batch(out[c].numpy()) for c in range(3)]
        got = [None if i else (x * pow(z, -2, P) % P, y * pow(z, -3, P) % P)
               for x, y, z, i in zip(*coords, out_inf[0].tolist())]
        want = [None if k == 0 or j == 7 else GC.scalar_mul(GC.FP_OPS, pt, k) for j, (pt, k) in enumerate(zip(pts, ks))]
    else:
        u = GH.hash_to_field_fp2(b"rlc-outside", 1, b"torch-rlc")[0]
        outside = GH.map_to_curve_svdw(GC.FP2_OPS, u)
        pts = g2(n - 1) + [outside]
        q = torch.from_numpy(np.stack([np.stack([LY.encode_batch([pt[c][k] for pt in pts]) for k in range(2)])
                                       for c in range(2)]))
        out, out_inf, sub = KV.g2_rsig_sub(q, inf, rw)
        assert sub[0].tolist() == [1] * 7 + [1]  # the outside point is flagged infinity
        inf[0, 7] = 0
        assert KV.g2_rsig_sub(q, inf, rw)[2][0].tolist() == [1] * 7 + [0]
        d = LY.planes_to_digits(out)
        got = [None if i else to_affine(*pt) for pt, i in zip(port_points(d), out_inf[0].tolist())]
        want = [None if k == 0 or j == 7 else GC.scalar_mul(GC.FP2_OPS, pt, k) for j, (pt, k) in enumerate(zip(pts, ks))]
    assert got == want


# ---------------------------------------------------------------------------
# lane reductions
# ---------------------------------------------------------------------------


SUM_LANES = 256  # two JAX lane tiles


def _sum_case():
    """256 lanes cycling through five points (random Z per lane): P and -P
    meet at the port tree's first level (lanes 0, 1) and in the JAX
    butterfly's first round (lanes 0, 128); Q and Q likewise (lanes 2, 3
    and 2, 130); lanes excluded."""
    a, b, c, d, e = g2(5)
    pts = [(a, b, c, d, e)[i % 5] for i in range(SUM_LANES)]
    na = GC.affine_neg(GC.FP2_OPS, a)
    pts[0], pts[1], pts[128] = a, na, na
    pts[2], pts[3], pts[130] = b, b, b
    excl = [i % 7 == 5 for i in range(SUM_LANES)]
    return pts, excl


def _oracle_sum(pts, excl):
    return GC.multi_add(GC.FP2_OPS, [p for p, e in zip(pts, excl) if not e])


@pytest.fixture(scope="module")
def jax_add2():
    """JAX's jac_add_full over Fp2 jitted once at the butterfly's width
    (every round of `sum_points_lanes` runs at full width)."""
    real = JCV.jac_add_full
    return jax.jit(lambda p, p_inf, q, q_inf: real(JCV.FP2_OPS, p, p_inf, q, q_inf))


def test_lane_sum_matches_jax_as_points(jax_add2, monkeypatch):
    """sum_points_lanes (the port's tree) and the JAX butterfly over two
    lane tiles give the crypto oracle's affine point, on the edge lanes,
    with lanes excluded, with only the first eight lanes live and with
    every lane excluded."""
    monkeypatch.setattr(JCV, "jac_add_full", lambda fo, p, p_inf, q, q_inf: jax_add2(p, p_inf, q, q_inf))
    pts, excl = _sum_case()
    jp = jac_g2(pts)
    port = tuple(t_fp2([p[c] for p in jp]) for c in range(3))
    jx = tuple(j_fp2([p[c] for p in jp]) for c in range(3))
    first8 = [i >= 8 or i == 5 for i in range(SUM_LANES)]
    for ex in (excl, first8, [True] * SUM_LANES):
        s, s_inf = CV.sum_points_lanes(CV.FP2_OPS, port, torch.tensor(ex))
        js, js_inf = JCV.sum_points_lanes(JCV.FP2_OPS, jx, jnp.asarray(ex))
        want = _oracle_sum(pts, ex)
        got = None if bool(s_inf[0]) else to_affine(*port_points(s)[0])
        assert got == want
        jinf = bool(np.asarray(js_inf)[0])
        assert (None if jinf else to_affine(*jax_points(js)[0])) == want


def test_sum_g2_folds_lanes_past_one_tile():
    """N = 300 lanes: the pairwise tree over more lanes than one tile (nine
    levels, four of them with an odd count whose last element passes up);
    the sum of the lanes not excluded equals the oracle's."""
    n = 300
    base = g2(5)
    pts = [base[i % 5] for i in range(n)]
    excl = [(i % 7) == 3 for i in range(n)]
    jp = jac_g2(pts)
    planes = torch.from_numpy(np.stack([
        np.stack([LY.encode_batch([p[c][k] for p in jp]) for k in range(2)]) for c in range(3)
    ]))
    s, s_inf = KV.sum_g2(planes, torch.tensor([excl], dtype=torch.int32))
    assert tuple(s.shape) == (3, 2, LY.NL, 1) and s_inf.tolist() == [[0]]
    assert to_affine(*port_points(LY.planes_to_digits(s))[0]) == _oracle_sum(pts, excl)


def _fp12(n):
    return [tuple(tuple((rand_fp(), rand_fp()) for _ in range(3)) for _ in range(2)) for _ in range(n)]


def test_lane_product_matches_jax():
    n = 8
    vals = _fp12(n)
    valid = [True, False, True, True, False, True, True, True]
    tf = torch.stack([torch.stack([t_fp2([v[h][i] for v in vals]) for i in range(3)]) for h in range(2)])
    jf = tuple(tuple(j_fp2([v[h][i] for v in vals]) for i in range(3)) for h in range(2))
    got = KP.product12_lanes(tf, torch.tensor(valid), KV.BT)
    with jax.disable_jit():
        want = JP.product12_lanes(jf, jnp.asarray(valid))
    got_ints = [LY.decode_digits(got.reshape(12, LY.ND, 1)[k])[0] for k in range(12)]
    want_ints = [JL.decode_batch(np.asarray(leaf))[0] for leaf in jax.tree_util.tree_leaves(want)]
    assert got_ints == want_ints
    # and the wrapper (planes) agrees with the oracle product
    planes = LY.digits_to_planes(tf.reshape(12, LY.ND, n))
    out = KV.prod12(torch.tensor([valid], dtype=torch.int32), planes)
    acc = GT.FP12_ONE
    for v, ok in zip(vals, valid):
        if ok:
            acc = GT.fp12_mul(acc, v)
    assert [LY.decode_batch(out[k].numpy())[0] for k in range(12)] == [x for h in acc for c in h for x in c]


# ---------------------------------------------------------------------------
# the tail
# ---------------------------------------------------------------------------


def _affine_ref(ref_vals):
    """Run the JAX kernel body _k_affine_g2 on plain arrays."""

    class Ref:
        def __init__(self, v=None):
            self.v = v

        def __getitem__(self, k):
            return self.v

        def __setitem__(self, k, v):
            self.v = v

    def body(*ins):
        outs = [Ref() for _ in range(5)]
        JKV._k_affine_g2(*[Ref(v) for v in ins], *outs)
        return tuple(o.v for o in outs)

    return jax.jit(body)(*ref_vals)


def test_affine_g2_matches_jax_kernel_body():
    """Jacobian -> affine with one inversion; a lane flagged infinity and
    a lane with Z = 0 both give the generator and flag 1."""
    n = 8
    pts = g2(n)
    jp = jac_g2(pts)
    jp[5] = (jp[5][0], jp[5][1], (0, 0))
    inf = [0, 0, 1, 0, 0, 0, 0, 0]
    planes = torch.from_numpy(np.stack([
        np.stack([LY.encode_batch([p[c][k] for p in jp]) for k in range(2)]) for c in range(3)
    ]))
    a, a_inf = KV.affine_g2(planes, torch.tensor([inf], dtype=torch.int32))
    got = [LY.decode_batch(a[c, k].numpy()) for c in range(2) for k in range(2)]
    jx = [jnp.asarray(JL.encode_batch([p[c][k] for p in jp])) for c in range(3) for k in range(2)]
    out = _affine_ref((*jx, jnp.asarray([inf], jnp.int32)))
    assert got == [JL.decode_batch(np.asarray(o)) for o in out[:4]]
    assert a_inf.tolist() == np.asarray(out[4]).tolist() == [[0, 0, 1, 0, 0, 1, 0, 0]]
    g = GC.G2_GEN
    for j in range(n):
        want = g if j in (2, 5) else pts[j]
        assert ((got[0][j], got[1][j]), (got[2][j], got[3][j])) == want


def _g1_planes(pts):
    return torch.from_numpy(np.stack([LY.encode_batch([p[0] for p in pts]), LY.encode_batch([p[1] for p in pts]),
                                      LY.encode_batch([1] * len(pts))]))


def _g2_planes(pts):
    return torch.from_numpy(np.stack([np.stack([LY.encode_batch([p[c][k] for p in pts]) for k in range(2)])
                                      for c in range(2)]))


def test_batch_tail_verdict_matches_oracle():
    """prod * f(-G1, A) -> final exponentiation -> is-one, lane by lane:
    a valid signature relation, a wrong A, and A = O with a product that
    is one by bilinearity (an all-dead job's shape); and _batch_tail on
    one lane."""
    sk = scalar()
    h = GH.hash_to_g2(b"rlc-tail")
    pk = GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, sk)
    sig = GC.scalar_mul(GC.FP2_OPS, h, sk)
    bad = GC.scalar_mul(GC.FP2_OPS, h, sk + 1)
    neg_pk = GC.affine_neg(GC.FP_OPS, pk)
    f_pk = KV.miller_loop(_g1_planes([pk] * 3), _g2_planes([h] * 3))
    f_neg = KV.miller_loop(_g1_planes([neg_pk]), _g2_planes([h]))
    prod = KV.prod12(torch.ones((1, 2), dtype=torch.int32), torch.cat([f_pk[..., :1], f_neg], -1))
    fprod = torch.cat([f_pk[..., :2], prod], -1).contiguous()
    a_jac = jac_g2([sig, bad, sig])
    jsum = torch.from_numpy(np.stack([
        np.stack([LY.encode_batch([p[c][k] for p in a_jac]) for k in range(2)]) for c in range(3)
    ]))
    jinf = torch.tensor([[0, 0, 1]], dtype=torch.int32)
    a, a_inf = KV.affine_g2(jsum, jinf)
    fa = KV.miller_loop(KV._neg_g1("cpu", 3), a)
    ok = KV.final_one(a_inf, fprod, fa)
    want = [
        GP.multi_pairing_is_one([(pk, h), (GC.affine_neg(GC.FP_OPS, GC.G1_GEN), sig)]),
        GP.multi_pairing_is_one([(pk, h), (GC.affine_neg(GC.FP_OPS, GC.G1_GEN), bad)]),
        GP.multi_pairing_is_one([(pk, h), (neg_pk, h)]),
    ]
    assert ok[0].tolist() == [int(w) for w in want] == [1, 0, 1]
    one = KV._batch_tail(fprod[..., :1].contiguous(), jsum[..., :1].contiguous(), jinf[:, :1].contiguous())
    assert one.tolist() == [[1]]


# ---------------------------------------------------------------------------
# verify_batch_device and the verifier on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    sks = [GB.keygen(b"torch-rlc-%d" % i) for i in range(N_KEYS)]
    pks = [GB.sk_to_pk(sk) for sk in sks]
    table = PubkeyTable()
    table.register(pks)
    roots = [b"rlc-root-a", b"rlc-root-b"]
    hs = [GH.hash_to_g2(r) for r in roots]
    sig = {(k, r): GC.scalar_mul(GC.FP2_OPS, hs[r], sks[k]) for k in range(N_KEYS) for r in range(2)}
    valid = [SignatureSet.single(k, hs[k % 2], sig[k, k % 2]) for k in range(N_KEYS)]
    valid += [SignatureSet.single(k, hs[1 - k % 2], sig[k, 1 - k % 2]) for k in range(2)]
    u = GH.hash_to_field_fp2(b"outside", 1, b"torch-rlc")[0]
    outside = GH.map_to_curve_svdw(GC.FP2_OPS, u)
    return dict(sks=sks, pks=pks, table=table, hs=hs, sig=sig, valid=valid, outside=outside)


@pytest.fixture
def small_buckets(monkeypatch):
    monkeypatch.setattr(VR, "N_BUCKETS", (8, 16, 512))


def _oracle(world, s):
    """The crypto oracle's verdict on a decoded set (hashed message)."""
    if s.signature is None or not GC.g2_subgroup_check(s.signature):
        return False
    neg_g1 = GC.affine_neg(GC.FP_OPS, GC.G1_GEN)
    return GP.multi_pairing_is_one([(world["pks"][s.indices[0]], s.message), (neg_g1, s.signature)])


def test_verify_batch_device_matches_oracle(world, small_buckets):
    """batch_ok is the AND of the oracle's verdicts and sub_ok the per-set
    subgroup row: an all-valid job, one wrong message, and a signature
    outside G2 (padding lanes of the 8-lane bucket pass)."""
    v = VR.TorchBlsVerifier(world["table"], device="cpu")
    good = world["valid"]
    wrong = list(good)
    wrong[2] = SignatureSet.single(2, world["hs"][1], good[2].signature)
    out = list(good)
    out[4] = SignatureSet.single(0, world["hs"][0], world["outside"])
    tx, ty = world["table"].device_planes("cpu")
    for sets, sub_want in ((good, [True] * 8), (wrong, [True] * 8), (out, [True] * 4 + [False] + [True] * 3)):
        idx, kmask, planes, sig_inf, valid = v._prepare(sets)
        rw = torch.from_numpy(RD.make_rand_words(8, np.random.default_rng(len(sets))))
        ok, sub_ok = KV.verify_batch_device(tx, ty, idx, kmask, planes, sig_inf, rw, valid)
        assert ok.dtype == torch.bool and ok.dim() == 0
        assert bool(ok) == all(_oracle(world, s) for s in sets)
        assert sub_ok.tolist() == sub_want


def test_wrappers_check_batch_operands():
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    with pytest.raises(ValueError, match="rwords"):
        KV.g1_rpk(i32(3, LY.NL, 4), i32(1, 4), i32(2, 4))
    with pytest.raises(ValueError, match="shape"):
        KV.g2_rsig_sub(i32(3, 2, LY.NL, 4), i32(1, 4), i32(4, 4))
    with pytest.raises(ValueError, match="excl"):
        KV.sum_g2(i32(3, 2, LY.NL, 4), i32(4))
    with pytest.raises(TypeError):
        KV.prod12(i32(1, 4), torch.zeros((12, LY.NL, 4), dtype=torch.int64))
    with pytest.raises(ValueError, match="shape"):
        KV.affine_g2(i32(2, 2, LY.NL, 1), i32(1, 1))
    with pytest.raises(ValueError, match="fa"):
        KV.final_one(i32(1, 1), i32(12, LY.NL, 1), i32(12, LY.NL, 2))
    with pytest.raises(ValueError, match="rwords"):
        KV.verify_batch_device(i32(LY.NL, 1), i32(LY.NL, 1), i32(4, 1), i32(4, 1), i32(8, LY.NL, 4), i32(4), i32(4, 3),
                               i32(4))


class Recorder:
    """Wraps the two device entry points of the verifier module."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("verify_batch_device", "verify_each_device"):
            real = getattr(KV, name)

            def wrapped(*args, _real=real, _name=name):
                self.calls.append(_name)
                return _real(*args)

            monkeypatch.setattr(VR.KV, name, wrapped)


def test_batchable_job_runs_the_batch_and_retries_per_set(world, small_buckets, monkeypatch):
    """A batchable job of decodable sets is ONE batch; a failing batch at
    or under the leaf retries per set on its own planes."""
    rec = Recorder(monkeypatch)
    v = VR.TorchBlsVerifier(world["table"], device="cpu", rng=np.random.default_rng(1))
    batchable = VR.VerifyOptions(batchable=True)
    assert v.verify_signature_sets(world["valid"], batchable) is True
    assert rec.calls == ["verify_batch_device"]
    rec.calls.clear()
    wrong = list(world["valid"])
    wrong[1] = SignatureSet.single(1, world["hs"][0], wrong[1].signature)
    job = v.begin_job(wrong, batchable=True)
    assert v.finish_job(job) is False
    assert rec.calls == ["verify_batch_device", "verify_each_device"]
    assert job.verdicts.tolist() == [i != 1 for i in range(len(wrong))]
    assert (job.batch_retries, job.batch_sigs_success, job.bisect_depth) == (1, 0, 0)


@pytest.mark.parametrize("case", ["single", "undecodable", "rlc_off", "not_batchable"])
def test_routing_goes_per_set(world, small_buckets, monkeypatch, case):
    """As the JAX package's _begin_job: a single set, a job with an
    undecodable signature (one batch retry), the LODESTAR_TPU_BLS_RLC=0
    switch (no retry) and a non-batchable job all get per-set verdicts."""
    if case == "rlc_off":
        monkeypatch.setenv("LODESTAR_TPU_BLS_RLC", "0")
    rec = Recorder(monkeypatch)
    v = VR.TorchBlsVerifier(world["table"], device="cpu")
    assert v._use_rlc == (case != "rlc_off")
    sets = world["valid"][:3]
    if case == "single":
        sets = sets[:1]
    elif case == "undecodable":
        sets = sets[:2] + [SignatureSet.single(2, world["hs"][0], None)]
    job = v.begin_job(sets, batchable=case != "not_batchable")
    ok = v.finish_job(job)
    assert rec.calls == ["verify_each_device"]
    assert ok is (case != "undecodable")
    assert job.batch_retries == (1 if case == "undecodable" else 0)


# ---------------------------------------------------------------------------
# bisection, against the JAX verifier's planner on the same fake sets
# ---------------------------------------------------------------------------


class FakeSet:
    __slots__ = ("ok",)

    def __init__(self, ok: bool):
        self.ok = ok


class PortOracle(VR.TorchBlsVerifier):
    """TorchBlsVerifier with its three device seams replaced by a host
    oracle reading FakeSet.ok, recording the call pattern."""

    def __init__(self, bisect_leaf):
        super().__init__(PubkeyTable(capacity=2), device="cpu", rng=np.random.default_rng(0),
                         bisect_leaf=bisect_leaf)
        self.batch_calls, self.leaf_calls = [], []

    def _dispatch_batch(self, sets):
        self.batch_calls.append(len(sets))
        return all(s.ok for s in sets)

    def _batch_verdict(self, handle):
        return handle

    def _per_set_verdicts(self, sets):
        self.leaf_calls.append(len(sets))
        return np.array([s.ok for s in sets])


class JaxOracle(TpuBlsVerifier):
    """The same oracle on the JAX package's TpuBlsVerifier."""

    def __init__(self, bisect_leaf):
        super().__init__(JPubkeyTable(capacity=2), rng=np.random.default_rng(0), bisect_leaf=bisect_leaf)
        self.batch_calls, self.leaf_calls = [], []

    def _dispatch_batch(self, sets, wire):
        self.batch_calls.append(len(sets))
        return all(s.ok for s in sets)

    def _batch_verdict(self, handle):
        return handle

    def _per_set_verdicts(self, sets, wire):
        self.leaf_calls.append(len(sets))
        return np.array([s.ok for s in sets])


def _both(leaf, truth):
    port, jx = PortOracle(leaf), JaxOracle(leaf)
    pv, pd = port._bisect([FakeSet(t) for t in truth], 1)
    jv, jd = jx._bisect([FakeSet(t) for t in truth], False, 1)
    jx.close()
    assert pv.tolist() == jv.tolist() == list(truth)
    assert pd == jd
    assert port.batch_calls == jx.batch_calls and port.leaf_calls == jx.leaf_calls
    return port, jx, pd


def test_bisection_isolates_single_bad_set_in_2048():
    truth = [True] * 2048
    truth[1337] = False
    port, _, depth = _both(16, truth)
    assert depth == 8 and len(port.batch_calls) <= 2 * 7


def test_bisection_all_invalid_job_terminates_and_rejects_all():
    port, _, _ = _both(16, [False] * 256)
    assert sum(port.leaf_calls) == 256 and len(port.batch_calls) == 2 + 4 + 8 + 16


def test_bisection_randomized_matches_jax_on_odd_sizes():
    rng = np.random.default_rng(7)
    for size, leaf in ((100, 8), (33, 4), (517, 16), (2, 1)):
        _both(leaf, (rng.random(size) > 0.3).tolist())


def test_finish_job_bisects_and_accounts_as_jax():
    """A failed 512-set batch: the verdicts, the depth and the sets cleared
    by passing halves equal the JAX verifier's (its metrics registry)."""
    truth = [True] * 512
    truth[3] = False
    port = PortOracle(16)
    job = VR._DeviceJob([FakeSet(t) for t in truth])
    job.batch_ok = False
    job.decodable = np.ones(512, bool)
    assert port.finish_job(job) is False
    assert (~job.verdicts).nonzero()[0].tolist() == [3]
    jx = JaxOracle(16)
    from lodestar_tpu.bls.verifier import _DeviceJob as JaxJob

    jjob = JaxJob([FakeSet(t) for t in truth], True, True, wire=False)
    jjob.batch_ok = False
    jjob.decodable = np.ones(512, bool)
    jjob.n_bucket = 512
    assert jx._finish_job(jjob) is False
    jx.close()
    assert job.verdicts.tolist() == jjob.verdicts.tolist()
    assert (job.batch_retries, job.batch_sigs_success) == (jjob.batch_retries, jjob.batch_sigs_success) == (1, 511 - 15)
    assert job.bisect_depth == 6 and port.batch_calls == jx.batch_calls


def test_finish_job_small_batch_skips_bisection(monkeypatch):
    """At or under the leaf a failed batch retries per set on the job's
    own planes, with no bisection."""
    port = PortOracle(128)
    sets = [FakeSet(True), FakeSet(False), FakeSet(True)]
    job = VR._DeviceJob(sets)
    job.batch_ok = False
    job.decodable = np.ones(3, bool)
    monkeypatch.setattr(port, "_each", lambda args: torch.tensor([s.ok for s in sets] + [True] * 5))
    assert port.finish_job(job) is False
    assert job.verdicts.tolist() == [True, False, True]
    assert port.batch_calls == [] and port.leaf_calls == [] and job.bisect_depth == 0


# ---------------------------------------------------------------------------
# the JAX Pallas batch pipeline itself (interpret mode: slow)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_batch_verdicts_equal_pallas_verify_batch_device(world):
    """The JAX Pallas verify_batch_device (interpret mode) and the port
    give the same (batch_ok, sub_ok) on the same 128-lane job and the
    same randomizers, for an all-valid job and one with a wrong message."""
    n = 128
    jtable = JPubkeyTable(capacity=8)
    jtable.register(world["pks"])
    v = VR.TorchBlsVerifier(world["table"], device="cpu")
    wrong = list(world["valid"])
    wrong[2] = SignatureSet.single(2, world["hs"][1], wrong[2].signature)
    for sets in (world["valid"], wrong):
        idx, kmask, planes, sig_inf, valid = v._prepare(sets)
        rw = RD.make_rand_words(n, np.random.default_rng(11))
        port = KV.verify_batch_device(*world["table"].device_planes("cpu"), idx, kmask, planes, sig_inf,
                                      torch.from_numpy(rw), valid)
        p = planes.numpy()
        out = JKV.verify_batch_device(
            *jtable.device_planes(), jnp.asarray(idx.numpy()), jnp.ones((n, 1), jnp.int32),
            *[jnp.asarray(JL.encode_plain_batch(LY.decode_plain_batch(p[k]))) for k in range(8)],
            jnp.asarray(sig_inf.numpy()), jnp.asarray(rw), jnp.asarray(valid.numpy()),
        )
        assert bool(out[0]) == bool(port[0])
        assert np.asarray(out[1]).tolist() == port[1].tolist()
