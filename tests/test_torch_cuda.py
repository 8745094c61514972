"""The port's CUDA kernels on the card (marker `cuda`; each test skips
without a CUDA device).

Imports nothing of JAX, so it runs on a machine with the card alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held bit for bit against its plain torch version on the
same device tensors, and the verifier (default device: CUDA), per set
and as an RLC batch, against the crypto oracle.  chip_smoke.py does the
same at the main paths' shapes with a 1M-row table.
"""

import ctypes

import numpy as np
import pytest
import torch

from lodestar_tpu_torch.bls.pubkey_table import PubkeyTable
from lodestar_tpu_torch.bls.rand import make_rand_words
from lodestar_tpu_torch.bls.signature_set import SignatureSet
from lodestar_tpu_torch.bls.verifier import TorchBlsVerifier, VerifyOptions
from lodestar_tpu_torch.crypto import curves as GC
from lodestar_tpu_torch.crypto import fields as GT
from lodestar_tpu_torch.crypto import hash_to_curve as GH
from lodestar_tpu_torch.kernels import build as B
from lodestar_tpu_torch.kernels import layout as LY
from lodestar_tpu_torch.kernels import verify as KV

pytestmark = pytest.mark.cuda

RNG = np.random.default_rng(0xCDA)
N = 40


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def scalar():
    return int.from_bytes(RNG.bytes(32), "little") % (GT.R - 2) + 2


def planes(arr, dev):
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


@pytest.fixture(scope="module")
def points(dev):
    qs = [GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, scalar()) for _ in range(N)]
    ps = [GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, scalar()) for _ in range(N)]
    q = planes(np.stack([np.stack([LY.encode_batch([p[c][k] for p in qs]) for k in range(2)]) for c in range(2)]), dev)
    p = planes(np.stack([LY.encode_batch([x for x, _ in ps]), LY.encode_batch([y for _, y in ps]),
                         LY.encode_batch([1] * N)]), dev)
    return p, q


def test_mont_convert_on_card(dev):
    vals = [int.from_bytes(RNG.bytes(48), "little") for _ in range(2 * N)]
    x = planes(LY.encode_plain_batch(vals).reshape(LY.NL, 2, N).transpose(1, 0, 2), dev)
    before = KV.LAUNCHES["mont_convert"]
    out = KV.mont_convert(x)
    assert KV.LAUNCHES["mont_convert"] == before + 1
    assert torch.equal(out, KV.mont_convert_plain(x))


def test_subgroup_miller_final_on_card(dev, points):
    p, q = points
    q_inf = torch.zeros((1, N), dtype=torch.int32, device=dev)
    assert torch.equal(KV.g2_subgroup_check(q, q_inf), KV.g2_subgroup_check_plain(q, q_inf))
    f = KV.miller_loop(p, q)
    assert torch.equal(f, KV.miller_loop_plain(p, q))
    live = torch.ones((1, N), dtype=torch.int32, device=dev)
    live[0, 1] = 0
    ok = KV.each_final(live, f, f)
    assert torch.equal(ok, KV.each_final_plain(live, f, f))
    torch.cuda.synchronize()


@pytest.fixture(scope="module")
def rlc(dev, points):
    """The RLC kernels' chained outputs on N lanes: lane 3 flagged
    infinity, lane 5 dead."""
    p, q = points
    rw = planes(make_rand_words(N, RNG), dev)
    inf = torch.zeros((1, N), dtype=torch.int32, device=dev)
    inf[0, 3] = 1
    live = torch.ones((1, N), dtype=torch.int32, device=dev)
    live[0, 5] = 0
    rpk, rpk_inf = KV.g1_rpk(p, inf, rw)
    rsig, rsig_inf, sub = KV.g2_rsig_sub(q, inf, rw)
    excl = (1 - live) | rsig_inf
    return dict(p=p, q=q, rw=rw, inf=inf, live=live, rpk=rpk, rsig=rsig, rsig_inf=rsig_inf,
                excl=excl, f=KV.miller_loop(rpk, q))


def _equal(kernel, plain, *args, counter=None, launches=1):
    name = counter or kernel.__name__
    before = KV.LAUNCHES[name]
    got = kernel(*args)
    assert KV.LAUNCHES[name] == before + launches
    want = plain(*args)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    torch.cuda.synchronize()
    return got


def test_g1_rpk_on_card(rlc):
    _equal(KV.g1_rpk, KV.g1_rpk_plain, rlc["p"], rlc["inf"], rlc["rw"])


def test_g2_rsig_sub_on_card(rlc):
    *_, sub = _equal(KV.g2_rsig_sub, KV.g2_rsig_sub_plain, rlc["q"], rlc["inf"], rlc["rw"])
    assert sub.all()


def test_sum_g2_on_card(rlc):
    _equal(KV.sum_g2, KV.sum_g2_plain, rlc["rsig"], rlc["excl"])


def test_prod12_on_card(rlc):
    _equal(KV.prod12, KV.prod12_plain, rlc["live"], rlc["f"])


def test_affine_g2_on_card(rlc):
    _equal(KV.affine_g2, KV.affine_g2_plain, rlc["rsig"], rlc["rsig_inf"])
    _equal(KV.affine_g2, KV.affine_g2_plain, *KV.sum_g2(rlc["rsig"], rlc["excl"]))


def test_final_one_on_card(rlc):
    a_inf = rlc["inf"][:, :8].contiguous()
    f = rlc["f"]
    ok, = _equal(KV.final_one, KV.final_one_plain, a_inf, f[..., :8].contiguous(), f[..., 8:16].contiguous())
    assert ok.sum() == 0


def test_verifier_on_card(dev):
    sks = [scalar() for _ in range(3)]
    pks = [GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, sk) for sk in sks]
    table = PubkeyTable()
    table.register(pks)
    h = GH.hash_to_g2(b"on-card")
    sig = [GC.scalar_mul(GC.FP2_OPS, h, sk) for sk in sks]
    sets = [SignatureSet.single(0, h, sig[0]), SignatureSet.single(1, h, sig[2]),
            SignatureSet.single(2, h, None), SignatureSet.single(2, h, sig[2])]
    v = TorchBlsVerifier(table)
    assert v.device.type == "cuda"
    KV.reset_launches()
    assert v.verify_signature_sets_individually(sets) == [True, False, False, True]
    assert min(KV.LAUNCHES[k] for k in ("mont_convert", "g2_subgroup_check", "miller_loop", "each_final")) > 0
    assert v._device_canary()
    # the RLC batch: valid sets in one multi-pairing; a bad set fails the
    # batch and the per-set retry names it
    batchable = VerifyOptions(batchable=True)
    KV.reset_launches()
    assert v.verify_signature_sets([sets[0], sets[3]], batchable) is True
    assert (KV.LAUNCHES["final_one"], KV.LAUNCHES["miller_loop"], KV.LAUNCHES["each_final"]) == (1, 2, 0)
    job = v.begin_job([sets[0], sets[1], sets[3]], batchable=True)
    assert v.finish_job(job) is False
    assert job.verdicts.tolist() == [True, False, True] and job.batch_retries == 1


def test_mont_convert_four_planes_on_card(dev):
    """The wire path's message planes: 4 planes of plain limbs (_k_mont4)."""
    vals = [int.from_bytes(RNG.bytes(48), "little") for _ in range(4 * N)]
    x = planes(LY.encode_plain_batch(vals).reshape(LY.NL, 4, N).transpose(1, 0, 2), dev)
    _equal(KV.mont_convert, KV.mont_convert_plain, x, counter="mont_convert_4")


def test_g2_decompress_on_card(dev):
    """Points of both signs, the infinity flag and x values off the curve."""
    from lodestar_tpu_torch.bls.ingest import parse_signature_bytes

    pts = [GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, scalar()) for _ in range(N - 8)]
    parsed = [parse_signature_bytes(GC.g2_compress(p)) for p in pts] + [(k, k + 1, k % 2, 0, True) for k in range(7)]
    parsed.append(parse_signature_bytes(GC.g2_compress(None)))
    x = planes(np.stack([LY.encode_plain_batch([p[i] for p in parsed]) for i in range(2)]), dev)
    flags = planes(np.array([[p[2] for p in parsed], [p[3] for p in parsed]], np.int32), dev)
    xy, ok = _equal(KV.g2_decompress, KV.g2_decompress_plain, x, flags)
    assert ok[0, : N - 8].all() and ok[0, -1] == 1


def test_hash_g2_on_card(dev):
    from lodestar_tpu_torch.crypto import hash_to_curve as HC

    us = [HC.hash_to_field_fp2(b"on-card-%d" % i, 2, HC.DST_G2) for i in range(4)]
    u = planes(np.stack([np.stack([LY.encode_plain_batch([v[i][k] for v in us]) for k in range(2)])
                         for i in range(2)]), dev)
    sgn = planes(np.array([[HC._sgn0_fp2(v[i]) for v in us] for i in range(2)], np.int32), dev)
    _, ok = _equal(KV.hash_g2, KV.hash_g2_plain, u, sgn)
    assert ok.all()


@pytest.mark.parametrize("k", [4, 64, 512])
def test_agg_pk_on_card(dev, points, k):
    p, _ = points
    n = 8
    idx = planes(RNG.integers(0, N, size=(n, k)).astype(np.int32), dev)
    kmask = planes((RNG.random((n, k)) < 0.7).astype(np.int32), dev)
    kmask[1] = 0
    # a live row past the table fails lane 2; a masked one leaves lane 3
    idx[2, 0], kmask[2, 0] = N + 7, 1
    idx[3, 0], kmask[3, 0], kmask[3, 1] = -1, 0, 1
    tx, ty = p[0].contiguous(), p[1].contiguous()
    _, inf = _equal(KV.agg_pk, KV.agg_pk_plain, tx, ty, idx, kmask)
    assert inf[0].tolist() == [0, 1, 1] + [0] * (n - 3)


def test_wire_verifier_on_card(dev):
    """Wire sets, single and aggregate, per set and as one RLC batch."""
    from lodestar_tpu_torch.bls.signature_set import WireSignatureSet

    sks = [scalar() for _ in range(3)]
    table = PubkeyTable()
    table.register([GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, sk) for sk in sks])
    root = b"on-card-wire"
    h = GH.hash_to_g2(root)
    sig = [GC.scalar_mul(GC.FP2_OPS, h, sk) for sk in sks]
    agg = GC.multi_add(GC.FP2_OPS, sig)
    sets = [WireSignatureSet.single(0, root, GC.g2_compress(sig[0])),
            WireSignatureSet.aggregate([0, 1, 2], root, GC.g2_compress(agg)),
            WireSignatureSet.single(1, root, GC.g2_compress(sig[2])),
            WireSignatureSet.aggregate([0, 1], root, GC.g2_compress(agg))]
    v = TorchBlsVerifier(table)
    KV.reset_launches()
    assert v.verify_signature_sets_individually(sets) == [True, True, False, False]
    assert min(KV.LAUNCHES[k] for k in ("hash_g2", "g2_decompress", "agg_pk", "each_final")) > 0
    KV.reset_launches()
    assert v.verify_signature_sets(sets[:2], VerifyOptions(batchable=True)) is True
    assert (KV.LAUNCHES["final_one"], KV.LAUNCHES["each_final"], KV.LAUNCHES["hash_g2"]) == (1, 0, 0)


def test_g1_keyvalidate_on_card(dev):
    """Keys of G1 with both signs, the order-3 key x = 0, an on-curve key
    outside G1, an x off the curve and a lane flagged infinity."""
    from lodestar_tpu_torch.bls.ingest import encode_pubkey_planes

    def x_key(x, sign=0):
        out = bytearray(x.to_bytes(48, "big"))
        out[0] |= 0x80 | (0x20 if sign else 0)
        return bytes(out)

    pks = [GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, scalar()) for _ in range(N - 8)]
    keys = [GC.g1_compress(p) for p in pks]
    keys += [bytes([keys[0][0] ^ 0x20]) + keys[0][1:], x_key(0), x_key(0, 1), x_key(4), x_key(5),
             GC.g1_compress(None), x_key(7), x_key(11)]
    x, flags, host_bad = encode_pubkey_planes(keys)
    assert not host_bad.any()
    xy, ok = _equal(KV.g1_keyvalidate, KV.g1_keyvalidate_plain, planes(x, dev), planes(flags, dev))
    want = [GC.g1_subgroup_check(GC.g1_decompress(k)) if k[0] & 0x40 == 0 and _on_curve(k) else False
            for k in keys]
    assert ok[0].tolist() == [int(w) for w in want] and ok[0, : N - 7].all() and not ok[0, N - 7 :].any()


def _on_curve(key):
    try:
        GC.g1_decompress(key)
    except ValueError:
        return False
    return True


def test_seg_sums_on_card(dev, points):
    """The G1 and G2 segmented scans over groups of 1..7 lanes with dead
    lanes, one launch per round."""
    p, q = points
    group = planes(np.repeat(np.arange(N), RNG.integers(1, 8, size=N))[:N].astype(np.int32), dev)
    dead = planes((RNG.random((1, N)) < 0.2).astype(np.int32), dev)
    rounds = KV.seg_rounds(N)
    _equal(KV.seg_sum_g1, KV.seg_sum_g1_plain, p, dead, group, launches=rounds)
    _equal(KV.seg_sum_g2, KV.seg_sum_g2_plain, q, dead, group, launches=rounds)


def test_grouped_wire_batch_and_aggregation_on_card(dev):
    """Wire sets over two roots: the verifier takes the grouped entry (one
    seg_sum_g1 scan, a 128-lane Miller tile and the one-lane tail) and
    accepts; aggregate_wire_signatures equals the host sum byte for byte,
    a group with a 95-byte member giving None, an empty one infinity."""
    from lodestar_tpu_torch.bls.signature_set import WireSignatureSet

    sks = [scalar() for _ in range(4)]
    table = PubkeyTable()
    table.register([GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, sk) for sk in sks])
    roots = [b"on-card-group-a", b"on-card-group-b"]
    hs = [GH.hash_to_g2(r) for r in roots]
    sigs = {(k, r): GC.g2_compress(GC.scalar_mul(GC.FP2_OPS, hs[r], sks[k])) for k in range(4) for r in range(2)}
    sets = [WireSignatureSet.single(k, roots[r], sigs[k, r]) for k in range(4) for r in range(2)]
    v = TorchBlsVerifier(table)
    v.messages.get_many(roots)
    KV.reset_launches()
    assert v.verify_signature_sets(sets, VerifyOptions(batchable=True)) is True
    assert (KV.LAUNCHES["seg_sum_g1"], KV.LAUNCHES["miller_loop"], KV.LAUNCHES["final_one"]) == (
        KV.seg_rounds(128), 2, 1)
    groups = [[], [sigs[k, 0] for k in range(4)], [sigs[1, 1], sigs[3, 1]], [sigs[0, 0], sigs[2, 0][:95]], []]
    KV.reset_launches()
    assert v.aggregate_wire_signatures(groups) == [v._aggregate_wire_host(g) for g in groups]
    assert v.aggregate_wire_signatures(groups)[3] is None
    assert KV.LAUNCHES["seg_sum_g2"] > 0 and KV.LAUNCHES["g2_decompress"] > 0


@pytest.fixture(scope="module")
def pairs(dev):
    """Relations e(P_i, Q_i) e(-P_i, Q_i) = 1 on 8 points, P Jacobian
    with Z != 1: planes of P, -P and Q."""
    ps = [GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, scalar()) for _ in range(8)]
    qs = [GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, scalar()) for _ in range(8)]

    def jac(pts):
        zs = [int.from_bytes(RNG.bytes(48), "little") % GT.P for _ in pts]
        cols = [(x * z * z % GT.P, y * z * z * z % GT.P, z) for (x, y), z in zip(pts, zs)]
        return planes(np.stack([LY.encode_batch([c[i] for c in cols]) for i in range(3)]), dev)

    q = planes(np.stack([np.stack([LY.encode_batch([p[c][k] for p in qs]) for k in range(2)]) for c in range(2)]), dev)
    return jac(ps), jac([GC.affine_neg(GC.FP_OPS, p) for p in ps]), q


def assert_warp_launch(source, name, n):
    """The library's last launch: n lanes, one warp of 32 threads each,
    4 to a block, the program's rounds."""
    shape = (ctypes.c_int * 8)()
    assert B.load(source).lt_warp_last_launch(shape) == 0
    assert list(shape[:4]) == [n, (n + 3) // 4, 128, 4] and shape[7] == KV.ROUNDS_PER_LANE[name]


@pytest.mark.parametrize("n", [1, 128, 129, 512])
def test_warp_pairing_lane_counts_on_card(dev, pairs, n):
    """The warp-per-lane Miller loop at the main paths' lane counts (one
    lane, a 128-lane tile, one lane past it, N = 512), and the final
    exponentiations of both prologues: bit-equal to the plain versions,
    every live relation equal to one, each launched one warp per lane."""
    p, pn, q = pairs
    idx = torch.arange(n, device=dev) % p.shape[-1]
    p, pn, q = (t[..., idx].contiguous() for t in (p, pn, q))
    (f1,) = _equal(KV.miller_loop, KV.miller_loop_plain, p, q)
    f2 = KV.miller_loop(pn, q)
    assert_warp_launch("miller", "miller_loop", n)
    assert torch.equal(f2, KV.miller_loop_plain(pn, q))
    if n == 129:
        return
    live = (torch.arange(n, device=dev) % 5 != 4).to(torch.int32)[None].contiguous()
    (ok,) = _equal(KV.each_final, KV.each_final_plain, live, f1, f2)
    assert_warp_launch("final", "each_final", n)
    assert bool(ok.all())
    a_inf = (torch.arange(n, device=dev) % 7 == 3).to(torch.int32)[None].contiguous()
    (ok,) = _equal(KV.final_one, KV.final_one_plain, a_inf, f1, f2)
    assert_warp_launch("tail", "final_one", n)
    assert ok[0].tolist() == (a_inf[0] == 0).to(torch.int32).tolist()


@pytest.mark.parametrize("n", [1, 5, 128, 512])
def test_g2_rsig_sub_lane_counts_on_card(dev, points, n):
    """The warp-per-lane r sig and subgroup check at 1, 5 (a block's lanes
    1..3 idle), 128 and 512 lanes, bit-equal to the plain version: lanes
    cycle through random scalars, the zero scalar, a scalar with leading
    zero windows, a signature flagged infinity and a point outside G2.
    The launch, as the library reports it, is the generated program's."""
    from lodestar_tpu_torch.kernels import warp_schedule as W

    _, q = points
    u = GH.hash_to_field_fp2(b"rsig-on-card", 1, b"torch-cuda")[0]
    out = GH.map_to_curve_svdw(GC.FP2_OPS, u)
    out_q = planes(np.stack([np.stack([LY.encode_batch([out[c][k]]) for k in range(2)]) for c in range(2)]), dev)
    idx = torch.arange(n, device=dev) % q.shape[-1]
    qn = q[..., idx].contiguous()
    ks = [int.from_bytes(RNG.bytes(16), "big") for _ in range(n)]
    for j in range(n):
        if j % 5 == 1:
            ks[j] = 0
        elif j % 5 == 2:
            ks[j] >>= 72
        elif j % 5 == 4:
            qn[..., j] = out_q[..., 0]
    w = np.array([[(k >> (32 * (3 - i))) & 0xFFFFFFFF for k in ks] for i in range(4)], np.uint32)
    rw = planes(w.view(np.int32), dev)
    inf = (torch.arange(n, device=dev) % 5 == 3).to(torch.int32)[None].contiguous()
    _, rinf, sub = _equal(KV.g2_rsig_sub, KV.g2_rsig_sub_plain, qn, inf, rw)
    assert sub[0].tolist() == [int(j % 5 != 4) for j in range(n)]
    assert rinf[0].tolist() == [int(j % 5 in (1, 3)) for j in range(n)]
    prog = W.rsig_program()
    shape = (ctypes.c_int * 8)()
    assert B.load("randmul").lt_warp_last_launch(shape) == 0
    smem = LY.NL * 4 * (4 * prog.nslots + len(prog.consts))
    assert list(shape) == [n, (n + 3) // 4, 128, 4, smem, prog.nslots, prog.phases, prog.rounds]
    assert prog.rounds == KV.ROUNDS_PER_LANE["g2_rsig_sub"]


@pytest.fixture(scope="module")
def neg_table(dev):
    """Table planes of 6 keys and, at rows 6..8, the negations of keys 0..2."""
    keys = [GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, scalar()) for _ in range(6)]
    keys += [GC.affine_neg(GC.FP_OPS, keys[i]) for i in range(3)]
    return planes(LY.encode_batch([x for x, _ in keys]), dev), planes(LY.encode_batch([y for _, y in keys]), dev)


@pytest.mark.parametrize("k", [4, 64, 512, 2048])
def test_agg_tree_on_card(dev, neg_table, k):
    """The block-per-set aggregation at the K buckets 4 to 2048 (2048:
    four batches of 16 trees on 256 threads): duplicate rows (P == Q in the
    tree and between chunk sums), a row beside its negation (P == -Q:
    chunks summing to infinity), a packed live prefix with masked chunks
    after it, infinity followed by masked chunks, an all-masked set and a
    live row past the table; bit-equal to the plain version, the launch
    as designed."""
    tx, ty = neg_table
    v = tx.shape[1]
    n = 7
    kc = min(k, KV.AGG_CHUNK)
    half = kc // 2
    idx = RNG.integers(0, v, size=(n, k)).astype(np.int32)
    kmask = np.ones((n, k), np.int32)
    chunk = RNG.integers(0, 6, size=kc)
    chunk[half : 2 * half] = chunk[:half]
    idx[0] = np.tile(chunk, k // kc)
    pm = RNG.integers(0, 3, size=(k // kc, half))
    idx[1] = np.concatenate([np.concatenate([c, c + 6]) for c in pm])
    kmask[2, max(1, (4 * k) // 10) :] = 0
    idx[3] = idx[1]
    kmask[3, kc:] = 0
    kmask[4] = 0
    idx[5, 0] = v + 7
    idx, kmask = planes(idx, dev), planes(kmask, dev)
    _, inf = _equal(KV.agg_pk, KV.agg_pk_plain, tx, ty, idx, kmask)
    assert inf[0].tolist() == [0, 1, 0, 1, 1, 1, 0]
    shape = (ctypes.c_int * 4)()
    assert B.load("aggpk").lt_agg_last_launch(shape) == 0
    assert list(shape) == KV.agg_launch_shape(n, k)
