"""The port's CUDA kernels on the card (marker `cuda`; each test skips
without a CUDA device).

Imports nothing of JAX, so it runs on a machine with the card alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Each kernel is held bit for bit against its plain torch version on the
same device tensors, and the verifier (default device: CUDA), per set
and as an RLC batch, against the crypto oracle.  chip_smoke.py does the
same at the main paths' shapes with a 1M-row table.  The verifiers run
under their default breaker, and every verifier test fails if the breaker
saw a failure or resolved a set on the host (`_no_fallback`).
"""

import ctypes
import threading
import time

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


def _no_fallback(v):
    """The breaker saw no failure and resolved no set on the host, so a
    device fault cannot pass a test on host verdicts."""
    sup = v.supervisor
    assert not sup.trip_count and not sup.m_failures.label_values(), sup.status()
    assert sup.m_host_fallback_sets.value == 0, sup.status()


@pytest.fixture(scope="module")
def points(dev):
    qs = [GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, scalar()) for _ in range(N)]
    ps = [GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, scalar()) for _ in range(N)]
    q = planes(np.stack([np.stack([LY.encode_batch([p[c][k] for p in qs]) for k in range(2)]) for c in range(2)]), dev)
    p = planes(np.stack([LY.encode_batch([x for x, _ in ps]), LY.encode_batch([y for _, y in ps]),
                         LY.encode_batch([1] * N)]), dev)
    return p, q


def _plain_g2(vals, dev):
    """Plain limb planes [2, 2, 12, n] of 4 n integers below 2^384."""
    n = len(vals) // 4
    return planes(LY.encode_plain_batch(vals).reshape(LY.NL, n, 2, 2).transpose(2, 3, 0, 1), dev)


def _to_plain(m):
    """Montgomery planes [..., 12, n] on the card -> plain limb planes of
    the same values."""
    flat = m.reshape(-1, LY.NL, m.shape[-1]).cpu().numpy()
    return planes(np.stack([LY.encode_plain_batch(LY.decode_batch(f)) for f in flat]).reshape(m.shape), m.device)


def _edge_vals(k):
    vals = [GT.P, GT.P + 1, 9 * GT.P, (1 << 384) - 1, GT.P - 1, 0, 1, 2 * GT.P]
    return (vals + [int.from_bytes(RNG.bytes(48), "little") for _ in range(k)])[:k]


@pytest.mark.parametrize("name", ["g2_subgroup_check", "g2_rsig_sub", "g2_decompress"])
def test_mont_ingest_on_card(dev, name):
    """The Montgomery ingest in the kernel that heads each path (once
    _k_mont8 / _k_mont4's launch of its own): one launch of the heading
    kernel, whose Montgomery planes equal mont_convert_plain's on values in
    [p, 2^384) and below p, and every output its plain version's."""
    pts = [GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, scalar()) for _ in range(N)]
    q = planes(np.stack([np.stack([LY.encode_batch([p[c][k] for p in pts]) for k in range(2)]) for c in range(2)]), dev)
    sig = _plain_g2([v + GT.P * (j % 3) for j, p in enumerate(pts) for c in p for v in c], dev)  # + 0, p, 2p
    msg = _plain_g2(_edge_vals(4 * N), dev)
    inf = torch.zeros((1, N), dtype=torch.int32, device=dev)
    if name == "g2_subgroup_check":
        out = _equal(KV.g2_subgroup_check, KV.g2_subgroup_check_plain, sig, inf, msg)
        assert torch.equal(out[1], q) and out[0].all()
    elif name == "g2_rsig_sub":
        rw = planes(make_rand_words(N, RNG), dev)
        out = _equal(KV.g2_rsig_sub, KV.g2_rsig_sub_plain, sig, inf, rw, msg)
        assert out[2].all()
    else:
        x = torch.zeros((2, LY.NL, N), dtype=torch.int32, device=dev)
        flags = torch.zeros((2, N), dtype=torch.int32, device=dev)
        flags[1] = 1
        out = _equal(KV.g2_decompress, KV.g2_decompress_plain, x, flags, msg)
    assert torch.equal(out[-1], KV.mont_convert_plain(msg))


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


def _sum_lanes(rlc, n):
    """n lanes cycling through the batch's r_i sig_i (lane 3 infinity, lane
    5 dead) with lanes 0 and 1 equal (a doubling at the tree's first level)
    and lane 7 the negation of lane 6 (infinity there)."""
    from lodestar_tpu_torch.kernels import fp2 as F2

    idx = torch.arange(n, device=rlc["rsig"].device) % N
    pts, excl = rlc["rsig"][..., idx].contiguous(), rlc["excl"][..., idx].contiguous()
    if n > 7:
        pts[..., 1] = pts[..., 0]
        pts[..., 7] = pts[..., 6]
        pts[1, ..., 7:8] = LY.digits_to_planes(F2.neg2(LY.planes_to_digits(pts[1, ..., 6:7].contiguous())))
        excl[0, :2] = 0
        excl[0, 6:8] = 0
    return pts, excl


@pytest.mark.parametrize("n", [1, 129, 512, 2048])
def test_sum_g2_on_card(rlc, n):
    """The lane sum's tree at one lane, one lane past a 128-lane tile and
    the main paths' 512 and 2048 lanes, bit-equal to the plain version;
    the kernel relaunched on the partials (LAUNCHES counts each launch),
    its first launch as the library reports it."""
    from lodestar_tpu_torch.kernels import warp_schedule as W

    pts, excl = _sum_lanes(rlc, n)
    # 32 elements per block to one partial: 1 launch up to 32 lanes, 2 up to 1024, 3 up to 32768
    _equal(KV.sum_g2, KV.sum_g2_plain, pts, excl, launches={1: 1, 129: 2, 512: 2, 2048: 3}[n])
    prog = W.sumg2_program()
    shape = (ctypes.c_int * 8)()
    assert B.load("reduce").lt_warp_last_launch(b"sum_g2", shape) == 0
    smem = LY.NL * 4 * (16 * prog.nslots + len(prog.consts))
    assert list(shape) == [n, -(-n // 32), 32 * 16, 32, smem, prog.nslots, prog.phases, prog.rounds]


@pytest.mark.parametrize("n", [1, 40, 128, 129, 512, 2048])
def test_prod12_on_card(rlc, n):
    """The Fp12 lane product's tree at one lane, the batch's 40, the
    grouped paths' 128-lane tile, one past it, and the ungrouped batches'
    512 and 2048 lanes (the batch's Miller values cycled, every seventh lane
    dead), bit-equal to the plain version; relaunched on its partials, its
    first launch as the library reports it."""
    from lodestar_tpu_torch.kernels import warp_schedule as W

    idx = torch.arange(n, device=rlc["f"].device) % N
    f, live = rlc["f"][..., idx].contiguous(), rlc["live"][..., idx].contiguous()
    live[0, 3::7] = 0
    _equal(KV.prod12, KV.prod12_plain, live, f, launches=1 if n <= 32 else 2 if n <= 1024 else 3)
    prog = W.prod12_program()
    shape = (ctypes.c_int * 8)()
    assert B.load("reduce").lt_warp_last_launch(b"prod12", shape) == 0
    smem = LY.NL * 4 * (16 * prog.nslots + len(prog.consts))
    assert list(shape) == [n, -(-n // 32), 32 * 16, 32, smem, prog.nslots, prog.phases, prog.rounds]


def test_affine_g2_on_card(rlc):
    """Finite lanes, a lane flagged infinity (lane 3) and lanes with Z = 0,
    flagged or not; the one-lane aggregate of the batch."""
    p = rlc["rsig"].clone()
    p[2, ..., 9] = 0
    p[2, ..., 3] = 0
    (_, a_inf) = _equal(KV.affine_g2, KV.affine_g2_plain, p, rlc["rsig_inf"])
    assert a_inf[0].tolist() == [int(j in (3, 9)) for j in range(N)]
    _equal(KV.affine_g2, KV.affine_g2_plain, *KV.sum_g2(rlc["rsig"], rlc["excl"]))
    assert_warp_launch("tail", "affine_g2", 1)


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
    assert {k: v for k, v in KV.LAUNCHES.items() if v} == {"g2_subgroup_check": 1, "miller_loop": 2, "each_final": 1}
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
    _no_fallback(v)


def test_mont_ingest_four_planes_on_card(dev):
    """The wire path's message planes, 4 planes of plain limbs (_k_mont4),
    converted by g2_decompress beside the wire x: its other outputs equal
    those of a launch without messages."""
    from lodestar_tpu_torch.bls.ingest import parse_signature_bytes

    pts = [GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, scalar()) for _ in range(N)]
    parsed = [parse_signature_bytes(GC.g2_compress(p)) for p in pts]
    x = planes(np.stack([LY.encode_plain_batch([p[i] for p in parsed]) for i in range(2)]), dev)
    flags = planes(np.array([[p[2] for p in parsed], [p[3] for p in parsed]], np.int32), dev)
    msg = _plain_g2(_edge_vals(4 * N), dev)
    xy, ok, msg_m = _equal(KV.g2_decompress, KV.g2_decompress_plain, x, flags, msg)
    xy0, ok0 = KV.g2_decompress(x, flags)
    assert torch.equal(xy, xy0) and torch.equal(ok, ok0) and ok.all()
    assert torch.equal(msg_m, KV.mont_convert_plain(msg))


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


def _hash_operands(lanes, dev):
    u = planes(np.stack([np.stack([LY.encode_plain_batch([v[i][k] for v in lanes]) for k in range(2)])
                         for i in range(2)]), dev)
    sgn = planes(np.array([[GH._sgn0_fp2(v[i]) for v in lanes] for i in range(2)], np.int32), dev)
    return u, sgn


def test_hash_g2_on_card(dev):
    """4 roots, u0 = 0 (SSWU's exceptional branch), u0 = u1 (q0 == q1: a
    doubling) and u1 = -u0 (the hash at infinity), bit-equal to the plain
    version; one warp per lane, its launch as the library reports it."""
    from lodestar_tpu_torch.kernels import warp_schedule as W

    lanes = [tuple(GH.hash_to_field_fp2(b"on-card-%d" % i, 2, GH.DST_G2)) for i in range(4)]
    u0 = lanes[0][0]
    lanes += [((0, 0), lanes[1][1]), (u0, u0), (u0, ((-u0[0]) % GT.P, (-u0[1]) % GT.P))]
    _, ok = _equal(KV.hash_g2, KV.hash_g2_plain, *_hash_operands(lanes, dev))
    assert ok.all()
    assert_warp_launch("ingest", "hash_g2", len(lanes))
    prog = W.hash_program()
    assert (prog.rounds, prog.fp_muls) == (KV.ROUNDS_PER_LANE["hash_g2"], KV.FP_MULS_PER_LANE["hash_g2"])


@pytest.mark.parametrize("n", [128, 512])
def test_hash_g2_distinct_roots_on_card(dev, n):
    """n distinct roots, as MessageCache encodes them: bit-equal to the
    plain version, every point hash_to_g2 of its root."""
    from lodestar_tpu_torch.bls.ingest import hash_field_planes, jacobian_to_affine

    roots = [b"on-card-distinct-%d" % i for i in range(n)]
    u, sgn = (planes(a, dev) for a in hash_field_planes(roots))
    out, ok = _equal(KV.hash_g2, KV.hash_g2_plain, u, sgn)
    assert ok.all()
    assert jacobian_to_affine(out, n) == [GH.hash_to_g2(r) for r in roots]


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
    _no_fallback(v)


def _cofactor_points():
    """A point of each prime order l dividing h1 ([#E / l^k] Q, l^k the
    l-part of #E, Q a curve point), its sum with a key of G1, and the
    cofactor part [r] Q."""
    def on_curve():
        while True:
            x = int.from_bytes(RNG.bytes(48), "big") % GT.P
            y = GT.fp_sqrt((x * x * x + 4) % GT.P)
            if y is not None:
                return x, y

    n_e = GT.H1_COFACTOR * GT.R
    pk = GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, scalar())
    out = []
    for ell, k in ((3, 1), (11, 2), (10177, 2), (859267, 2), (52437899, 2)):
        t = None
        while t is None:
            t = GC.scalar_mul(GC.FP_OPS, on_curve(), n_e // ell**k)
        out += [t, GC.affine_add(GC.FP_OPS, pk, t)]
    return out + [GC.scalar_mul(GC.FP_OPS, on_curve(), GT.R)]


def test_g1_keyvalidate_on_card(dev):
    """Keys of G1 with both signs, the order-3 key x = 0, an on-curve key
    outside G1, an x off the curve, a lane flagged infinity, and keys made
    from E(Fp)'s cofactor components (_cofactor_points, both signs): the
    kernel (the sigma test) bit-equal to the plain version ([r]P), each
    verdict the oracle's."""
    from lodestar_tpu_torch.bls.ingest import encode_pubkey_planes

    def x_key(x, sign=0):
        out = bytearray(x.to_bytes(48, "big"))
        out[0] |= 0x80 | (0x20 if sign else 0)
        return bytes(out)

    pks = [GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, scalar()) for _ in range(N - 8)]
    keys = [GC.g1_compress(p) for p in pks]
    keys += [bytes([keys[0][0] ^ 0x20]) + keys[0][1:], x_key(0), x_key(0, 1), x_key(4), x_key(5),
             GC.g1_compress(None), x_key(7), x_key(11)]
    for c in map(GC.g1_compress, _cofactor_points()):
        keys += [c, bytes([c[0] ^ 0x20]) + c[1:]]
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


@pytest.mark.parametrize("n", [1, 33, 512, 1024, 2048])
def test_seg_sums_on_card(dev, points, n):
    """The G1 and G2 segmented scans at 1, 33, 512, 1024 and 2048 lanes,
    one warp per lane and round: groups of 1..60 lanes (spanning blocks
    of 16 lanes), every sixth lane dead, the 40 points repeated (equal
    points in a group: doublings) and every eleventh lane the negation of
    the one before (P + (-P)); bit-equal to the plain versions, one launch
    per round as the entry point reports it, each launch's shape the
    library's record."""
    from lodestar_tpu_torch.kernels import warp_schedule as W

    p, q = points
    idx = torch.arange(n, device=dev) % N
    p, q = p[..., idx].contiguous(), q[..., idx].contiguous()
    def neg(col):  # Montgomery planes [12, 1] of y -> those of -y
        y = LY.decode_batch(col.cpu().numpy())[0]
        return planes(LY.encode_batch([(-y) % GT.P])[:, 0], dev)

    for j in range(10, n, 11):
        p[1, :, j] = neg(p[1, :, j - 1:j])
        for k in range(2):
            q[1, k, :, j] = neg(q[1, k, :, j - 1:j])
    group = planes(np.repeat(np.arange(n), RNG.integers(1, 61, size=n))[:n].astype(np.int32), dev)
    dead = (torch.arange(n, device=dev) % 6 == 5).to(torch.int32)[None].contiguous()
    rounds = KV.seg_rounds(n)
    for name, (kernel, plain), prog, pts in (
            ("seg_sum_g1", (KV.seg_sum_g1, KV.seg_sum_g1_plain), W.sumg1_program(), p),
            ("seg_sum_g2", (KV.seg_sum_g2, KV.seg_sum_g2_plain), W.sumg2_program(), q)):
        _equal(kernel, plain, pts, dead, group, launches=rounds)
        shape = (ctypes.c_int * 8)()
        assert B.load("segsum").lt_warp_last_launch(name.encode(), shape) == 0
        w = KV.seg_warps(n)
        smem = LY.NL * 4 * (w * prog.nslots + len(prog.consts))
        assert list(shape) == [n, -(-n // w), 32 * w, w, smem, prog.nslots, prog.phases, prog.rounds]
        assert prog.rounds == KV.ROUNDS_PER_LANE[name]


@pytest.mark.parametrize("n", [1, 5, 128, 129, 512])
def test_g2_subgroup_check_on_card(dev, points, n):
    """The warp-per-lane subgroup check at 1, 5 (a block's lanes 1..3
    idle), 128, 129 and 512 lanes, bit-equal to the plain version: points
    of G2, twist points outside it (j % 5 == 4), lanes flagged infinity
    (j % 5 == 3; outside points among them where j % 10 == 8, whose
    coordinates are set outside too) and the generator (j % 5 == 2, the
    per-set path's padding).  The launch, as the library reports it, is
    the generated program's."""
    from lodestar_tpu_torch.kernels import warp_schedule as W

    _, q = points
    u = GH.hash_to_field_fp2(b"sub-on-card", 1, b"torch-cuda")[0]
    out = GH.map_to_curve_svdw(GC.FP2_OPS, u)
    assert not GC.g2_subgroup_check(out)
    out_q = planes(np.stack([np.stack([LY.encode_batch([out[c][k]]) for k in range(2)]) for c in range(2)]), dev)
    gen = planes(np.stack([np.stack([LY.encode_batch([GC.G2_GEN[c][k]]) for k in range(2)]) for c in range(2)]), dev)
    qn = q[..., torch.arange(n, device=dev) % N].contiguous()
    for j in range(n):
        if j % 5 == 4 or j % 10 == 8:
            qn[..., j] = out_q[..., 0]
        elif j % 5 == 2:
            qn[..., j] = gen[..., 0]
    inf = (torch.arange(n, device=dev) % 5 == 3).to(torch.int32)[None].contiguous()
    prog = W.sub_program()
    smem = LY.NL * 4 * (4 * prog.nslots + len(prog.consts))
    # on Montgomery points (the wire per-set path: no ingest), then on the
    # decoded path's plain limbs beside a message (the ingest converts both)
    (sub,) = _equal(KV.g2_subgroup_check, KV.g2_subgroup_check_plain, qn, inf)
    assert sub[0].tolist() == [int(j % 5 != 4) for j in range(n)]
    shape = (ctypes.c_int * 8)()
    assert B.load("subgroup").lt_warp_last_launch(b"g2_subgroup_check", shape) == 0
    skip = (prog.io["INGEST_PHASES"], prog.io["INGEST_ROUNDS"])
    assert list(shape) == [n, (n + 3) // 4, 128, 4, smem, prog.nslots, prog.phases - skip[0], prog.rounds - skip[1]]
    msg = _plain_g2(_edge_vals(4 * n), dev)
    sub2, q_m, _ = _equal(KV.g2_subgroup_check, KV.g2_subgroup_check_plain, _to_plain(qn), inf, msg)
    assert torch.equal(sub2, sub) and torch.equal(q_m, qn)
    assert B.load("subgroup").lt_warp_last_launch(b"g2_subgroup_check", shape) == 0
    assert list(shape) == [n, (n + 3) // 4, 128, 4, smem, prog.nslots, prog.phases, prog.rounds]
    assert prog.rounds == KV.ROUNDS_PER_LANE["g2_subgroup_check"]


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
    _no_fallback(v)


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
    """The last launch of the library's kernel `name`: n lanes, one warp
    of 32 threads each, 4 to a block, the program's rounds."""
    shape = (ctypes.c_int * 8)()
    assert B.load(source).lt_warp_last_launch(name.encode(), shape) == 0
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
    prog = W.rsig_program()
    smem = LY.NL * 4 * (4 * prog.nslots + len(prog.consts))
    # on a Montgomery signature (the wire paths: no ingest), then on the
    # decoded path's plain limbs beside a message (the ingest converts both)
    rsig, rinf, sub = _equal(KV.g2_rsig_sub, KV.g2_rsig_sub_plain, qn, inf, rw)
    assert sub[0].tolist() == [int(j % 5 != 4) for j in range(n)]
    assert rinf[0].tolist() == [int(j % 5 in (1, 3)) for j in range(n)]
    shape = (ctypes.c_int * 8)()
    assert B.load("randmul").lt_warp_last_launch(b"g2_rsig_sub", shape) == 0
    skip = (prog.io["INGEST_PHASES"], prog.io["INGEST_ROUNDS"])
    assert list(shape) == [n, (n + 3) // 4, 128, 4, smem, prog.nslots, prog.phases - skip[0], prog.rounds - skip[1]]
    msg = _plain_g2(_edge_vals(4 * n), dev)
    out2 = _equal(KV.g2_rsig_sub, KV.g2_rsig_sub_plain, _to_plain(qn), inf, rw, msg)
    assert all(torch.equal(a, b) for a, b in zip(out2, (rsig, rinf, sub, KV.mont_convert_plain(msg))))
    assert B.load("randmul").lt_warp_last_launch(b"g2_rsig_sub", shape) == 0
    assert list(shape) == [n, (n + 3) // 4, 128, 4, smem, prog.nslots, prog.phases, prog.rounds]
    assert prog.rounds == KV.ROUNDS_PER_LANE["g2_rsig_sub"]


def _scalar_lanes(n):
    """n 128-bit scalars: random ones, the zero scalar (lane j % 5 == 1) and
    scalars with leading zero windows (j % 5 == 2) or all digits 15
    (j % 5 == 4); -> (scalars, word planes int32 [4, n] on the host)."""
    ks = [int.from_bytes(RNG.bytes(16), "big") for _ in range(n)]
    for j in range(n):
        ks[j] = {1: 0, 2: ks[j] >> 72, 4: (1 << 128) - 1}.get(j % 5, ks[j])
    w = np.array([[(k >> (32 * (3 - i))) & 0xFFFFFFFF for k in ks] for i in range(4)], np.uint32)
    return ks, w.view(np.int32)


@pytest.mark.parametrize("n", [1, 128, 129, 512])
def test_g1_rpk_lane_counts_on_card(dev, pairs, n):
    """The warp-per-lane r pk at 1, 128, 129 and 512 lanes, bit-equal to
    the plain version: Jacobian pubkeys with Z != 1, lanes cycling through
    random scalars, the zero scalar, leading zero windows, a pubkey flagged
    infinity and all digits 15.  The launch, as the library reports it
    under the kernel's name, is the generated program's."""
    from lodestar_tpu_torch.kernels import warp_schedule as W

    p, _, _ = pairs
    pn = p[..., torch.arange(n, device=dev) % p.shape[-1]].contiguous()
    _, w = _scalar_lanes(n)
    rw = planes(w, dev)
    inf = (torch.arange(n, device=dev) % 5 == 3).to(torch.int32)[None].contiguous()
    _, rinf = _equal(KV.g1_rpk, KV.g1_rpk_plain, pn, inf, rw)
    assert rinf[0].tolist() == [int(j % 5 in (1, 3)) for j in range(n)]
    prog = W.rpk_program()
    shape = (ctypes.c_int * 8)()
    assert B.load("randmul").lt_warp_last_launch(b"g1_rpk", shape) == 0
    smem = LY.NL * 4 * (4 * prog.nslots + len(prog.consts))
    assert list(shape) == [n, (n + 3) // 4, 128, 4, smem, prog.nslots, prog.phases, prog.rounds]
    assert prog.rounds == KV.ROUNDS_PER_LANE["g1_rpk"]


def _a1_zero_x(square: bool):
    """An x whose x^3 + 4(1 + i) is real, its real part a square of Fp or
    not: x = a + b i with 3 a^2 b - b^3 + 4 = 0."""
    P = GT.P
    while True:
        b = int.from_bytes(RNG.bytes(48), "little") % P or 1
        a = GT.fp_sqrt((b * b * b - 4) * pow(3 * b, P - 2, P) % P)
        for s in (a, (P - a) % P) if a is not None else ():
            rhs0 = (s * s * s - 3 * s * b * b + 4) % P
            if (GT.fp_sqrt(rhs0) is not None) == square:
                return (s, b)


@pytest.mark.parametrize("n", [1, 128, 129, 512])
def test_g2_decompress_lane_counts_on_card(dev, n):
    """The warp-per-lane decompression at 1, 128, 129 and 512 lanes,
    bit-equal to the plain version: lanes cycling through points with
    their own sign, the same x with the other sign, x off the curve, the
    infinity flag and the two rhs1 == 0 branches (a real and an imaginary
    root).  The launch, as the library reports it, is the generated
    program's."""
    from lodestar_tpu_torch.kernels import warp_schedule as W

    def rhs(x):
        return GT.fp2_add(GT.fp2_mul(GT.fp2_sqr(x), x), GC.FP2_OPS.b_coeff)

    pts = [GC.scalar_mul(GC.FP2_OPS, GC.G2_GEN, scalar()) for _ in range(2)]
    off = next((k, k + 3) for k in range(1, 100) if GT.fp2_sqrt(rhs((k, k + 3))) is None)
    base = [(p[0], GT.fp2_sgn(p[1]), 0) for p in pts] + [(pts[0][0], 1 - GT.fp2_sgn(pts[0][1]), 0)]
    base += [(off, 0, 0), ((0, 0), 0, 1), (_a1_zero_x(True), 1, 0), (_a1_zero_x(False), 0, 0)]
    pick = [base[j % len(base)] for j in range(n)]
    x = planes(np.stack([LY.encode_plain_batch([c[0][k] for c in pick]) for k in range(2)]), dev)
    flags = planes(np.array([[c[1] for c in pick], [c[2] for c in pick]], np.int32), dev)
    xy, ok = _equal(KV.g2_decompress, KV.g2_decompress_plain, x, flags)
    assert ok[0].tolist() == [int(j % 7 != 3) for j in range(n)]
    msg = _plain_g2(_edge_vals(4 * n), dev)  # with the wire paths' messages: the same rounds
    out2 = _equal(KV.g2_decompress, KV.g2_decompress_plain, x, flags, msg)
    assert torch.equal(out2[0], xy) and torch.equal(out2[1], ok)
    prog = W.decompress_program()
    shape = (ctypes.c_int * 8)()
    assert B.load("ingest").lt_warp_last_launch(b"g2_decompress", shape) == 0
    smem = LY.NL * 4 * (4 * prog.nslots + len(prog.consts))
    assert list(shape) == [n, (n + 3) // 4, 128, 4, smem, prog.nslots, prog.phases, prog.rounds]
    assert prog.rounds == KV.ROUNDS_PER_LANE["g2_decompress"]


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


@pytest.fixture(scope="module")
def service_world(dev):
    """chip_smoke.py's service phases at a small size: 8 keys over 2 roots
    (row r holds key r % 8), their 16 signatures as chip_smoke's make_job
    lays them out (key k over root r at r * 8 + k)."""
    import chip_smoke as CS
    from lodestar_tpu_torch.bls.signature_set import WireSignatureSet

    n_keys, roots = 8, [b"on-card-service-a", b"on-card-service-b"]
    sks = [scalar() for _ in range(n_keys)]
    pks = [GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, sk) for sk in sks]
    hs = [GH.hash_to_g2(r) for r in roots]
    wire_valid = [WireSignatureSet.single(k, roots[r], GC.g2_compress(GC.scalar_mul(GC.FP2_OPS, hs[r], sks[k])))
                  for r in range(2) for k in range(n_keys)]
    table = PubkeyTable()
    table.register_points_unchecked(pks, tile_to=320)
    return CS, table, dict(roots=roots, wire_valid=wire_valid)


def _small_service_phases(monkeypatch, CS):
    for name, value in dict(FLOOD_SETS=128, FLOOD_WAVES=2, WARM_SETS=16, CRIT_ROW=128, SIDE_ROW=160, WARM_ROW=192,
                            BREAKER_ROW=256).items():
        monkeypatch.setattr(CS, name, value)


def test_service_flood_on_card(service_world, monkeypatch):
    """chip_smoke.service_flood at 128 distinct sets (2 of them bad): every
    verdict right, the breaker closed with no host-fallback set, every
    kernel of the flood launched."""
    CS, table, d = service_world
    _small_service_phases(monkeypatch, CS)
    line = CS.service_flood(table, d, "test")
    assert line["bad_sets"] == 2 and line["breaker"] == "closed" and line["host_fallback_sets"] == 0
    assert set(line["launches"]) >= set(CS.FLOOD_KERNELS)


def test_breaker_trip_and_recovery_on_card(service_world, monkeypatch):
    """chip_smoke.breaker_phase: a CUDA launch failure at the wire batch
    entry trips to host verdicts, the canary closes the breaker on the
    card, and a 16-set job runs on the device."""
    CS, table, d = service_world
    _small_service_phases(monkeypatch, CS)
    line = CS.breaker_phase(table, d, "test")
    assert line["outcome"] == "error" and line["sets_on_host"] == CS.BREAKER_SETS
    assert line["state_after"] == "closed" and line["canary_launches"]["each_final"] >= 1


def test_begin_job_does_not_wait_for_the_card(service_world):
    """begin_job returns while a spin kernel queued before it still runs
    (its operands are copied with `non_blocking`), decoded and
    wire, per set and batched; finish_job then gives the verdicts."""
    CS, table, d = service_world
    v = TorchBlsVerifier(table)
    wire = d["wire_valid"]
    decoded = [s.decode() for s in wire[:2]]
    for sets in (decoded, wire):
        assert v.verify_signature_sets(sets, VerifyOptions(batchable=True))  # warm: constants, table, cache
        for batchable in (False, True):
            torch.cuda.synchronize()
            torch.cuda._sleep(1_000_000_000)  # ~0.5 s of spinning on the stream
            spin = torch.cuda.Event()
            spin.record()
            job = v.begin_job(sets, batchable)
            assert not spin.query(), "begin_job waited for the card"
            assert v.finish_job(job) is True
    _no_fallback(v)


def test_watchdog_polls_the_card_on_the_callers_thread(dev):
    """On the card a guarded call runs on the caller's thread: a wait for
    the card within the deadline returns the tensor, one past it raises
    DeviceTimeout (classified `timeout`) while the kernel spins on, and no
    thread is started."""
    from lodestar_tpu_torch.bls.supervisor import DeviceSupervisor, DeviceTimeout, classify_failure

    table = PubkeyTable()
    table.register([GC.scalar_mul(GC.FP_OPS, GC.G1_GEN, scalar())])
    v = TorchBlsVerifier(table, supervisor=DeviceSupervisor(device="cuda", job_deadline_s=0.2, auto_probe=False))
    x = torch.ones(4, device="cuda")
    torch.cuda.synchronize()
    threads = threading.active_count()
    assert v._guarded(lambda: v._host(x * 2).tolist(), "quick") == [2.0] * 4
    torch.cuda._sleep(2_000_000_000)  # ~1 s of spinning
    y = x + 1
    t0 = time.monotonic()
    with pytest.raises(DeviceTimeout) as e:
        v._guarded(lambda: v._host(y), "hung")
    assert 0.2 <= time.monotonic() - t0 < 0.6 and classify_failure(e.value) == "timeout"
    assert threading.active_count() == threads
    torch.cuda.synchronize()
    assert y.cpu().tolist() == [2.0] * 4


# -- the hash forest (csrc/sha256.cu) --------------------------------------------


def _sha_words(rng, shape, dev):
    return torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32)).to(dev)


@pytest.mark.parametrize("n", [1, 33, 1025])
def test_sha256_hash_pairs_on_card(dev, n):
    from lodestar_tpu_torch.kernels import sha256 as SK

    x = _sha_words(np.random.default_rng(n), (n, 16), dev)
    before = SK.LAUNCHES["hash_pairs"]
    out = SK.hash_pairs(x)
    assert SK.LAUNCHES["hash_pairs"] == before + 1
    assert torch.equal(out, SK.hash_pairs_plain(x))


@pytest.mark.parametrize("k,b", [(3, 1), (40, 512), (2, 1024)])
def test_sha256_forest_sweep_on_card(dev, k, b):
    from lodestar_tpu_torch.kernels import sha256 as SK

    rng = np.random.default_rng(k * b)
    pairs = _sha_words(rng, (k, b, 16), dev)
    # each level's lanes scattered to a permutation of [0, b + 4): some dropped
    lane = torch.from_numpy(np.stack([rng.permutation(b + 4)[:b] for _ in range(k)]).astype(np.int32)).to(dev)
    half = torch.from_numpy(rng.integers(0, 2, (k, b)).astype(np.int32)).to(dev)
    assert torch.equal(SK.forest_sweep(pairs, lane, half), SK.forest_sweep_plain(pairs, lane, half))


def _sweep_plan(rng, k, b, dev):
    pairs = _sha_words(rng, (k, b, 16), dev)
    lane = torch.from_numpy(np.stack([rng.permutation(b + 4)[:b] for _ in range(k)]).astype(np.int32)).to(dev)
    half = torch.from_numpy(rng.integers(0, 2, (k, b)).astype(np.int32)).to(dev)
    return pairs, lane, half


@pytest.mark.parametrize("case", ["slot_like", "one_lane", "dead_lanes", "narrow_from_start", "wide_to_the_end"])
def test_sha256_forest_sweep_live_on_card(dev, case):
    """The cluster sweep with live counts against its plain version: a
    slot-like plan (~256 live lanes for 12 levels, then halving to 1), the
    (40, 1) chain, live counts with dead lanes scattering, a plan narrow
    from its first level (block 0 alone) and one wide to its last."""
    from lodestar_tpu_torch.kernels import sha256 as SK

    rng = np.random.default_rng(len(case))
    k, b = (40, 1) if case == "one_lane" else (40, 512)
    pairs, lane, half = _sweep_plan(rng, k, b, dev)
    if case == "slot_like":
        live = [256] * 12 + [max(1, 256 >> (l - 11)) for l in range(12, 40)]
    elif case == "one_lane":
        live = [1] * 40
    elif case == "dead_lanes":
        live = [int(x) for x in rng.integers(0, b + 1, k)]
    elif case == "narrow_from_start":
        live = [64] * 5 + [3] * 35
    else:
        live = [b] * 39 + [300]
    live = torch.tensor(live, dtype=torch.int32, device=dev)
    before = SK.LAUNCHES["forest_sweep"]
    out = SK.forest_sweep(pairs, lane, half, live)
    torch.cuda.synchronize()
    assert SK.LAUNCHES["forest_sweep"] == before + 1
    assert torch.equal(out, SK.forest_sweep_plain(pairs, lane, half, live))


@pytest.mark.parametrize("d", [1, 513])
def test_sha256_validator_roots_on_card(dev, d):
    from lodestar_tpu_torch.kernels import sha256 as SK

    rng = np.random.default_rng(d)
    cols = [_sha_words(rng, (d, 8), dev), _sha_words(rng, (d, 8), dev)] + [_sha_words(rng, (d, 2), dev)
                                                                           for _ in range(5)]
    cols.append(torch.from_numpy(rng.integers(0, 2, d).astype(np.int32)).to(dev))
    assert torch.equal(SK.validator_roots(*cols), SK.validator_roots_plain(*cols))


def test_sha256_wrappers_refuse_bad_operands_on_card(dev):
    from lodestar_tpu_torch.kernels import sha256 as SK

    x = torch.zeros((8, 16), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        SK.hash_pairs(x.to(torch.int64))
    with pytest.raises(ValueError):
        SK.hash_pairs(torch.zeros((16, 8), dtype=torch.int32, device=dev).t())  # not contiguous
    with pytest.raises(ValueError):
        SK.hash_pairs(x.view(-1)[1:113].view(7, 16))  # not 16-byte aligned
    with pytest.raises(ValueError):
        SK.forest_sweep(torch.zeros((1, 8, 16), dtype=torch.int32, device=dev),
                        torch.zeros((1, 8), dtype=torch.int32), torch.zeros((1, 8), dtype=torch.int32, device=dev))


def test_merkle_backend_on_card(dev):
    from lodestar_tpu_torch.ssz import ChunkTree, merkleize_chunks
    from lodestar_tpu_torch.ssz import device_backend as DB

    b = DB.DeviceMerkleBackend()
    assert b.device.type == "cuda" and b.supervisor.job_deadline_s
    assert b._canary()
    DB.set_backend(b)
    try:
        rng = np.random.default_rng(3)
        leaves = rng.integers(0, 256, (3000, 32), dtype=np.uint8)
        tree = ChunkTree(1 << 40)
        tree.update(leaves)  # the level loop: 1,500 pairs on the card
        leaves[rng.integers(0, 3000, 100)] = rng.integers(0, 256, (100, 32), dtype=np.uint8)
        tree.update(leaves)  # one sweep
        assert tree.root == merkleize_chunks([bytes(r) for r in leaves], 1 << 40)
        assert b.m_dispatches.get("htr_hash_pairs") == 1 and b.m_dispatches.get("htr_forest_sweep") == 1
        assert b.supervisor.status()["state"] == "closed" and b.m_host_levels.value == 0
    finally:
        DB.reset_backend()


def test_a_refused_sweep_launch_raises_on_card(dev, monkeypatch):
    """A sweep launch the card refuses (its entry point returning a CUDA
    error, as a cluster the card cannot place does) raises LaunchRefused
    out of the state root's tree on the card: no host level, the breaker
    closed."""
    from lodestar_tpu_torch.ssz import ChunkTree
    from lodestar_tpu_torch.ssz import device_backend as DB

    b = DB.DeviceMerkleBackend()
    DB.set_backend(b)
    try:
        rng = np.random.default_rng(4)
        leaves = rng.integers(0, 256, (3000, 32), dtype=np.uint8)
        tree = ChunkTree(1 << 40)
        tree.update(leaves)
        monkeypatch.setattr(B.load("sha256"), "lt_sha256_sweep", lambda *args: 1)  # cudaErrorInvalidValue
        leaves[rng.integers(0, 3000, 100)] = rng.integers(0, 256, (100, 32), dtype=np.uint8)
        with pytest.raises(B.LaunchRefused):
            tree.update(leaves)
        assert b.supervisor.status()["state"] == "closed" and b.m_host_levels.value == 0
    finally:
        DB.reset_backend()


# -- the slasher's span update (csrc/spans.cu) ------------------------------------

SPAN_EDGES = [(5, 20), (-7, 12), (9, 9), (0, 0), (10, 63), (50, 94), (67, 73), (-9, -2), (12, 40)]


@pytest.mark.parametrize("s,t", SPAN_EDGES)
def test_span_update_on_card(dev, s, t):
    from lodestar_tpu_torch.kernels import spans as SP

    rng = np.random.default_rng(s * 100 + t + 1000)
    v, h = 300, 64
    mn = torch.from_numpy(rng.integers(-4, 80, (v, h)).astype(np.int32)).to(dev)
    mx = torch.from_numpy(rng.integers(-4, 80, (v, h)).astype(np.int32)).to(dev)
    for rows in ([3, 0, 299, 17, 3], list(range(v)), []):
        r = torch.tensor(rows, dtype=torch.int64, device=dev)
        mask = torch.zeros(v, dtype=torch.bool, device=dev)
        mask[r] = True
        want = SP.span_update_planes_plain(mn, mx, mask, s, t)
        before = SP.LAUNCHES["span_update"]
        SP.span_update(mn, mx, r, s, t)
        torch.cuda.synchronize()
        launched = bool(rows) and SP.touched_columns(h, s, t) > 0
        assert SP.LAUNCHES["span_update"] == before + launched
        assert torch.equal(mn, want[0]) and torch.equal(mx, want[1])
    with pytest.raises(ValueError):
        SP.span_update(mn, mx, torch.zeros(1, dtype=torch.int64), s, t)  # rows on the host


@pytest.mark.parametrize("case", ["narrow", "wide", "odd_h"])
def test_span_update_many_on_card(dev, case):
    """One launch of many datas with disjoint rows against the plain
    version data after data: 64 narrow datas (3 columns, the path's), 4
    wide ones (16-byte vectors over ~4,000 columns), and single columns at
    an odd h."""
    from lodestar_tpu_torch.kernels import spans as SP

    rng = np.random.default_rng(len(case) + 50)
    v, h = {"narrow": (4096, 4096), "wide": (256, 4096), "odd_h": (300, 61)}[case]
    d = {"narrow": 64, "wide": 4, "odd_h": 9}[case]
    mn = torch.from_numpy(rng.integers(-4, 4000, (v, h)).astype(np.int32)).to(dev)
    mx = torch.from_numpy(rng.integers(-4, 4000, (v, h)).astype(np.int32)).to(dev)
    per = v // d
    rows = rng.permutation(v)[: per * d].reshape(d, per)
    if case == "narrow":
        cols = [(3, 4)] * d
    elif case == "wide":
        cols = [(2048, 4095), (-5, 3000), (4000, 4000), (1, 4096)]
    else:
        cols = [(int(s), int(s) + int(g)) for s, g in zip(rng.integers(-3, 64, d), rng.integers(-2, 30, d))]
    seg = np.arange(d + 1, dtype=np.int64) * per
    pm, px = mn.clone(), mx.clone()
    for i, (s_col, t_col) in enumerate(cols):
        mask = torch.zeros(v, dtype=torch.bool, device=dev)
        mask[torch.from_numpy(rows[i]).to(dev)] = True
        pm, px = SP.span_update_planes_plain(pm, px, mask, s_col, t_col)
    assert SP.span_width(mn, mx) == (1 if case == "odd_h" else 4)
    before = SP.LAUNCHES["span_update"], SP.APPLIES["span_update"]
    carried = SP.span_update_many(mn, mx, torch.from_numpy(rows.reshape(-1)).to(dev), seg,
                                  [c[0] for c in cols], [c[1] for c in cols])
    torch.cuda.synchronize()
    assert carried == sum(1 for s_col, t_col in cols if SP.touched_columns(h, s_col, t_col))
    assert (SP.LAUNCHES["span_update"] - before[0], SP.APPLIES["span_update"] - before[1]) == (1, carried)
    assert torch.equal(mn, pm) and torch.equal(mx, px)


def test_torch_span_state_on_card_equals_numpy(dev):
    from lodestar_tpu_torch.slasher import AttesterSlasher, SpanState, TorchSpanState

    rng = np.random.default_rng(77)
    a = SpanState(num_validators=8, history_length=64, chunk_size=8)
    c = TorchSpanState(num_validators=8, history_length=64, chunk_size=8)
    assert c.device.type == "cuda" and c.min_spans.is_cuda
    for step in range(60):
        t = int(rng.integers(0, 150))
        s = int(rng.integers(max(0, t - 40), t + 1))
        rows = np.unique(rng.integers(0, 40 + 4 * step, int(rng.integers(1, 6))))
        for sp in (a, c):
            sp.ensure_epoch(t)
            sp.ensure_validators(int(rows.max()) + 1)
            sp.apply(rows, s, t)
        assert a.base_epoch == c.base_epoch and a.num_validators == c.num_validators
        if s >= a.base_epoch:
            for x, y in zip(a.lookup(rows, s), c.lookup(rows, s)):
                assert y.dtype == np.int32 and np.array_equal(x, y)
        if step % 13 == 12:
            a.advance_base(a.base_epoch + 24)
            c.advance_base(c.base_epoch + 24)
    snap = c.snapshot()
    assert np.array_equal(snap.min_spans, a.min_spans) and np.array_equal(snap.max_spans, a.max_spans)
    assert sum(c.drains.values()) > 0  # the deferred applies went through span_update_many
    assert AttesterSlasher().spans.min_spans.is_cuda  # the card with no argument


def test_node_phase_on_card(dev, monkeypatch):
    """chip_smoke.node_phase at 8,192 validators (2 committees of 128 at
    the slot, 2 bad attesters, 32 re-publishes, the second committee
    parked until its block; 288 arrivals over the slot's 4 s, too few to
    fill the queue): every verdict as constructed, the parked
    committee released, both committee aggregates True, no set on the
    host, every kernel of the node's path launched and its first call
    equal to its plain version, the head where the votes point."""
    import chip_smoke as CS
    from lodestar_tpu_torch.crypto import bls as GB

    monkeypatch.setattr(CS, "NODE_REPUBLISH", 32)
    n = 8192
    sks = CS.make_keys(np.random.default_rng(CS.SEED))
    pks = [GB.sk_to_pk(sk) for sk in sks]
    comp = [GC.g1_compress(pk) for pk in pks]
    table = PubkeyTable()
    table.register_points_unchecked(pks, tile_to=n)
    line, counts, held = CS.node_phase(table, [comp[r % CS.N_KEYS] for r in range(n)], sks, "test")
    assert (line["committees"], line["attestations"], line["accepted"]) == (2, 256, 254)
    assert line["parked"] == line["released"] > 128 and line["dropped"] == 0 and line["deduped"] == 32
    assert line["host_fallback_sets"] == 0 and line["committee_aggregates"]["all_true"]
    assert set(held) >= set(CS.NODE_KERNELS) and all(counts[k] for k in held)


def test_chain_phase_on_card(dev, monkeypatch):
    """chip_smoke.chain_phase, the fork walk, at 8,192 validators (2
    committees of 128 a slot): the blocks at 33 (phase0, two slots'
    committees), 64 (the rewarded phase0 epoch and the altair upgrade), 96
    (the merge), 128 (capella) and 160 (deneb), and the three refused
    copies of 160: every block imported on its fork, each post-state's
    root equal to the host path's, the copies refused by their legs, the
    head's payload the engine's head, no set on the host, no host tree level, no signature checked inside the
    transition, every kernel of the chain's path launched and every call
    of it equal to its plain version; the merge block on the tracker's
    terminal block, the capella block through the builder, two epochs
    precomputed and five payloads prepared, three light-client updates off
    the planes, the monitor's counts and the checkpoint start's cold
    root."""
    import chip_smoke as CS
    from lodestar_tpu_torch.crypto import bls as GB

    n = 8192
    monkeypatch.setattr(CS, "CHAIN_VALIDATORS", n)
    monkeypatch.setattr(CS, "CHAIN_SWAPPED", (0, 1))
    sks = CS.make_keys(np.random.default_rng(CS.SEED))
    pks = [GB.sk_to_pk(sk) for sk in sks]
    comp = [GC.g1_compress(pk) for pk in pks]
    table = PubkeyTable()
    table.register_points_unchecked(pks, tile_to=n)
    line, counts = CS.chain_phase(table, [comp[r % CS.N_KEYS] for r in range(n)], sks, "test")
    assert [b["slot"] for b in line["blocks"]] == list(CS.CHAIN_SLOTS)
    assert line["forks"] == ["phase0", "altair", "bellatrix", "capella", "deneb"]
    assert [r["leg"] for r in line["rejected"]] == ["signature_verify", "state_root", "validation"]
    assert line["engine"]["payload_head"] == line["engine"]["head"] and line["engine"]["optimistic"] == 0
    assert line["host_fallback_sets"] == 0 and line["host_tree_levels"] == 0
    assert line["host_signature_checks_in_stf"] == 0
    assert set(line["held"]) >= set(CS.CHAIN_KERNELS + CS.CHAIN_SHA)
    assert all(counts[k] for k in CS.CHAIN_KERNELS + CS.CHAIN_SHA)
    assert line["merge"]["terminal_block"] == 3 and line["builder"]["revealed"] == 1
    prepared = len(CS.CHAIN_PREPARED_SLOTS) + sum(s >= CS.CHAIN_MERGE_SLOT for s in CS.CHAIN_SLOTS)
    assert (line["scheduler"]["prepared_epochs"], line["scheduler"]["payloads_prepared"]) == (2, prepared)
    assert line["light_client"]["signature_slots"] == list(CS.CHAIN_LC_SLOTS)
    assert line["light_client"]["host_proofs"] == 0 and line["checkpoint_start"]["source"] == "checkpoint"
