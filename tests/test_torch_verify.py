"""The port's per-set verification slice as a whole: kernels/verify.py,
bls/pubkey_table.py and bls/verifier.py.

The port runs with device="cpu", so every kernel wrapper takes its plain
torch version.  Verdicts are held against the JAX package's host ground
truth (`TpuBlsVerifier._verify_set_cpu`) on the SAME pubkey table,
carried across from a JAX `PubkeyTable` with `from_jax_planes`.  Job
buckets are narrowed to 8 lanes where a test needs several jobs (the
plain engine's cost is per call, not per lane); one test keeps the real
128-lane bucket.  The comparison with the JAX Pallas path (interpret
mode) is `slow`, like the JAX package's own pipeline tests.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lodestar_tpu.bls import pubkey_table as JPT
from lodestar_tpu.bls import signature_set as JSS
from lodestar_tpu.bls.verifier import TpuBlsVerifier
from lodestar_tpu.crypto import bls as GB
from lodestar_tpu.crypto import curves as GC
from lodestar_tpu.crypto import hash_to_curve as GH
from lodestar_tpu_torch.bls import verifier as VR
from lodestar_tpu_torch.bls.pubkey_table import PubkeyTable
from lodestar_tpu_torch.bls.signature_set import SignatureSet
from lodestar_tpu_torch.kernels import layout as LY
from lodestar_tpu_torch.kernels import verify as KV

N_KEYS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain engine's tensors are small, and
    parallel test workers must not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    sks = [GB.keygen(b"torch-verify-%d" % i) for i in range(N_KEYS)]
    pks = [GB.sk_to_pk(sk) for sk in sks]
    jtable = JPT.PubkeyTable(capacity=8)
    jtable.register(pks)
    table = PubkeyTable.from_jax_planes(jtable._host_x, jtable._host_y, len(jtable))
    roots = [b"root-a", b"root-b"]
    hs = [GH.hash_to_g2(r) for r in roots]
    sigs = {(k, r): GC.scalar_mul(GC.FP2_OPS, hs[r], sks[k]) for k in range(N_KEYS) for r in range(2)}
    u = GH.hash_to_field_fp2(b"outside", 1, b"torch-verify")[0]
    outside = GH.map_to_curve_svdw(GC.FP2_OPS, u)
    assert not GC.g2_subgroup_check(outside)
    # (index, message, signature, kind)
    cases = [
        (0, hs[0], sigs[0, 0], "valid"),
        (1, hs[1], sigs[1, 1], "valid"),
        (2, hs[1], sigs[2, 0], "wrong message"),
        (3, hs[0], sigs[1, 0], "swapped signature"),
        (1, hs[0], None, "signature at infinity"),
        (2, hs[0], outside, "signature outside G2"),
        (3, hs[1], sigs[3, 1], "valid"),
    ]
    jax_verifier = TpuBlsVerifier(jtable)
    truth = [jax_verifier._verify_set_cpu(JSS.SignatureSet.single(i, m, s)) for i, m, s, _ in cases]
    jax_verifier.close()
    assert truth == [kind == "valid" for *_, kind in cases]
    sets = [SignatureSet.single(i, m, s) for i, m, s, _ in cases]
    return dict(pks=pks, jtable=jtable, table=table, sets=sets, truth=truth, cases=cases)


@pytest.fixture
def small_buckets(monkeypatch):
    monkeypatch.setattr(VR, "N_BUCKETS", (8, 16, 512))


# ---------------------------------------------------------------------------
# the table
# ---------------------------------------------------------------------------


def test_table_carried_across_from_jax(world):
    table, jtable, pks = world["table"], world["jtable"], world["pks"]
    assert len(table) == N_KEYS
    for i, pk in enumerate(pks):
        assert table.host_affine(i) == jtable.host_affine(i) == pk
    tx, ty = table.device_planes("cpu")
    assert tx.dtype == torch.int32 and tuple(tx.shape) == (LY.NL, N_KEYS)
    assert np.array_equal(tx.numpy(), LY.encode_batch([p[0] for p in pks]))
    assert np.array_equal(ty.numpy(), LY.encode_batch([p[1] for p in pks]))


def test_register_validates_and_bulk_load_tiles(world):
    pks = world["pks"]
    t = PubkeyTable(capacity=2)
    assert t.register(pks[:3]) == [0, 1, 2]  # grows past capacity
    assert [t.host_affine(i) for i in range(3)] == pks[:3]
    with pytest.raises(ValueError, match="infinity"):
        t.register([None])
    with pytest.raises(ValueError, match="not on curve"):
        t.register([(1, 1)])
    tiled = PubkeyTable(capacity=1)
    assert tiled.register_points_unchecked(pks[:3], tile_to=10) == list(range(10))
    assert [tiled.host_affine(i) for i in range(10)] == [pks[i % 3] for i in range(10)]
    assert tiled.nbytes == 2 * LY.NL * 4 * 10  # the planes grew to exactly 10 rows
    with pytest.raises(ValueError, match="empty table"):
        tiled.register_points_unchecked(pks[:1])
    with pytest.raises(ValueError, match="tile_to"):
        PubkeyTable().register_points_unchecked(pks[:3], tile_to=2)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def test_wrappers_check_operands_and_take_plain_version_on_cpu():
    x = torch.from_numpy(LY.encode_plain_batch([1, 2, LY.P + 5]))
    KV.reset_launches()
    assert LY.decode_batch(KV.mont_convert(x).numpy()) == [1, 2, 5]
    assert KV.LAUNCHES == {k: 0 for k in KV.LAUNCHES}
    with pytest.raises(TypeError):
        KV.mont_convert(x.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        KV.mont_convert(torch.zeros((LY.NL, 6), dtype=torch.int32)[:, ::2])
    with pytest.raises(ValueError, match="device"):
        KV.mont_convert(torch.zeros((LY.NL, 2), dtype=torch.int32, device="meta"))
    q = torch.zeros((2, 2, LY.NL, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        KV.g2_subgroup_check(q, torch.zeros((1, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="shape"):
        KV.miller_loop(torch.zeros((2, LY.NL, 4), dtype=torch.int32), q)
    f = torch.zeros((12, LY.NL, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="shape"):
        KV.each_final(torch.zeros((4,), dtype=torch.int32), f, f)


def test_verify_each_device_padding_and_dead_lanes(world):
    """Direct call: padding lanes (valid 0) are True whatever they hold,
    a set flagged infinity is False, valid sets pass."""
    table, cases = world["table"], world["cases"]
    g2 = GC.G2_GEN
    rows = [(0, cases[0][1], cases[0][2]), (1, cases[1][1], cases[1][2]), (0, cases[0][1], cases[0][2])]
    msgs = [m for _, m, _ in rows] + [g2]
    sigs = [s for _, _, s in rows] + [g2]
    coords = [[pt[c][k] for pt in pts] for pts in (msgs, sigs) for c in range(2) for k in range(2)]
    planes = torch.from_numpy(np.stack([LY.encode_plain_batch(v) for v in coords]))
    idx = torch.tensor([[0], [1], [0], [3]], dtype=torch.int32)
    sig_inf = torch.tensor([0, 0, 1, 0], dtype=torch.int32)
    valid = torch.tensor([1, 1, 1, 0], dtype=torch.int32)
    tx, ty = table.device_planes("cpu")
    got = KV.verify_each_device(tx, ty, idx, torch.ones_like(idx), planes, sig_inf, valid)
    assert got.tolist() == [True, True, False, True]
    # K = 2 with the second row masked: agg_pk sums one key, same verdicts
    idx2 = torch.cat([idx, torch.full_like(idx, 2)], 1)
    kmask2 = torch.tensor([[1, 0]] * 4, dtype=torch.int32)
    assert KV.verify_each_device(tx, ty, idx2, kmask2, planes, sig_inf, valid).tolist() == got.tolist()


# ---------------------------------------------------------------------------
# the verifier
# ---------------------------------------------------------------------------


def test_verdicts_match_jax_host_ground_truth(world, small_buckets):
    """Valid and invalid mixes, infinity and non-subgroup signatures and a
    padding lane (7 sets in an 8-lane job), against TpuBlsVerifier's host
    ground truth on the table carried across."""
    v = VR.TorchBlsVerifier(world["table"], device="cpu")
    sets, truth = world["sets"], world["truth"]
    assert v.verify_signature_sets_individually(sets) == truth
    assert [v._verify_set_cpu(s) for s in sets] == truth
    assert v.can_accept_work()


def test_verify_signature_sets_ands_over_chunks(world, small_buckets):
    v = VR.TorchBlsVerifier(world["table"], device="cpu", max_job_sets=3)
    sets, truth = world["sets"], world["truth"]
    valid_sets = [s for s, t in zip(sets, truth) if t]
    assert v.verify_signature_sets(valid_sets) is True
    assert v.verify_signature_sets(valid_sets + [sets[2]]) is False  # 2 jobs, bad one in the second
    assert v.verify_signature_sets([]) is True
    main = VR.VerifyOptions(verify_on_main_thread=True)
    assert v.verify_signature_sets(valid_sets, main) is True
    assert v.verify_signature_sets(sets[:3], main) is False


@pytest.mark.parametrize("case", ["aggregate_verifies", "unknown_index_raises"])
def test_aggregate_and_unknown_index_sets(world, small_buckets, case):
    """An aggregate set (K = 2, the K bucket 4) verifies on the device
    path against the oracle; an index outside the table still raises."""
    v = VR.TorchBlsVerifier(world["table"], device="cpu")
    s = world["sets"][0]
    if case == "unknown_index_raises":
        with pytest.raises(IndexError, match="not in the pubkey table"):
            v.verify_signature_sets([SignatureSet.single(N_KEYS, s.message, s.signature)])
        return
    sig01 = GC.affine_add(GC.FP2_OPS, s.signature, world["cases"][3][2])  # keys 0 and 1 sign root a
    good = SignatureSet.aggregate([0, 1], s.message, sig01)
    bad = SignatureSet.aggregate([0, 1], s.message, s.signature)
    assert GB.fast_aggregate_verify(world["pks"][:2], b"root-a", sig01)
    assert v.verify_signature_sets_individually([bad, good, s]) == [False, True, True]
    assert v.verify_signature_sets([s, good]) is True


def test_canary_on_the_real_bucket(world):
    """The breaker canary: one junk set padded into the real 128-lane
    bucket must come back False."""
    v = VR.TorchBlsVerifier(world["table"], device="cpu")
    assert v._device_canary() is True


def test_default_device_is_cuda():
    """Entry points run on the card unless the caller asks for the CPU."""
    table = PubkeyTable()
    if torch.cuda.is_available():
        assert VR.TorchBlsVerifier(table).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            VR.TorchBlsVerifier(table)
    assert VR.TorchBlsVerifier(table, device="cpu").device.type == "cpu"


@pytest.mark.slow
def test_verdicts_equal_pallas_verify_each_device(world):
    """The JAX Pallas per-set path (interpret mode) and the port give the
    same verdict plane on the same 128-lane job."""
    from lodestar_tpu.kernels import layout as JL
    from lodestar_tpu.kernels import verify as JKV

    n = 128
    sets, jtable = world["sets"], world["jtable"]
    v = VR.TorchBlsVerifier(world["table"], device="cpu")
    idx, kmask, planes, sig_inf, valid = v._prepare(sets)
    port = KV.verify_each_device(*world["table"].device_planes("cpu"), idx, kmask, planes, sig_inf, valid)
    g2 = GC.G2_GEN
    msgs = [s.message for s in sets] + [g2] * (n - len(sets))
    sigs = [g2 if s.signature is None else s.signature for s in sets] + [g2] * (n - len(sets))
    enc = lambda vals: jnp.asarray(JL.encode_plain_batch(vals))  # noqa: E731
    tx, ty = jtable.device_planes()
    out = JKV.verify_each_device(
        tx, ty, jnp.asarray(idx.numpy()), jnp.ones((n, 1), jnp.int32),
        enc([m[0][0] for m in msgs]), enc([m[0][1] for m in msgs]),
        enc([m[1][0] for m in msgs]), enc([m[1][1] for m in msgs]),
        enc([s[0][0] for s in sigs]), enc([s[0][1] for s in sigs]),
        enc([s[1][0] for s in sigs]), enc([s[1][1] for s in sigs]),
        jnp.asarray(sig_inf.numpy()), jnp.asarray(valid.numpy()),
    )
    assert np.asarray(out).tolist() == port.tolist()
