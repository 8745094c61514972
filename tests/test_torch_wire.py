"""The port's wire-set slice as a whole: `TorchBlsVerifier` over
`WireSignatureSet` jobs, single and aggregate, per set and as RLC batches
with bisection, against the crypto oracle `lodestar_tpu/crypto/bls.py`.

The port runs with device="cpu", so every kernel wrapper takes its plain
torch version.  The pubkey table is carried across from a JAX
`PubkeyTable` with `from_jax_planes`.  One plain hash (a 4-lane
`MessageCache` batch) serves the whole module: every verifier here shares
that cache.  Job buckets are narrowed to 8 and 16 lanes (the plain
engine's cost is per call, not per lane).  The bisection plan of a wire
job (sorted by signing root, halved, unsorted) is held against the JAX
`TpuBlsVerifier` on the same sets with the device replaced by an oracle,
as tests/test_torch_rlc.py does for decoded sets.
"""

import numpy as np
import pytest
import torch

from lodestar_tpu.bls import PubkeyTable as JPubkeyTable
from lodestar_tpu.bls import TpuBlsVerifier
from lodestar_tpu.bls import signature_set as JSS
from lodestar_tpu.crypto import bls as GB
from lodestar_tpu.crypto import curves as GC
from lodestar_tpu.crypto import hash_to_curve as GH
from lodestar_tpu_torch.bls import ingest as IN
from lodestar_tpu_torch.bls import verifier as VR
from lodestar_tpu_torch.bls.pubkey_table import PubkeyTable
from lodestar_tpu_torch.bls.signature_set import WireSignatureSet
from lodestar_tpu_torch.kernels import verify as KV

N_KEYS = 4
ROOTS = [b"wire-root-a", b"wire-root-b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: parallel test workers must not oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def small_buckets(monkeypatch):
    monkeypatch.setattr(VR, "N_BUCKETS", (8, 16, 512))


@pytest.fixture(scope="module")
def world():
    sks = [GB.keygen(b"torch-wire-%d" % i) for i in range(N_KEYS)]
    pks = [GB.sk_to_pk(sk) for sk in sks]
    jtable = JPubkeyTable(capacity=8)
    jtable.register(pks)
    table = PubkeyTable.from_jax_planes(jtable._host_x, jtable._host_y, len(jtable))
    hs = [GH.hash_to_g2(r) for r in ROOTS]
    sig = {(k, r): GC.scalar_mul(GC.FP2_OPS, hs[r], sks[k]) for k in range(N_KEYS) for r in range(2)}
    u = GH.hash_to_field_fp2(b"outside", 1, b"torch-wire")[0]
    outside = GH.map_to_curve_svdw(GC.FP2_OPS, u)
    assert GC.is_on_curve(GC.FP2_OPS, outside) and not GC.g2_subgroup_check(outside)
    with pytest.MonkeyPatch.context() as mp:  # one 4-lane plain hash of both roots
        mp.setattr(IN, "BT", 4)
        cache = IN.MessageCache(device="cpu")
        assert cache.get_many(ROOTS) == hs
    return dict(sks=sks, pks=pks, jtable=jtable, table=table, hs=hs, sig=sig, outside=outside, cache=cache)


def verifier(world, **kw):
    v = VR.TorchBlsVerifier(world["table"], device="cpu", rng=np.random.default_rng(5), **kw)
    v.messages = world["cache"]
    return v


def agg_sig(world, keys, r):
    """The aggregate signature of `keys` (with multiplicity) over root r."""
    return GC.multi_add(GC.FP2_OPS, [world["sig"][k, r] for k in keys])


def oracle(world, s) -> bool:
    """lodestar_tpu/crypto/bls.py on the set's bytes: decompression, then
    verify or fast_aggregate_verify (registry keys validate once each)."""
    try:
        sig = GC.g2_decompress(s.signature)
    except ValueError:
        return False
    if s.pubkeys is not None:
        try:
            keys = [GC.g1_decompress(p) for p in s.pubkeys]
        except ValueError:
            return False
        return GB.fast_aggregate_verify(keys, s.signing_root, sig)
    distinct = [world["pks"][i] for i in set(s.indices)]
    if not all(GC.is_on_curve(GC.FP_OPS, pk) and GC.g1_subgroup_check(pk) for pk in distinct):
        return False
    return GB.verify(GB.aggregate_pubkeys([world["pks"][i] for i in s.indices]), s.signing_root, sig)


def single(world, k, r, sig):
    return WireSignatureSet.single(k, ROOTS[r], sig if isinstance(sig, bytes) else GC.g2_compress(sig))


def mixed_job(world):
    """Every wire case of one job (K bucket 4), with the kinds."""
    sig, c = world["sig"], GC.g2_compress
    good = c(sig[2, 1])
    x_big = bytes([0x80 | 0x1F]) + b"\xff" * 47 + good[48:]  # x1 >= p
    k = 1
    while True:  # a well-formed x with no y on E2
        off = bytes([0x80]) + k.to_bytes(47, "big") + (k + 3).to_bytes(48, "big")
        if IN.parse_signature_bytes(off)[4]:
            try:
                GC.g2_decompress(off)
            except ValueError:
                break
        k += 1
    cases = [
        (single(world, 0, 0, sig[0, 0]), "valid"),
        (single(world, 1, 1, sig[1, 0]), "wrong message"),
        (single(world, 2, 0, sig[3, 0]), "swapped signature"),
        (single(world, 3, 0, c(None)), "infinity encoding"),
        (single(world, 0, 1, world["outside"]), "outside G2"),
        (single(world, 1, 0, c(sig[1, 0])[:95]), "95 bytes"),
        (single(world, 1, 0, bytes([c(sig[1, 0])[0] & 0x7F]) + c(sig[1, 0])[1:]), "no compression bit"),
        (single(world, 2, 1, x_big), "x >= p"),
        (single(world, 2, 1, off), "x off the curve"),
        (single(world, 2, 1, good), "valid"),
        (WireSignatureSet.aggregate([0, 1, 3], ROOTS[1], c(agg_sig(world, [0, 1, 3], 1))), "valid"),
        (WireSignatureSet.aggregate([0, 1, 3], ROOTS[1], c(agg_sig(world, [0, 1], 1))), "missing signer"),
        (WireSignatureSet.aggregate([2, 2], ROOTS[0], c(agg_sig(world, [2, 2], 0))), "valid"),
    ]
    return [s for s, _ in cases], [kind for _, kind in cases]


def record(monkeypatch, *names):
    """Wrap functions of kernels/verify.py; returns the list of calls."""
    calls = []
    for name in names:
        real = getattr(KV, name)

        def wrapped(*args, _real=real, _name=name):
            calls.append(_name)
            return _real(*args)

        monkeypatch.setattr(KV, name, wrapped)
    return calls


def test_mixed_wire_job_per_set_equals_oracle(world, monkeypatch):
    """Singles and K = 2, 3 aggregates with every wire fault, plus a set
    beyond MAX_AGG_INDICES and an external-key set (both verified on the
    host, as the JAX package routes them): per-set verdicts in submission
    order equal the oracle; the device ran the wire per-set path."""
    sets, kinds = mixed_job(world)
    big_keys = [i % N_KEYS for i in range(VR.MAX_AGG_INDICES + 1)]
    big = WireSignatureSet.aggregate(big_keys, ROOTS[0], GC.g2_compress(agg_sig(world, big_keys, 0)))
    ext_sk = GB.keygen(b"torch-wire-external")
    ext_sig = GC.scalar_mul(GC.FP2_OPS, world["hs"][1], ext_sk)
    ext = WireSignatureSet.external([GC.g1_compress(GB.sk_to_pk(ext_sk))], ROOTS[1], GC.g2_compress(ext_sig))
    ext_bad = WireSignatureSet.external([GC.g1_compress(world["pks"][0])], ROOTS[1], GC.g2_compress(ext_sig))
    sets = sets[:5] + [big, ext] + sets[5:] + [ext_bad]
    kinds = kinds[:5] + ["valid (host)", "valid (host)"] + kinds[5:] + ["wrong key (host)"]
    want = [oracle(world, s) for s in sets]
    assert want == [k.startswith("valid") for k in kinds]
    v = verifier(world)
    calls = record(monkeypatch, "verify_each_device_wire", "verify_batch_device_wire", "g2_decompress", "agg_pk")
    job = v.begin_job(sets, batchable=False)
    assert v.finish_job(job) is False
    assert job.verdicts.tolist() == want
    assert job.host_sets == 3 and job.wire
    assert calls == ["verify_each_device_wire", "g2_decompress", "agg_pk"]
    # malformed encodings are host-bad; an x off the curve is not
    bad = {kinds[job.order[j]] for j, ok in enumerate(job.decodable) if not ok}
    assert bad == {"95 bytes", "no compression bit", "x >= p"}
    assert v.verify_signature_sets_individually(sets[:2]) == want[:2]


def test_aggregate_batch_k16_and_k_buckets(world, monkeypatch):
    """A batchable wire job of aggregates in the K bucket 16 (and a
    single) is ONE RLC batch that accepts, through the grouped entry (two
    of its three sets share a root); the verifier's K buckets and kmask
    follow the JAX package's."""
    keys = [[0, 1, 2, 3, 0, 1, 2, 3, 0, 1], [3, 3, 1], [2]]
    sets = [WireSignatureSet.aggregate(ks, ROOTS[j % 2], GC.g2_compress(agg_sig(world, ks, j % 2)))
            for j, ks in enumerate(keys)]
    assert all(oracle(world, s) for s in sets)
    v = verifier(world)
    calls = record(monkeypatch, "verify_each_device_wire", "verify_batch_device_wire",
                   "verify_batch_device_wire_grouped", "agg_pk", "seg_sum_g1", "final_one")
    assert v.verify_signature_sets(sets, VR.VerifyOptions(batchable=True)) is True
    assert calls == ["verify_batch_device_wire_grouped", "agg_pk", "seg_sum_g1", "final_one"]
    idx, kmask = v._kslots(sets, 8)
    assert idx.shape == (8, 16) and kmask.sum(1).tolist() == [10, 3, 1, 0, 0, 0, 0, 0]
    assert VR.K_BUCKETS == (1, 4, 16, 64, 512, 2048) and VR.MAX_AGG_INDICES == 2048


def test_off_curve_x_in_a_batch_bisects(world):
    """An x off the curve is decodable on the host, so the batchable job
    is dispatched as one batch; the batch fails and bisects (leaf 1), and
    the verdicts, in submission order, equal the oracle."""
    sets, kinds = mixed_job(world)
    job_sets = [sets[9], sets[8], sets[0]]  # roots b, b, a: sorted, the job is a, b, b
    want = [oracle(world, s) for s in job_sets]
    assert want == [True, False, True]
    v = verifier(world, bisect_leaf=1)
    job = v.begin_job(job_sets, batchable=True)
    assert job.decodable.all() and job.batch_ok is not None
    assert v.finish_job(job) is False
    assert job.verdicts.tolist() == want
    assert (job.batch_retries, job.bisect_depth, job.batch_sigs_success) == (1, 2, 2)


# ---------------------------------------------------------------------------
# the wire bisection plan, against the JAX verifier's on the same sets
# ---------------------------------------------------------------------------


def _fake_wire(cls, n, bad, rng):
    """n wire sets over 5 roots in shuffled order; the signature bytes
    name the set and whether the oracle passes it."""
    roots = rng.integers(0, 5, size=n)
    return [cls.single(i, b"root-%d" % roots[i], b"%s-%d" % (b"bad" if i in bad else b"ok", i)) for i in range(n)]


class _Oracle:
    """Records each dispatched batch (the set identities in lane order)
    and each per-set leaf; a batch passes iff all its sets are ok."""

    def _record_batch(self, sets, grouped):
        self.batch_calls.append([s.signature for s in sets])
        self.grouped.append(grouped)
        return all(s.signature.startswith(b"ok") for s in sets)

    def _record_leaf(self, sets):
        self.leaf_calls.append([s.signature for s in sets])
        return np.array([s.signature.startswith(b"ok") for s in sets])

    def _batch_verdict(self, handle):
        return handle


class PortWireOracle(_Oracle, VR.TorchBlsVerifier):
    def __init__(self, leaf):
        super().__init__(PubkeyTable(capacity=2), device="cpu", bisect_leaf=leaf)
        self.batch_calls, self.leaf_calls, self.grouped = [], [], []

    def _prepare_wire(self, sets):
        return list(sets), np.zeros(len(sets), bool)

    def _dispatch_rlc_batch(self, args, sets):
        return self._record_batch(sets, self._grouping(sets, VR._bucket(len(sets))) is not None)

    def _per_set_verdicts(self, sets):
        return self._record_leaf(sets)


class JaxWireOracle(_Oracle, TpuBlsVerifier):
    def __init__(self, leaf):
        super().__init__(JPubkeyTable(capacity=2), rng=np.random.default_rng(0), bisect_leaf=leaf)
        self.batch_calls, self.leaf_calls, self.grouped = [], [], []

    def _prepare_wire(self, sets):
        return None, None, len(sets), np.zeros(len(sets), bool)

    def _dispatch_rlc_batch(self, sets, args, valid, n, wire):
        return self._record_batch(sets, self._grouping(sets, n) is not None)

    def _per_set_verdicts(self, sets, wire):
        return self._record_leaf(sets)


@pytest.mark.parametrize("n,leaf,bad", [(37, 4, (3, 20)), (64, 8, (0,)), (9, 2, (1, 2, 8))])
def test_wire_bisection_plan_equals_jax(n, leaf, bad):
    """begin_job / finish_job on a batchable wire job: the same sorted
    batches and leaves in the same order, each batch grouped by message
    exactly when the JAX verifier groups it, the same verdicts in
    submission order and the same counters as the JAX verifier."""
    port, jx = PortWireOracle(leaf), JaxWireOracle(leaf)
    pjob = port.begin_job(_fake_wire(WireSignatureSet, n, bad, np.random.default_rng(n)), batchable=True)
    jjob = jx.begin_job(_fake_wire(JSS.WireSignatureSet, n, bad, np.random.default_rng(n)), batchable=True)
    assert port.finish_job(pjob) is False and jx.finish_job(jjob) is False
    jx.close()
    assert pjob.verdicts.tolist() == jjob.verdicts.tolist() == [i not in bad for i in range(n)]
    assert port.batch_calls == jx.batch_calls and port.leaf_calls == jx.leaf_calls
    assert port.grouped == jx.grouped and True in port.grouped
    assert (pjob.batch_retries, pjob.batch_sigs_success) == (jjob.batch_retries, jjob.batch_sigs_success)
    roots = [s.signing_root for s in pjob.sets]
    assert roots == sorted(roots) and len(port.batch_calls[0]) == n
