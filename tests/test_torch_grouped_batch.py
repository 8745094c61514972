"""Message grouping and pre-verify signature aggregation through the
port's verifier.

- A grouped wire batch (`verify_batch_device_wire_grouped`) gives the
  ungrouped batch's verdicts on the same operands and randomizers, and
  the verifier's verdicts equal the oracle's, one tampered set included;
  the verifier takes the grouped entry exactly for jobs with a repeated
  root (the choice is held against the JAX verifier's, bisection
  included, in tests/test_torch_wire.py).
- `aggregate_wire_signatures` equals the JAX package's host aggregation
  (`_aggregate_wire_host`) byte for byte, the None group included, on
  the device path and on the host path (`LODESTAR_TPU_AGG_DEVICE=0`).

The port runs with device="cpu", so every wrapper takes its plain torch
version.  One plain hash (a 4-lane `MessageCache` batch) serves the
module, and job buckets are narrowed to 8 and 16 lanes.  The scans
themselves are tested in tests/test_torch_grouping.py.
"""

import numpy as np
import pytest
import torch

from lodestar_tpu.bls import PubkeyTable as JPubkeyTable
from lodestar_tpu.bls import TpuBlsVerifier
from lodestar_tpu.crypto import bls as GB
from lodestar_tpu.crypto import curves as GC
from lodestar_tpu.crypto import hash_to_curve as GH
from lodestar_tpu_torch.bls import ingest as IN
from lodestar_tpu_torch.bls import verifier as VR
from lodestar_tpu_torch.bls.pubkey_table import PubkeyTable
from lodestar_tpu_torch.bls.rand import make_rand_words
from lodestar_tpu_torch.bls.signature_set import WireSignatureSet
from lodestar_tpu_torch.kernels import verify as KV

N_KEYS = 4
ROOTS = [b"grouping-root-a", b"grouping-root-b"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: parallel test workers must not oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    sks = [GB.keygen(b"torch-grouping-%d" % i) for i in range(N_KEYS)]
    pks = [GB.sk_to_pk(sk) for sk in sks]
    jtable = JPubkeyTable(capacity=8)
    jtable.register(pks)
    table = PubkeyTable.from_jax_planes(jtable._host_x, jtable._host_y, len(jtable))
    hs = [GH.hash_to_g2(r) for r in ROOTS]
    sig = {(k, r): GC.scalar_mul(GC.FP2_OPS, hs[r], sks[k]) for k in range(N_KEYS) for r in range(2)}
    with pytest.MonkeyPatch.context() as mp:  # one 4-lane plain hash of both roots
        mp.setattr(IN, "BT", 4)
        cache = IN.MessageCache(device="cpu")
        assert cache.get_many(ROOTS) == hs
    return dict(sks=sks, pks=pks, table=table, hs=hs, sig=sig, cache=cache)


def verifier(world, **kw):
    v = VR.TorchBlsVerifier(world["table"], device="cpu", rng=np.random.default_rng(9), **kw)
    v.messages = world["cache"]
    return v


def wire_job(world, tamper=None):
    """Six sets over two roots: keys 0..3 sign root a, keys 0 and 2 root b;
    `tamper` gives that set the other root's signature."""
    pairs = [(0, 0), (1, 0), (2, 0), (3, 0), (0, 1), (2, 1)]
    out = []
    for i, (k, r) in enumerate(pairs):
        s = world["sig"][k, 1 - r if i == tamper else r]
        out.append(WireSignatureSet.single(k, ROOTS[r], GC.g2_compress(s)))
    return out


def test_grouped_wire_batch_equals_ungrouped_and_oracle(world, monkeypatch):
    """On a job with one tampered set, the grouped entry and the ungrouped
    one give the same batch and subgroup verdicts on the same operands and
    randomizers, the oracle's: the batch fails.  The verifier takes the
    grouped entry for the valid job (two roots over six sets) and accepts
    it, as the oracle does."""
    monkeypatch.setattr(VR, "N_BUCKETS", (8, 16, 512))
    v = verifier(world)
    tx, ty = world["table"].device_planes("cpu")
    rwords = torch.from_numpy(make_rand_words(8, np.random.default_rng(3)))
    sets = wire_job(world, tamper=4)
    oracle = [GB.verify(world["pks"][s.indices[0]], s.signing_root, GC.g2_decompress(s.signature)) for s in sets]
    assert oracle == [True] * 4 + [False, True]
    sets = sorted(sets, key=lambda s: s.signing_root)
    args, _ = v._prepare_wire(sets)
    grouping = v._grouping(sets, 8)
    assert grouping[0].tolist() == [0, 0, 0, 0, 1, 1, 2, 3] and grouping[1][:3].tolist() == [3, 5, 0]
    ok_g, sub_g = KV.verify_batch_device_wire_grouped(
        tx, ty, *args[:-1], *(torch.from_numpy(a) for a in grouping), rwords, args.valid
    )
    ok_u, sub_u = KV.verify_batch_device_wire(tx, ty, *args[:-1], rwords, args.valid)
    assert bool(ok_g) is bool(ok_u) is False and torch.equal(sub_g, sub_u) and bool(sub_g.all())
    calls = []
    monkeypatch.setattr(KV, "verify_batch_device_wire_grouped",
                        lambda *a, _r=KV.verify_batch_device_wire_grouped: calls.append(1) or _r(*a))
    assert v.verify_signature_sets(wire_job(world), VR.VerifyOptions(batchable=True)) is True
    assert calls == [1]


def test_verifier_entries_follow_grouping(world, monkeypatch):
    """Distinct roots only: the ungrouped entry (the grouped wrapper is
    never called); a repeated root: the grouped one."""
    monkeypatch.setattr(VR, "N_BUCKETS", (8, 16, 512))
    calls = []
    for name in ("verify_batch_device_wire", "verify_batch_device_wire_grouped"):
        real = getattr(KV, name)
        monkeypatch.setattr(KV, name, lambda *a, _r=real, _n=name: calls.append(_n) or _r(*a))
    v = verifier(world)
    sig = world["sig"]
    distinct = [WireSignatureSet.single(0, ROOTS[r], GC.g2_compress(sig[0, r])) for r in range(2)]
    assert v.verify_signature_sets(distinct, VR.VerifyOptions(batchable=True)) is True
    assert calls == ["verify_batch_device_wire"]
    assert v.verify_signature_sets(wire_job(world), VR.VerifyOptions(batchable=True)) is True
    assert calls == ["verify_batch_device_wire", "verify_batch_device_wire_grouped"]


def _sig_groups(world):
    sig, c = world["sig"], GC.g2_compress
    s = [c(sig[k, 0]) for k in range(N_KEYS)]
    neg = c(GC.affine_neg(GC.FP2_OPS, sig[1, 0]))
    return [
        [],  # empty: the infinity encoding, first in its chunk
        s[:3],  # three signers of root a
        [c(sig[2, 1])],  # one
        [],  # empty after a group: not that group's sum
        [s[1], neg],  # P + (-P): the infinity encoding
        [s[0], s[3][:95]],  # a 95-byte member: None
        s + [c(sig[0, 1])],  # five, across roots
    ]


def test_aggregate_wire_signatures_equal_jax_host(world, monkeypatch):
    """The device path (plain versions on the CPU) and the host path both
    equal JAX's `_aggregate_wire_host` byte for byte, empty groups (the
    infinity encoding) included; chunks of the device path hold at most
    128 groups."""
    groups = _sig_groups(world)
    want = [TpuBlsVerifier._aggregate_wire_host(g) for g in groups]
    assert want[5] is None and want[0] == want[3] == want[4] == GC.g2_compress(None)
    monkeypatch.setattr(VR, "N_BUCKETS", (8, 16, 512))
    v = verifier(world)
    monkeypatch.setenv("LODESTAR_TPU_AGG_DEVICE", "1")
    calls = []
    real = KV.aggregate_g2_sum_device
    monkeypatch.setattr(KV, "aggregate_g2_sum_device", lambda *a: calls.append(a[2].shape[0]) or real(*a))
    assert v.aggregate_wire_signatures(groups) == want
    assert calls == [16]  # one dispatch: 13 signatures in the 16-lane bucket
    assert v.aggregate_wire_signatures([]) == []
    monkeypatch.setenv("LODESTAR_TPU_AGG_DEVICE", "0")
    assert v.aggregate_wire_signatures(groups) == want
    assert calls == [16]
    # the chunking of the device path: 130 groups are two dispatches
    monkeypatch.setenv("LODESTAR_TPU_AGG_DEVICE", "1")
    chunks = []
    monkeypatch.setattr(v, "_aggregate_chunk_device", lambda chunk, total: chunks.append((len(chunk), total))
                        or [None] * len(chunk))
    assert v.aggregate_wire_signatures([[b"x"]] * 130) == [None] * 130
    assert chunks == [(128, 128), (2, 2)]
