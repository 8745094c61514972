"""`TorchBlsVerifier` on the JAX package's set objects.

The node and the BLS service hand the verifier
`lodestar_tpu.bls.signature_set` objects, which the port does not import:
the verifier tells wire sets from decoded ones by their fields.  Here
JAX-package `WireSignatureSet`s (single, aggregate, with external
`pubkeys`) and decoded `SignatureSet`s, alone and mixed with the port's
own sets, go through every public entry of a CPU verifier (plain torch
versions): `verify_signature_sets` as a batch and per set,
`begin_job` / `finish_job` and `verify_signature_sets_individually`.
Every verdict must equal the oracle, `lodestar_tpu/crypto/bls.py`.  Few
sets: each plain path costs seconds per call on a CPU.
"""

import numpy as np
import pytest
import torch

from lodestar_tpu.bls import signature_set as JSS
from lodestar_tpu.crypto import bls as GB
from lodestar_tpu.crypto import curves as GC
from lodestar_tpu.crypto import hash_to_curve as GH
from lodestar_tpu_torch.bls import ingest as IN
from lodestar_tpu_torch.bls import signature_set as PSS
from lodestar_tpu_torch.bls import verifier as VR
from lodestar_tpu_torch.bls.pubkey_table import PubkeyTable

N_KEYS = 3
ROOTS = [b"jax-sets-root-a", b"jax-sets-root-b"]


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
    sks = [GB.keygen(b"torch-jax-sets-%d" % i) for i in range(N_KEYS)]
    pks = [GB.sk_to_pk(sk) for sk in sks]
    table = PubkeyTable(capacity=8)
    table.register(pks)
    hs = [GH.hash_to_g2(r) for r in ROOTS]
    sig = {(k, r): GC.scalar_mul(GC.FP2_OPS, hs[r], sks[k]) for k in range(N_KEYS) for r in range(2)}
    ext_sk = GB.keygen(b"torch-jax-sets-external")
    with pytest.MonkeyPatch.context() as mp:  # one 4-lane plain hash of both roots
        mp.setattr(IN, "BT", 4)
        cache = IN.MessageCache(device="cpu")
        assert cache.get_many(ROOTS) == hs
    return dict(sks=sks, pks=pks, table=table, hs=hs, sig=sig, cache=cache, ext_sk=ext_sk)


def verifier(world):
    v = VR.TorchBlsVerifier(world["table"], device="cpu", rng=np.random.default_rng(11))
    v.messages = world["cache"]
    return v


def agg(world, keys, r):
    return GC.multi_add(GC.FP2_OPS, [world["sig"][k, r] for k in keys])


def jax_wire_sets(world):
    """JAX-package wire sets: a valid single, a valid aggregate, a single
    signed over the other root, and a valid set of an external key."""
    c, sig = GC.g2_compress, world["sig"]
    ext_pk = GB.sk_to_pk(world["ext_sk"])
    ext_sig = GC.scalar_mul(GC.FP2_OPS, world["hs"][0], world["ext_sk"])
    return [
        JSS.WireSignatureSet.single(0, ROOTS[0], c(sig[0, 0])),
        JSS.WireSignatureSet.aggregate([1, 2], ROOTS[1], c(agg(world, [1, 2], 1))),
        JSS.WireSignatureSet.single(2, ROOTS[0], c(sig[2, 1])),
        JSS.WireSignatureSet.external([GC.g1_compress(ext_pk)], ROOTS[0], c(ext_sig)),
    ]


def oracle(world, s) -> bool:
    """lodestar_tpu/crypto/bls.py on the set: wire bytes are decompressed
    first; decoded sets carry the message point, so the pairing check is
    made on it directly."""
    if hasattr(s, "signing_root"):
        try:
            sig = GC.g2_decompress(s.signature)
        except ValueError:
            return False
        if s.pubkeys is not None:
            keys = [GC.g1_decompress(p) for p in s.pubkeys]
            return GB.fast_aggregate_verify(keys, s.signing_root, sig)
        return GB.verify(GB.aggregate_pubkeys([world["pks"][i] for i in s.indices]), s.signing_root, sig)
    if s.signature is None:
        return False
    root = ROOTS[world["hs"].index(s.message)]
    return GB.verify(GB.aggregate_pubkeys([world["pks"][i] for i in s.indices]), root, s.signature)


def test_jax_wire_sets_through_verify_signature_sets(world):
    """Batch (the failed RLC batch resolves per set) and per set: the
    verdict equals the oracle's; begin_job / finish_job give the oracle's
    per-set verdicts, the external-key set on the host."""
    sets = jax_wire_sets(world)
    want = [oracle(world, s) for s in sets]
    assert want == [True, True, False, True]
    v = verifier(world)
    assert v.verify_signature_sets(sets, VR.VerifyOptions(batchable=True)) is False
    assert v.verify_signature_sets(sets[:2] + sets[3:], VR.VerifyOptions(batchable=True)) is True
    assert v.verify_signature_sets(sets, VR.VerifyOptions(batchable=False)) is False
    job = v.begin_job(sets, batchable=False)
    assert job.wire and job.host_sets == 1
    assert v.finish_job(job) is False
    assert job.verdicts.tolist() == want


def test_jax_decoded_sets_and_a_mixed_job(world):
    """JAX-package decoded `SignatureSet`s, and `decode()` of a JAX wire
    set, through begin_job / finish_job and the main-thread path; then
    `verify_signature_sets_individually` on JAX wire, JAX decoded, port
    wire and port decoded sets in one list, in submission order."""
    sig, hs = world["sig"], world["hs"]
    decoded = [
        JSS.SignatureSet.single(1, hs[0], sig[1, 0]),
        JSS.SignatureSet.aggregate([0, 2], hs[1], agg(world, [0, 2], 0)),
        jax_wire_sets(world)[1].decode(),
        JSS.SignatureSet.single(0, hs[1], None),
    ]
    want = [oracle(world, s) for s in decoded]
    assert want == [True, False, True, False]
    v = verifier(world)
    job = v.begin_job(decoded, batchable=False)
    assert not job.wire and job.host_sets == 0
    assert v.finish_job(job) is False
    assert job.verdicts.tolist() == want
    assert v.verify_signature_sets(decoded[:1] + decoded[2:3], VR.VerifyOptions(verify_on_main_thread=True))
    c = GC.g2_compress
    mixed = [
        jax_wire_sets(world)[2],
        decoded[0],
        PSS.WireSignatureSet.single(1, ROOTS[1], c(sig[1, 1])),
        PSS.SignatureSet.single(2, hs[1], sig[2, 1]),
        jax_wire_sets(world)[0],
        decoded[1],
        jax_wire_sets(world)[3],
    ]
    want = [oracle(world, s) for s in mixed]
    assert want == [False, True, True, True, True, False, True]
    assert v.verify_signature_sets_individually(mixed) == want
    with pytest.raises(ValueError, match="only wire or only decoded"):
        v.begin_job(mixed[:2], batchable=False)
