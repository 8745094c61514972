"""The port's deneb data availability against the JAX package's: KZG at
width 8 (`insecure_dev_setup(8)`), blob sidecars and their inclusion
proofs, the sidecar codec and store, and the chain's availability gate.

KZG runs on the host big-integer oracle in both packages.  Commitments,
proofs (at and off the domain, the infinity proof), verdicts, sidecars,
inclusion proofs and generalized indices, `_merkle_branch` and the codec's
bytes are held equal; the gate parks a deneb block until every sidecar
has arrived and then imports it (roots, heads, the sidecars the db
keeps), refuses a commitment mismatch, expires parked blocks and
sidecars with the clock and bounds the parking, on both packages.
"""

import hashlib

import pytest

from lodestar_tpu_torch.crypto import bls as B

from test_torch_beacon_state import J, P, keys
from test_torch_chain import HostSets, _signing_root
from lodestar_tpu_torch.ssz import device_backend as DB

WIDTH = 8
SPE = P.params.ACTIVE_PRESET.SLOTS_PER_EPOCH
INFINITY = bytes([0xC0]) + b"\x00" * 47


@pytest.fixture(scope="module")
def setups():
    return {M.pkg: M.kzg.insecure_dev_setup(WIDTH) for M in (J, P)}


def _blob(M, seed: bytes) -> bytes:
    evals = [int.from_bytes(hashlib.sha256(seed + bytes([i])).digest(), "big") % M.kzg.R for i in range(WIDTH)]
    return M.kzg.polynomial_to_blob(evals)


def _kzg_story(M, setup):
    K = M.kzg
    out = [K.compute_roots_of_unity(WIDTH), K.bit_reversal_permutation(list(range(8))),
           setup.roots_brp, repr(setup.g1_lagrange), repr(setup.g2_monomial)]
    blob = _blob(M, b"p1")
    c = K.blob_to_kzg_commitment(blob, setup)
    z = (12345).to_bytes(32, "big")
    proof, y = K.compute_kzg_proof(blob, z, setup)
    bad_y = ((int.from_bytes(y, "big") + 1) % K.R).to_bytes(32, "big")
    out += [c, proof, y, K.verify_kzg_proof(c, z, y, proof, setup), K.verify_kzg_proof(c, z, bad_y, proof, setup)]
    zk = int(setup.roots_brp[3]).to_bytes(32, "big")  # on the domain: the quotient's other branch
    pk, yk = K.compute_kzg_proof(blob, zk, setup)
    out += [pk, yk, K.verify_kzg_proof(c, zk, yk, pk, setup)]
    bp = K.compute_blob_kzg_proof(blob, c, setup)
    tampered = bytearray(blob)
    tampered[-1] ^= 1
    other = K.blob_to_kzg_commitment(_blob(M, b"p4"), setup)
    out += [bp, K.verify_blob_kzg_proof(blob, c, bp, setup), K.verify_blob_kzg_proof(bytes(tampered), c, bp, setup),
            K.verify_blob_kzg_proof(blob, other, bp, setup), K.verify_blob_kzg_proof(blob, c, b"\x01" * 48, setup)]
    blobs = [blob, _blob(M, b"p4")]
    cs = [c, other]
    ps = [bp, K.compute_blob_kzg_proof(blobs[1], other, setup)]
    out += [K.verify_blob_kzg_proof_batch(blobs, cs, ps, setup),
            K.verify_blob_kzg_proof_batch(blobs, cs, [ps[0], ps[0]], setup),
            K.verify_blob_kzg_proof_batch(blobs[:1], cs, ps, setup)]
    const = K.polynomial_to_blob([7] * WIDTH)
    out.append(K.compute_kzg_proof(const, (99).to_bytes(32, "big"), setup))
    with pytest.raises(K.KzgError, match="canonical") as e:
        K.blob_to_polynomial(K.polynomial_to_blob([K.R] + [0] * (WIDTH - 1)), WIDTH)
    out.append(str(e.value))
    return out


def test_kzg_equals_jax(setups):
    theirs, ours = _kzg_story(J, setups[J.pkg]), _kzg_story(P, setups[P.pkg])
    assert ours == theirs
    assert ours[-2][0] == INFINITY


def _block_with(M, commitments, slot=1):
    body = M.T.BeaconBlockBodyDeneb.default()
    body["blob_kzg_commitments"] = list(commitments)
    return {"slot": slot, "proposer_index": 0, "parent_root": b"\x01" * 32, "state_root": b"\x02" * 32,
            "body": body}


def _sidecar_story(M, setup):
    blobs = [_blob(M, b"bp-%d" % j) for j in range(3)]
    commitments = [M.kzg.blob_to_kzg_commitment(b, setup) for b in blobs]
    signed = {"message": _block_with(M, commitments), "signature": b"\x00" * 96}
    body_t = M.T.BeaconBlockBodyDeneb
    sidecars = M.blobs.make_blob_sidecars(signed, body_t, blobs, setup)
    codec = M.db.beacon_db.BlobSidecarListCodec()
    data = codec.serialize(sidecars)
    out = [data, [M.blobs.verify_blob_inclusion(sc, body_t) for sc in sidecars],
           [M.blobs.blob_inclusion_gindex(body_t, i) for i in range(3)],
           M.blobs.blob_inclusion_proof(body_t, signed["message"]["body"], 2)]
    bad = dict(sidecars[1], kzg_commitment_inclusion_proof=list(sidecars[0]["kzg_commitment_inclusion_proof"]))
    out.append(M.blobs.verify_blob_inclusion(bad, body_t))
    out.append(codec.serialize(codec.deserialize(data)) == data)
    chunks = [hashlib.sha256(bytes([i])).digest() for i in range(5)]
    out.append([M.ssz.core._merkle_branch(chunks, i, limit) for i in (0, 3, 4) for limit in (None, 16)])
    db = M.db.BeaconDb()
    header = dict(signed["message"])
    del header["body"]
    header["body_root"] = body_t.hash_tree_root(signed["message"]["body"])
    root = M.T.BeaconBlockHeader.hash_tree_root(header)
    db.put_blob_sidecars(root, sidecars)
    out.append(codec.serialize(db.get_blob_sidecars(root)))
    db.close()
    return out


def test_sidecars_and_store_equal_jax(setups):
    theirs, ours = _sidecar_story(J, setups[J.pkg]), _sidecar_story(P, setups[P.pkg])
    assert ours == theirs
    assert ours[1] == [True, True, True] and ours[4] is False and ours[5] is True


def _gate_story(M):
    """The gate on shells of blocks (the JAX package's test_data_availability)."""
    DB.set_backend(None)
    try:
        cfg = M.config.create_chain_config(M.config.MAINNET_CHAIN_CONFIG, fork_epochs={M.params.ForkName.altair: 0})
        chain = M.chain.BeaconChain(cfg, M.gen.create_genesis_state(cfg, keys(4)[1], genesis_time=2))
    finally:
        DB.reset_backend()
    out = []

    def gate(block, root):
        try:
            chain._check_data_availability(block, root)
            out.append("ok")
        except Exception as e:  # noqa: BLE001 - compared across packages
            out.append((type(e).__name__, str(e)))

    c0, c1 = b"\xaa" * 48, b"\xbb" * 48
    both = {"body": {"blob_kzg_commitments": [c0, c1]}}
    gate(both, b"\x11" * 32)
    chain.on_blob_sidecar(b"\x11" * 32, 0, c0, slot=5)
    gate(both, b"\x11" * 32)
    chain.on_blob_sidecar(b"\x11" * 32, 1, c1, slot=5)
    gate(both, b"\x11" * 32)
    chain.on_blob_sidecar(b"\x22" * 32, 0, b"\xcc" * 48, slot=5)
    gate({"body": {"blob_kzg_commitments": [c0]}}, b"\x22" * 32)
    gate({"body": {}}, b"\x33" * 32)
    gate({"body": {"blob_kzg_commitments": []}}, b"\x33" * 32)
    chain.on_blob_sidecar(b"\x44" * 32, 0, c0, slot=3)
    chain.prune_pools(3 + SPE + 1)
    gate({"body": {"blob_kzg_commitments": [c0]}}, b"\x44" * 32)
    chain._da_pending["aa" * 32] = {"message": {"slot": 3, "body": {}}}
    chain._da_pending["bb" * 32] = {"message": {"slot": 3 + 2 * SPE, "body": {}}}
    chain.prune_pools(3 + SPE + 1)
    out.append(sorted(chain._da_pending))
    chain._da_pending.clear()
    chain._da_pending_max = 2
    for i in range(3):
        block = {"slot": 9, "body": {"blob_kzg_commitments": [bytes([i]) * 48]}}
        with pytest.raises(M.chain.BlobsUnavailableError):
            chain._process_block_inner({"message": block}, block, bytes([i]) * 32, timely=False)
    out.append(len(chain._da_pending))
    return out


def test_availability_gate_equals_jax():
    theirs, ours = _gate_story(J), _gate_story(P)
    assert ours == theirs
    assert ours[0][0] == "BlobsUnavailableError" and ours[2] == "ok" and ours[3][0] == "ValueError"
    assert ours[-2] == ["bb" * 32] and ours[-1] == 2


def _parked_import(M, sks, pks, setup, tmp_path):
    """A deneb merge block carrying two commitments parks until both
    sidecars arrive, then imports from on_blob_sidecar."""
    sk_of = dict(zip(pks, sks))
    epochs = {getattr(M.params.ForkName, f): (0 if f == "altair" else 1)
              for f in ("altair", "bellatrix", "capella", "deneb")}
    cfg = M.config.create_chain_config(M.config.MAINNET_CHAIN_CONFIG, fork_epochs=epochs)
    DB.set_backend(None)
    try:
        el = M.execution.ExecutionEngineMock()
        db = M.db.BeaconDb(str(tmp_path / M.pkg), config=cfg)
        chain = M.chain.BeaconChain(cfg, M.gen.create_genesis_state(cfg, pks, genesis_time=2), db=db,
                                    bls_verifier=HostSets(pks), execution=el, kzg_setup=setup)
        events = []
        chain.emitter.on(M.emitter.ChainEvent.head, lambda r, s: events.append((bytes(r), int(s))))
        slot = SPE + 1
        st = chain.head_state.clone()
        M.slot.process_slots(st, slot)
        proposer = M.acc.get_beacon_proposer_index(st)
        sk = sk_of[st.pubkeys[proposer]]
        reveal = B.sign_bytes(sk, _signing_root(M, st, M.params.DOMAIN_RANDAO,
                                                M.ssz.uint64.hash_tree_root(slot // SPE), slot))
        blobs = [_blob(M, b"park-%d" % j) for j in range(2)]
        commitments = [M.kzg.blob_to_kzg_commitment(b, setup) for b in blobs]
        block, _post = M.pb.produce_block(chain.head_state, slot, reveal, execution=el,
                                          blob_kzg_commitments=commitments)
        root_sig = _signing_root(M, st, M.params.DOMAIN_BEACON_PROPOSER,
                                 chain._block_type(slot).hash_tree_root(block), slot)
        signed = {"message": block, "signature": B.sign_bytes(sk, root_sig)}
        body_t = cfg.get_fork_types(slot)[2]
        sidecars = M.blobs.make_blob_sidecars(signed, body_t, blobs, setup)
        root = M.T.BeaconBlockHeader.hash_tree_root(sidecars[0]["signed_block_header"]["message"])
        out = []
        try:
            chain.process_block(signed)
        except M.chain.BlobsUnavailableError as e:
            out.append(str(e))
        out += [sorted(chain._da_pending), chain.head_root_hex == root.hex()]
        for sc in sidecars:
            assert M.kzg.verify_blob_kzg_proof(sc["blob"], sc["kzg_commitment"], sc["kzg_proof"], setup)
            assert M.blobs.verify_blob_inclusion(sc, body_t)
            chain.on_blob_sidecar(root, sc["index"], sc["kzg_commitment"], slot=slot, sidecar=sc)
            out += [sorted(chain._da_pending), chain.head_root_hex]
        codec = M.db.beacon_db.BlobSidecarListCodec()
        out += [codec.serialize(chain.get_blob_sidecars(root)), codec.serialize(db.get_blob_sidecars(root)),
                chain.head_state.serialize(), events, chain._block_type(slot).serialize(block)]
        db.close()
        return out
    finally:
        DB.reset_backend()


def test_parked_deneb_block_imports_when_its_sidecars_arrive(setups, tmp_path):
    sks, pks = keys(8)
    theirs = _parked_import(J, sks, pks, setups[J.pkg], tmp_path)
    ours = _parked_import(P, sks, pks, setups[P.pkg], tmp_path)
    assert ours == theirs
    assert ours[0].startswith("blob 0/2 not available") and ours[2] is False
    assert ours[3] != [] and ours[5] == [] and ours[6] != ours[4]  # imported with the second sidecar
