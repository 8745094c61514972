"""The port's builder flow against the JAX package's on the same chain.

Each package's `BeaconChain` grows the same post-merge head (altair at
genesis, bellatrix at epoch 1: an altair block, then the merge block, its
payload from the package's `ExecutionEngineMock`) on the same keys, then
runs tests/test_builder_flow.py's scenarios through its own builder:
blinded production through `ExecutionBuilderMock`, the proposer's
signature over the blinded block, unblinding by `submit_blinded_block`
and import; blinded and full roots; substituted payloads; a disabled or
absent builder; relay faults tripping the breaker through the chain
(`ExecutionBuilderHttp` against a closed loopback port); the breaker's
window; the blobs bundle registering availability; an unknown header.
Blocks, bids, registrations and reveals cross between the packages as
builder-specs JSON (`builder_codec`, `api/encoding`), held equal.  The
port runs on its host merkle path.
"""

import hashlib
import importlib

import pytest

from lodestar_tpu_torch.crypto import bls as B
from lodestar_tpu_torch.ssz import device_backend as DB

from test_torch_beacon_state import J, P, keys

PRESET = P.params.ACTIVE_PRESET
SPE = PRESET.SLOTS_PER_EPOCH
N = 8


def mod(M, name):
    return importlib.import_module(f"{M.pkg}.{name}")


def cfg_of(M, **forks):
    F = M.params.ForkName
    return M.config.create_chain_config(
        M.config.MAINNET_CHAIN_CONFIG, fork_epochs={getattr(F, k): v for k, v in forks.items()})


def randao(M, cfg, sk, slot):
    epoch = slot // SPE
    return B.sign_bytes(sk, cfg.compute_signing_root(M.ssz.uint64.hash_tree_root(epoch),
                                                     cfg.get_domain(slot, M.params.DOMAIN_RANDAO, slot)))


def sign_block(M, cfg, block, sk, blinded=False):
    slot = int(block["slot"])
    btype = (cfg.get_blinded_fork_types if blinded else cfg.get_fork_types)(slot)[0]
    root = cfg.compute_signing_root(btype.hash_tree_root(block),
                                    cfg.get_domain(slot, M.params.DOMAIN_BEACON_PROPOSER, slot))
    return {"message": block, "signature": B.sign_bytes(sk, root)}


def registration(M, cfg, sk, pk, fee_recipient, timestamp=0):
    msg = {"fee_recipient": fee_recipient, "gas_limit": 30_000_000, "timestamp": timestamp, "pubkey": pk}
    domain = cfg.compute_domain(M.params.DOMAIN_APPLICATION_BUILDER, cfg.fork_versions[M.params.ForkName.phase0],
                                b"\x00" * 32)
    root = cfg.compute_signing_root(M.T.ValidatorRegistrationV1.hash_tree_root(msg), domain)
    return {"message": msg, "signature": B.sign_bytes(sk, root)}


def proposer_at(M, chain, slot):
    st = chain.head_state.clone()
    M.slot.process_slots(st, slot)
    return int(M.acc.get_beacon_proposer_index(st))


class World:
    """One package's chain at a post-merge head."""

    def __init__(self, M, sks, pks, **forks):
        self.M, self.sks, self.pks = M, sks, pks
        self.cfg = cfg_of(M, **(forks or {"altair": 0, "bellatrix": 1}))
        self.el = M.execution.ExecutionEngineMock()
        genesis = M.gen.create_genesis_state(self.cfg, pks, genesis_time=2)
        self.chain = M.chain.BeaconChain(self.cfg, genesis, execution=self.el)
        for slot in (1, SPE + 1):
            p = proposer_at(M, self.chain, slot)
            block = self.chain.produce_block(slot, randao(M, self.cfg, sks[p], slot))
            self.chain.process_block(sign_block(M, self.cfg, block, sks[p]))

    def blinded(self, slot):
        """(proposer, signed blinded block) produced through the chain's builder."""
        M, cfg = self.M, self.cfg
        p = proposer_at(M, self.chain, slot)
        block = self.chain.produce_blinded_block(slot, randao(M, cfg, self.sks[p], slot))
        return p, sign_block(M, cfg, block, self.sks[p], blinded=True)


@pytest.fixture(scope="module")
def worlds():
    sks, pks = keys(N)
    DB.set_backend(None)
    try:
        yield {"J": World(J, sks, pks), "P": World(P, sks, pks)}
    finally:
        DB.reset_backend()


@pytest.fixture
def host(worlds):
    DB.set_backend(None)
    yield worlds
    DB.reset_backend()


def _json(M, signed_blinded):
    return mod(M, "execution.builder_codec").signed_blinded_to_json(signed_blinded)


def test_blinded_block_produced_unblinded_imported(host):
    """Produce blinded through the mock relay, sign, unblind through
    submit_blinded_block, import: the same bytes, roots and head on both."""
    out = {}
    slot = SPE + 2
    for key, w in host.items():
        M = w.M
        builder = M.execution.ExecutionBuilderMock(w.el)
        w.chain.execution_builder = builder
        p = proposer_at(M, w.chain, slot)
        reg = registration(M, w.cfg, w.sks[p], w.pks[p], b"\x0b" * 20, timestamp=123)
        builder.register_validator([reg])
        assert bytes(reg["message"]["pubkey"]) in builder.registrations
        _p, signed_blinded = w.blinded(slot)
        body = signed_blinded["message"]["body"]
        assert "execution_payload_header" in body and "execution_payload" not in body
        root = w.chain.submit_blinded_block(signed_blinded)
        assert w.chain.head_root_hex == bytes(root).hex()
        assert builder.revealed == 1
        head = w.chain.head_state
        header = body["execution_payload_header"]
        assert bytes(head.latest_execution_payload_header["block_hash"]) == bytes(header["block_hash"])
        out[key] = (_json(M, signed_blinded), bytes(root), head.serialize(), w.chain.head_root_hex,
                    mod(M, "api.encoding").to_json(M.T.SignedValidatorRegistrationV1, reg))
        w.chain.execution_builder = None
    assert out["P"] == out["J"]


def test_blinded_and_full_roots_agree(host):
    """hash_tree_root(blinded) == hash_tree_root(unblinded): the
    proposer's signature covers both shapes alike."""
    out = {}
    slot = SPE + 3
    for key, w in host.items():
        M = w.M
        builder = M.execution.ExecutionBuilderMock(w.el)
        w.chain.execution_builder = builder
        _p, signed_blinded = w.blinded(slot)
        blinded = signed_blinded["message"]
        payload, bundle = builder.submit_blinded_block(signed_blinded)
        full = M.execution.unblind_signed_block(signed_blinded, payload)
        blinded_root = w.cfg.get_blinded_fork_types(slot)[0].hash_tree_root(blinded)
        full_root = w.cfg.get_fork_types(slot)[0].hash_tree_root(full["message"])
        assert bytes(blinded_root) == bytes(full_root) and bundle is None
        assert full["signature"] == signed_blinded["signature"]
        out[key] = (bytes(blinded_root), mod(M, "execution.builder_codec").payload_to_json(payload))
        w.chain.execution_builder = None
    assert out["P"] == out["J"]


def test_capella_blinded_block_imports_as_jax():
    """A capella head (the merge block a capella block): the blinded
    header carries `withdrawals_root`; the blinded and full roots agree,
    a reveal with other withdrawals is refused, and the unblinded block
    imports, equal on both packages."""
    sks, pks = keys(N)
    out = {}
    DB.set_backend(None)
    try:
        for M in (J, P):
            w = World(M, sks, pks, altair=0, bellatrix=1, capella=1)
            builder = M.execution.ExecutionBuilderMock(w.el)
            w.chain.execution_builder = builder
            slot = SPE + 2
            _p, signed_blinded = w.blinded(slot)
            header = signed_blinded["message"]["body"]["execution_payload_header"]
            assert "withdrawals_root" in header
            payload = builder._payloads[bytes(M.T.ExecutionPayloadHeader.hash_tree_root(header)).hex()]
            full = M.execution.unblind_signed_block(signed_blinded, payload)
            roots = (w.cfg.get_blinded_fork_types(slot)[0].hash_tree_root(signed_blinded["message"]),
                     w.cfg.get_fork_types(slot)[0].hash_tree_root(full["message"]))
            assert roots[0] == roots[1]
            evil = dict(payload, withdrawals=[{"index": 0, "validator_index": 1, "address": b"\x01" * 20,
                                               "amount": 5}])
            with pytest.raises(M.execution.BuilderError, match="withdrawals_root") as e:
                M.execution.verify_revealed_payload(signed_blinded, evil)
            root = w.chain.submit_blinded_block(signed_blinded)
            out[M.pkg] = (mod(M, "execution.builder_codec").signed_blinded_to_json(signed_blinded), roots[0], root,
                          w.chain.head_state.serialize(), str(e.value), builder.revealed)
    finally:
        DB.reset_backend()
    assert out["lodestar_tpu_torch"] == out["lodestar_tpu"]


def test_substituted_payload_rejected(host):
    out = {}
    slot = SPE + 4
    for key, w in host.items():
        M = w.M
        builder = M.execution.ExecutionBuilderMock(w.el)
        w.chain.execution_builder = builder
        _p, signed_blinded = w.blinded(slot)
        payload, _bundle = builder.submit_blinded_block(signed_blinded)
        errs = []
        for evil in (dict(payload, block_hash=b"\x66" * 32), dict(payload, transactions=[b"\xde\xad"])):
            with pytest.raises(M.execution.BuilderError) as e:
                M.execution.verify_revealed_payload(signed_blinded, evil)
            errs.append(str(e.value))
        assert "block_hash" in errs[0] and "transactions_root" in errs[1]
        out[key] = errs
        w.chain.execution_builder = None
    assert out["P"] == out["J"]


def test_builder_disabled_or_absent_errors(host):
    out = {}
    for key, w in host.items():
        M = w.M
        builder = M.execution.ExecutionBuilderMock(w.el)
        builder.update_status(False)
        w.chain.execution_builder = builder
        errs = []
        with pytest.raises(ValueError, match="disabled") as e:
            w.chain.produce_blinded_block(SPE + 5, b"\x00" * 96)
        errs.append(str(e.value))
        w.chain.execution_builder = None
        for call in (lambda: w.chain.produce_blinded_block(SPE + 5, b"\x00" * 96),
                     lambda: w.chain.submit_blinded_block({"message": {"slot": SPE + 5}})):
            with pytest.raises(ValueError, match="not set") as e:
                call()
            errs.append(str(e.value))
        out[key] = errs
    assert out["P"] == out["J"]


def test_relay_faults_trip_breaker_through_chain(host):
    """Produce-time relay faults count against the circuit breaker: the
    HTTP client against a closed loopback port trips after the allowed
    faults, after as many calls on both packages."""
    out = {}
    for key, w in host.items():
        M = w.M
        builder = M.execution.ExecutionBuilderHttp("http://127.0.0.1:1", w.cfg, timeout=0.05,
                                                   fault_inspection_window=M.params.SLOTS_PER_EPOCH,
                                                   allowed_faults=2)
        builder.update_status(True)
        w.chain.execution_builder = builder
        calls = 0
        for i in range(4):
            with pytest.raises(Exception):
                w.chain.produce_blinded_block(SPE + 8 + i, b"\x00" * 96)
            calls += 1
            if not builder.status:
                break
        assert not builder.status, "breaker must trip after the allowed faults"
        out[key] = (calls, builder._faults.fault_slots)
        w.chain.execution_builder = None
    assert out["P"] == out["J"] and out["P"][0] == 3


@pytest.mark.parametrize("window,allowed,faults", [
    (SPE, 2, (10, 11, 12)),
    (SPE, 2, (1, 2, 2 + 2 * SPE)),
    (1, 9, (0, 3, 5, 7, 9, 40, 41)),
])
def test_fault_window_circuit_breaker(window, allowed, faults):
    seen = []
    for M in (J, P):
        fw = mod(M, "execution.builder")._FaultWindow(window=window, allowed=allowed)
        trips = [fw.record_fault(s) for s in faults]
        fw.record_success(faults[-1] + window)
        seen.append((fw.window, fw.allowed, trips, fw.fault_slots))
    assert seen[1] == seen[0]
    if faults == (10, 11, 12):
        assert seen[1][2] == [False, False, True]


def test_builder_blobs_bundle_registers_availability():
    """A deneb reveal's blobs bundle becomes validated sidecars in the DA
    tracker before import; a missing bundle or a mismatched blob refuses."""
    sks, pks = keys(4)
    out = []
    DB.set_backend(None)
    try:
        for M in (J, P):
            cfg = cfg_of(M, altair=0, bellatrix=0, capella=0, deneb=0)
            K = M.kzg
            setup = K.insecure_dev_setup(8)
            chain = M.chain.BeaconChain(cfg, M.gen.create_genesis_state(cfg, pks, genesis_time=2), kzg_setup=setup)
            blobs = [K.polynomial_to_blob([int.from_bytes(hashlib.sha256(b"bf-%d" % i).digest(), "big") % K.R
                                           for i in range(8)])]
            commitments = [K.blob_to_kzg_commitment(b, setup) for b in blobs]
            body = M.T.BeaconBlockBodyDeneb.default()
            body["blob_kzg_commitments"] = list(commitments)
            signed = {"message": {"slot": 1, "proposer_index": 0, "parent_root": b"\x01" * 32,
                                  "state_root": b"\x02" * 32, "body": body}, "signature": b"\x00" * 96}
            chain._register_builder_blobs(signed, commitments, {"blobs": blobs, "commitments": commitments,
                                                                "proofs": []})
            header = dict(signed["message"])
            del header["body"]
            header["body_root"] = M.T.BeaconBlockBodyDeneb.hash_tree_root(body)
            root = M.T.BeaconBlockHeader.hash_tree_root(header)
            chain._check_data_availability(signed["message"], root)
            errs = []
            with pytest.raises(ValueError, match="bundle") as e:
                chain._register_builder_blobs(signed, commitments, None)
            errs.append(str(e.value))
            bad = {"blobs": [bytes(len(blobs[0]))], "commitments": [], "proofs": []}
            with pytest.raises(ValueError, match="commitment") as e:
                chain._register_builder_blobs(signed, commitments, bad)
            errs.append(str(e.value))
            sidecars = chain.get_blob_sidecars(root)
            out.append((root, commitments, errs, sidecars))
    finally:
        DB.reset_backend()
    assert out[1] == out[0] and len(out[1][3]) == 1


def test_unknown_header_not_revealed(host):
    for w in host.values():
        M = w.M
        builder = M.execution.ExecutionBuilderMock(w.el)
        signed_blinded = {"message": {"slot": SPE + 6, "proposer_index": 0, "parent_root": b"\x00" * 32,
                                      "state_root": b"\x00" * 32,
                                      "body": {"execution_payload_header": M.T.ExecutionPayloadHeader.default()}},
                          "signature": b"\x00" * 96}
        with pytest.raises(M.execution.BuilderError, match="never bid"):
            builder.submit_blinded_block(signed_blinded)
        assert builder.revealed == 0


def test_builder_codec_json_equals_jax(host):
    """Registrations, bids, signed blinded blocks and reveals as
    builder-specs JSON: each package's encoding of the same values is
    the same JSON, and each decodes the other's to the same values."""
    wj, wp = host["J"], host["P"]
    cj, cp = mod(J, "execution.builder_codec"), mod(P, "execution.builder_codec")
    ej, ep = mod(J, "api.encoding"), mod(P, "api.encoding")
    slot = SPE + 12
    builder = P.execution.ExecutionBuilderMock(wp.el)
    wp.chain.execution_builder = builder
    try:
        _p, signed_blinded = wp.blinded(slot)
    finally:
        wp.chain.execution_builder = None
    payload, _ = builder.submit_blinded_block(signed_blinded)
    regs = [registration(P, wp.cfg, wp.sks[i], wp.pks[i], bytes([i]) * 20, timestamp=i) for i in range(3)]
    assert cp.registrations_to_json(regs) == cj.registrations_to_json(regs)
    assert cp.registrations_from_json(cj.registrations_to_json(regs)) == regs
    header = signed_blinded["message"]["body"]["execution_payload_header"]
    bid_p = cp.bid_to_json(header, 10**9, builder.pubkey)
    assert bid_p == cj.bid_to_json(header, 10**9, builder.pubkey)
    got = [(b.header, b.value, b.pubkey, b.blob_kzg_commitments)
           for b in (cp.bid_from_json(bid_p), cj.bid_from_json(bid_p))]
    assert got[0] == got[1] == [(header, 10**9, builder.pubkey, None)][0]
    sj = cj.signed_blinded_to_json(signed_blinded)
    assert cp.signed_blinded_to_json(signed_blinded) == sj
    assert cp.signed_blinded_from_json(sj) == cj.signed_blinded_from_json(sj)
    assert cp.signed_blinded_from_json(sj)["message"]["body"]["execution_payload_header"] == header
    pj = cj.payload_to_json(payload)
    assert cp.payload_to_json(payload) == pj
    bundle = {"commitments": ["0x" + "11" * 48], "proofs": ["0x" + "22" * 48], "blobs": ["0x" + "33" * 64]}
    for data in (pj, {"execution_payload": pj, "blobs_bundle": bundle}):
        assert cp.reveal_from_json(data) == cj.reveal_from_json(data)
    # the encoding's bounds: a short byte vector and an over-limit list refuse on both
    for M, enc in ((P, ep), (J, ej)):
        with pytest.raises(ValueError):
            enc.from_json(M.T.ExecutionPayloadHeader, dict(pj, parent_hash="0x00"))
        with pytest.raises(ValueError):
            enc.from_json(M.T.SignedValidatorRegistrationV1, dict(
                cj.registrations_to_json(regs)[0], signature="0x" + "00" * 95))
