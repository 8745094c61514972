"""The port's execution layer and the chain's payload leg against the JAX
package's.

The engine mock (payload building, block hashes, statuses, one-shot
payload ids, fault injection), the HS256 JWT, the JSON-RPC client against
the in-process server (each package's client against either server, over
loopback), `build_payload_attributes` and `_fetch_payload` at every
payload fork, the chain's payload verdicts (VALID, SYNCING, INVALID,
UNAVAILABLE) and optimistic sync (an INVALID fcU evicting an optimistic
branch, a VALID one resolving it), each run on both packages and held
equal: statuses, latest valid hashes, payload SSZ bytes, block hashes,
roots, heads and fork-choice statuses.
"""

import time

import pytest

from lodestar_tpu_torch.crypto import bls as B

from test_torch_beacon_state import J, P, keys
from test_torch_chain import HostSets, _signing_root
from lodestar_tpu_torch.ssz import device_backend as DB

PRESET = P.params.ACTIVE_PRESET
SPE = PRESET.SLOTS_PER_EPOCH
ZERO = b"\x00" * 32


def attrs(M, **kw):
    base = dict(timestamp=1234, prev_randao=b"\x07" * 32, suggested_fee_recipient=b"\x0a" * 20)
    base.update(kw)
    return M.execution.PayloadAttributes(**base)


def _status(r):
    return (r.status.value, getattr(r, "latest_valid_hash", None), getattr(r, "validation_error", None))


def _mock_story(M):
    """Build, import, fcU, one-shot ids, corrupt hash, unknown parent,
    faults, invalid hashes; every verdict and payload recorded."""
    mock = M.execution.engine_mock
    el = M.execution.ExecutionEngineMock()
    out = []
    r = el.notify_forkchoice_update(ZERO, ZERO, ZERO, attrs(M))
    out.append((r.status.value, r.payload_id))
    payload = el.get_payload(r.payload_id)
    out.append(M.T.ExecutionPayload.serialize(payload))
    with pytest.raises(ValueError):
        el.get_payload(r.payload_id)
    out.append(_status(el.notify_new_payload(payload)))
    r2 = el.notify_forkchoice_update(payload["block_hash"], payload["block_hash"], ZERO)
    out += [r2.status.value, el.head]
    bad = dict(payload, block_hash=b"\xff" * 32)
    out.append(_status(el.notify_new_payload(bad)))
    orphan = dict(payload, parent_hash=b"\xee" * 32)
    orphan["block_hash"] = mock.compute_block_hash(orphan)
    out += [orphan["block_hash"], _status(el.notify_new_payload(orphan))]
    out.append(el.notify_forkchoice_update(b"\xdd" * 32, ZERO, ZERO).status.value)
    for fault in ("SYNCING", "UNAVAILABLE", "ELERROR"):
        el.fail_with = getattr(M.execution.ExecutePayloadStatus, fault)
        out.append(_status(el.notify_new_payload(payload)))
    el.fail_with = None
    el.invalid_hashes = {bytes(payload["block_hash"])}
    out.append(_status(el.notify_new_payload(payload)))
    el.invalid_hashes = set()
    # capella (v2, withdrawals) and deneb (v3, the parent beacon root) payloads
    ws = [{"index": 3, "validator_index": 5, "address": b"\x33" * 20, "amount": 7}]
    r3 = el.notify_forkchoice_update(payload["block_hash"], ZERO, ZERO, attrs(M, withdrawals=ws))
    p3 = el.get_payload(r3.payload_id, 2)
    out.append(M.T.ExecutionPayloadCapella.serialize(p3))
    r4 = el.notify_forkchoice_update(payload["block_hash"], ZERO, ZERO,
                                     attrs(M, withdrawals=ws, parent_beacon_block_root=b"\x44" * 32))
    p4 = el.get_payload(r4.payload_id, 3)
    out.append(sorted((k, repr(v)) for k, v in p4.items()))
    out.append(sorted(el.valid_blocks.items()))
    return out


def test_mock_engine_equals_jax():
    assert _mock_story(P) == _mock_story(J)


def test_jwt_equals_jax():
    secret = b"\x42" * 32
    claims = {"iat": int(time.time())}
    tok = P.execution.engine_http.jwt_encode_hs256(secret, claims)
    assert tok == J.execution.engine_http.jwt_encode_hs256(secret, claims)
    for Mv in (J, P):
        verify = Mv.execution.engine_http.jwt_verify_hs256
        assert verify(secret, tok)["iat"] == claims["iat"]
        with pytest.raises(ValueError):
            verify(b"\x43" * 32, tok)
        stale = P.execution.engine_http.jwt_encode_hs256(secret, {"iat": int(time.time()) - 3600})
        with pytest.raises(ValueError):
            verify(secret, stale)


def _http_story(client):
    out = []
    r = client.notify_forkchoice_update(ZERO, ZERO, ZERO, None)
    out.append(r.status.value)
    ws = [{"index": 0, "validator_index": 1, "address": b"\x11" * 20, "amount": 9}]
    r = client.notify_forkchoice_update(ZERO, ZERO, ZERO, attrs(P, withdrawals=ws))
    out.append(r.status.value)
    payload = client.get_payload(r.payload_id)
    out.append(sorted((k, repr(v)) for k, v in payload.items()))
    st = client.notify_new_payload(payload)
    out.append(_status(st))
    return out


@pytest.mark.parametrize("client_pkg,server_pkg", [("port", "port"), ("port", "jax"), ("jax", "port")])
def test_http_client_and_server_across_packages(client_pkg, server_pkg):
    """Each package's client against either server over loopback, beside
    the JAX client against the JAX server; the one-shot id and a wrong
    JWT secret are refused."""
    secret = b"\x11" * 32
    got = []
    for cp, sp in ((client_pkg, server_pkg), ("jax", "jax")):
        C, S = (P if cp == "port" else J), (P if sp == "port" else J)
        server = S.execution.EngineApiServer(S.execution.ExecutionEngineMock(), secret)
        server.listen()
        try:
            url = f"http://127.0.0.1:{server.port}"
            client = C.execution.ExecutionEngineHttp(url, secret, timeout=10)
            # the port's PayloadAttributes travel through either client (the same fields)
            got.append(_http_story(client))
            r = client.notify_forkchoice_update(ZERO, ZERO, ZERO, attrs(C))
            client.get_payload(r.payload_id)
            with pytest.raises(C.execution.engine_http.EngineHttpError):
                client.get_payload(r.payload_id)
            import urllib.error

            with pytest.raises(urllib.error.HTTPError):
                C.execution.ExecutionEngineHttp(url, b"\x99" * 32, timeout=10).notify_forkchoice_update(
                    ZERO, ZERO, ZERO)
        finally:
            server.close()
    assert got[0] == got[1]


# -- the chain's payload leg ---------------------------------------------------

def _cfg(M, **forks):
    epochs = {M.params.ForkName.altair: 0}
    epochs.update({getattr(M.params.ForkName, k): v for k, v in forks.items()})
    return M.config.create_chain_config(M.config.MAINNET_CHAIN_CONFIG, fork_epochs=epochs)


def _shell(slot, payload, commitments=None):
    body = {"randao_reveal": b"\x00" * 96,
            "eth1_data": {"deposit_root": ZERO, "deposit_count": 0, "block_hash": ZERO},
            "graffiti": ZERO, "proposer_slashings": [], "attester_slashings": [], "attestations": [],
            "deposits": [], "voluntary_exits": [],
            "sync_aggregate": {"sync_committee_bits": [False] * 512, "sync_committee_signature": b"\x00" * 96},
            "execution_payload": payload}
    if commitments is not None:
        body["blob_kzg_commitments"] = commitments
    return {"slot": slot, "proposer_index": 0, "parent_root": b"\x05" * 32, "state_root": ZERO, "body": body}


@pytest.fixture(scope="module")
def leg_keys():
    return keys(8)


def _leg_story(M, pks):
    DB.set_backend(None)
    try:
        cfg = _cfg(M)
        el = M.execution.ExecutionEngineMock()
        chain = M.chain.BeaconChain(cfg, M.gen.create_genesis_state(cfg, pks[:4], genesis_time=2), execution=el)
    finally:
        DB.reset_backend()
    mock = M.execution.engine_mock
    r = el.notify_forkchoice_update(ZERO, ZERO, ZERO, attrs(M))
    payload = el.get_payload(r.payload_id)
    out = [chain._verify_execution_payload(_shell(1, payload))]
    out.append(dict(chain._execution_block_hash))  # no residue before an import
    orphan = dict(payload, parent_hash=b"\xee" * 32)
    orphan["block_hash"] = mock.compute_block_hash(orphan)
    out.append(chain._verify_execution_payload(_shell(2, orphan)))  # SYNCING: optimistic
    for case, blk in (("hash", _shell(3, dict(payload, block_hash=b"\xff" * 32))), ("outage", _shell(4, payload))):
        if case == "outage":
            el.fail_with = M.execution.ExecutePayloadStatus.UNAVAILABLE
        try:
            chain._verify_execution_payload(blk)
            out.append((case, None))
        except Exception as e:  # noqa: BLE001 - compared across packages
            out.append((case, type(e).__name__, str(e), getattr(e, "latest_valid_hash", None)))
        el.fail_with = None
    # an EL-ruled INVALID payload carries the latest valid hash
    el.invalid_hashes = {bytes(payload["block_hash"])}
    try:
        chain._verify_execution_payload(_shell(5, payload))
    except M.chain.PayloadInvalidError as e:
        out.append(("invalid", str(e), e.latest_valid_hash))
    el.invalid_hashes = set()
    # a deneb payload hands the commitments' versioned hashes and the parent root to the engine
    seen = []
    real = el.notify_new_payload

    def spy(p, *rest):
        seen.append(rest)
        return real(p, *rest)

    el.notify_new_payload = spy
    deneb = dict(payload, blob_gas_used=0, excess_blob_gas=0)
    deneb["block_hash"] = mock.compute_block_hash(deneb)
    out.append(chain._verify_execution_payload(_shell(6, deneb, [b"\xc0" + b"\x00" * 47, b"\xab" * 48])))
    out.append(seen)
    no_payload = _shell(7, payload)
    del no_payload["body"]["execution_payload"]
    out.append(chain._verify_execution_payload(no_payload))
    out.append(chain.execution_head_hashes())
    return out


def test_chain_payload_verdicts_equal_jax(leg_keys):
    _sks, pks = leg_keys
    theirs, ours = _leg_story(J, pks), _leg_story(P, pks)
    assert ours == theirs
    assert ours[2][1] is True and ours[3][1] == "PayloadInvalidError" and ours[4][1] == "ExecutionEngineUnavailable"


@pytest.mark.parametrize("forks,version", [({"bellatrix": 0}, 1), ({"bellatrix": 0, "capella": 0}, 2),
                                           ({"bellatrix": 0, "capella": 0, "deneb": 0}, 3)])
def test_payload_attributes_and_fetch_equal_jax(leg_keys, forks, version):
    """build_payload_attributes and _fetch_payload on a state of each
    payload fork: the attributes, the engine version asked for and the
    payload (the pre-merge parent, capella's withdrawals, deneb's blob
    gas defaults)."""
    _sks, pks = leg_keys
    outs = []
    DB.set_backend(None)
    try:
        for M in (J, P):
            cfg = _cfg(M, **forks)
            st = M.gen.create_genesis_state(cfg, pks, genesis_time=2)
            M.slot.process_slots(st, 3)
            a = M.pb.build_payload_attributes(st, 3, b"\x0b" * 20)
            el = M.execution.ExecutionEngineMock()
            asked = []
            real = el.get_payload
            el.get_payload = lambda pid, v=2: (asked.append(v), real(pid, v))[1]
            payload = M.pb._fetch_payload(el, st, b"\x0b" * 20)
            outs.append((repr(a), asked, sorted((k, repr(v)) for k, v in payload.items())))
    finally:
        DB.reset_backend()
    assert outs[0] == outs[1]
    assert outs[1][1] == [version]


# -- optimistic sync -------------------------------------------------------------

@pytest.fixture(scope="module")
def opt_blocks(leg_keys):
    """Blocks at slots 1 (altair), 33 (the merge) and 34 made by a JAX
    chain with a working engine: the same signed blocks feed both packages."""
    sks, pks = leg_keys
    sk_of = dict(zip(pks, sks))
    cfg = _cfg(J, bellatrix=1)
    DB.set_backend(None)
    try:
        genesis = J.gen.create_genesis_state(cfg, pks, genesis_time=2)
        builder = J.chain.BeaconChain(cfg, genesis, execution=J.execution.ExecutionEngineMock(),
                                      bls_verifier=HostSets(pks))
        signed = []
        for slot in (1, SPE + 1, SPE + 2):
            st = builder.head_state.clone()
            J.slot.process_slots(st, slot)
            proposer = J.acc.get_beacon_proposer_index(st)
            sk = sk_of[st.pubkeys[proposer]]
            reveal = B.sign_bytes(sk, _signing_root(J, st, J.params.DOMAIN_RANDAO,
                                                    J.ssz.uint64.hash_tree_root(slot // SPE), slot))
            block = builder.produce_block(slot, reveal)
            root = _signing_root(J, st, J.params.DOMAIN_BEACON_PROPOSER,
                                 builder._block_type(slot).hash_tree_root(block), slot)
            signed.append({"message": block, "signature": B.sign_bytes(sk, root)})
            builder.process_block(signed[-1])
    finally:
        DB.reset_backend()
    return pks, genesis.serialize(), signed


def _optimistic(M, opt_blocks, verdict):
    pks, genesis_bytes, (b_alt, b_merge, b_child) = opt_blocks
    cfg = _cfg(M, bellatrix=1)
    DB.set_backend(None)
    try:
        genesis = M.state.BeaconState.deserialize(genesis_bytes, cfg)
        el = M.execution.ExecutionEngineMock()
        chain = M.chain.BeaconChain(cfg, genesis, execution=el, bls_verifier=HostSets(pks))
        heads = []
        chain.emitter.on(M.emitter.ChainEvent.head, lambda r, s: heads.append((bytes(r), int(s))))
        alt = chain.process_block(b_alt).hex()
        el.fail_with = M.execution.ExecutePayloadStatus.SYNCING
        m = chain.process_block(b_merge).hex()
        el.fail_with = None
        out = [chain.fork_choice.get_execution_status(alt), chain.fork_choice.get_execution_status(m),
               sorted(chain.optimistic_roots)]
        if verdict == "invalid":
            c = chain.process_block(b_child).hex()  # unknown ancestry: SYNCING organically
            out += [sorted(chain.optimistic_roots), chain.head_root_hex == c]
            el.invalid_hashes = {chain._execution_block_hash[m], chain._execution_block_hash[c]}
            chain._notify_forkchoice()
            out += [chain.fork_choice.get_execution_status(m), chain.fork_choice.get_execution_status(c),
                    chain.head_root_hex == alt]
        else:
            el.valid_blocks[chain._execution_block_hash[m]] = ZERO
            chain._notify_forkchoice()
        out += [chain.fork_choice.get_execution_status(m), sorted(chain.optimistic_roots), chain.head_root_hex,
                heads]
        return out
    finally:
        DB.reset_backend()


@pytest.mark.parametrize("verdict", ["invalid", "valid"])
def test_optimistic_sync_equals_jax(opt_blocks, verdict):
    """SYNCING imports optimistically; an INVALID forkchoiceUpdated evicts
    the branch (the head falls back to the pre-merge block), a VALID one
    resolves it."""
    theirs, ours = _optimistic(J, opt_blocks, verdict), _optimistic(P, opt_blocks, verdict)
    assert ours == theirs
    assert ours[1] == "Syncing"
    if verdict == "invalid":
        assert ours[5:8] == ["Invalid", "Invalid", True] and ours[9] == []
    else:
        assert ours[3] == "Valid" and ours[4] == []
