"""The port's light client, proof helpers, plane reader and light-client
server against the JAX package's.

  - `Lightclient`: tests/test_light_client.py's updates (a valid one,
    finality with and without its branch, too little participation, a
    wrong signature, partial participation, a committee rotation with and
    without its proof) through both packages' clients, verdicts and
    headers held equal;
  - the proof helpers and `proofs/plane_reader.py`: tests/test_proofs.py's
    plane-reader cases on one warm altair state per package: plane
    proofs equal to `container_branch` and to the JAX package's, the
    multiproofs, the None contract where the planes cannot serve;
  - `LightClientServer`: tests/test_light_client_server.py's chain on
    both packages (altair, 16 validators, a `BeaconDb`): the updates as
    `LightClientUpdateType` bytes, the client accepting them, the
    bootstrap, persistence and restore, held equal;
  - ROADMAP Queue C item 3: on a bellatrix attested state the JAX server's
    update fails `is_valid_merkle_branch` and `validate_update`, the
    port's passes both.

The port runs on its host merkle path; its plane reads come off the
host `ChunkTree`s, the same planes the card's kernels fill.
"""

import hashlib
import importlib
import random
from dataclasses import replace

import pytest

from lodestar_tpu_torch.crypto import bls as B
from lodestar_tpu_torch.crypto import curves as C
from lodestar_tpu_torch.ssz import device_backend as DB

from test_torch_beacon_state import J, P, keys
from test_torch_builder import cfg_of, proposer_at, randao, sign_block

PARAMS = P.params
PRESET = PARAMS.ACTIVE_PRESET
SPE = PRESET.SLOTS_PER_EPOCH


def mod(M, name):
    return importlib.import_module(f"{M.pkg}.{name}")


@pytest.fixture(autouse=True)
def host():
    DB.set_backend(None)
    yield
    DB.reset_backend()


# -- the client -------------------------------------------------------------

N = 8


def header(slot, tag=0):
    return {"slot": slot, "proposer_index": 0, "parent_root": bytes([tag]) * 32, "state_root": bytes(32),
            "body_root": bytes(32)}


def _bound(leaf, depth, index, salt):
    """(branch, root) binding `leaf` at (depth, index) over arbitrary siblings."""
    branch = [bytes([salt + i]) * 32 for i in range(depth)]
    node = leaf
    for i in range(depth):
        node = hashlib.sha256(branch[i] + node if (index >> i) & 1 else node + branch[i]).digest()
    return branch, node


def _update(M, sks, attested, signature_slot, bits=None, **kw):
    bits = bits if bits is not None else [True] * len(sks)
    cfg = M.config.MAINNET_CHAIN_CONFIG
    root = cfg.compute_signing_root(M.T.BeaconBlockHeader.hash_tree_root(attested), cfg.get_domain(
        signature_slot, M.params.DOMAIN_SYNC_COMMITTEE, max(signature_slot, 1) - 1))
    sk = sum(s for s, b in zip(sks, bits) if b)
    return mod(M, "light_client").LightClientUpdate(
        attested_header=attested, sync_committee_bits=bits, sync_committee_signature=B.sign_bytes(sk, root),
        signature_slot=signature_slot, **kw)


def _scenario(M, name, sks, pks):
    """The updates of one scenario, each through `process_update` of one
    client: [(outcome, optimistic slot, finalized slot, periods)]."""
    LC = mod(M, "light_client.lightclient")
    lc = LC.Lightclient(M.config.MAINNET_CHAIN_CONFIG, header(0), pks)
    ups = []
    if name == "valid":
        ups = [_update(M, sks, header(5, 1), 6)]
    elif name == "participation":
        ups = [_update(M, sks, header(5, 1), 6, bits=[True] * (N // 2) + [False] * (N - N // 2))]
    elif name == "partial":
        ups = [_update(M, sks, header(7, 1), 8, bits=[True] * 6 + [False] * 2)]
    elif name == "wrong_signature":
        up = _update(M, sks, header(5, 1), 6)
        up.attested_header = header(5, 9)
        ups = [up]
    elif name == "finality":
        fin = header(3, 3)
        branch, state_root = _bound(M.T.BeaconBlockHeader.hash_tree_root(fin), LC.FINALIZED_ROOT_DEPTH,
                                    LC.FINALIZED_ROOT_INDEX, 0x40)
        attested = dict(header(9, 2), state_root=state_root)
        ups = [_update(M, sks, attested, 10, finalized_header=fin),
               _update(M, sks, attested, 10, finalized_header=header(4, 3), finality_branch=branch),
               _update(M, sks, attested, 10, finalized_header=fin, finality_branch=branch)]
    elif name == "rotation":
        next_sks = [B.keygen(b"lc-next-%d" % i) for i in range(N)]
        next_pks = [C.g1_compress(B.sk_to_pk(sk)) for sk in next_sks]
        full = (next_pks * (PARAMS.SYNC_COMMITTEE_SIZE // N + 1))[:PARAMS.SYNC_COMMITTEE_SIZE]
        value = {"pubkeys": full, "aggregate_pubkey": next_pks[0]}
        branch, state_root = _bound(M.T.SyncCommittee.hash_tree_root(value), LC.NEXT_SYNC_COMMITTEE_DEPTH,
                                    LC.NEXT_SYNC_COMMITTEE_INDEX, 1)
        attested = dict(header(5, 1), state_root=state_root)
        late = SPE * PARAMS.EPOCHS_PER_SYNC_COMMITTEE_PERIOD + 2
        tiled = (next_sks * (PARAMS.SYNC_COMMITTEE_SIZE // N + 1))[:PARAMS.SYNC_COMMITTEE_SIZE]
        ups = [_update(M, sks, attested, 6, next_sync_committee=value),
               _update(M, sks, attested, 6, next_sync_committee=dict(value, aggregate_pubkey=next_pks[1]),
                       next_sync_committee_branch=branch),
               _update(M, sks, attested, 6, next_sync_committee=value, next_sync_committee_branch=branch),
               _update(M, tiled, header(late, 4), late + 1)]
    out = []
    for up in ups:
        try:
            lc.process_update(up)
            outcome = "ok"
        except LC.ValidationError as e:
            outcome = "refused: " + str(e)
        out.append((outcome, lc.optimistic_header["slot"], lc.finalized_header["slot"], sorted(lc.committees)))
    return out


@pytest.mark.parametrize("name", ["valid", "participation", "partial", "wrong_signature", "finality", "rotation"])
def test_lightclient_updates_equal_jax(name):
    sks = [B.keygen(b"lc-%d" % i) for i in range(N)]
    pks = [C.g1_compress(B.sk_to_pk(sk)) for sk in sks]
    theirs, ours = _scenario(J, name, sks, pks), _scenario(P, name, sks, pks)
    assert ours == theirs
    want = {"valid": ["ok"], "participation": ["refused"], "partial": ["ok"], "wrong_signature": ["refused"],
            "finality": ["refused", "refused", "ok"], "rotation": ["refused", "refused", "ok", "ok"]}[name]
    assert [o[0].split(":")[0] for o in ours] == want


# -- the proof helpers and the plane reader ----------------------------------

PLANE_PATHS = [
    ["slot"], ["genesis_time"], ["validators"], ["balances"], ["current_sync_committee"], ["next_sync_committee"],
    ["finalized_checkpoint"], ["finalized_checkpoint", "root"], ["finalized_checkpoint", "epoch"],
    ["latest_block_header", "state_root"], ["fork", "current_version"], ["balances", "0"], ["validators", "3"],
    ["block_roots", "5"], ["state_roots", "0"], ["randao_mixes", "7"], ["slashings", "0"],
    ["inactivity_scores", "0"], ["previous_epoch_participation", "0"],
]


@pytest.fixture(scope="module")
def warm():
    """One warm altair state per package, 16 validators, at slot 3."""
    _sks, pks = keys(16)
    DB.set_backend(None)
    try:
        out = {}
        for M in (J, P):
            state = M.gen.create_genesis_state(cfg_of(M, altair=0), pks, genesis_time=7)
            M.slot.process_slots(state, 3)
            state.hash_tree_root()
            out[M.pkg] = state
        yield out
    finally:
        DB.reset_backend()


def _reader(M):
    return mod(M, "proofs.plane_reader")


def _core(M):
    return mod(M, "ssz.core")


def test_plane_proofs_equal_host_and_jax(warm):
    sj, sp = warm["lodestar_tpu"], warm["lodestar_tpu_torch"]
    value, ctype, root = sp.to_value(), sp._container(), sp.hash_tree_root()
    assert root == sj.hash_tree_root()
    for path in PLANE_PATHS:
        got = _reader(P).state_proof(sp, path)
        assert got is not None, path
        assert got == _core(P).container_branch(ctype, value, path) == _reader(J).state_proof(sj, path), path
        assert P.ssz.is_valid_merkle_branch(*got, root), path


def test_multiproof_equals_container_branches_and_jax(warm):
    sj, sp = warm["lodestar_tpu"], warm["lodestar_tpu_torch"]
    paths = [["next_sync_committee"], ["finalized_checkpoint", "root"], ["current_sync_committee"]]
    got = _reader(P).state_multiproof(sp, paths)
    assert got == _core(P).container_branches(sp._container(), sp.to_value(), paths)
    assert got == _reader(J).state_multiproof(sj, paths)
    assert [(d, i) for _, _, d, i in got[:2]] == [(5, 23), (6, 41)]


def test_plane_proof_random_chunk_indices(warm):
    """Leaf indices across each packed field's padded leaf space (beyond
    the live count: zero chunks), equal to the host oracle and to JAX."""
    sj, sp = warm["lodestar_tpu"], warm["lodestar_tpu_torch"]
    value, ctype, root = sp.to_value(), sp._container(), sp.hash_tree_root()
    rng = random.Random(17)
    for fname in ("balances", "validators", "block_roots", "randao_mixes", "slashings", "inactivity_scores"):
        tree, _length, _mixin = sp._root_engine.leaf_cell(fname)
        pad = 1 << tree.depth
        for ci in sorted({0, pad - 1, rng.randrange(pad), rng.randrange(pad)}):
            path = [fname, str(ci)]
            got = _reader(P).state_proof(sp, path)
            assert got == _core(P).container_branch(ctype, value, path) == _reader(J).state_proof(sj, path), path
            assert P.ssz.is_valid_merkle_branch(*got, root), path
            # the in-field part of the branch is leaf_chunk_branch's, anchored at the field root
            leaf, branch, depth, _index = _core(P).leaf_chunk_branch(dict(ctype.fields)[fname], value[fname], ci)
            assert got[0] == leaf and got[1][:depth] == branch


def test_plane_proof_stays_current_after_mutation(warm):
    out = []
    for M in (J, P):
        st = warm[M.pkg].clone()
        M.slot.process_slots(st, int(st.slot) + 2)
        root = st.hash_tree_root()
        for path in (["slot"], ["state_roots", "1"], ["latest_block_header"]):
            got = _reader(M).state_proof(st, path)
            assert got == _core(M).container_branch(st._container(), st.to_value(), path)
            assert M.ssz.is_valid_merkle_branch(*got, root)
            out.append((M.pkg, got))
    assert [g for _, g in out[3:]] == [g for _, g in out[:3]]


def test_unservable_paths_return_none_not_wrong(warm, monkeypatch):
    got = []
    for M in (J, P):
        R, st = _reader(M), warm[M.pkg]
        tree, _, _ = st._root_engine.leaf_cell("balances")
        got.append([R.state_proof(st, ["no_such_field"]), R.state_proof(st, ["balances", "0", "x"]),
                    R.state_proof(st, ["balances", str(1 << tree.depth)]),
                    R.state_multiproof(st, [["slot"], ["no_such_field"]])])
        # released planes and an evicted engine fall through; the host path still serves
        released = st.clone()
        released.hash_tree_root()
        assert R.state_proof(released, ["slot"]) is not None
        released._root_engine.release_planes()
        evicted = st.clone()
        evicted._root_engine = None
        got[-1] += [R.state_proof(released, ["slot"]), R.state_proof(evicted, ["slot"])]
        leaf, branch, depth, index = _core(M).container_branch(evicted._container(), evicted.to_value(), ["slot"])
        assert M.ssz.is_valid_merkle_branch(leaf, branch, depth, index, evicted.hash_tree_root())
        # LODESTAR_TPU_HTR=full bypasses the engine: its planes go stale and are not served
        stale = st.clone()
        stale.hash_tree_root()
        monkeypatch.setenv("LODESTAR_TPU_HTR", "full")
        M.slot.process_slots(stale, int(stale.slot) + 1)
        got[-1].append(R.state_proof(stale, ["slot"]))
        monkeypatch.delenv("LODESTAR_TPU_HTR")
    assert got[1] == got[0] == [None] * 7


def test_engine_fault_raises_in_the_port(warm, monkeypatch):
    """A fault of the warm sync propagates out of the port's plane
    reader, as every port state root does, instead of sending the
    caller to a host re-merkleization (the JAX reader returns None)."""
    def boom(_state):
        raise RuntimeError("engine fault")

    for M in (J, P):
        st = warm[M.pkg].clone()
        st.hash_tree_root()
        monkeypatch.setattr(st._root_engine, "hash_tree_root", boom)
        if M is P:
            with pytest.raises(RuntimeError, match="engine fault"):
                _reader(M).state_proof(st, ["slot"])
        else:
            _reader(M).state_proof(st, ["slot"])


def test_multiproof_pack_equals_jax_and_verifies(warm):
    sp = warm["lodestar_tpu_torch"]
    root = sp.hash_tree_root()
    for paths in ([["finalized_checkpoint", "root"], ["finalized_checkpoint", "epoch"], ["next_sync_committee"],
                   ["slot"]], [["finalized_checkpoint"], ["finalized_checkpoint", "root"]]):
        proofs = _reader(P).state_multiproof(sp, paths)
        packed = _reader(P).pack_multiproof(proofs)
        assert packed == _reader(J).pack_multiproof(proofs)
        assert len(packed["helpers"]) < sum(len(b) for _, b, _, _ in proofs)
        helper_g = [g for g, _ in packed["helpers"]]
        assert helper_g == sorted(helper_g, reverse=True)
        for M in (J, P):
            assert _reader(M).verify_multiproof(packed["leaves"], packed["helpers"], root)
            assert not _reader(M).verify_multiproof(packed["leaves"], packed["helpers"][:-1], root)
            for g in packed["leaves"]:
                bad = dict(packed["leaves"])
                bad[g] = bytes(b ^ 0xFF for b in bad[g])
                assert not _reader(M).verify_multiproof(bad, packed["helpers"], root), g


def test_multiproof_rejects_forged_helpers():
    """Helpers on a leaf's path, at a leaf's own gindex, unconsumable or
    repeated, and no leaves, refuse on both; ancestor leaves verify both
    ways."""
    digest = mod(P, "ssz.hasher").digest
    n4, n5, n6, n7 = (bytes([i]) * 32 for i in (4, 5, 6, 7))
    n2, n3 = digest(n4 + n5), digest(n6 + n7)
    root = digest(n2 + n3)
    fake = b"\xaa" * 32
    cases = [({4: n4, 5: n5}, [(3, n3)]), ({4: fake, 5: fake}, [(2, n2), (3, n3)]),
             ({4: fake}, [(4, n4), (5, n5), (3, n3)]), ({4: n4, 5: n5}, [(3, n3), (6, n6)]),
             ({4: n4, 5: n5}, [(3, n3), (3, n3)]), ({}, [(2, n2), (3, n3)]),
             ({2: n2, 4: n4}, [(5, n5), (3, n3)]), ({2: fake, 4: n4}, [(5, n5), (3, n3)]),
             ({2: n2, 4: fake}, [(5, n5), (3, n3)])]
    got = [[_reader(M).verify_multiproof(leaves, helpers, root) for leaves, helpers in cases] for M in (J, P)]
    assert got[1] == got[0] == [True, False, False, False, False, False, True, False, False]


# -- the light-client server ---------------------------------------------------


def _import(M, cfg, chain, sks, slot, sync=False, execution=None):
    """Produce (the package's produce_block, optionally with a full sync
    aggregate over the head root), sign and import a block."""
    head = chain.head_state
    p = proposer_at(M, chain, slot)
    kw = {}
    if sync:
        pks = head.current_sync_committee["pubkeys"]
        sk_of = dict(zip(WORLD_PKS, sks))
        root = cfg.compute_signing_root(chain.get_head_root(),
                                        cfg.get_domain(slot, M.params.DOMAIN_SYNC_COMMITTEE, slot - 1))
        kw["sync_aggregate"] = {"sync_committee_bits": [True] * PARAMS.SYNC_COMMITTEE_SIZE,
                                "sync_committee_signature": B.sign_bytes(sum(sk_of[pk] for pk in pks), root)}
    block, _post = M.pb.produce_block(head, slot, randao(M, cfg, sks[p], slot), execution=execution, **kw)
    return chain.process_block(sign_block(M, cfg, block, sks[p]))


WORLD_SKS, WORLD_PKS = keys(16)


def _value(M, update):
    R = mod(M, "network.reqresp_protocols")
    return R.LightClientUpdateType.serialize(R.light_client_update_to_value(update))


def _server_world(M):
    cfg = cfg_of(M, altair=0)
    genesis = M.gen.create_genesis_state(cfg, WORLD_PKS, genesis_time=21)
    chain = M.chain.BeaconChain(cfg, genesis, db=M.db.BeaconDb(None, config=cfg))
    server = mod(M, "chain.light_client_server").LightClientServer(chain)
    return cfg, genesis, chain, server


@pytest.fixture(scope="module")
def served():
    """Both packages' chains: block 1 (no sync aggregate: nothing
    produced), block 2 attesting block 1, block 3 attesting block 2."""
    DB.set_backend(None)
    try:
        out = {}
        for M in (J, P):
            cfg, genesis, chain, server = _server_world(M)
            _import(M, cfg, chain, WORLD_SKS, 1)
            produced_after_1 = server.produced
            for slot in (2, 3):
                _import(M, cfg, chain, WORLD_SKS, slot, sync=True)
            out[M.pkg] = (cfg, genesis, chain, server, produced_after_1)
        yield out
    finally:
        DB.reset_backend()


def test_server_updates_equal_jax_and_validate(served):
    got = {}
    for M in (J, P):
        cfg, genesis, chain, server, first = served[M.pkg]
        update = server.get_optimistic_update()
        assert first == 0 and server.produced == 2
        assert update.signature_slot == 3 and update.attested_header["slot"] == 2
        anchor = dict(genesis.latest_block_header, state_root=genesis.hash_tree_root())
        client = mod(M, "light_client.lightclient").Lightclient(cfg, anchor,
                                                                 genesis.current_sync_committee["pubkeys"])
        client.process_update(update)
        assert client.optimistic_header["slot"] == 2 and len(client.committees) == 2
        bad = replace(update, next_sync_committee_branch=[b"\x00" * 32] * 5)
        with pytest.raises(mod(M, "light_client.lightclient").ValidationError):
            client.process_update(bad)
        got[M.pkg] = ([_value(M, u) for _p, u in sorted(server.best_update_by_period.items())],
                      _value(M, update), server.latest_finality_update)
    assert got["lodestar_tpu_torch"] == got["lodestar_tpu"]
    assert served["lodestar_tpu_torch"][3].plane_proofs == 2 and served["lodestar_tpu_torch"][3].host_proofs == 0


def test_bootstrap_equals_jax(served):
    got = []
    for M in (J, P):
        _cfg, _genesis, chain, server, _first = served[M.pkg]
        head_root = chain.get_head_root()
        boot = server.get_bootstrap(head_root)
        state = chain.regen._get_post_state(head_root.hex())
        assert M.ssz.is_valid_merkle_branch(M.T.SyncCommittee.hash_tree_root(boot["current_sync_committee"]),
                                            boot["current_sync_committee_branch"], 5, 22, state.hash_tree_root())
        got.append(mod(M, "network.reqresp_protocols").LightClientBootstrapType.serialize(
            {"header": boot["header"], "current_sync_committee": boot["current_sync_committee"],
             "current_sync_committee_branch": boot["current_sync_committee_branch"]}))
    assert got[1] == got[0]


def test_best_updates_persist_across_restart(served):
    got = []
    for M in (J, P):
        _cfg, _genesis, chain, server, _first = served[M.pkg]
        assert server.best_update_by_period
        again = mod(M, "chain.light_client_server").LightClientServer(chain)
        assert set(again.best_update_by_period) == set(server.best_update_by_period)
        for period in server.best_update_by_period:
            assert _value(M, again.get_update(period)) == _value(M, server.get_update(period))
        # an update older than the memory window is read back from the db
        period = min(server.best_update_by_period)
        del again.best_update_by_period[period]
        got.append((_value(M, again.get_update(period)), again.get_update(period + 1)))
    assert got[1] == got[0] and got[1][1] is None


def test_bellatrix_attested_update_port_right_jax_wrong():
    """ROADMAP Queue C item 3.  A chain with bellatrix at epoch 1: the
    merge block at slot 33, then a block at 34 whose sync aggregate
    attests it.  The attested state has bellatrix's 25 fields and its
    header a bellatrix body.  The JAX server proves the committee under
    altair's 24 fields and hashes the body as altair's, so its update
    fails both checks; the port's passes both."""
    verdicts = {}
    updates = {}
    for M in (J, P):
        cfg = cfg_of(M, altair=0, bellatrix=1)
        genesis = M.gen.create_genesis_state(cfg, WORLD_PKS, genesis_time=21)
        el = M.execution.ExecutionEngineMock()
        chain = M.chain.BeaconChain(cfg, genesis, db=M.db.BeaconDb(None, config=cfg), execution=el)
        server = mod(M, "chain.light_client_server").LightClientServer(chain)
        _import(M, cfg, chain, WORLD_SKS, SPE + 1, execution=el)
        attested_root = chain.get_head_root()
        attested_state = chain.head_state
        assert attested_state.fork_name == M.params.ForkName.bellatrix
        _import(M, cfg, chain, WORLD_SKS, SPE + 2, sync=True, execution=el)
        update = server.get_optimistic_update()
        LC = mod(M, "light_client.lightclient")
        # judged by the port's client and merkle check for both servers
        header_ok = P.T.BeaconBlockHeader.hash_tree_root(update.attested_header) == attested_root
        branch_ok = P.ssz.is_valid_merkle_branch(
            P.T.SyncCommittee.hash_tree_root(update.next_sync_committee), update.next_sync_committee_branch,
            LC.NEXT_SYNC_COMMITTEE_DEPTH, LC.NEXT_SYNC_COMMITTEE_INDEX, update.attested_header["state_root"])
        anchor = dict(genesis.latest_block_header, state_root=genesis.hash_tree_root())
        client = mod(P, "light_client.lightclient").Lightclient(cfg_of(P, altair=0, bellatrix=1), anchor,
                                                                 genesis.current_sync_committee["pubkeys"])
        try:
            client.validate_update(update)
            signature_ok = True
        except mod(P, "light_client.lightclient").ValidationError:
            signature_ok = False
        verdicts[M.pkg] = (header_ok, branch_ok, signature_ok)
        updates[M.pkg] = update
    assert verdicts["lodestar_tpu_torch"] == (True, True, True)
    assert verdicts["lodestar_tpu"] == (False, False, False)
    # the parts that do not depend on the fork are the same
    ours, theirs = updates["lodestar_tpu_torch"], updates["lodestar_tpu"]
    assert ours.attested_header["state_root"] == theirs.attested_header["state_root"]
    assert ours.next_sync_committee == theirs.next_sync_committee
    assert ours.sync_committee_signature == theirs.sync_committee_signature


def test_host_fallback_is_counted_and_logged(served, caplog):
    """Released planes send the port's bootstrap to the host pass: the
    same branch, counted in `host_proofs` and logged with the registry
    size and its time."""
    cfg, _genesis, chain, _server, _first = served["lodestar_tpu_torch"]
    server = mod(P, "chain.light_client_server").LightClientServer(chain)
    head_root = chain.get_head_root()
    planes = server.get_bootstrap(head_root)
    chain.regen._get_post_state(head_root.hex())._root_engine.release_planes()
    with caplog.at_level("WARNING", logger="lodestar_tpu_torch"):
        host = server.get_bootstrap(head_root)
    assert host["current_sync_committee_branch"] == planes["current_sync_committee_branch"]
    assert (server.plane_proofs, server.host_proofs) == (1, 1)
    warned = [r.getMessage() for r in caplog.records if "re-merkleized on the host" in r.getMessage()]
    assert len(warned) == 1 and f"validators={len(WORLD_PKS)}" in warned[0] and " ms=" in warned[0]
