"""The port's validator monitor, archiver and anchor-state selection
against the JAX package's.

  - `ValidatorMonitor`: tests/test_validator_monitor.py's accounting
    (tracked-only attestations, best inclusion delay, proposals, sync
    signals, missed duties at epoch close, the historic window) on both
    packages, the summaries held equal as dicts; and a chain feeding its
    monitor on import;
  - `Archiver`: tests/test_node_services.py's migration on finality
    (canonical blocks to the slot-keyed archive, the finalized state
    archived, the hot repo drained, a side fork pruned);
  - `init_beacon_state`: tests/test_backfill.py's sources: resume from
    the state archive, checkpoint bytes (a state from the other
    package), genesis, the corrupt-checkpoint refusals, and the URL path
    raising `NotImplementedError` naming ROADMAP Queue A item 7.3.

The port runs on its host merkle path.
"""

import importlib

import pytest

from lodestar_tpu_torch.crypto import bls as B
from lodestar_tpu_torch.ssz import device_backend as DB

from test_torch_beacon_state import J, P, keys
from test_torch_builder import cfg_of, proposer_at, randao, sign_block

SPE = P.params.ACTIVE_PRESET.SLOTS_PER_EPOCH
N = 16


def mod(M, name):
    return importlib.import_module(f"{M.pkg}.{name}")


@pytest.fixture(autouse=True)
def host():
    DB.set_backend(None)
    yield
    DB.reset_backend()


# -- the validator monitor ----------------------------------------------------


def _indexed(indices, slot=1, root=b"\x01" * 32):
    return {"attesting_indices": list(indices),
            "data": {"slot": slot, "index": 0, "beacon_block_root": root,
                     "source": {"epoch": 0, "root": b"\x00" * 32},
                     "target": {"epoch": slot // SPE, "root": root}},
            "signature": b"\x00" * 96}


def _monitor_script(M):
    """One monitor through every hook; the summaries and counters seen."""
    VM = mod(M, "utils.validator_monitor")
    mon = VM.ValidatorMonitor()
    out = []
    for v in (3, 5, 7, 1):
        mon.register_local_validator(v)
    mon.register_attestation_in_block(_indexed([3, 9], slot=1), parent_slot=1, correct_head=True)
    mon.register_attestation_in_block(_indexed([3], slot=1), parent_slot=4, correct_head=False)
    mon.register_beacon_block(7, slot=5)
    mon.register_beacon_block(8, slot=5)  # untracked
    mon.register_local_validator_in_sync_committee(7, until_epoch=10)
    mon.register_local_validator_in_sync_committee(5, until_epoch=0)
    mon.register_sync_aggregate_in_block(0, [7, 8])
    out.append([mon.summary_dict(i, 0) for i in (3, 5, 7, 9)])
    out.append(mon.on_epoch_close(0))
    out.append(mon.on_epoch_close(0))  # idempotent per epoch
    for epoch in range(VM.HISTORIC_EPOCHS + 3):
        mon.register_attestation_in_block(_indexed([1], slot=epoch * SPE + 1), parent_slot=epoch * SPE + 1,
                                          correct_head=True)
    out.append(sorted(mon._validators[1].summaries))
    out.append(sorted(mon.tracked_indices))
    out.append({name: getattr(mon, name).value for name in (
        "m_validators", "m_attestations", "m_correct_head", "m_blocks", "m_sync_signals", "m_missed",
        "m_sync_missed")})
    out.append((mon.m_inclusion_distance.count, mon.m_inclusion_distance.sum))
    return out


def test_monitor_accounting_equals_jax():
    theirs, ours = _monitor_script(J), _monitor_script(P)
    assert ours == theirs
    s3 = ours[0][0]
    assert (s3["attestations_included"], s3["attestation_min_delay_slots"], s3["attestation_correct_head"]) == (2, 1, 1)
    assert ours[0][3]["attestations_included"] == 0  # untracked
    assert ours[5]["m_missed"] == 3 and ours[5]["m_sync_missed"] == 1  # 5, 7 and 1 attested nothing in epoch 0
    assert len(ours[3]) <= mod(P, "utils.validator_monitor").HISTORIC_EPOCHS


def test_monitor_metric_names_equal_jax():
    names = []
    for M in (J, P):
        reg = mod(M, "utils.metrics").Registry()
        mod(M, "utils.validator_monitor").ValidatorMonitor(reg)
        names.append(sorted((name, type(m).__name__) for name, m in reg._metrics.items()))
    assert names[1] == names[0] and len(names[1]) == 8


def test_chain_feeds_monitor_on_import():
    """A block with a full committee's aggregate and a sync aggregate
    lands in each package's monitor as the same summaries."""
    sks, pks = keys(N)
    sk_of = dict(zip(pks, sks))
    got = []
    for M in (J, P):
        cfg = cfg_of(M, altair=0)
        mon = mod(M, "utils.validator_monitor").ValidatorMonitor()
        for i in range(N):
            mon.register_local_validator(i)
        chain = M.chain.BeaconChain(cfg, M.gen.create_genesis_state(cfg, pks, genesis_time=2), monitor=mon)
        p1 = proposer_at(M, chain, 1)
        chain.process_block(sign_block(M, cfg, chain.produce_block(1, randao(M, cfg, sks[p1], 1)), sks[p1]))
        committee = [int(v) for v in M.acc.get_beacon_committee(chain.head_state, 1, 0)]
        data = chain.produce_attestation_data(0, 1)
        root = cfg.compute_signing_root(M.T.AttestationData.hash_tree_root(data),
                                        cfg.get_domain(1, M.params.DOMAIN_BEACON_ATTESTER, 1))
        chain.add_aggregate({"aggregation_bits": [True] * len(committee), "data": data,
                             "signature": B.sign_bytes(sum(sk_of[pks[v]] for v in committee), root)})
        p2 = proposer_at(M, chain, 2)
        chain.process_block(sign_block(M, cfg, chain.produce_block(2, randao(M, cfg, sks[p2], 2)), sks[p2]))
        got.append(([mon.summary_dict(i, 0) for i in range(N)], p1, p2, committee))
    assert got[1] == got[0]
    summaries, p1, p2, committee = got[1]
    assert summaries[p1]["blocks_proposed"] >= 1 and summaries[p2]["blocks_proposed"] >= 1
    assert all(summaries[v]["attestations_included"] == 1 and summaries[v]["attestation_min_delay_slots"] == 1
               for v in committee)


# -- the archiver --------------------------------------------------------------


def _grow(M, cfg, chain, sks, slots):
    roots = []
    for slot in slots:
        p = proposer_at(M, chain, slot)
        roots.append(chain.process_block(sign_block(M, cfg, chain.produce_block(slot, randao(M, cfg, sks[p], slot)),
                                                    sks[p])))
    return roots


def test_archiver_migrates_on_finality_equals_jax():
    sks, pks = keys(N)
    got = []
    for M in (J, P):
        cfg = cfg_of(M, altair=0)
        genesis = M.gen.create_genesis_state(cfg, pks, genesis_time=31)
        chain = M.chain.BeaconChain(cfg, genesis, db=M.db.BeaconDb(None, config=cfg))
        archiver = mod(M, "chain.archiver").Archiver(chain)
        roots = _grow(M, cfg, chain, sks, (1, 2, 3))
        # a side block at slot 2 on block 1: not canonical, pruned at finality
        side_state = chain.regen._get_post_state(roots[0].hex()).clone()
        M.slot.process_slots(side_state, 2)
        p = int(M.acc.get_beacon_proposer_index(side_state))
        side_block, _ = M.pb.produce_block(chain.regen._get_post_state(roots[0].hex()), 2,
                                           randao(M, cfg, sks[p], 2), graffiti=b"\x05" * 32)
        side_root = chain.process_block(sign_block(M, cfg, side_block, sks[p]))
        assert chain.db.block.has(side_root) and all(chain.db.block.has(r) for r in roots)
        chain.emitter.emit(M.emitter.ChainEvent.finalized, {"epoch": 1, "root": roots[-1]})
        archived = [chain.db.block_archive.get(s.to_bytes(8, "big")) for s in (1, 2, 3)]
        assert all(a is not None and a["message"]["slot"] == s for a, s in zip(archived, (1, 2, 3)))
        state_bytes = chain.db.state_archive.get(chain.db.state_archive.last_key())
        got.append((archiver.archived_blocks, archiver.pruned_blocks, archiver.archived_states,
                    [chain.db.block.has(r) for r in roots + [side_root]],
                    [cfg.get_fork_types(1)[1].serialize(a) for a in archived], state_bytes,
                    chain.db.get_block_anywhere(roots[0])["message"]["slot"]))
    assert got[1] == got[0]
    assert got[1][:4] == (3, 1, 1, [False] * 4)


# -- anchor-state selection -------------------------------------------------------


@pytest.fixture(scope="module")
def grown():
    """A JAX chain of five blocks and its head state's bytes."""
    sks, pks = keys(N)
    DB.set_backend(None)
    try:
        cfg = cfg_of(J, altair=0)
        chain = J.chain.BeaconChain(cfg, J.gen.create_genesis_state(cfg, pks, genesis_time=2))
        roots = _grow(J, cfg, chain, sks, range(1, 6))
        yield {"chain": chain, "roots": roots, "head_bytes": chain.head_state.serialize(),
               "mid_bytes": chain.regen._get_post_state(roots[2].hex()).serialize()}
    finally:
        DB.reset_backend()


def _source(M, grown, tmp_path, which):
    cfg = cfg_of(M, altair=0)
    IS = mod(M, "chain.init_state")
    genesis_fn = (lambda: M.gen.create_genesis_state(cfg, keys(N)[1], genesis_time=2))
    if which == "resume":
        db = M.db.BeaconDb(str(tmp_path / f"{M.pkg}-resume"), config=cfg)
        db.archive_state(3, grown["mid_bytes"])
        try:
            state, source = IS.init_beacon_state(cfg, db=db, checkpoint_state_bytes=grown["head_bytes"],
                                                 genesis_fn=lambda: pytest.fail("genesis must not be used"))
        finally:
            db.close()
    elif which == "checkpoint":
        state, source = IS.init_beacon_state(cfg, db=M.db.BeaconDb(None, config=cfg),
                                             checkpoint_state_bytes=grown["head_bytes"], genesis_fn=genesis_fn)
    else:
        state, source = IS.init_beacon_state(cfg, db=M.db.BeaconDb(None, config=cfg), genesis_fn=genesis_fn)
    return source, state.slot, state.serialize(), state.hash_tree_root()


@pytest.mark.parametrize("which", ["resume", "checkpoint", "genesis"])
def test_init_beacon_state_sources_equal_jax(grown, tmp_path, which):
    theirs, ours = _source(J, grown, tmp_path, which), _source(P, grown, tmp_path, which)
    assert ours == theirs
    assert ours[:2] == {"resume": ("resume", 3), "checkpoint": ("checkpoint", 5), "genesis": ("genesis", 0)}[which]
    if which == "checkpoint":
        assert ours[3] == grown["chain"].head_state.hash_tree_root()


def test_checkpoint_start_imports_on(grown):
    """A port chain anchored on the checkpoint state (the JAX chain's head)
    imports the JAX chain's next block."""
    sks, pks = keys(N)
    cfg = cfg_of(P, altair=0)
    state, source = mod(P, "chain.init_state").init_beacon_state(cfg, checkpoint_state_bytes=grown["head_bytes"])
    chain = P.chain.BeaconChain(cfg, state)
    ours = _grow(P, cfg, chain, sks, (6,))
    jax_chain = grown["chain"]
    jcfg = cfg_of(J, altair=0)
    fork = J.chain.BeaconChain(jcfg, J.state.BeaconState.deserialize(grown["head_bytes"], jcfg))
    theirs = _grow(J, jcfg, fork, sks, (6,))
    assert source == "checkpoint" and ours == theirs and jax_chain.head_state.slot == 5


def _corrupt(M, head_bytes, how):
    cfg = cfg_of(M, altair=0)
    state = M.state.BeaconState.deserialize(head_bytes, cfg)
    if how == "header_beyond":
        state.latest_block_header = dict(state.latest_block_header, slot=int(state.slot) + 1)
    elif how == "no_genesis_time":
        state.genesis_time = 0
    try:
        mod(M, "chain.init_state").state_from_checkpoint_bytes(
            cfg, state.serialize() if how != "truncated" else head_bytes[:1000])
        return None
    except Exception as e:  # noqa: BLE001 - compared across packages
        return type(e).__name__, str(e)


@pytest.mark.parametrize("how", ["header_beyond", "no_genesis_time", "truncated"])
def test_corrupt_checkpoints_refused_as_jax(grown, how):
    theirs, ours = _corrupt(J, grown["head_bytes"], how), _corrupt(P, grown["head_bytes"], how)
    assert ours is not None and ours[0] == theirs[0]
    if how != "truncated":
        assert ours == theirs


def test_no_source_and_url_path():
    cfg = cfg_of(P, altair=0)
    IS = mod(P, "chain.init_state")
    with pytest.raises(ValueError, match="no anchor source"):
        IS.init_beacon_state(cfg)
    with pytest.raises(NotImplementedError, match="7.3"):
        IS.init_beacon_state(cfg, checkpoint_sync_url="http://127.0.0.1:1")
    with pytest.raises(NotImplementedError, match="7.3"):
        IS.fetch_checkpoint_state(cfg, "http://127.0.0.1:1")
