"""The port's BeaconChain against the JAX package's on the same blocks.

One scenario runs on each package: a chain over the same genesis makes
its blocks with its own `produce_block` from its pools (aggregated
attestations of each slot's committees, a full sync aggregate from four
subnet contributions), signs them with the proposers' keys and imports
them with `process_block`, its signatures through an injected verifier
(`HostSets`: the host oracle on the wire sets, one verdict per distinct
set); a copy with a wrong attestation signature and one with a wrong
state root are refused.  The blocks, roots, heads, post-states,
fork-choice nodes, events, the sets handed to the verifier and the
rejections are held equal.  The port's roots run on
`DeviceMerkleBackend(device="cpu")`.
"""

import pytest

from lodestar_tpu_torch.crypto import bls as B
from lodestar_tpu_torch.crypto import curves as C

from test_torch_beacon_state import (  # noqa: F401  (fixtures)
    J,
    P,
    config,
    installed,
    world,
)

PRESET = P.params.ACTIVE_PRESET
SPE = PRESET.SLOTS_PER_EPOCH
SUBNETS = P.params.SYNC_COMMITTEE_SUBNET_COUNT
_VERDICTS = {}  # (indices, pubkeys, root, signature) -> bool, shared by both packages


class HostSets:
    """A verifier for either package's wire signature sets: each distinct
    set is checked once on the host oracle (fast_aggregate_verify)."""

    def __init__(self, pks):
        self.pks = pks
        self.jobs = []

    def verify_signature_sets(self, sets, opts=None):
        self.jobs.append([(s.type.value, tuple(s.indices), s.signing_root, s.signature, s.pubkeys)
                          for s in sets])
        ok = True
        for s in sets:
            key = (tuple(s.indices), s.pubkeys, s.signing_root, s.signature)
            if key not in _VERDICTS:
                pks = s.pubkeys if s.pubkeys else [self.pks[i] for i in s.indices]
                try:
                    verdict = B.fast_aggregate_verify(
                        [C.g1_decompress(pk) for pk in pks], s.signing_root, C.g2_decompress(s.signature))
                except Exception:  # noqa: BLE001 - an undecodable signature never verifies
                    verdict = False
                _VERDICTS[key] = verdict
            ok = ok and _VERDICTS[key]
        return ok


def _signing_root(M, state, domain_type, obj_root, slot):
    return state.config.compute_signing_root(obj_root, state.config.get_domain(slot, domain_type, slot))


def _feed_pools(M, chain, sk_of, slot: int) -> None:
    """Every committee of `slot` as one full aggregate into the aggregated
    pool, and the sync committee's four subnet contributions for the head
    root (each signed with the sum of its members' keys)."""
    head = chain.head_state
    head_root = chain.get_head_root()
    for index in range(M.acc.get_committee_count_per_slot(head, slot // SPE)):
        data = chain.produce_attestation_data(index, slot)
        committee = [int(v) for v in M.acc.get_beacon_committee(head, slot, index)]
        root = _signing_root(M, head, M.params.DOMAIN_BEACON_ATTESTER, M.T.AttestationData.hash_tree_root(data),
                             slot)
        sk = sum(sk_of[head.pubkeys[v]] for v in committee)
        chain.aggregated_attestation_pool.add(
            {"aggregation_bits": [True] * len(committee), "data": data, "signature": B.sign_bytes(sk, root)})
    root = _signing_root(M, head, M.params.DOMAIN_SYNC_COMMITTEE, head_root, slot)
    seats = head.current_sync_committee["pubkeys"]
    size = len(seats) // SUBNETS
    for subnet in range(SUBNETS):
        sk = sum(sk_of[pk] for pk in seats[subnet * size:(subnet + 1) * size])
        chain.sync_contribution_pool.add(
            {"slot": slot, "beacon_block_root": head_root, "subcommittee_index": subnet,
             "aggregation_bits": [True] * size, "signature": B.sign_bytes(sk, root)})


def _signed(M, chain, block, sk_of):
    pre = chain.head_state
    root = _signing_root(M, pre, M.params.DOMAIN_BEACON_PROPOSER,
                         chain._block_type(block["slot"]).hash_tree_root(block), block["slot"])
    return {"message": block, "signature": B.sign_bytes(sk_of[pre.pubkeys[block["proposer_index"]]], root)}


def _produce(M, chain, sk_of, slot: int):
    head = chain.head_state.clone()
    M.slot.process_slots(head, slot)
    proposer = M.acc.get_beacon_proposer_index(head)
    reveal = B.sign_bytes(sk_of[head.pubkeys[proposer]], _signing_root(
        M, head, M.params.DOMAIN_RANDAO, M.ssz.uint64.hash_tree_root(slot // SPE), slot))
    return chain.produce_block(slot, reveal)


def _fc_nodes(chain):
    return [(n.root, n.parent, n.slot, n.justified_epoch, n.finalized_epoch, n.weight)
            for n in chain.fork_choice.proto.nodes]


def _run(M, w, tmp_path):
    """The scenario on package M: blocks at slots 1..3, a tampered
    signature and a tampered root at slot 4, then the real block 4."""
    sk_of = dict(zip(w.pks, w.sks))
    anchor = M.gen.create_genesis_state(config(M), w.pks, genesis_time=1234)
    db = M.db.BeaconDb(str(tmp_path / M.pkg))
    verifier = HostSets(w.pks)
    chain = M.chain.BeaconChain(config(M), anchor, db=db, bls_verifier=verifier)
    events = []
    E = M.emitter.ChainEvent
    chain.emitter.on(E.block, lambda s, r: events.append(("block", bytes(r))))
    chain.emitter.on(E.head, lambda r, s: events.append(("head", bytes(r), int(s))))
    phases = []
    chain.phase_timer = type("T", (), {"observe": lambda self, n, s: phases.append(n)})()
    out = {"blocks": [], "roots": [], "states": [], "rejected": []}
    P.blk.reset_host_signature_checks()
    for slot in (1, 2, 3, 4):
        if slot > 1:
            _feed_pools(M, chain, sk_of, slot - 1)
        block = _produce(M, chain, sk_of, slot)
        if slot == 4:
            head = chain.head_root_hex
            n_nodes = len(chain.fork_choice.proto.nodes)
            att = block["body"]["attestations"][0]
            wrong_sig = dict(block, body=dict(block["body"], attestations=[
                dict(att, signature=block["body"]["sync_aggregate"]["sync_committee_signature"])]
                + block["body"]["attestations"][1:]))
            for bad in (wrong_sig, dict(block, state_root=b"\x01" * 32)):
                try:
                    chain.process_block(_signed(M, chain, bad, sk_of))
                    out["rejected"].append(None)
                except Exception as e:  # noqa: BLE001 - compared across packages
                    out["rejected"].append((type(e).__name__, str(e).split(":")[0]))
                assert chain.head_root_hex == head
                assert len(chain.fork_choice.proto.nodes) == n_nodes
        signed = _signed(M, chain, block, sk_of)
        root = chain.process_block(signed, timely=True)
        assert chain.head_root_hex == root.hex()
        out["blocks"].append(chain._block_type(slot).serialize(block))
        out["roots"].append(root)
        out["states"].append(chain.head_state.serialize())
    assert block["body"]["sync_aggregate"]["sync_committee_bits"] == [True] * PRESET.SYNC_COMMITTEE_SIZE
    # the aggregated pool keeps each slot's aggregates includable for an epoch
    assert [a["data"]["slot"] for a in block["body"]["attestations"]] == [1, 2, 3]
    out["head_root"] = chain.head_state.hash_tree_root()
    out["nodes"] = _fc_nodes(chain)
    out["events"] = events
    out["jobs"] = verifier.jobs
    out["phases"] = phases
    out["imported"] = chain.imported_blocks
    out["governor"] = {k: v for k, v in chain.memory_governor.status().items()
                       if k in ("evictions", "pressure_events", "entries")}
    db.close()
    return out


def test_chain_imports_the_same_blocks_as_jax(installed, tmp_path):
    w = installed
    theirs = _run(J, w, tmp_path)
    ours = _run(P, w, tmp_path)
    assert P.blk.host_signature_checks() == 0  # every set went to the verifier
    for key in theirs:
        assert ours[key] == theirs[key], key
    assert ours["rejected"] == [("ValueError", "block signature verification failed"),
                                ("BlockProcessError", "state root mismatch at slot 4")]
    assert ours["imported"] == 4
    assert {"validation", "signature_verify", "stf", "state_root", "fork_choice"} <= set(ours["phases"])
    assert w.backend.m_dispatches.get("htr_forest_sweep") > 0


def test_chain_without_a_verifier_checks_in_the_transition(installed, tmp_path):
    """No verifier: the proposer and the randao reveal are checked on the
    host inside the state transition, as in the JAX package."""
    w = installed
    sk_of = dict(zip(w.pks, w.sks))
    roots = []
    for M in (J, P):
        chain = M.chain.BeaconChain(config(M), M.gen.create_genesis_state(config(M), w.pks, genesis_time=1234))
        block = _produce(M, chain, sk_of, 1)
        P.blk.reset_host_signature_checks()
        roots.append(chain.process_block(_signed(M, chain, block, sk_of)))
        with pytest.raises(M.blk.BlockProcessError):
            bad = _produce(M, chain, sk_of, 2)
            chain.process_block({"message": bad, "signature": _signed(M, chain, bad, sk_of)["signature"][::-1]})
    assert roots[0] == roots[1]
    assert P.blk.host_signature_checks() >= 2


def test_unported_legs_raise(installed):
    w = installed
    anchor = P.gen.create_genesis_state(config(P), w.pks[:8] * 4, genesis_time=1)
    with pytest.raises(NotImplementedError, match="7.1b"):
        P.chain.BeaconChain(config(P), anchor, execution=object())
    with pytest.raises(NotImplementedError, match="7.1c"):
        P.chain.BeaconChain(config(P), anchor, kzg_setup=object())
    chain = P.chain.BeaconChain(config(P), anchor)
    with pytest.raises(NotImplementedError, match="7.1d"):
        chain.produce_blinded_block(1, b"\x00" * 96)
    with pytest.raises(NotImplementedError, match="7.1c"):
        chain.on_blob_sidecar(b"\x00" * 32, 0, b"\x00" * 48)
    # a payload with no engine wired is rejected, as in the JAX package
    with pytest.raises(ValueError, match="no engine wired"):
        chain._verify_execution_payload({"body": {"execution_payload": {}}})


def test_op_pools_equal_jax(installed):
    """The five pools on the same inputs: naive aggregation by data root,
    the block's attestations, slashings and exits, sync contributions."""
    w = installed
    sj, sp = w.gj.clone(), w.gp.clone()
    J.slot.process_slots(sj, 2)
    P.slot.process_slots(sp, 2)
    outs = []
    for M, st in ((J, sj), (P, sp)):
        data = {"slot": 1, "index": 0, "beacon_block_root": b"\x05" * 32,
                "source": dict(st.current_justified_checkpoint), "target": {"epoch": 0, "root": b"\x06" * 32}}
        pool, agg_pool = M.pools.AttestationPool(), M.pools.AggregatedAttestationPool()
        res = []
        for pos in (0, 1, 1):
            sig = B.sign_bytes(w.sks[pos], b"\x07" * 32)
            res.append(pool.add({"aggregation_bits": [i == pos for i in range(4)], "data": data, "signature": sig}))
        agg = pool.get_aggregate(1, M.T.AttestationData.hash_tree_root(data))
        res += [agg_pool.add(agg), agg_pool.add(agg), agg["signature"]]
        res.append(agg_pool.get_attestations_for_block(st))
        ops = M.pools.OpPool()
        sl = {"attestation_1": {"attesting_indices": [3, 5], "data": data, "signature": b"\x00" * 96},
              "attestation_2": {"attesting_indices": [5, 9], "data": dict(data, index=1), "signature": b"\x00" * 96}}
        res += [ops.insert_attester_slashing(sl), ops.insert_attester_slashing(sl),
                M.pools.attester_slashing_intersection(sl)]
        ops.insert_voluntary_exit({"message": {"epoch": 0, "validator_index": 7}, "signature": b"\x00" * 96})
        res.append(ops.get_slashings_and_exits(st))
        msgs = M.pools.SyncCommitteeMessagePool()
        res.append(msgs.add(0, {"slot": 1, "beacon_block_root": b"\x05" * 32, "validator_index": 2,
                                "signature": B.sign_bytes(w.sks[2], b"\x08" * 32)}, 3))
        res.append(msgs.get_contribution(0, 1, b"\x05" * 32))
        outs.append(res)
    assert outs[1] == outs[0]


def test_emitter_and_job_queue_equal_jax():
    seen = []
    for M in (J, P):
        em = M.emitter.ChainEventEmitter()
        got = []
        em.on(M.emitter.ChainEvent.head, lambda *a: got.append(a))
        em.on(M.emitter.ChainEvent.head, lambda *a: 1 / 0)  # an isolated bad listener
        em.emit(M.emitter.ChainEvent.head, b"\x01" * 32, 3)
        q = M.queue.JobItemQueue(lambda x: x * 2, max_length=2, queue_type=M.queue.QueueType.FIFO)
        futs = [q.push(i) for i in range(2)]
        got.append([f.result(timeout=10) for f in futs])
        q.stop()
        seen.append(got)
    assert seen[0] == seen[1] == [(b"\x01" * 32, 3), [0, 2]]


def test_block_processor_equals_jax(installed):
    """The queued segment import over the verifier: a valid segment of two
    blocks, then a block with a flipped signature bit refused with the
    same code, the state view's roots restored, as the JAX package's."""
    w = installed
    out = []
    for M in (J, P):
        cfg = config(M)
        cache = M.st.EpochCache(w.pks, epoch=0, seed=b"\x07" * 32)
        genesis_root = b"\x33" * 32
        view = M.sigsets.BeaconStateView(cfg, 1, cache, block_roots={0: genesis_root})
        fc = M.fc.ForkChoice(M.fc.ProtoArray(genesis_root.hex()), genesis_root.hex())
        db = M.db.BeaconDb(None)
        proc = M.bp.BlockProcessor(view, HostSets(w.pks), fork_choice=fc, db=db)

        def make(slot, proposer, parent):
            body = M.T.BeaconBlockBodyAltair.default()
            body["randao_reveal"] = B.sign_bytes(w.sks[proposer], cfg.compute_signing_root(
                M.T.Epoch.hash_tree_root(0), cfg.get_domain(1, M.params.DOMAIN_RANDAO, slot)))
            block = {"slot": slot, "proposer_index": proposer, "parent_root": parent, "state_root": bytes(32),
                     "body": body}
            sig = B.sign_bytes(w.sks[proposer], cfg.compute_signing_root(
                M.T.BeaconBlockAltair.hash_tree_root(block), cfg.get_domain(1, M.params.DOMAIN_BEACON_PROPOSER,
                                                                            slot)))
            return {"message": block, "signature": sig}

        try:
            b1 = make(1, 3, genesis_root)
            r1 = M.T.BeaconBlockAltair.hash_tree_root(b1["message"])
            b2 = make(2, 4, r1)
            roots = proc.process_blocks([b1, b2]).result(timeout=60)
            bad = make(3, 5, roots[-1])
            sig = bytearray(bad["signature"])
            sig[10] ^= 1
            with pytest.raises(M.bp.BlockError) as err:
                proc.process_blocks([dict(bad, signature=bytes(sig))]).result(timeout=60)
            out.append((roots, proc.imported, err.value.code, view.get_block_root_at_slot(1),
                        view.get_block_root_at_slot(3), fc.has_block(r1.hex())))
        finally:
            proc.close()
    assert out[1] == out[0]
    assert out[1][1:3] == (2, "INVALID_SIGNATURE")
