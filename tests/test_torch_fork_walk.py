"""The port's BeaconChain walked from a phase0 genesis through every fork
against the JAX package's on the same blocks.

Each package's chain starts from the same phase0 genesis (altair at epoch
1, bellatrix 2, capella 3, deneb 4; validator 0 holds 1 ETH over
MAX_EFFECTIVE_BALANCE), with its own `ExecutionEngineMock`, and imports
the blocks at slots 31 (phase0: PendingAttestations), 32 (the phase0
epoch, then `upgrade_to_altair`), 64 (bellatrix: the merge block, its
payload from the engine), 96 (capella: a BLS-to-execution change for
validator 0 from the op pool) and 128 (deneb: the payload's withdrawal
skims validator 0's excess).  Each block is made by the chain's own
`produce_block` from its pools, its proposer taken from
`get_proposer_duties`, signed and imported by `process_block`, its
signatures through `HostSets`.  Before the last import a copy with a
swapped attestation signature, one with a wrong state root and the block
itself during an engine outage are refused without moving the head.  The
blocks, roots, post-states (SSZ bytes), heads, fork-choice nodes, events,
the verifier's jobs, the refusals and the engines' block trees are held
equal.  The port runs on its host merkle path (many slots); its end state
is held on the CPU device backend with `cold_root`.
"""

import numpy as np
import pytest

from lodestar_tpu_torch.crypto import bls as B

from test_torch_beacon_state import J, P, cold_root, cpu_backend, keys
from test_torch_chain import HostSets, _signing_root
from lodestar_tpu_torch.ssz import device_backend as DB

PRESET = P.params.ACTIVE_PRESET
SPE = PRESET.SLOTS_PER_EPOCH
N = 16
SLOTS = (31, 32, 64, 96, 128)
FORKS = {"altair": 1, "bellatrix": 2, "capella": 3, "deneb": 4}
# the validator whose turn in the withdrawal sweep the deneb block reaches
# (the capella block's sweep advanced the cursor by one sweep)
WITHDRAWER = PRESET.MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP % N


def walk_config(M):
    epochs = {getattr(M.params.ForkName, k): v for k, v in FORKS.items()}
    return M.config.create_chain_config(M.config.MAINNET_CHAIN_CONFIG, fork_epochs=epochs)


def balances(n=N):
    out = [PRESET.MAX_EFFECTIVE_BALANCE] * n
    out[WITHDRAWER] += 10**9
    return out


@pytest.fixture(scope="module")
def walk_keys():
    return keys(N)


def _feed(M, chain, sk_of, slot):
    """The non-empty committees of the two slots before `slot` as full
    aggregates, and the sync committee's four contributions for the head
    (from altair on)."""
    head = chain.head_state
    for att_slot in (slot - 2, slot - 1):
        for index in range(M.acc.get_committee_count_per_slot(head, att_slot // SPE)):
            committee = [int(v) for v in M.acc.get_beacon_committee(head, att_slot, index)]
            if not committee:
                continue
            data = chain.produce_attestation_data(index, att_slot)
            root = _signing_root(M, head, M.params.DOMAIN_BEACON_ATTESTER,
                                 M.T.AttestationData.hash_tree_root(data), att_slot)
            sk = sum(sk_of[head.pubkeys[v]] for v in committee)
            chain.aggregated_attestation_pool.add(
                {"aggregation_bits": [True] * len(committee), "data": data, "signature": B.sign_bytes(sk, root)})
    if head.fork_name == M.params.ForkName.phase0:
        return
    head_root = chain.get_head_root()
    root = _signing_root(M, head, M.params.DOMAIN_SYNC_COMMITTEE, head_root, slot - 1)
    seats = head.current_sync_committee["pubkeys"]
    size = len(seats) // M.params.SYNC_COMMITTEE_SUBNET_COUNT
    for subnet in range(M.params.SYNC_COMMITTEE_SUBNET_COUNT):
        sk = sum(sk_of[pk] for pk in seats[subnet * size:(subnet + 1) * size])
        chain.sync_contribution_pool.add(
            {"slot": slot - 1, "beacon_block_root": head_root, "subcommittee_index": subnet,
             "aggregation_bits": [True] * size, "signature": B.sign_bytes(sk, root)})


def _bls_change(M, cfg, chain, sks, pks):
    change = {"validator_index": WITHDRAWER, "from_bls_pubkey": pks[WITHDRAWER],
              "to_execution_address": b"\xaa" * 20}
    domain = cfg.compute_domain(M.params.DOMAIN_BLS_TO_EXECUTION_CHANGE, cfg.fork_versions[M.params.ForkName.phase0],
                                chain.head_state.genesis_validators_root)
    root = cfg.compute_signing_root(M.T.BLSToExecutionChange.hash_tree_root(change), domain)
    return {"message": change, "signature": B.sign_bytes(sks[WITHDRAWER], root)}


def _produce(M, cfg, chain, sk_of, slot):
    epoch = slot // SPE
    duty = next(d for d in chain.get_proposer_duties(epoch) if d["slot"] == slot)
    sk = sk_of[duty["pubkey"]]
    reveal = B.sign_bytes(sk, cfg.compute_signing_root(M.ssz.uint64.hash_tree_root(epoch),
                                                       cfg.get_domain(slot, M.params.DOMAIN_RANDAO, slot)))
    block = chain.produce_block(slot, reveal)
    assert block["proposer_index"] == duty["validator_index"]
    return block, sk


def _sign(M, cfg, chain, block, sk):
    slot = block["slot"]
    root = cfg.compute_signing_root(chain._block_type(slot).hash_tree_root(block),
                                    cfg.get_domain(slot, M.params.DOMAIN_BEACON_PROPOSER, slot))
    return {"message": block, "signature": B.sign_bytes(sk, root)}


def run_walk(M, sks, pks, tmp_path):
    cfg = walk_config(M)
    sk_of = dict(zip(pks, sks))
    anchor = M.gen.create_genesis_state(cfg, pks, genesis_time=1234, balances=balances())
    assert anchor.fork_name == M.params.ForkName.phase0
    el = M.execution.ExecutionEngineMock()
    db = M.db.BeaconDb(str(tmp_path / M.pkg), config=cfg)
    chain = M.chain.BeaconChain(cfg, anchor, db=db, bls_verifier=HostSets(pks), execution=el)
    events = []
    E = M.emitter.ChainEvent
    chain.emitter.on(E.block, lambda s, r: events.append(("block", bytes(r))))
    chain.emitter.on(E.head, lambda r, s: events.append(("head", bytes(r), int(s))))
    out = {"blocks": [], "roots": [], "states": [], "forks": [], "refused": [], "translated": None}
    for slot in SLOTS:
        _feed(M, chain, sk_of, slot)
        if slot == 96:
            chain.op_pool.insert_bls_to_execution_change(_bls_change(M, cfg, chain, sks, pks))
        if slot == 32:
            # epoch 0's records, translated by the upgrade into the altair flags
            last_phase0 = chain.head_state.clone()
        block, sk = _produce(M, cfg, chain, sk_of, slot)
        body = block["body"]
        if slot == SLOTS[-1]:
            head, n_nodes = chain.head_root_hex, len(chain.fork_choice.proto.nodes)
            att = body["attestations"][0]
            swapped = dict(block, body=dict(body, attestations=[
                dict(att, signature=body["sync_aggregate"]["sync_committee_signature"])] + body["attestations"][1:]))
            copies = [("signature", swapped, None), ("state_root", dict(block, state_root=b"\x01" * 32), None),
                      ("engine", block, M.execution.ExecutePayloadStatus.UNAVAILABLE)]
            for label, copy, fail in copies:
                el.fail_with = fail
                try:
                    chain.process_block(_sign(M, cfg, chain, copy, sk))
                    out["refused"].append((label, None))
                except Exception as e:  # noqa: BLE001 - compared across packages
                    out["refused"].append((label, type(e).__name__, str(e).split(":")[0]))
                finally:
                    el.fail_with = None
                assert chain.head_root_hex == head
                assert len(chain.fork_choice.proto.nodes) == n_nodes
        root = chain.process_block(_sign(M, cfg, chain, block, sk), timely=True)
        assert chain.head_root_hex == root.hex()
        post = chain.head_state
        out["forks"].append((cfg.get_fork_name(slot).value, post.fork_name.value))
        out["blocks"].append(chain._block_type(slot).serialize(block))
        out["roots"].append(root)
        out["states"].append(post.serialize())
        if slot == 32:
            # every epoch-0 attester of block 31's records carries the flags
            # its timely record earns (source and target; head at an
            # inclusion delay of 1); no one else carries any
            records = last_phase0.current_epoch_attestations
            want = np.zeros(N, np.uint8)
            for rec in records:
                mask = M.ph0.attesting_mask(last_phase0, [rec])
                want[mask] |= 0b011 | (0b100 if int(rec["inclusion_delay"]) == 1 else 0)
            upgraded = last_phase0.clone()
            M.slot.process_slots(upgraded, 32)
            out["translated"] = upgraded.previous_epoch_participation.tolist()
            assert records and want.any()
            assert np.array_equal(upgraded.previous_epoch_participation, want)
        if slot == 128:
            payload = body["execution_payload"]
            out["withdrawals"] = [(w["validator_index"], w["amount"]) for w in payload["withdrawals"]]
    out["head"] = chain.head_root_hex
    out["el_head"] = el.head
    out["payload_head"] = bytes(chain.head_state.latest_execution_payload_header["block_hash"])
    out["el_blocks"] = sorted(el.valid_blocks.items())
    out["optimistic"] = sorted(chain.optimistic_roots)
    out["head_status"] = chain.fork_choice.get_execution_status(chain.head_root_hex)
    out["nodes"] = [(n.root, n.parent, n.slot, n.justified_epoch, n.finalized_epoch, n.weight,
                     n.execution_status, n.execution_block_hash) for n in chain.fork_choice.proto.nodes]
    out["events"] = events
    out["jobs"] = chain.bls.jobs
    out["end_state"] = chain.head_state
    db.close()
    return out


@pytest.fixture(scope="module")
def walks(walk_keys, tmp_path_factory):
    sks, pks = walk_keys
    tmp = tmp_path_factory.mktemp("walk")
    DB.set_backend(None)
    try:
        theirs = run_walk(J, sks, pks, tmp)
        P.blk.reset_host_signature_checks()
        ours = run_walk(P, sks, pks, tmp)
        ours["host_checks"] = P.blk.host_signature_checks()
    finally:
        DB.reset_backend()
    return theirs, ours


@pytest.mark.parametrize("key", ["blocks", "roots", "states", "forks", "refused", "translated", "withdrawals",
                                 "head", "el_head", "payload_head", "el_blocks", "optimistic", "head_status",
                                 "nodes", "events", "jobs"])
def test_walk_equals_jax(walks, key):
    theirs, ours = walks
    assert ours[key] == theirs[key]


def test_walk_crosses_every_fork_on_schedule(walks):
    _theirs, ours = walks
    assert ours["forks"] == [("phase0", "phase0"), ("altair", "altair"), ("bellatrix", "bellatrix"),
                             ("capella", "capella"), ("deneb", "deneb")]
    assert ours["refused"] == [("signature", "ValueError", "block signature verification failed"),
                               ("state_root", "BlockProcessError", "state root mismatch at slot 128"),
                               ("engine", "ExecutionEngineUnavailable", "EL outage")]
    assert ours["host_checks"] == 0  # every set went to the verifier
    # the head's payload is the engine's head, imported VALID (not optimistic)
    assert ours["payload_head"] == ours["el_head"] != b"\x00" * 32
    assert ours["optimistic"] == [] and ours["head_status"] == "Valid"
    # the deneb payload skims the withdrawer's excess, now at 0x01 credentials
    # (its 1 ETH less the net penalties of the slots whose committees are
    # empty at 16 validators), and leaves it near MAX
    assert [v for v, _ in ours["withdrawals"]] == [WITHDRAWER] and ours["withdrawals"][0][1] > 9 * 10**8
    end = ours["end_state"]
    assert bytes(end.withdrawal_credentials[WITHDRAWER][:1]) == P.params.ETH1_ADDRESS_WITHDRAWAL_PREFIX
    assert int(end.balances[WITHDRAWER]) < PRESET.MAX_EFFECTIVE_BALANCE + 10**7


def test_walk_end_state_root_on_the_cpu_backend(walks):
    theirs, ours = walks
    assert cold_root(ours["end_state"], cpu_backend()) == theirs["end_state"].hash_tree_root()


def test_walk_end_state_carries_across(walks):
    theirs, ours = walks
    moved = P.state.BeaconState.deserialize(theirs["states"][-1], walk_config(P))
    assert moved.serialize() == ours["states"][-1]
    back = J.state.BeaconState.deserialize(ours["states"][-1], walk_config(J))
    assert back.hash_tree_root() == ours["end_state"].hash_tree_root()
    assert np.array_equal(moved.balances, ours["end_state"].balances)
