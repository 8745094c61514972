"""The port's state transition against the JAX package's, byte for byte.

Both packages start from the same genesis (tests/test_torch_beacon_state.py)
and run the same slots, blocks and operations; every step's state is held
by its SSZ bytes and its root, every verdict (raise or not) by equality.
Slot runs of more than a few slots take the port's host merkle path (an
explicit opt-out) and hold the end state on `DeviceMerkleBackend("cpu")`.
"""

import hashlib

import numpy as np
import pytest

from lodestar_tpu_torch.crypto import bls as B
from lodestar_tpu_torch.crypto import curves as C

from test_torch_beacon_state import (  # noqa: F401  (fixtures)
    J,
    P,
    cold_root,
    config,
    host_path,
    installed,
    same,
    world,
)

PRESET = P.params.ACTIVE_PRESET
SPE = PRESET.SLOTS_PER_EPOCH


def _both(fn):
    """fn(M, state) on the JAX state and the port state of a pair; the
    outcomes (the raise, its type) are held equal and the states after."""
    def run(pair):
        out = []
        for M, st in zip((J, P), pair):
            try:
                fn(M, st)
                out.append(None)
            except Exception as e:  # noqa: BLE001 - compared below
                out.append(type(e).__name__)
        assert out[0] == out[1], out
        assert pair[1].serialize() == pair[0].serialize()
        return out[0]
    return run


def _pair(w, slot: int):
    sj, sp = w.gj.clone(), w.gp.clone()
    if slot:
        J.slot.process_slots(sj, slot)
        P.slot.process_slots(sp, slot)
    return [sj, sp]


def _sign(M, state, sk, domain_type, obj_root, slot=None):
    cfg = state.config
    domain = cfg.get_domain(state.slot, domain_type, slot)
    return B.sign_bytes(sk, cfg.compute_signing_root(obj_root, domain))


def test_process_slots_across_an_epoch_boundary(host_path):
    w = host_path
    pair = _pair(w, SPE - 2)
    for target in (SPE - 1, SPE, SPE + 1):
        J.slot.process_slots(pair[0], target)
        P.slot.process_slots(pair[1], target)
        same(*pair)
    assert cold_root(pair[1], w.backend) == pair[0].hash_tree_root()


def _attest_head(M, post, head_root):
    slot = post.slot
    epoch = slot // SPE
    start = epoch * SPE
    target = head_root if start >= post.slot else M.acc.get_block_root_at_slot(post, start)
    return [
        {
            "aggregation_bits": [True] * len(M.acc.get_beacon_committee(post, slot, i)),
            "data": {"slot": slot, "index": i, "beacon_block_root": head_root,
                     "source": dict(post.current_justified_checkpoint),
                     "target": {"epoch": epoch, "root": target}},
            "signature": bytes([0xC0]) + b"\x00" * 95,
        }
        for i in range(M.acc.get_committee_count_per_slot(post, epoch))
    ]


def test_blocks_with_attestations_justify_and_finalize(host_path):
    """produce_block over four epochs with full participation (signatures
    unchecked): every block and post-state equal, the rewards, the
    justification and finalization of epoch.py included."""
    w = host_path
    states = [w.gj, w.gp]
    heads = [None, None]
    for slot in range(1, 4 * SPE + 2):
        posts = []
        for k, M in enumerate((J, P)):
            atts = _attest_head(M, states[k], heads[k]) if heads[k] is not None else []
            reveal = hashlib.sha256(b"reveal-%d" % slot).digest() * 3
            block, post = M.pb.produce_block(states[k], slot, reveal, attestations=atts)
            heads[k] = M.T.BeaconBlockAltair.hash_tree_root(block)
            posts.append(post)
        assert heads[0] == heads[1]
        states = posts
        if slot % SPE in (0, 1):
            same(*states)
    same(*states)
    sp = states[1]
    assert int(sp.finalized_checkpoint["epoch"]) >= 1
    assert int(sp.current_justified_checkpoint["epoch"]) >= 2
    assert (sp.balances != w.gp.balances).any()
    assert cold_root(sp, w.backend) == states[0].hash_tree_root()
    # the unrealized checkpoints fork choice reads
    uj = J.ep.compute_unrealized_checkpoints(states[0])
    up = P.ep.compute_unrealized_checkpoints(sp)
    assert up == uj


def test_operations_with_signatures(installed):
    """Each operation kind through block.py with its signature checked on
    the host, in both packages: proposer and attester slashings, a
    deposit (new key and top-up), a voluntary exit, an attestation and a
    sync aggregate; a bad signature of each is refused by both."""
    w = installed
    sks, pks = w.sks, w.pks
    pair = _pair(w, 2)
    P.blk.reset_host_signature_checks()

    # proposer slashing of validator 12
    def header(body):
        return {"slot": 1, "proposer_index": 12, "parent_root": b"\x01" * 32,
                "state_root": b"\x02" * 32, "body_root": body}

    def signed_header(M, st, h, sk):
        return {"message": h, "signature": _sign(M, st, sk, M.params.DOMAIN_BEACON_PROPOSER,
                                                 M.T.BeaconBlockHeader.hash_tree_root(h), 1)}

    h1, h2 = header(b"\x03" * 32), header(b"\x04" * 32)
    bad = lambda M, st: M.blk.process_proposer_slashing(  # noqa: E731
        st, {"signed_header_1": signed_header(M, st, h1, sks[12]),
             "signed_header_2": signed_header(M, st, h2, sks[13])}, True)
    assert _both(bad)(pair) == "BlockProcessError"
    good = lambda M, st: M.blk.process_proposer_slashing(  # noqa: E731
        st, {"signed_header_1": signed_header(M, st, h1, sks[12]),
             "signed_header_2": signed_header(M, st, h2, sks[12])}, True)
    assert _both(good)(pair) is None
    assert bool(pair[1].slashed[12])

    # attester slashing: a double vote by 5 (3 and 9 sign one side each)
    data1 = {"slot": 0, "index": 0, "beacon_block_root": b"\x0a" * 32,
             "source": {"epoch": 0, "root": b"\x00" * 32}, "target": {"epoch": 0, "root": b"\x0b" * 32}}
    data2 = dict(data1, beacon_block_root=b"\x0c" * 32)

    def indexed(M, st, idx, data):
        root = M.T.AttestationData.hash_tree_root(data)
        sigs = [B.sign(sks[i], st.config.compute_signing_root(
            root, st.config.get_domain(st.slot, M.params.DOMAIN_BEACON_ATTESTER, 0))) for i in idx]
        return {"attesting_indices": idx, "data": data,
                "signature": C.g2_compress(B.aggregate_signatures(sigs))}

    def att_slashing(M, st):
        M.blk.process_attester_slashing(st, {"attestation_1": indexed(M, st, [3, 5], data1),
                                             "attestation_2": indexed(M, st, [5, 9], data2)}, True)

    assert _both(att_slashing)(pair) is None
    assert bool(pair[1].slashed[5]) and not bool(pair[1].slashed[3])

    # deposits: a new key (signature checked even unverified blocks) and a top-up
    new_sk = B.keygen(np.random.default_rng(3).bytes(32))
    new_pk = C.g1_compress(B.sk_to_pk(new_sk))
    dep = {"pubkey": new_pk, "withdrawal_credentials": b"\x00" * 32,
           "amount": PRESET.MAX_EFFECTIVE_BALANCE, "signature": b"\x00" * 96}
    dep["signature"] = B.sign_bytes(new_sk, P.blk.get_deposit_signing_root(pair[1].config, dep))
    topup = {"pubkey": pks[0], "withdrawal_credentials": b"\x00" * 32, "amount": 5 * 10**9,
             "signature": b"\x00" * 96}

    def deposits(M, st):
        tree = M.gen.DepositTree()
        tree.push(dep)
        tree.push(topup)
        st.eth1_data = {"deposit_root": tree.root(), "deposit_count": 2, "block_hash": b"\x11" * 32}
        st.eth1_deposit_index = 0
        M.blk.process_deposit(st, {"proof": tree.proof(0), "data": dep})
        M.blk.process_deposit(st, {"proof": tree.proof(1), "data": topup})

    assert _both(deposits)(pair) is None
    assert pair[1].num_validators == len(pks) + 1

    # a sync aggregate of every seat, then one signed by a wrong key
    def sync(M, st, wrong=False):
        prev = st.slot - 1
        root = st.config.compute_signing_root(
            M.acc.get_block_root_at_slot(st, prev),
            st.config.get_domain(st.slot, M.params.DOMAIN_SYNC_COMMITTEE, prev))
        sk_of = dict(zip(pks, sks))
        total = sum(sk_of[pk] for pk in st.current_sync_committee["pubkeys"])
        sig = B.sign(total + (1 if wrong else 0), root)
        M.blk.process_sync_aggregate(st, {"sync_committee_bits": [True] * PRESET.SYNC_COMMITTEE_SIZE,
                                          "sync_committee_signature": C.g2_compress(sig)}, True)

    assert _both(lambda M, st: sync(M, st, wrong=True))(pair) == "BlockProcessError"
    assert _both(sync)(pair) is None

    # an attestation of slot 1's committee with its aggregate signature
    def attest(M, st):
        committee = [int(v) for v in M.acc.get_beacon_committee(st, 1, 0)]
        data = {"slot": 1, "index": 0, "beacon_block_root": M.acc.get_block_root_at_slot(st, 1),
                "source": dict(st.current_justified_checkpoint),
                "target": {"epoch": 0, "root": M.acc.get_block_root_at_slot(st, 0)}}
        ind = indexed(M, st, committee, data)
        M.blk.process_attestation(st, {"aggregation_bits": [True] * len(committee), "data": data,
                                       "signature": ind["signature"]}, True)

    assert _both(attest)(pair) is None
    assert P.blk.host_signature_checks() > 0

    # a voluntary exit of validator 0, the chain aged past SHARD_COMMITTEE_PERIOD
    def exit_(M, st, signer):
        ep = st.config.SHARD_COMMITTEE_PERIOD
        st.slot = ep * SPE
        msg = {"epoch": ep, "validator_index": 0}
        sig = _sign(M, st, sks[signer], M.params.DOMAIN_VOLUNTARY_EXIT,
                    M.T.VoluntaryExit.hash_tree_root(msg), ep * SPE)
        M.blk.process_voluntary_exit(st, {"message": msg, "signature": sig}, True)

    assert _both(lambda M, st: exit_(M, st, 1))(pair) == "BlockProcessError"
    assert _both(lambda M, st: exit_(M, st, 0))(pair) is None
    assert int(pair[1].exit_epoch[0]) != P.params.FAR_FUTURE_EPOCH
    same(*pair)


def test_capella_withdrawals_and_bls_changes(host_path):
    """At the block.py level on a capella state: a BLS-to-execution change
    (signed against the genesis fork), then a payload whose withdrawals
    the protocol expects; a payload with a wrong withdrawal is refused."""
    w = host_path
    forks = {"bellatrix": 1, "capella": 1}
    pair = [J.gen.create_genesis_state(config(J, **forks), w.pks, genesis_time=1234),
            P.gen.create_genesis_state(config(P, **forks), w.pks, genesis_time=1234)]
    J.slot.process_slots(pair[0], SPE + 1)
    P.slot.process_slots(pair[1], SPE + 1)

    def change(M, st, v, signer):
        msg = {"validator_index": v, "from_bls_pubkey": w.pks[v], "to_execution_address": bytes([v]) * 20}
        domain = st.config.compute_domain(M.params.DOMAIN_BLS_TO_EXECUTION_CHANGE,
                                          st.config.fork_versions[M.params.ForkName.phase0],
                                          st.genesis_validators_root)
        sig = B.sign_bytes(w.sks[signer], st.config.compute_signing_root(
            M.T.BLSToExecutionChange.hash_tree_root(msg), domain))
        M.blk.process_bls_to_execution_change(st, {"message": msg, "signature": sig}, True)

    assert _both(lambda M, st: change(M, st, 4, 5))(pair) == "BlockProcessError"
    for v in (4, 6):
        assert _both(lambda M, st: change(M, st, v, v))(pair) is None
    for st in pair:
        st.balances[4] += 3 * 10**9
        st.balances[6] += 10**9
    expected = P.blk.get_expected_withdrawals(pair[1])
    assert expected == J.blk.get_expected_withdrawals(pair[0])
    assert [e["validator_index"] for e in expected] == [4, 6]
    _both(lambda M, st: M.blk.process_withdrawals(st, {"withdrawals": [dict(expected[0], amount=1)]}))(pair)
    assert _both(lambda M, st: M.blk.process_withdrawals(st, {"withdrawals": expected}))(pair) is None
    assert pair[1].next_withdrawal_index == 2

    def payload(M, st):
        p = dict(M.T.ExecutionPayloadCapella.default())
        p.update(block_hash=b"\x77" * 32, timestamp=st.genesis_time + st.slot * M.params.SECONDS_PER_SLOT,
                 prev_randao=M.acc.get_randao_mix(st, st.slot // SPE), withdrawals=[])
        M.blk.process_execution_payload(st, p)

    assert _both(payload)(pair) is None
    assert P.blk.is_merge_transition_complete(pair[1])
    assert cold_root(pair[1], w.backend) == pair[0].hash_tree_root()


def test_state_transition_checks_the_proposer_and_the_root(host_path):
    """state_transition with the proposer's signature and the state root
    verified, as the chain's no-verifier path runs it; a wrong root and a
    wrong signer are refused by both."""
    w = host_path
    pair = [w.gj, w.gp]
    blocks = []
    for M, st in zip((J, P), pair):
        pre = st.clone()
        M.slot.process_slots(pre, 1)
        proposer = M.acc.get_beacon_proposer_index(pre)
        reveal = _sign(M, pre, w.sks[proposer], M.params.DOMAIN_RANDAO, M.ssz.uint64.hash_tree_root(0))
        block, _ = M.pb.produce_block(st, 1, reveal)
        sig = _sign(M, pre, w.sks[proposer], M.params.DOMAIN_BEACON_PROPOSER,
                    M.T.BeaconBlockAltair.hash_tree_root(block), 1)
        blocks.append(({"message": block, "signature": sig}, proposer))
    assert P.T.BeaconBlockAltair.serialize(blocks[1][0]["message"]) == J.T.BeaconBlockAltair.serialize(
        blocks[0][0]["message"])
    P.blk.reset_host_signature_checks()
    posts = [M.tr.state_transition(st, b, verify_proposer=True, verify_signatures=True)
             for M, st, (b, _) in zip((J, P), pair, blocks)]
    same(*posts)
    assert cold_root(posts[1], w.backend) == posts[0].hash_tree_root()
    assert P.blk.host_signature_checks() == 2  # the proposer and the randao reveal
    for M, st, (b, prop) in zip((J, P), pair, blocks):
        wrong_root = {"message": dict(b["message"], state_root=b"\x01" * 32), "signature": b["signature"]}
        with pytest.raises(M.blk.BlockProcessError, match="state root"):
            M.tr.state_transition(st, wrong_root)
        assert not M.tr.verify_proposer_signature(
            st, {"message": b["message"], "signature": B.sign_bytes(w.sks[prop + 1], b"\x00" * 32)})
