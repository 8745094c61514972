"""The port's signature-set extractors (`lodestar_tpu_torch/state_transition/
signature_sets.py`) against the JAX package's: the same view (chain
config, epoch caches from the same pubkeys, seeds and active indices,
block roots), the same blocks and gossip objects made with numpy from a
seed, for every fork; each extractor's WireSignatureSets compared field
by field (kind, indices, signing root, signature, external pubkeys).
"""

import numpy as np
import pytest

from lodestar_tpu import config as JC
from lodestar_tpu import params as JP
from lodestar_tpu.state_transition import epoch_cache as JE
from lodestar_tpu.state_transition import signature_sets as JS
from lodestar_tpu_torch import config as TC
from lodestar_tpu_torch import params as TP
from lodestar_tpu_torch.state_transition import epoch_cache as TE
from lodestar_tpu_torch.state_transition import signature_sets as TS

N_VALIDATORS = 2048
FORKS = [f.value for f in TP.FORK_ORDER]


def _fields(s):
    return (s.type.value, tuple(s.indices), s.signing_root, s.signature, s.pubkeys)


def _same(ours, theirs):
    if isinstance(ours, list):
        assert [_fields(s) for s in ours] == [_fields(s) for s in theirs]
    elif ours is None:
        assert theirs is None
    else:
        assert _fields(ours) == _fields(theirs)


def _world(fork, seed):
    """Both packages' views of one state at a slot of `fork`: forks every
    4 epochs, an epoch cache and the previous epoch's, a block-root window."""
    rng = np.random.default_rng(seed)
    gvr = rng.bytes(32)
    pubkeys = [rng.bytes(48) for _ in range(N_VALIDATORS)]
    active = np.sort(rng.choice(N_VALIDATORS, N_VALIDATORS - 64, replace=False))
    sync = rng.choice(N_VALIDATORS, TP.SYNC_COMMITTEE_SIZE).tolist()
    k = FORKS.index(fork)
    epoch = 4 * k + 1
    slot = epoch * TP.SLOTS_PER_EPOCH + int(rng.integers(1, TP.SLOTS_PER_EPOCH))
    seeds = (rng.bytes(32), rng.bytes(32))
    block_roots = {s: rng.bytes(32) for s in range(slot - 40, slot)}
    views = []
    for C, E, S, P in ((TC, TE, TS, TP), (JC, JE, JS, JP)):
        cfg = C.create_chain_config(C.MAINNET_CHAIN_CONFIG, genesis_validators_root=gvr,
                                    fork_epochs={f: 4 * i for i, f in enumerate(P.FORK_ORDER)})
        caches = [E.EpochCache(pubkeys, e, s, active_indices=active, sync_committee_indices=sync)
                  for e, s in zip((epoch, epoch - 1), seeds)]
        views.append(S.BeaconStateView(config=cfg, slot=slot, epoch_cache=caches[0], block_roots=dict(block_roots),
                                       prev_epoch_cache=caches[1], _genesis_validators_root=gvr[::-1]))
    return views, rng, slot


def _attestation(view, rng, slot):
    index = int(rng.integers(view.epoch_cache.committees_per_slot))
    cache = view.epoch_cache if slot // TP.SLOTS_PER_EPOCH == view.epoch_cache.epoch else view.prev_epoch_cache
    n = len(cache.get_beacon_committee(slot, index))
    return {
        "aggregation_bits": [bool(b) for b in rng.integers(0, 2, n)],
        "data": {"slot": slot, "index": index, "beacon_block_root": rng.bytes(32),
                 "source": {"epoch": max(slot // TP.SLOTS_PER_EPOCH - 1, 0), "root": rng.bytes(32)},
                 "target": {"epoch": slot // TP.SLOTS_PER_EPOCH, "root": rng.bytes(32)}},
        "signature": rng.bytes(96),
    }


def _indexed(rng, slot):
    return {"attesting_indices": sorted(rng.choice(N_VALIDATORS, 5, replace=False).tolist()),
            "data": {"slot": slot, "index": 0, "beacon_block_root": rng.bytes(32),
                     "source": {"epoch": 1, "root": rng.bytes(32)}, "target": {"epoch": 2, "root": rng.bytes(32)}},
            "signature": rng.bytes(96)}


def _header(rng, slot):
    return {"message": {"slot": slot, "proposer_index": int(rng.integers(N_VALIDATORS)),
                        "parent_root": rng.bytes(32), "state_root": rng.bytes(32), "body_root": rng.bytes(32)},
            "signature": rng.bytes(96)}


def _block(view, rng, slot):
    """A signed block of the fork at `slot`, carrying every kind of
    signed object its body has."""
    _block_t, signed_t, body_t = view.config.get_fork_types(slot)
    body = body_t.default()
    body["randao_reveal"] = rng.bytes(96)
    body["attestations"] = [_attestation(view, rng, slot - 1), _attestation(view, rng, slot - TP.SLOTS_PER_EPOCH)]
    body["proposer_slashings"] = [{"signed_header_1": _header(rng, slot - 3), "signed_header_2": _header(rng, slot - 3)}]
    body["attester_slashings"] = [{"attestation_1": _indexed(rng, slot - 5), "attestation_2": _indexed(rng, slot - 5)}]
    body["voluntary_exits"] = [{"message": {"epoch": int(rng.integers(0, slot // TP.SLOTS_PER_EPOCH + 1)),
                                            "validator_index": int(rng.integers(N_VALIDATORS))},
                                "signature": rng.bytes(96)}]
    if "sync_aggregate" in dict(body_t.fields):
        body["sync_aggregate"] = {"sync_committee_bits": [bool(b) for b in rng.integers(0, 2, TP.SYNC_COMMITTEE_SIZE)],
                                  "sync_committee_signature": rng.bytes(96)}
    if "bls_to_execution_changes" in dict(body_t.fields):
        body["bls_to_execution_changes"] = [{"message": {"validator_index": int(rng.integers(N_VALIDATORS)),
                                                         "from_bls_pubkey": rng.bytes(48),
                                                         "to_execution_address": rng.bytes(20)},
                                             "signature": rng.bytes(96)}]
    block = signed_t.default()
    block["message"].update({"slot": slot, "proposer_index": int(rng.integers(N_VALIDATORS)),
                             "parent_root": rng.bytes(32), "state_root": rng.bytes(32), "body": body})
    block["signature"] = rng.bytes(96)
    assert signed_t.serialize(block)  # a value of the fork's container
    return block


BLOCK_EXTRACTORS = ["get_proposer_signature_set", "get_attestation_signature_sets",
                    "get_proposer_slashings_signature_sets", "get_attester_slashings_signature_sets",
                    "get_voluntary_exits_signature_sets", "get_bls_to_execution_change_signature_sets"]


@pytest.mark.parametrize("fork", FORKS)
def test_block_extractors_equal_jax(fork):
    (ours, theirs), rng, slot = _world(fork, FORKS.index(fork))
    block = _block(ours, rng, slot)
    for name in BLOCK_EXTRACTORS:
        _same(getattr(TS, name)(ours, block), getattr(JS, name)(theirs, block))
    _same(TS.get_randao_reveal_signature_set(ours, block["message"]),
          JS.get_randao_reveal_signature_set(theirs, block["message"]))
    _same(TS.get_sync_committee_signature_set(ours, block["message"]),
          JS.get_sync_committee_signature_set(theirs, block["message"]))
    for skip in (False, True):
        got = TS.get_block_signature_sets(ours, block, skip_proposer_signature=skip)
        _same(got, JS.get_block_signature_sets(theirs, block, skip_proposer_signature=skip))
    n_extra = ("sync_aggregate" in block["message"]["body"]) + ("bls_to_execution_changes" in block["message"]["body"])
    assert len(got) == 1 + 2 + 2 + 2 + 1 + n_extra - (not any(
        block["message"]["body"].get("sync_aggregate", {}).get("sync_committee_bits", [True])))
    for att in block["message"]["body"]["attestations"]:
        assert ours.get_indexed_attestation(att) == theirs.get_indexed_attestation(att)
        assert TS.get_attestation_data_signing_root(ours, att["data"]) == \
            JS.get_attestation_data_signing_root(theirs, att["data"])
    # the exit's root in both domain regimes (EIP-7044 from deneb on)
    exit_msg = block["message"]["body"]["voluntary_exits"][0]["message"]
    for deneb in (False, True):
        assert TS.voluntary_exit_signing_root(ours.config, ours.genesis_validators_root, deneb, slot, exit_msg) == \
            JS.voluntary_exit_signing_root(theirs.config, theirs.genesis_validators_root, deneb, slot, exit_msg)


@pytest.mark.parametrize("fork", FORKS[1:])
def test_gossip_extractors_equal_jax(fork):
    (ours, theirs), rng, slot = _world(fork, 10 + FORKS.index(fork))
    agg = {"message": {"aggregator_index": int(rng.integers(N_VALIDATORS)),
                       "aggregate": _attestation(ours, rng, slot), "selection_proof": rng.bytes(96)},
           "signature": rng.bytes(96)}
    _same(TS.get_aggregate_and_proof_signature_set(ours, agg), JS.get_aggregate_and_proof_signature_set(theirs, agg))
    _same(TS.get_selection_proof_signature_set(ours, slot, 7, agg["message"]["selection_proof"]),
          JS.get_selection_proof_signature_set(theirs, slot, 7, agg["message"]["selection_proof"]))
    _same(TS.get_indexed_attestation_signature_set(ours, _indexed(np.random.default_rng(1), slot)),
          JS.get_indexed_attestation_signature_set(theirs, _indexed(np.random.default_rng(1), slot)))
    msg = {"slot": slot, "beacon_block_root": rng.bytes(32), "validator_index": 9, "signature": rng.bytes(96)}
    _same(TS.get_sync_committee_message_signature_set(ours, msg),
          JS.get_sync_committee_message_signature_set(theirs, msg))
    contribution = {"slot": slot, "beacon_block_root": rng.bytes(32), "subcommittee_index": 2,
                    "aggregation_bits": [bool(b) for b in rng.integers(0, 2, 128)], "signature": rng.bytes(96)}
    cap = {"aggregator_index": 11, "contribution": contribution, "selection_proof": rng.bytes(96)}
    _same(TS.get_sync_committee_selection_proof_signature_set(ours, cap),
          JS.get_sync_committee_selection_proof_signature_set(theirs, cap))
    signed = {"message": cap, "signature": rng.bytes(96)}
    _same(TS.get_contribution_and_proof_signature_set(ours, signed),
          JS.get_contribution_and_proof_signature_set(theirs, signed))
    _same(TS.get_contribution_signature_set(ours, contribution, [1, 5, 9]),
          JS.get_contribution_signature_set(theirs, contribution, [1, 5, 9]))


def test_from_state_waits_for_the_state_slice():
    """The state slice is here: the view built from a port BeaconState
    equals the JAX package's built from the JAX state of the same keys."""
    from lodestar_tpu.config import MAINNET_CHAIN_CONFIG as J_MAINNET
    from lodestar_tpu.config import create_chain_config as j_config
    from lodestar_tpu.state_transition import create_genesis_state as j_genesis
    from lodestar_tpu.state_transition.slot import process_slots as j_slots
    from lodestar_tpu_torch.config import MAINNET_CHAIN_CONFIG, create_chain_config
    from lodestar_tpu_torch.params import ForkName
    from lodestar_tpu_torch.ssz import device_backend as DB
    from lodestar_tpu_torch.state_transition import create_genesis_state
    from lodestar_tpu_torch.state_transition.slot import process_slots

    from lodestar_tpu_torch.crypto import bls as B
    from lodestar_tpu_torch.crypto import curves as C

    pks = [C.g1_compress(B.sk_to_pk(B.keygen(bytes([i]) * 32))) for i in range(16)]
    DB.set_backend(None)
    try:
        sp = create_genesis_state(create_chain_config(MAINNET_CHAIN_CONFIG, fork_epochs={ForkName.altair: 0}), pks)
        process_slots(sp, 35)
        ours = TS.BeaconStateView.from_state(sp)
    finally:
        DB.reset_backend()
    sj = j_genesis(j_config(J_MAINNET, fork_epochs={JP.ForkName.altair: 0}), pks)
    j_slots(sj, 35)
    theirs = JS.BeaconStateView.from_state(sj)
    assert (ours.slot, ours.block_roots, ours._genesis_validators_root) == (
        theirs.slot, theirs.block_roots, theirs._genesis_validators_root)
    for a, b in ((ours.epoch_cache, theirs.epoch_cache), (ours.prev_epoch_cache, theirs.prev_epoch_cache)):
        assert (a.epoch, a.seed, list(a._shuffling), a.sync_committee_indices) == (
            b.epoch, b.seed, list(b._shuffling), b.sync_committee_indices)
