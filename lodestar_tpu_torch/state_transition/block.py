"""Block processing — altair.

The port's copy of `lodestar_tpu/state_transition/block.py`; it imports nothing of the
JAX package.

Reference: packages/state-transition/src/block/index.ts (processBlock
order), processBlockHeader.ts, processRandao.ts, processEth1Data.ts,
processOperations.ts, processAttestationsAltair.ts,
processProposerSlashing.ts, processAttesterSlashing.ts,
processDeposit.ts, processVoluntaryExit.ts, processSyncCommittee.ts,
slashValidator.ts, isValidIndexedAttestation.ts.

Signature verification is gated by `verify_signatures` exactly like the
reference's ProcessBlockOpts {verifySignatures} (block/types.ts): the
import pipeline verifies every signature up front in one batch on the card
(chain/block_processor.py + state_transition/signature_sets.py), then
runs the transition with verify_signatures=False — the reference's
"verified in bulk by the BLS worker pool" flow.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence

import numpy as np

from .. import params
from ..ssz import hash_tree_root as _htr, is_valid_merkle_branch, uint64
from ..types import (
    AttestationData,
    BeaconBlockHeader,
    DepositDataType,
    Eth1Data,
    VoluntaryExit,
)
from .accessors import (
    get_attesting_indices,
    get_beacon_committee,
    get_beacon_proposer_index,
    get_block_root,
    get_block_root_at_slot,
    get_committee_count_per_slot,
    get_randao_mix,
    get_total_active_balance,
    integer_squareroot,
    is_slashable_validator_mask,
)
from .epoch import initiate_validator_exit
from .util import compute_epoch_at_slot

P = params.ACTIVE_PRESET
FAR_FUTURE = params.FAR_FUTURE_EPOCH


class BlockProcessError(AssertionError):
    """Raised when a block is invalid against the state."""


# signatures the state transition checked on the host itself (every
# `crypto.bls` call of this module and of transition.py); 0 when the
# chain hands every set to its verifier and runs the transition with
# verify_signatures=False
_HOST_SIG_CHECKS = [0]


def host_signature_checks() -> int:
    """Host BLS checks the state transition made since the last reset."""
    return _HOST_SIG_CHECKS[0]


def reset_host_signature_checks() -> None:
    _HOST_SIG_CHECKS[0] = 0


def _count_host_check() -> None:
    _HOST_SIG_CHECKS[0] += 1


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise BlockProcessError(msg)


def _verify_sig(state, pubkey_index: int, signing_root: bytes, sig: bytes) -> bool:
    from ..crypto import bls as _bls

    _count_host_check()
    return _bls.verify_bytes(
        state.pubkeys[pubkey_index], signing_root, sig
    )


# -- header -----------------------------------------------------------------


def process_block_header(state, block: Dict) -> None:
    _require(block["slot"] == state.slot, "block slot != state slot")
    _require(
        block["slot"] > state.latest_block_header["slot"],
        "block not newer than latest header",
    )
    proposer = get_beacon_proposer_index(state)
    _require(
        block["proposer_index"] == proposer, "wrong proposer index"
    )
    _require(
        block["parent_root"]
        == BeaconBlockHeader.hash_tree_root(state.latest_block_header),
        "parent root mismatch",
    )
    _require(not bool(state.slashed[proposer]), "proposer is slashed")
    body_type = _body_type(state, block["slot"], block["body"])
    state.latest_block_header = {
        "slot": block["slot"],
        "proposer_index": block["proposer_index"],
        "parent_root": block["parent_root"],
        "state_root": b"\x00" * 32,
        "body_root": body_type.hash_tree_root(block["body"]),
    }


def _body_type(state, slot: int, body: Dict = None):
    """Fork body container; the BLINDED variant when the body carries a
    payload header (builder flow — same hash_tree_root by design)."""
    if body is not None and "execution_payload_header" in body:
        return state.config.get_blinded_fork_types(slot)[2]
    return state.config.get_fork_types(slot)[2]


# -- randao -----------------------------------------------------------------


def process_randao(state, body: Dict, verify_signatures: bool) -> None:
    epoch = compute_epoch_at_slot(state.slot)
    reveal = body["randao_reveal"]
    if verify_signatures:
        proposer = get_beacon_proposer_index(state)
        domain = state.config.get_domain(state.slot, params.DOMAIN_RANDAO)
        root = state.config.compute_signing_root(
            uint64.hash_tree_root(epoch), domain
        )
        _require(
            _verify_sig(state, proposer, root, reveal),
            "invalid randao reveal",
        )
    mix = bytes(
        a ^ b
        for a, b in zip(
            get_randao_mix(state, epoch), hashlib.sha256(reveal).digest()
        )
    )
    state.randao_mixes[epoch % P.EPOCHS_PER_HISTORICAL_VECTOR] = mix


# -- eth1 data --------------------------------------------------------------


def process_eth1_data(state, body: Dict) -> None:
    vote = body["eth1_data"]
    state.eth1_data_votes.append(dict(vote))
    period_slots = P.EPOCHS_PER_ETH1_VOTING_PERIOD * P.SLOTS_PER_EPOCH
    vote_root = Eth1Data.hash_tree_root(vote)
    votes = sum(
        1
        for v in state.eth1_data_votes
        if Eth1Data.hash_tree_root(v) == vote_root
    )
    if votes * 2 > period_slots:
        state.eth1_data = dict(vote)


# -- attestations (altair participation-flag path) --------------------------


def get_attestation_participation_flag_indices(
    state, data: Dict, inclusion_delay: int
) -> List[int]:
    """Spec get_attestation_participation_flag_indices."""
    current_epoch = compute_epoch_at_slot(state.slot)
    if data["target"]["epoch"] == current_epoch:
        justified_checkpoint = state.current_justified_checkpoint
    else:
        justified_checkpoint = state.previous_justified_checkpoint

    is_matching_source = (
        data["source"]["epoch"] == justified_checkpoint["epoch"]
        and data["source"]["root"] == justified_checkpoint["root"]
    )
    _require(is_matching_source, "attestation source does not match justified")
    is_matching_target = is_matching_source and data["target"][
        "root"
    ] == get_block_root(state, data["target"]["epoch"])
    is_matching_head = (
        is_matching_target
        and data["beacon_block_root"]
        == get_block_root_at_slot(state, data["slot"])
    )
    flags: List[int] = []
    if is_matching_source and inclusion_delay <= integer_squareroot(
        P.SLOTS_PER_EPOCH
    ):
        flags.append(params.TIMELY_SOURCE_FLAG_INDEX)
    if is_matching_target and inclusion_delay <= P.SLOTS_PER_EPOCH:
        flags.append(params.TIMELY_TARGET_FLAG_INDEX)
    if is_matching_head and inclusion_delay == P.MIN_ATTESTATION_INCLUSION_DELAY:
        flags.append(params.TIMELY_HEAD_FLAG_INDEX)
    return flags


def _attestation_sanity_checks(state, attestation: Dict) -> None:
    """The fork-independent gossip/STF attestation preconditions (spec
    process_attestation head, shared by the phase0 and altair paths)."""
    data = attestation["data"]
    current_epoch = compute_epoch_at_slot(state.slot)
    previous_epoch = max(current_epoch - 1, params.GENESIS_EPOCH)
    _require(
        data["target"]["epoch"] in (previous_epoch, current_epoch),
        "attestation target epoch out of range",
    )
    _require(
        data["target"]["epoch"] == compute_epoch_at_slot(data["slot"]),
        "target epoch != epoch of slot",
    )
    _require(
        data["slot"] + P.MIN_ATTESTATION_INCLUSION_DELAY <= state.slot,
        "attestation too new",
    )
    _require(
        state.slot <= data["slot"] + P.SLOTS_PER_EPOCH,
        "attestation too old",
    )
    _require(
        data["index"]
        < get_committee_count_per_slot(state, data["target"]["epoch"]),
        "committee index out of range",
    )
    committee = get_beacon_committee(state, data["slot"], data["index"])
    _require(
        len(attestation["aggregation_bits"]) == len(committee),
        "aggregation bits length mismatch",
    )


def process_attestation_phase0(
    state, attestation: Dict, verify_signatures: bool
) -> None:
    """phase0: append a PendingAttestation record; FFG source must match
    the era's justified checkpoint (reference:
    state-transition/src/block/processAttestationPhase0.ts:1)."""
    data = attestation["data"]
    current_epoch = compute_epoch_at_slot(state.slot)
    _attestation_sanity_checks(state, attestation)
    if data["target"]["epoch"] == current_epoch:
        jcp = state.current_justified_checkpoint
        book = state.current_epoch_attestations
    else:
        jcp = state.previous_justified_checkpoint
        book = state.previous_epoch_attestations
    _require(
        data["source"]["epoch"] == jcp["epoch"]
        and bytes(data["source"]["root"]) == bytes(jcp["root"]),
        "attestation source does not match justified",
    )
    if verify_signatures:
        attesting = get_attesting_indices(
            state, data, attestation["aggregation_bits"]
        )
        _require(
            is_valid_indexed_attestation(
                state,
                {
                    "attesting_indices": attesting,
                    "data": data,
                    "signature": attestation["signature"],
                },
            ),
            "invalid attestation signature",
        )
    book.append(
        {
            "aggregation_bits": list(attestation["aggregation_bits"]),
            "data": {
                **dict(data),
                "source": dict(data["source"]),
                "target": dict(data["target"]),
            },
            "inclusion_delay": int(state.slot) - int(data["slot"]),
            "proposer_index": get_beacon_proposer_index(state),
        }
    )


def process_attestation(
    state, attestation: Dict, verify_signatures: bool
) -> None:
    if getattr(state, "previous_epoch_attestations", None) is not None:
        return process_attestation_phase0(
            state, attestation, verify_signatures
        )
    data = attestation["data"]
    current_epoch = compute_epoch_at_slot(state.slot)
    previous_epoch = max(current_epoch - 1, params.GENESIS_EPOCH)
    _require(
        data["target"]["epoch"] in (previous_epoch, current_epoch),
        "attestation target epoch out of range",
    )
    _require(
        data["target"]["epoch"] == compute_epoch_at_slot(data["slot"]),
        "target epoch != epoch of slot",
    )
    _require(
        data["slot"] + P.MIN_ATTESTATION_INCLUSION_DELAY <= state.slot,
        "attestation too new",
    )
    _require(
        state.slot <= data["slot"] + P.SLOTS_PER_EPOCH,
        "attestation too old",
    )
    _require(
        data["index"]
        < get_committee_count_per_slot(state, data["target"]["epoch"]),
        "committee index out of range",
    )
    committee = get_beacon_committee(state, data["slot"], data["index"])
    _require(
        len(attestation["aggregation_bits"]) == len(committee),
        "aggregation bits length mismatch",
    )

    inclusion_delay = state.slot - data["slot"]
    flag_indices = get_attestation_participation_flag_indices(
        state, data, inclusion_delay
    )

    attesting = get_attesting_indices(
        state, data, attestation["aggregation_bits"]
    )
    if verify_signatures:
        _require(
            is_valid_indexed_attestation(
                state,
                {
                    "attesting_indices": attesting,
                    "data": data,
                    "signature": attestation["signature"],
                },
            ),
            "invalid attestation signature",
        )

    if data["target"]["epoch"] == current_epoch:
        participation = state.current_epoch_participation
    else:
        participation = state.previous_epoch_participation

    base_rewards = _base_rewards_vector(state)
    proposer_reward_numerator = 0
    idx = np.asarray(attesting, np.int64)
    for flag_index in flag_indices:
        weight = params.PARTICIPATION_FLAG_WEIGHTS[flag_index]
        bit = np.uint8(1 << flag_index)
        fresh = (participation[idx] & bit) == 0
        if fresh.any():
            new_idx = idx[fresh]
            proposer_reward_numerator += int(
                (base_rewards[new_idx] * weight).sum()
            )
            participation[new_idx] |= bit

    if proposer_reward_numerator:
        proposer_reward_denominator = (
            (params.WEIGHT_DENOMINATOR - params.PROPOSER_WEIGHT)
            * params.WEIGHT_DENOMINATOR
            // params.PROPOSER_WEIGHT
        )
        proposer_reward = (
            proposer_reward_numerator // proposer_reward_denominator
        )
        state.increase_balance(
            get_beacon_proposer_index(state), proposer_reward
        )


def _base_rewards_vector(state) -> np.ndarray:
    """Per-validator base rewards, memoized per epoch: effective
    balances and the active set only change at epoch processing, so one
    registry pass serves every attestation in the epoch (the reference
    caches baseRewardPerIncrement on the EpochCache)."""
    epoch = compute_epoch_at_slot(state.slot)
    cached = getattr(state, "_base_reward_cache", None)
    if cached is not None and cached[0] == (epoch, state.num_validators):
        return cached[1]
    increment = P.EFFECTIVE_BALANCE_INCREMENT
    per_increment = (
        increment
        * P.BASE_REWARD_FACTOR
        // integer_squareroot(get_total_active_balance(state))
    )
    out = (
        state.effective_balance.astype(np.int64) // np.int64(increment)
    ) * np.int64(per_increment)
    state._base_reward_cache = ((epoch, state.num_validators), out)
    return out


def is_valid_indexed_attestation(state, indexed: Dict) -> bool:
    """Spec is_valid_indexed_attestation (with signature check)."""
    from ..crypto import bls as _bls
    from ..crypto import curves as _curves

    indices = list(indexed["attesting_indices"])
    if not indices or indices != sorted(set(indices)):
        return False
    if any(i >= state.num_validators for i in indices):
        return False
    domain = state.config.get_domain(
        state.slot,
        params.DOMAIN_BEACON_ATTESTER,
        indexed["data"]["slot"],
    )
    root = state.config.compute_signing_root(
        AttestationData.hash_tree_root(indexed["data"]), domain
    )
    try:
        pks = [_curves.g1_decompress(state.pubkeys[i]) for i in indices]
        sig = _curves.g2_decompress(indexed["signature"])
    except Exception:
        return False
    _count_host_check()
    return _bls.fast_aggregate_verify(pks, root, sig)


# -- slashings --------------------------------------------------------------


def slash_validator(
    state, slashed_index: int, whistleblower_index: int = None
) -> None:
    """Spec slash_validator; penalty quotient and the whistleblower
    split are fork-scaled (phase0: quotient 128, proposer share
    whistleblower//PROPOSER_REWARD_QUOTIENT; altair: quotient 64,
    PROPOSER_WEIGHT/WEIGHT_DENOMINATOR)."""
    phase0 = getattr(state, "previous_epoch_attestations", None) is not None
    epoch = compute_epoch_at_slot(state.slot)
    initiate_validator_exit(state, slashed_index)
    state.slashed[slashed_index] = True
    state.withdrawable_epoch[slashed_index] = max(
        int(state.withdrawable_epoch[slashed_index]),
        epoch + P.EPOCHS_PER_SLASHINGS_VECTOR,
    )
    eff = int(state.effective_balance[slashed_index])
    state.slashings[epoch % P.EPOCHS_PER_SLASHINGS_VECTOR] += np.uint64(eff)
    min_quotient = (
        2 * P.MIN_SLASHING_PENALTY_QUOTIENT_ALTAIR  # phase0 = 128
        if phase0
        else P.MIN_SLASHING_PENALTY_QUOTIENT_ALTAIR
    )
    state.decrease_balance(slashed_index, eff // min_quotient)

    proposer_index = get_beacon_proposer_index(state)
    if whistleblower_index is None:
        whistleblower_index = proposer_index
    whistleblower_reward = eff // P.WHISTLEBLOWER_REWARD_QUOTIENT
    if phase0:
        proposer_reward = whistleblower_reward // P.PROPOSER_REWARD_QUOTIENT
    else:
        proposer_reward = (
            whistleblower_reward
            * params.PROPOSER_WEIGHT
            // params.WEIGHT_DENOMINATOR
        )
    state.increase_balance(proposer_index, proposer_reward)
    state.increase_balance(
        whistleblower_index, whistleblower_reward - proposer_reward
    )


def process_proposer_slashing(
    state, proposer_slashing: Dict, verify_signatures: bool
) -> None:
    h1 = proposer_slashing["signed_header_1"]["message"]
    h2 = proposer_slashing["signed_header_2"]["message"]
    _require(h1["slot"] == h2["slot"], "slashing headers differ in slot")
    _require(
        h1["proposer_index"] == h2["proposer_index"],
        "slashing headers differ in proposer",
    )
    _require(
        BeaconBlockHeader.hash_tree_root(h1)
        != BeaconBlockHeader.hash_tree_root(h2),
        "slashing headers identical",
    )
    proposer = h1["proposer_index"]
    _require(proposer < state.num_validators, "unknown proposer")
    epoch = compute_epoch_at_slot(state.slot)
    _require(
        bool(is_slashable_validator_mask(state, epoch)[proposer]),
        "proposer not slashable",
    )
    if verify_signatures:
        for signed in (
            proposer_slashing["signed_header_1"],
            proposer_slashing["signed_header_2"],
        ):
            domain = state.config.get_domain(
                state.slot,
                params.DOMAIN_BEACON_PROPOSER,
                signed["message"]["slot"],
            )
            root = state.config.compute_signing_root(
                BeaconBlockHeader.hash_tree_root(signed["message"]), domain
            )
            _require(
                _verify_sig(state, proposer, root, signed["signature"]),
                "invalid proposer slashing signature",
            )
    slash_validator(state, proposer)


def is_slashable_attestation_data(data_1: Dict, data_2: Dict) -> bool:
    """Double vote or surround vote (spec)."""
    double = (
        AttestationData.hash_tree_root(data_1)
        != AttestationData.hash_tree_root(data_2)
        and data_1["target"]["epoch"] == data_2["target"]["epoch"]
    )
    surround = (
        data_1["source"]["epoch"] < data_2["source"]["epoch"]
        and data_2["target"]["epoch"] < data_1["target"]["epoch"]
    )
    return double or surround


def process_attester_slashing(
    state, attester_slashing: Dict, verify_signatures: bool
) -> None:
    att_1 = attester_slashing["attestation_1"]
    att_2 = attester_slashing["attestation_2"]
    _require(
        is_slashable_attestation_data(att_1["data"], att_2["data"]),
        "attestations not slashable",
    )
    if verify_signatures:
        _require(
            is_valid_indexed_attestation(state, att_1),
            "attestation_1 invalid",
        )
        _require(
            is_valid_indexed_attestation(state, att_2),
            "attestation_2 invalid",
        )
    else:
        for att in (att_1, att_2):
            ind = list(att["attesting_indices"])
            _require(
                bool(ind) and ind == sorted(set(ind)),
                "attesting indices not sorted/unique",
            )
    epoch = compute_epoch_at_slot(state.slot)
    slashable = is_slashable_validator_mask(state, epoch)
    slashed_any = False
    for index in sorted(
        set(att_1["attesting_indices"]) & set(att_2["attesting_indices"])
    ):
        if index < state.num_validators and bool(slashable[index]):
            slash_validator(state, index)
            slashed_any = True
    _require(slashed_any, "no validator slashed")


# -- deposits ---------------------------------------------------------------


def get_deposit_signing_root(config, deposit_data: Dict) -> bytes:
    """Deposit message domain: genesis fork version, zero GVR (spec
    compute_domain default)."""
    from ..types import DepositMessage as deposit_message

    fork_version = config.fork_versions[params.ForkName.phase0]
    fork_data_root = config.fork_data_root(fork_version, b"\x00" * 32)
    domain = params.DOMAIN_DEPOSIT + fork_data_root[:28]
    return config.compute_signing_root(
        deposit_message.hash_tree_root(
            {
                "pubkey": deposit_data["pubkey"],
                "withdrawal_credentials": deposit_data[
                    "withdrawal_credentials"
                ],
                "amount": deposit_data["amount"],
            }
        ),
        domain,
    )


def process_deposit(state, deposit: Dict) -> None:
    """Spec process_deposit: merkle proof against eth1_data.deposit_root,
    then apply (deposit signatures are checked regardless of
    verify_signatures — they are self-certifying, reference
    processDeposit.ts)."""
    _require(
        is_valid_merkle_branch(
            DepositDataType.hash_tree_root(deposit["data"]),
            deposit["proof"],
            params.DEPOSIT_CONTRACT_TREE_DEPTH + 1,
            state.eth1_deposit_index,
            state.eth1_data["deposit_root"],
        ),
        "invalid deposit proof",
    )
    state.eth1_deposit_index += 1
    apply_deposit(state, deposit["data"])


def apply_deposit(state, data: Dict) -> None:
    from ..crypto import bls as _bls
    from ..crypto import curves as _curves

    pubkey = data["pubkey"]
    amount = data["amount"]
    index = state.pubkey_index(pubkey)
    if index is not None:
        state.increase_balance(index, amount)
        return
    # new validator: BLS proof-of-possession must verify
    root = get_deposit_signing_root(state.config, data)
    try:
        pk = _curves.g1_decompress(pubkey)
        sig = _curves.g2_decompress(data["signature"])
        _count_host_check()
        ok = _bls.verify(pk, root, sig)
    except Exception:
        ok = False
    if not ok:
        return  # invalid deposit signature: ignored, not rejected
    state.add_validator(pubkey, data["withdrawal_credentials"], amount)


# -- voluntary exits --------------------------------------------------------


def process_voluntary_exit(
    state, signed_exit: Dict, verify_signatures: bool
) -> None:
    exit_msg = signed_exit["message"]
    index = exit_msg["validator_index"]
    _require(index < state.num_validators, "unknown validator")
    current_epoch = compute_epoch_at_slot(state.slot)
    _require(
        bool(
            (state.activation_epoch[index] <= current_epoch)
            & (current_epoch < state.exit_epoch[index])
        ),
        "validator not active",
    )
    _require(
        int(state.exit_epoch[index]) == FAR_FUTURE, "exit already initiated"
    )
    _require(
        current_epoch >= exit_msg["epoch"], "exit epoch in the future"
    )
    _require(
        current_epoch
        >= int(state.activation_epoch[index])
        + state.config.SHARD_COMMITTEE_PERIOD,
        "validator too young to exit",
    )
    if verify_signatures:
        from .signature_sets import voluntary_exit_signing_root

        root = voluntary_exit_signing_root(
            state.config,
            state.genesis_validators_root,
            state.fork_at_least(params.ForkName.deneb),
            state.slot,
            exit_msg,
        )
        _require(
            _verify_sig(state, index, root, signed_exit["signature"]),
            "invalid exit signature",
        )
    initiate_validator_exit(state, index)


# -- capella: withdrawals + BLS-to-execution changes ------------------------


def has_eth1_withdrawal_credential(cred: bytes) -> bool:
    return bytes(cred[:1]) == params.ETH1_ADDRESS_WITHDRAWAL_PREFIX


def _is_fully_withdrawable(state, index: int, epoch: int) -> bool:
    """spec is_fully_withdrawable_validator"""
    return (
        has_eth1_withdrawal_credential(state.withdrawal_credentials[index])
        and int(state.withdrawable_epoch[index]) <= epoch
        and int(state.balances[index]) > 0
    )


def _is_partially_withdrawable(state, index: int) -> bool:
    """spec is_partially_withdrawable_validator: effective balance pinned
    at max AND an excess balance above it."""
    return (
        has_eth1_withdrawal_credential(state.withdrawal_credentials[index])
        and int(state.effective_balance[index]) == P.MAX_EFFECTIVE_BALANCE
        and int(state.balances[index]) > P.MAX_EFFECTIVE_BALANCE
    )


def get_expected_withdrawals(state) -> List[Dict]:
    """spec get_expected_withdrawals (capella): sweep up to
    MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP validators from the rotating
    cursor, emitting full withdrawals for withdrawable validators and
    excess-balance skims for max-effective ones, capped at
    MAX_WITHDRAWALS_PER_PAYLOAD (reference:
    state-transition/src/block/processWithdrawals.ts)."""
    epoch = compute_epoch_at_slot(state.slot)
    withdrawal_index = state.next_withdrawal_index
    validator_index = state.next_withdrawal_validator_index
    n = state.num_validators
    withdrawals: List[Dict] = []
    for _ in range(min(P.MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP, n)):
        if len(withdrawals) == P.MAX_WITHDRAWALS_PER_PAYLOAD:
            break
        balance = int(state.balances[validator_index])
        address = bytes(
            state.withdrawal_credentials[validator_index][12:]
        )
        if _is_fully_withdrawable(state, validator_index, epoch):
            withdrawals.append(
                {
                    "index": withdrawal_index,
                    "validator_index": validator_index,
                    "address": address,
                    "amount": balance,
                }
            )
            withdrawal_index += 1
        elif _is_partially_withdrawable(state, validator_index):
            withdrawals.append(
                {
                    "index": withdrawal_index,
                    "validator_index": validator_index,
                    "address": address,
                    "amount": balance - P.MAX_EFFECTIVE_BALANCE,
                }
            )
            withdrawal_index += 1
        validator_index = (validator_index + 1) % n
    return withdrawals


def process_withdrawals(state, payload: Dict) -> None:
    """spec process_withdrawals: the payload's withdrawal list must equal
    the protocol-computed expectation; balances are debited and both
    cursors advance."""
    from ..types import Withdrawal

    from ..ssz import List as SszList

    expected = get_expected_withdrawals(state)
    if "withdrawals" in payload:
        got = list(payload["withdrawals"])
        _require(
            len(got) == len(expected)
            and all(
                Withdrawal.hash_tree_root(a) == Withdrawal.hash_tree_root(e)
                for a, e in zip(got, expected)
            ),
            "payload withdrawals do not match protocol expectation",
        )
    else:
        # blinded body: the header commits to the list by root (spec
        # blinded process_withdrawals compares hash_tree_root)
        expected_root = SszList(
            Withdrawal, P.MAX_WITHDRAWALS_PER_PAYLOAD
        ).hash_tree_root(expected)
        _require(
            bytes(payload["withdrawals_root"]) == bytes(expected_root),
            "header withdrawals_root does not match protocol expectation",
        )
    for w in expected:
        state.decrease_balance(w["validator_index"], w["amount"])
    if expected:
        state.next_withdrawal_index = expected[-1]["index"] + 1
    n = state.num_validators
    if len(expected) == P.MAX_WITHDRAWALS_PER_PAYLOAD:
        # full payload: resume after the last withdrawn validator
        state.next_withdrawal_validator_index = (
            expected[-1]["validator_index"] + 1
        ) % n
    else:
        # partial sweep: jump the cursor by the UNCLAMPED sweep bound
        # before the modulo (spec get_expected_withdrawals epilogue —
        # clamping changes the post-state cursor when n < sweep bound)
        state.next_withdrawal_validator_index = (
            state.next_withdrawal_validator_index
            + P.MAX_VALIDATORS_PER_WITHDRAWALS_SWEEP
        ) % n


def process_bls_to_execution_change(
    state, signed_change: Dict, verify_signatures: bool
) -> None:
    """spec process_bls_to_execution_change: rotate 0x00 BLS withdrawal
    credentials to a 0x01 execution address; signed against the GENESIS
    fork domain so pre-signed changes outlive forks."""
    change = signed_change["message"]
    index = change["validator_index"]
    _require(index < state.num_validators, "unknown validator")
    cred = bytes(state.withdrawal_credentials[index])
    _require(
        cred[:1] == params.BLS_WITHDRAWAL_PREFIX,
        "credentials already rotated",
    )
    pk_hash = hashlib.sha256(bytes(change["from_bls_pubkey"])).digest()
    _require(cred[1:] == pk_hash[1:], "from_bls_pubkey does not match credentials")
    if verify_signatures:
        from ..crypto import bls as _bls
        from ..crypto import curves as _curves
        from ..types import BLSToExecutionChange

        domain = state.config.compute_domain(
            params.DOMAIN_BLS_TO_EXECUTION_CHANGE,
            state.config.fork_versions[params.ForkName.phase0],
            state.genesis_validators_root,
        )
        root = state.config.compute_signing_root(
            BLSToExecutionChange.hash_tree_root(change), domain
        )
        try:
            pk = _curves.g1_decompress(bytes(change["from_bls_pubkey"]))
            sig = _curves.g2_decompress(bytes(signed_change["signature"]))
            _count_host_check()
            ok = _bls.verify(pk, root, sig)
        except Exception:
            ok = False
        _require(ok, "invalid BLS-to-execution-change signature")
    state.withdrawal_credentials[index] = (
        params.ETH1_ADDRESS_WITHDRAWAL_PREFIX
        + b"\x00" * 11
        + bytes(change["to_execution_address"])
    )


# -- sync aggregate ---------------------------------------------------------


def process_sync_aggregate(
    state, sync_aggregate: Dict, verify_signatures: bool
) -> None:
    from ..crypto import bls as _bls
    from ..crypto import curves as _curves

    bits = sync_aggregate["sync_committee_bits"]
    committee_pubkeys = state.current_sync_committee["pubkeys"]
    _require(len(bits) == len(committee_pubkeys), "sync bits length")

    if verify_signatures:
        previous_slot = max(state.slot, 1) - 1
        domain = state.config.get_domain(
            state.slot, params.DOMAIN_SYNC_COMMITTEE, previous_slot
        )
        root = state.config.compute_signing_root(
            get_block_root_at_slot(state, previous_slot), domain
        )
        participant_pks = [
            pk for pk, bit in zip(committee_pubkeys, bits) if bit
        ]
        try:
            sig = _curves.g2_decompress(
                sync_aggregate["sync_committee_signature"]
            )
            pks = [_curves.g1_decompress(pk) for pk in participant_pks]
            ok = _eth_fast_aggregate_verify(_bls, pks, root, sig)
        except Exception:
            ok = False
        _require(ok, "invalid sync aggregate signature")

    # rewards
    total_active_increments = (
        get_total_active_balance(state) // P.EFFECTIVE_BALANCE_INCREMENT
    )
    base_reward_per_increment = (
        P.EFFECTIVE_BALANCE_INCREMENT
        * P.BASE_REWARD_FACTOR
        // integer_squareroot(get_total_active_balance(state))
    )
    total_base_rewards = base_reward_per_increment * total_active_increments
    max_participant_rewards = (
        total_base_rewards
        * params.SYNC_REWARD_WEIGHT
        // params.WEIGHT_DENOMINATOR
        // P.SLOTS_PER_EPOCH
    )
    participant_reward = max_participant_rewards // P.SYNC_COMMITTEE_SIZE
    proposer_reward = (
        participant_reward
        * params.PROPOSER_WEIGHT
        // (params.WEIGHT_DENOMINATOR - params.PROPOSER_WEIGHT)
    )
    proposer_index = get_beacon_proposer_index(state)
    committee_indices = _sync_committee_validator_indices(state)
    for i, bit in enumerate(bits):
        vindex = committee_indices[i]
        if bit:
            state.increase_balance(vindex, participant_reward)
            state.increase_balance(proposer_index, proposer_reward)
        else:
            state.decrease_balance(vindex, participant_reward)


def _sync_committee_validator_indices(state) -> List[int]:
    """Map current sync-committee pubkeys back to validator indices."""
    return [
        state.pubkey_index(pk)
        for pk in state.current_sync_committee["pubkeys"]
    ]


def _eth_fast_aggregate_verify(_bls, pks, root, sig) -> bool:
    """eth_fast_aggregate_verify: empty participation + infinity sig is
    valid (altair spec)."""
    if not pks and sig is None:
        return True
    if not pks:
        return False
    _count_host_check()
    return _bls.fast_aggregate_verify(pks, root, sig)


# -- operations + entry -----------------------------------------------------


def process_operations(state, body: Dict, verify_signatures: bool) -> None:
    expected_deposits = min(
        P.MAX_DEPOSITS,
        state.eth1_data["deposit_count"] - state.eth1_deposit_index,
    )
    _require(
        len(body["deposits"]) == expected_deposits,
        "wrong deposit count in block",
    )
    for op in body["proposer_slashings"]:
        process_proposer_slashing(state, op, verify_signatures)
    for op in body["attester_slashings"]:
        process_attester_slashing(state, op, verify_signatures)
    for op in body["attestations"]:
        process_attestation(state, op, verify_signatures)
    for op in body["deposits"]:
        process_deposit(state, op)
    for op in body["voluntary_exits"]:
        process_voluntary_exit(state, op, verify_signatures)
    for op in body.get("bls_to_execution_changes", ()):
        _require(
            state.fork_at_least(params.ForkName.capella),
            "bls_to_execution_changes before capella",
        )
        process_bls_to_execution_change(state, op, verify_signatures)


def is_merge_transition_complete(state) -> bool:
    """The payload header differs from the default (spec
    is_merge_transition_complete)."""
    from ..types import ExecutionPayloadHeader

    header = state.latest_execution_payload_header
    return header is not None and ExecutionPayloadHeader.hash_tree_root(
        header
    ) != ExecutionPayloadHeader.hash_tree_root(ExecutionPayloadHeader.default())


def payload_to_header(payload: Dict) -> Dict:
    """ExecutionPayload -> ExecutionPayloadHeader (transactions list ->
    transactions_root; capella also roots the withdrawal list, deneb
    copies the blob gas fields)."""
    from ..types import Transaction, Withdrawal
    from ..ssz import List as SszList

    txs_root = SszList(Transaction, 1_048_576).hash_tree_root(
        payload["transactions"]
    )
    header = {
        k: payload[k]
        for k in (
            "parent_hash", "fee_recipient", "state_root", "receipts_root",
            "logs_bloom", "prev_randao", "block_number", "gas_limit",
            "gas_used", "timestamp", "extra_data", "base_fee_per_gas",
            "block_hash",
        )
    }
    header["transactions_root"] = txs_root
    if "withdrawals" in payload:
        header["withdrawals_root"] = SszList(
            Withdrawal, P.MAX_WITHDRAWALS_PER_PAYLOAD
        ).hash_tree_root(payload["withdrawals"])
    if "blob_gas_used" in payload:
        header["blob_gas_used"] = payload["blob_gas_used"]
        header["excess_blob_gas"] = payload["excess_blob_gas"]
    return header


def _is_nondefault_payload(payload: Dict) -> bool:
    """spec is_merge_transition_block's payload != ExecutionPayload()
    test (a default payload means execution is not yet enabled).
    Accepts either shape: a full payload or a blinded header (the
    bellatrix field subset decides default-ness in both cases)."""
    from ..types import ExecutionPayload, ExecutionPayloadHeader

    t = (
        ExecutionPayload
        if "transactions" in payload
        else ExecutionPayloadHeader
    )
    return t.hash_tree_root(payload) != t.hash_tree_root(t.default())


def process_execution_payload(state, payload: Dict) -> None:
    """Consensus-side payload checks + header update (reference:
    bellatrix block/processExecutionPayload.ts).  EL-side validity
    (engine_newPayload) runs at the chain layer as the parallel
    verification leg — NOT here."""
    from .accessors import get_randao_mix

    _require(
        state.latest_execution_payload_header is not None,
        "pre-bellatrix state cannot process an execution payload",
    )
    if is_merge_transition_complete(state):
        _require(
            bytes(payload["parent_hash"])
            == bytes(state.latest_execution_payload_header["block_hash"]),
            "payload parent hash does not extend the latest header",
        )
    epoch = compute_epoch_at_slot(state.slot)
    _require(
        bytes(payload["prev_randao"]) == bytes(get_randao_mix(state, epoch)),
        "payload prev_randao mismatch",
    )
    expected_time = (
        state.genesis_time + state.slot * params.SECONDS_PER_SLOT
    )
    _require(
        int(payload["timestamp"]) == expected_time,
        f"payload timestamp {payload['timestamp']} != slot time {expected_time}",
    )
    # a blinded body carries the HEADER (transactions_root instead of
    # the transactions list) — same consensus checks, stored verbatim
    # (spec: process_execution_payload on ExecutionPayloadHeader for
    # blinded blocks; reference state-transition handles both shapes)
    state.latest_execution_payload_header = (
        payload_to_header(payload)
        if "transactions" in payload
        else dict(payload)
    )


def process_block(state, block: Dict, verify_signatures: bool = False) -> None:
    """Full altair/bellatrix block processing (reference block/index.ts
    order; the payload step activates once the state carries a header)."""
    process_block_header(state, block)
    body = block["body"]
    if state.latest_execution_payload_header is not None:
        # blinded bodies carry the payload HEADER; the consensus checks
        # are identical (withdrawals verify against withdrawals_root)
        blinded = "execution_payload_header" in body
        _require(
            "execution_payload" in body or blinded,
            "bellatrix block must carry an execution payload",
        )
        payload = body["execution_payload_header" if blinded else "execution_payload"]
        if state.fork_at_least(params.ForkName.deneb):
            _require(
                len(body.get("blob_kzg_commitments", ()))
                <= P.MAX_BLOBS_PER_BLOCK,
                "too many blob commitments",
            )
        # spec is_execution_enabled: process the payload once the merge
        # transition is complete OR this block IS the transition block
        # (non-default payload); a pre-merge default payload is skipped.
        if is_merge_transition_complete(state) or _is_nondefault_payload(
            payload
        ):
            # capella order: withdrawals precede the payload header update
            # (spec capella process_block: process_withdrawals(payload)
            # then process_execution_payload)
            if state.next_withdrawal_index is not None:
                process_withdrawals(state, payload)
            # spec order: the payload step precedes randao — its
            # prev_randao check reads the PRE-block mix
            process_execution_payload(state, payload)
    process_randao(state, body, verify_signatures)
    process_eth1_data(state, body)
    process_operations(state, body, verify_signatures)
    if "sync_aggregate" in body:
        process_sync_aggregate(
            state, body["sync_aggregate"], verify_signatures
        )
