"""phase0 state transition: PendingAttestation-era processing.

The port's copy of `lodestar_tpu/state_transition/phase0.py`; it imports nothing of the
JAX package.

Mirror of the reference's phase0 paths (reference:
state-transition/src/block/processAttestationPhase0.ts,
epoch/getAttestationDeltas.ts, epoch/processPendingAttestations —
folded into cache/epochProcess.ts in the reference; and
slot/upgradeStateToAltair.ts): blocks append PendingAttestation records
instead of setting participation flags, and the epoch transition
derives justification/rewards from those records.

Representation: pending attestations are plain dicts
{aggregation_bits, data, inclusion_delay, proposer_index}; the epoch
transition resolves them to boolean attester masks over the registry
(vectorized where the data allows, committee resolution per
attestation like the reference's epochProcess loop).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .. import params
from .accessors import (
    get_beacon_committee,
    get_block_root,
    get_block_root_at_slot,
    get_total_active_balance,
)
from .epoch import (
    EpochTransitionCache,
    process_effective_balance_updates,
    process_eth1_data_reset,
    process_historical_roots_update,
    process_randao_mixes_reset,
    process_registry_updates,
    process_slashings_reset,
    weigh_justification_and_finalization,
)
from .util import compute_epoch_at_slot, compute_start_slot_at_epoch

P = params.ACTIVE_PRESET
_I64 = np.int64
_U64 = np.uint64

# phase0 constants the later forks rescaled (consensus-specs phase0)
BASE_REWARDS_PER_EPOCH = 4
INACTIVITY_PENALTY_QUOTIENT_PHASE0 = 2**26
PROPORTIONAL_SLASHING_MULTIPLIER_PHASE0 = 1
MIN_EPOCHS_TO_INACTIVITY_PENALTY = 4


def is_phase0_state(state) -> bool:
    return getattr(state, "previous_epoch_attestations", None) is not None


# -- attester resolution ----------------------------------------------------


def attesting_mask(state, attestations: List[Dict]) -> np.ndarray:
    """Union of attesting validators over pending attestations
    (spec get_unslashed_attesting_indices without the slash filter)."""
    mask = np.zeros(state.num_validators, bool)
    for att in attestations:
        data = att["data"]
        committee = get_beacon_committee(
            state, int(data["slot"]), int(data["index"])
        )
        bits = att["aggregation_bits"]
        for pos, v in enumerate(committee):
            if bits[pos]:
                mask[int(v)] = True
    return mask


def _matching(state, epoch: int) -> Tuple[List[Dict], List[Dict], List[Dict]]:
    """(source, target, head) matching attestation lists for `epoch`
    (spec get_matching_*_attestations)."""
    current_epoch = compute_epoch_at_slot(state.slot)
    if epoch == current_epoch:
        source = list(state.current_epoch_attestations)
    else:
        source = list(state.previous_epoch_attestations)
    boundary = get_block_root(state, epoch)
    target = [
        a
        for a in source
        if bytes(a["data"]["target"]["root"]) == bytes(boundary)
    ]
    head = [
        a
        for a in target
        if bytes(a["data"]["beacon_block_root"])
        == bytes(get_block_root_at_slot(state, int(a["data"]["slot"])))
    ]
    return source, target, head


def _unslashed_mask(state, attestations: List[Dict]) -> np.ndarray:
    return attesting_mask(state, attestations) & ~state.slashed


def _attesting_balance(state, mask: np.ndarray) -> int:
    total = int(state.effective_balance[mask].sum())
    return max(P.EFFECTIVE_BALANCE_INCREMENT, total)


# -- justification ----------------------------------------------------------


def process_justification_and_finalization_phase0(state, cache=None) -> None:
    cache = cache or EpochTransitionCache(state)
    if cache.current_epoch <= params.GENESIS_EPOCH + 1:
        return
    _s, prev_target, _h = _matching(state, cache.previous_epoch)
    _s2, curr_target, _h2 = _matching(state, cache.current_epoch)
    weigh_justification_and_finalization(
        state,
        cache,
        cache.total_active_balance,
        _attesting_balance(state, _unslashed_mask(state, prev_target)),
        _attesting_balance(state, _unslashed_mask(state, curr_target)),
    )


# -- rewards & penalties (spec get_attestation_deltas) ----------------------


def get_base_rewards_phase0(state, total_balance: int) -> np.ndarray:
    from .accessors import integer_squareroot

    sqrt_total = integer_squareroot(total_balance)
    return (
        state.effective_balance.astype(object)
        * P.BASE_REWARD_FACTOR
        // sqrt_total
        // BASE_REWARDS_PER_EPOCH
    ).astype(_I64)


def get_attestation_deltas(state, cache=None) -> Tuple[np.ndarray, np.ndarray]:
    """(rewards, penalties) per validator for the PREVIOUS epoch."""
    n = state.num_validators
    rewards = np.zeros(n, _I64)
    penalties = np.zeros(n, _I64)
    cache = cache or EpochTransitionCache(state)
    prev_epoch = cache.previous_epoch
    total_balance = cache.total_active_balance
    base = get_base_rewards_phase0(state, total_balance)
    eligible = cache.eligible

    source_atts, target_atts, head_atts = _matching(state, prev_epoch)
    finality_delay = prev_epoch - int(state.finalized_checkpoint["epoch"])
    in_leak = finality_delay > MIN_EPOCHS_TO_INACTIVITY_PENALTY
    increment = P.EFFECTIVE_BALANCE_INCREMENT

    for atts in (source_atts, target_atts, head_atts):
        attester = _unslashed_mask(state, atts)
        attesting_balance = _attesting_balance(state, attester)
        hit = eligible & attester
        miss = eligible & ~attester
        if in_leak:
            # optimal participation is rewarded as if full to cancel the
            # base reward against the leak (spec get_attestation_
            # component_deltas "cancel" rule)
            rewards[hit] += base[hit]
        else:
            reward_num = base.astype(object) * (
                attesting_balance // increment
            )
            rewards[hit] += (
                reward_num[hit] // (total_balance // increment)
            ).astype(_I64)
        penalties[miss] += base[miss]

    # inclusion delay: earliest inclusion per attester; the proposer of
    # the including block earns base // PROPOSER_REWARD_QUOTIENT
    earliest: Dict[int, Dict] = {}
    for att in source_atts:
        committee = get_beacon_committee(
            state, int(att["data"]["slot"]), int(att["data"]["index"])
        )
        bits = att["aggregation_bits"]
        for pos, v in enumerate(committee):
            if not bits[pos] or bool(state.slashed[int(v)]):
                continue
            vi = int(v)
            if vi not in earliest or int(att["inclusion_delay"]) < int(
                earliest[vi]["inclusion_delay"]
            ):
                earliest[vi] = att
    for vi, att in earliest.items():
        proposer_reward = int(base[vi]) // P.PROPOSER_REWARD_QUOTIENT
        rewards[int(att["proposer_index"])] += proposer_reward
        max_attester = int(base[vi]) - proposer_reward
        rewards[vi] += max_attester // int(att["inclusion_delay"])

    if in_leak:
        target_attester = _unslashed_mask(state, target_atts)
        proposer_rewards = base // P.PROPOSER_REWARD_QUOTIENT
        penalties[eligible] += (
            BASE_REWARDS_PER_EPOCH * base[eligible]
            - proposer_rewards[eligible]
        )
        miss_t = eligible & ~target_attester
        penalties[miss_t] += (
            state.effective_balance[miss_t].astype(object)
            * finality_delay
            // INACTIVITY_PENALTY_QUOTIENT_PHASE0
        ).astype(_I64)
    return rewards, penalties


def process_rewards_and_penalties_phase0(state, cache=None) -> None:
    if compute_epoch_at_slot(state.slot) == params.GENESIS_EPOCH:
        return
    rewards, penalties = get_attestation_deltas(state, cache)
    balances = state.balances.astype(object)
    balances = balances + rewards.astype(object)
    balances = np.maximum(balances - penalties.astype(object), 0)
    state.balances = np.asarray(balances, _U64)


# -- slashings (multiplier 1) -----------------------------------------------


def process_slashings_phase0(state) -> None:
    epoch = compute_epoch_at_slot(state.slot)
    total_balance = get_total_active_balance(state)
    adjusted_total = min(
        int(state.slashings.sum()) * PROPORTIONAL_SLASHING_MULTIPLIER_PHASE0,
        total_balance,
    )
    increment = P.EFFECTIVE_BALANCE_INCREMENT
    target_withdrawable = epoch + P.EPOCHS_PER_SLASHINGS_VECTOR // 2
    mask = state.slashed & (
        state.withdrawable_epoch == _U64(target_withdrawable)
    )
    if not mask.any():
        return
    numerator = (
        state.effective_balance.astype(object) // increment
    ) * adjusted_total
    penalty = numerator // total_balance * increment
    balances = state.balances.astype(object)
    balances = np.where(mask, np.maximum(balances - penalty, 0), balances)
    state.balances = np.asarray(balances, _U64)


# -- participation record rotation ------------------------------------------


def process_participation_record_updates(state) -> None:
    state.previous_epoch_attestations = list(
        state.current_epoch_attestations
    )
    state.current_epoch_attestations = []


# -- the phase0 epoch transition --------------------------------------------


def process_epoch_phase0(state) -> Dict:
    """Spec phase0 process_epoch order.  ONE registry-scan cache
    serves justification, deltas, and the update steps (the same
    sharing the altair process_epoch does)."""
    cache = EpochTransitionCache(state)
    process_justification_and_finalization_phase0(state, cache)
    process_rewards_and_penalties_phase0(state, cache)
    process_registry_updates(state, cache)
    process_slashings_phase0(state)
    process_eth1_data_reset(state, cache)
    process_effective_balance_updates(state, cache)
    process_slashings_reset(state, cache)
    process_randao_mixes_reset(state, cache)
    process_historical_roots_update(state, cache)
    process_participation_record_updates(state)
    return {"cache": cache}


# -- the altair upgrade (reference: slot/upgradeStateToAltair.ts) -----------


def translate_participation(state, attestations: List[Dict]) -> None:
    """Pending attestations -> previous-epoch participation flags
    (spec upgrade translate_participation)."""
    from .block import get_attestation_participation_flag_indices

    for att in attestations:
        data = att["data"]
        flag_indices = get_attestation_participation_flag_indices(
            state, data, int(att["inclusion_delay"])
        )
        committee = get_beacon_committee(
            state, int(data["slot"]), int(data["index"])
        )
        bits = att["aggregation_bits"]
        flag_byte = np.uint8(0)
        for f in flag_indices:
            flag_byte |= np.uint8(1 << f)
        for pos, v in enumerate(committee):
            if bits[pos]:
                state.previous_epoch_participation[int(v)] |= flag_byte


def upgrade_to_altair(state) -> None:
    from .accessors import get_next_sync_committee

    n = state.num_validators
    state.previous_epoch_participation = np.zeros(n, np.uint8)
    state.current_epoch_participation = np.zeros(n, np.uint8)
    state.inactivity_scores = np.zeros(n, _U64)
    pending = list(state.previous_epoch_attestations)
    # fork record first: flag derivation reads justified checkpoints,
    # not the fork, but the spec upgrades the fork before translating
    state.fork = {
        "previous_version": state.fork["current_version"],
        "current_version": state.config.fork_versions[
            params.ForkName.altair
        ],
        "epoch": compute_epoch_at_slot(state.slot),
    }
    translate_participation(state, pending)
    state.previous_epoch_attestations = None
    state.current_epoch_attestations = None
    committee = get_next_sync_committee(state)
    state.current_sync_committee = committee
    state.next_sync_committee = dict(committee)
