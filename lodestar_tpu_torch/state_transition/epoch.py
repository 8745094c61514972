"""Epoch transition — altair, fully vectorized over the registry.

The port's copy of `lodestar_tpu/state_transition/epoch.py`; it imports nothing of the
JAX package.

Reference: packages/state-transition/src/epoch/index.ts (processEpoch
order), epoch/processJustificationAndFinalization.ts,
processInactivityUpdates.ts, processRewardsAndPenalties.ts +
getRewardsAndPenalties.ts, processRegistryUpdates.ts,
processSlashings.ts, processEffectiveBalanceUpdates.ts,
processSyncCommitteeUpdates.ts, and cache/epochProcess.ts
(beforeProcessEpoch: the one-pass precomputation).

The reference walks the registry in JS loops with packed status flags
(epochProcess.ts `FLAG_*` bitmasks); here the same dataflow is numpy
column arithmetic — every per-validator rule is a masked vector
expression, so a 1M-validator epoch transition is ~30 array passes with
no Python-level loop (the only loops left are the rare sequential
queues: activations and exits, bounded by the churn limit).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .. import params
from ..types import HistoricalBatch
from .accessors import (
    active_mask,
    get_block_root,
    get_next_sync_committee,
    get_randao_mix,
    get_total_active_balance,
    get_validator_churn_limit,
    integer_squareroot,
)
from .util import compute_activation_exit_epoch, compute_epoch_at_slot

P = params.ACTIVE_PRESET
FAR_FUTURE = params.FAR_FUTURE_EPOCH
_I64 = np.int64


class EpochTransitionCache:
    """beforeProcessEpoch analog: shared per-epoch precomputation."""

    def __init__(self, state):
        self.current_epoch = compute_epoch_at_slot(state.slot)
        self.previous_epoch = max(self.current_epoch - 1, params.GENESIS_EPOCH)
        self.active_current = active_mask(state, self.current_epoch)
        self.active_previous = active_mask(state, self.previous_epoch)
        self.total_active_balance = get_total_active_balance(state)
        # spec get_eligible_validator_indices
        self.eligible = self.active_previous | (
            state.slashed
            & (self.previous_epoch + 1 < state.withdrawable_epoch)
        )
        # unslashed & participating masks per flag, for both epochs
        prev = state.previous_epoch_participation
        curr = state.current_epoch_participation
        self.prev_flag = [
            self.active_previous
            & (~state.slashed)
            & ((prev >> np.uint8(f)) & np.uint8(1)).astype(bool)
            for f in range(3)
        ]
        self.curr_flag = [
            self.active_current
            & (~state.slashed)
            & ((curr >> np.uint8(f)) & np.uint8(1)).astype(bool)
            for f in range(3)
        ]

    def participating_balance(self, state, mask) -> int:
        total = int(state.effective_balance[mask].sum())
        return max(P.EFFECTIVE_BALANCE_INCREMENT, total)

    def is_in_inactivity_leak(self, state) -> bool:
        finality_delay = self.previous_epoch - int(
            state.finalized_checkpoint["epoch"]
        )
        return finality_delay > P.MIN_EPOCHS_TO_INACTIVITY_PENALTY


# -- 1. justification & finalization ---------------------------------------


def process_justification_and_finalization(
    state, cache: EpochTransitionCache
) -> None:
    if cache.current_epoch <= params.GENESIS_EPOCH + 1:
        return
    prev_target = cache.participating_balance(
        state, cache.prev_flag[params.TIMELY_TARGET_FLAG_INDEX]
    )
    curr_target = cache.participating_balance(
        state, cache.curr_flag[params.TIMELY_TARGET_FLAG_INDEX]
    )
    weigh_justification_and_finalization(
        state, cache, cache.total_active_balance, prev_target, curr_target
    )


def weigh_justification_and_finalization(
    state,
    cache: EpochTransitionCache,
    total_balance: int,
    previous_target_balance: int,
    current_target_balance: int,
) -> None:
    previous_epoch = cache.previous_epoch
    current_epoch = cache.current_epoch
    old_previous_justified = dict(state.previous_justified_checkpoint)
    old_current_justified = dict(state.current_justified_checkpoint)

    state.previous_justified_checkpoint = dict(
        state.current_justified_checkpoint
    )
    bits = state.justification_bits
    state.justification_bits = [False] + bits[:-1]

    if previous_target_balance * 3 >= total_balance * 2:
        state.current_justified_checkpoint = {
            "epoch": previous_epoch,
            "root": get_block_root(state, previous_epoch),
        }
        state.justification_bits[1] = True
    if current_target_balance * 3 >= total_balance * 2:
        state.current_justified_checkpoint = {
            "epoch": current_epoch,
            "root": get_block_root(state, current_epoch),
        }
        state.justification_bits[0] = True

    bits = state.justification_bits
    # 2nd/3rd/4th most recent epochs justified → finalize accordingly
    if all(bits[1:4]) and old_previous_justified["epoch"] + 3 == current_epoch:
        state.finalized_checkpoint = old_previous_justified
    if all(bits[1:3]) and old_previous_justified["epoch"] + 2 == current_epoch:
        state.finalized_checkpoint = old_previous_justified
    if all(bits[0:3]) and old_current_justified["epoch"] + 2 == current_epoch:
        state.finalized_checkpoint = old_current_justified
    if all(bits[0:2]) and old_current_justified["epoch"] + 1 == current_epoch:
        state.finalized_checkpoint = old_current_justified


# -- 2. inactivity scores ---------------------------------------------------


def process_inactivity_updates(state, cache: EpochTransitionCache) -> None:
    if cache.current_epoch == params.GENESIS_EPOCH:
        return
    scores = state.inactivity_scores.astype(_I64)
    eligible = cache.eligible
    target_participant = cache.prev_flag[params.TIMELY_TARGET_FLAG_INDEX]
    bias = state.config.INACTIVITY_SCORE_BIAS
    recovery = state.config.INACTIVITY_SCORE_RECOVERY_RATE

    delta = np.where(
        target_participant, -np.minimum(scores, 1), _I64(bias)
    )
    if not cache.is_in_inactivity_leak(state):
        post = scores + delta
        delta = delta - np.minimum(post, _I64(recovery))
    scores = scores + np.where(eligible, delta, _I64(0))
    state.inactivity_scores = np.maximum(scores, 0).astype(np.uint64)


# -- 3. rewards & penalties -------------------------------------------------


def get_flag_index_deltas(
    state, cache: EpochTransitionCache, flag_index: int
):
    """Vectorized spec get_flag_index_deltas → (rewards, penalties) i64."""
    n = state.num_validators
    rewards = np.zeros(n, _I64)
    penalties = np.zeros(n, _I64)
    weight = params.PARTICIPATION_FLAG_WEIGHTS[flag_index]
    unslashed_participating = cache.prev_flag[flag_index]
    increment = P.EFFECTIVE_BALANCE_INCREMENT
    participating_increments = (
        cache.participating_balance(state, unslashed_participating)
        // increment
    )
    active_increments = cache.total_active_balance // increment
    base_reward = get_base_rewards(state, cache)

    eligible = cache.eligible
    in_leak = cache.is_in_inactivity_leak(state)
    participate = eligible & unslashed_participating
    if not in_leak:
        reward_numerator = (
            base_reward * _I64(weight) * _I64(participating_increments)
        )
        rewards = np.where(
            participate,
            reward_numerator
            // _I64(active_increments * params.WEIGHT_DENOMINATOR),
            _I64(0),
        )
    if flag_index != params.TIMELY_HEAD_FLAG_INDEX:
        penalties = np.where(
            eligible & ~unslashed_participating,
            base_reward * _I64(weight) // _I64(params.WEIGHT_DENOMINATOR),
            _I64(0),
        )
    return rewards, penalties


def get_inactivity_penalty_deltas(state, cache: EpochTransitionCache):
    n = state.num_validators
    penalties = np.zeros(n, _I64)
    target = cache.prev_flag[params.TIMELY_TARGET_FLAG_INDEX]
    mask = cache.eligible & ~target
    numerator = state.effective_balance.astype(_I64) * state.inactivity_scores.astype(
        _I64
    )
    denominator = (
        state.config.INACTIVITY_SCORE_BIAS
        * P.INACTIVITY_PENALTY_QUOTIENT_ALTAIR
    )
    penalties = np.where(mask, numerator // _I64(denominator), _I64(0))
    return np.zeros(n, _I64), penalties


def get_base_rewards(state, cache: EpochTransitionCache) -> np.ndarray:
    """Per-validator get_base_reward as one vector."""
    increment = P.EFFECTIVE_BALANCE_INCREMENT
    base_reward_per_increment = (
        increment
        * P.BASE_REWARD_FACTOR
        // integer_squareroot(cache.total_active_balance)
    )
    return (state.effective_balance.astype(_I64) // _I64(increment)) * _I64(
        base_reward_per_increment
    )


def process_rewards_and_penalties(state, cache: EpochTransitionCache) -> None:
    if cache.current_epoch == params.GENESIS_EPOCH:
        return
    n = state.num_validators
    rewards = np.zeros(n, _I64)
    penalties = np.zeros(n, _I64)
    for flag_index in range(len(params.PARTICIPATION_FLAG_WEIGHTS)):
        r, p = get_flag_index_deltas(state, cache, flag_index)
        rewards += r
        penalties += p
    r, p = get_inactivity_penalty_deltas(state, cache)
    rewards += r
    penalties += p
    balances = state.balances.astype(_I64) + rewards - penalties
    state.balances = np.maximum(balances, 0).astype(np.uint64)


# -- 4. registry updates ----------------------------------------------------


def initiate_validator_exit(state, index: int) -> None:
    """Spec initiate_validator_exit (sequential; exits are churn-rare)."""
    if int(state.exit_epoch[index]) != FAR_FUTURE:
        return
    exiting = state.exit_epoch[state.exit_epoch != np.uint64(FAR_FUTURE)]
    activation_exit = compute_activation_exit_epoch(
        compute_epoch_at_slot(state.slot)
    )
    exit_queue_epoch = max(
        int(exiting.max()) if len(exiting) else 0, activation_exit
    )
    exit_queue_churn = int((exiting == np.uint64(exit_queue_epoch)).sum())
    if exit_queue_churn >= get_validator_churn_limit(state):
        exit_queue_epoch += 1
    state.exit_epoch[index] = exit_queue_epoch
    state.withdrawable_epoch[index] = (
        exit_queue_epoch + state.config.MIN_VALIDATOR_WITHDRAWABILITY_DELAY
    )


def process_registry_updates(state, cache: EpochTransitionCache) -> None:
    current_epoch = cache.current_epoch
    # eligibility for activation queue
    newly_eligible = (
        state.activation_eligibility_epoch == np.uint64(FAR_FUTURE)
    ) & (state.effective_balance == np.uint64(P.MAX_EFFECTIVE_BALANCE))
    state.activation_eligibility_epoch[newly_eligible] = current_epoch + 1

    # ejections
    eject = cache.active_current & (
        state.effective_balance <= np.uint64(P.EJECTION_BALANCE)
    )
    for idx in np.nonzero(eject)[0]:
        initiate_validator_exit(state, int(idx))

    # activation queue: eligible & not yet activated, finalized eligibility
    finalized_epoch = int(state.finalized_checkpoint["epoch"])
    queue_mask = (
        (state.activation_eligibility_epoch <= np.uint64(finalized_epoch))
        & (state.activation_epoch == np.uint64(FAR_FUTURE))
    )
    queue = np.nonzero(queue_mask)[0]
    if len(queue):
        order = np.lexsort(
            (queue, state.activation_eligibility_epoch[queue])
        )
        from .accessors import get_validator_activation_churn_limit

        churn = get_validator_activation_churn_limit(state)
        dequeued = queue[order][:churn]
        state.activation_epoch[dequeued] = compute_activation_exit_epoch(
            current_epoch
        )


# -- 5. slashings -----------------------------------------------------------


def process_slashings(state, cache: EpochTransitionCache) -> None:
    epoch = cache.current_epoch
    total_balance = cache.total_active_balance
    adjusted_total = min(
        int(state.slashings.sum())
        * P.PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR,
        total_balance,
    )
    increment = P.EFFECTIVE_BALANCE_INCREMENT
    target_withdrawable = epoch + P.EPOCHS_PER_SLASHINGS_VECTOR // 2
    mask = state.slashed & (
        state.withdrawable_epoch == np.uint64(target_withdrawable)
    )
    if not mask.any():
        return
    # penalty_numerator // total_balance * increment, per spec rounding
    numerator = (
        state.effective_balance.astype(object) // increment
    ) * adjusted_total
    penalty = numerator // total_balance * increment
    for idx in np.nonzero(mask)[0]:
        state.decrease_balance(int(idx), int(penalty[idx]))


# -- 6-12. resets & rotations ----------------------------------------------


def process_eth1_data_reset(state, cache: EpochTransitionCache) -> None:
    next_epoch = cache.current_epoch + 1
    if next_epoch % P.EPOCHS_PER_ETH1_VOTING_PERIOD == 0:
        state.eth1_data_votes = []


def process_effective_balance_updates(
    state, cache: EpochTransitionCache
) -> None:
    increment = P.EFFECTIVE_BALANCE_INCREMENT
    hysteresis_increment = increment // P.HYSTERESIS_QUOTIENT
    downward = hysteresis_increment * P.HYSTERESIS_DOWNWARD_MULTIPLIER
    upward = hysteresis_increment * P.HYSTERESIS_UPWARD_MULTIPLIER
    balances = state.balances.astype(_I64)
    eff = state.effective_balance.astype(_I64)
    update = (balances + downward < eff) | (eff + upward < balances)
    new_eff = np.minimum(
        balances - balances % increment, P.MAX_EFFECTIVE_BALANCE
    )
    state.effective_balance = np.where(update, new_eff, eff).astype(np.uint64)


def process_slashings_reset(state, cache: EpochTransitionCache) -> None:
    next_epoch = cache.current_epoch + 1
    state.slashings[next_epoch % P.EPOCHS_PER_SLASHINGS_VECTOR] = 0


def process_randao_mixes_reset(state, cache: EpochTransitionCache) -> None:
    current_epoch = cache.current_epoch
    next_epoch = current_epoch + 1
    state.randao_mixes[next_epoch % P.EPOCHS_PER_HISTORICAL_VECTOR] = (
        get_randao_mix(state, current_epoch)
    )


def process_historical_roots_update(
    state, cache: EpochTransitionCache
) -> None:
    next_epoch = cache.current_epoch + 1
    if next_epoch % (P.SLOTS_PER_HISTORICAL_ROOT // P.SLOTS_PER_EPOCH) == 0:
        if state.historical_summaries is not None:
            # capella (process_historical_summaries_update): summarize the
            # two root vectors separately so light proofs need no batch
            from ..ssz import Vector as _Vec
            from ..types import Root as _Root

            vec = _Vec(_Root, P.SLOTS_PER_HISTORICAL_ROOT)
            state.historical_summaries.append(
                {
                    "block_summary_root": vec.hash_tree_root(
                        list(state.block_roots)
                    ),
                    "state_summary_root": vec.hash_tree_root(
                        list(state.state_roots)
                    ),
                }
            )
        else:
            state.historical_roots.append(
                HistoricalBatch.hash_tree_root(
                    {
                        "block_roots": list(state.block_roots),
                        "state_roots": list(state.state_roots),
                    }
                )
            )


def process_participation_flag_updates(
    state, cache: EpochTransitionCache
) -> None:
    engine = getattr(state, "_root_engine", None)
    if engine is not None:
        # swap the incremental merkle caches with the rotation so the
        # previous-epoch field diffs clean against what current held; a
        # missing/wrong hint only costs extra hashing (state_root.py)
        engine.note_participation_rotation()
    state.previous_epoch_participation = state.current_epoch_participation
    state.current_epoch_participation = np.zeros(
        state.num_validators, np.uint8
    )


def process_sync_committee_updates(
    state, cache: EpochTransitionCache
) -> None:
    next_epoch = cache.current_epoch + 1
    if next_epoch % P.EPOCHS_PER_SYNC_COMMITTEE_PERIOD == 0:
        state.current_sync_committee = state.next_sync_committee
        state.next_sync_committee = get_next_sync_committee(state)


# -- entry ------------------------------------------------------------------


def compute_unrealized_checkpoints(state) -> Dict[str, Dict]:
    """Pulled-up justification: the checkpoints the chain WOULD realize
    if the epoch transition ran right after this state's latest block
    (reference: state-transition/src/epoch/computeUnrealizedCheckpoints.ts:15).

    Runs justification-and-finalization on a clone; the fork-choice
    stores the result per node for the prev-epoch viability filter."""
    epoch = compute_epoch_at_slot(state.slot)
    if epoch <= params.GENESIS_EPOCH + 1:
        return {
            "justified": dict(state.current_justified_checkpoint),
            "finalized": dict(state.finalized_checkpoint),
        }
    # weigh_justification_and_finalization touches exactly four fields;
    # save/restore them instead of deep-cloning the whole registry —
    # this runs in the per-block import hot path
    saved = (
        dict(state.previous_justified_checkpoint),
        dict(state.current_justified_checkpoint),
        list(state.justification_bits),
        dict(state.finalized_checkpoint),
    )
    try:
        process_justification_and_finalization(
            state, EpochTransitionCache(state)
        )
        return {
            "justified": dict(state.current_justified_checkpoint),
            "finalized": dict(state.finalized_checkpoint),
        }
    finally:
        (
            state.previous_justified_checkpoint,
            state.current_justified_checkpoint,
            state.justification_bits,
            state.finalized_checkpoint,
        ) = saved


def process_epoch(state) -> Dict:
    """Run the full altair epoch transition in spec order; returns the
    cache for callers that want the precomputed masks (regen metrics)."""
    cache = EpochTransitionCache(state)
    process_justification_and_finalization(state, cache)
    process_inactivity_updates(state, cache)
    process_rewards_and_penalties(state, cache)
    process_registry_updates(state, cache)
    process_slashings(state, cache)
    process_eth1_data_reset(state, cache)
    process_effective_balance_updates(state, cache)
    process_slashings_reset(state, cache)
    process_randao_mixes_reset(state, cache)
    process_historical_roots_update(state, cache)
    process_participation_flag_updates(state, cache)
    process_sync_committee_updates(state, cache)
    return {"cache": cache}
