"""State accessors — spec get_* helpers over the columnar BeaconState.

The port's copy of `lodestar_tpu/state_transition/accessors.py`; it imports nothing of the
JAX package.

Reference: packages/state-transition/src/util/{seed,validator,balance}.ts
and cache/epochContext.ts (proposer/committee/sync-committee selection).
Everything registry-shaped is a vectorized numpy pass; the rejection-
sampling loops (proposer, sync committee) draw candidates from the
whole-epoch permutation computed once by `shuffled_positions`.
"""

from __future__ import annotations

import hashlib
import math
from typing import List, Sequence

import numpy as np

from .. import params
from .util import (
    compute_epoch_at_slot,
    compute_shuffled_index,
    compute_start_slot_at_epoch,
    shuffle_list,
    shuffled_positions,
)

P = params.ACTIVE_PRESET
FAR_FUTURE = params.FAR_FUTURE_EPOCH


def integer_squareroot(n: int) -> int:
    return math.isqrt(n)


def uint_to_bytes(n: int, length: int = 8) -> bytes:
    return int(n).to_bytes(length, "little")


# -- validator status (vectorized; spec is_active_validator et al) ----------


def active_mask(state, epoch: int) -> np.ndarray:
    return (state.activation_epoch <= epoch) & (epoch < state.exit_epoch)


def get_active_validator_indices(state, epoch: int) -> np.ndarray:
    return np.nonzero(active_mask(state, epoch))[0].astype(np.int64)


def is_slashable_validator_mask(state, epoch: int) -> np.ndarray:
    return (
        (~state.slashed)
        & (state.activation_epoch <= epoch)
        & (epoch < state.withdrawable_epoch)
    )


def get_total_balance(state, indices) -> int:
    """max(EFFECTIVE_BALANCE_INCREMENT, sum of effective balances)."""
    total = int(state.effective_balance[np.asarray(indices, np.int64)].sum())
    return max(P.EFFECTIVE_BALANCE_INCREMENT, total)


def get_total_active_balance(state) -> int:
    epoch = compute_epoch_at_slot(state.slot)
    return get_total_balance(state, get_active_validator_indices(state, epoch))


def get_validator_churn_limit(state) -> int:
    epoch = compute_epoch_at_slot(state.slot)
    active = int(active_mask(state, epoch).sum())
    return max(
        state.config.MIN_PER_EPOCH_CHURN_LIMIT,
        active // state.config.CHURN_LIMIT_QUOTIENT,
    )


def get_validator_activation_churn_limit(state) -> int:
    """deneb (EIP-7514): activations are additionally capped at
    MAX_PER_EPOCH_ACTIVATION_CHURN_LIMIT; exits keep the plain limit."""
    from .. import params as _params

    limit = get_validator_churn_limit(state)
    if state.fork_at_least(_params.ForkName.deneb):
        return min(_params.ACTIVE_PRESET.MAX_PER_EPOCH_ACTIVATION_CHURN_LIMIT, limit)
    return limit


# -- randao / seeds ---------------------------------------------------------


def get_randao_mix(state, epoch: int) -> bytes:
    return state.randao_mixes[epoch % P.EPOCHS_PER_HISTORICAL_VECTOR]


def get_seed(state, epoch: int, domain_type: bytes) -> bytes:
    mix = get_randao_mix(
        state,
        (epoch + P.EPOCHS_PER_HISTORICAL_VECTOR - P.MIN_SEED_LOOKAHEAD - 1)
        % P.EPOCHS_PER_HISTORICAL_VECTOR,
    )
    return hashlib.sha256(domain_type + uint_to_bytes(epoch) + mix).digest()


# -- block roots ------------------------------------------------------------


def get_block_root_at_slot(state, slot: int) -> bytes:
    assert slot < state.slot <= slot + P.SLOTS_PER_HISTORICAL_ROOT, (
        "slot outside block-roots window"
    )
    return state.block_roots[slot % P.SLOTS_PER_HISTORICAL_ROOT]


def get_block_root(state, epoch: int) -> bytes:
    return get_block_root_at_slot(state, compute_start_slot_at_epoch(epoch))


# -- proposer selection (spec compute_proposer_index) -----------------------


def compute_proposer_index(state, indices: np.ndarray, seed: bytes) -> int:
    """Rejection-sample a proposer weighted by effective balance.

    Each candidate's shuffled position is the spec's scalar
    compute_shuffled_index (the loop stops at the first acceptance,
    expected ~2 draws at full effective balance); the JAX package's copy
    shuffles the whole registry for it, seconds at 1M validators, with the
    same candidates."""
    total = len(indices)
    assert total > 0, "no active validators"
    eff = state.effective_balance
    max_eff = P.MAX_EFFECTIVE_BALANCE
    i = 0
    while True:
        candidate = int(indices[compute_shuffled_index(i % total, total, seed)])
        rand_bytes = hashlib.sha256(seed + uint_to_bytes(i // 32)).digest()
        random_byte = rand_bytes[i % 32]
        if int(eff[candidate]) * 255 >= max_eff * random_byte:
            return candidate
        i += 1


def get_beacon_proposer_index(state) -> int:
    epoch = compute_epoch_at_slot(state.slot)
    seed = hashlib.sha256(
        get_seed(state, epoch, params.DOMAIN_BEACON_PROPOSER)
        + uint_to_bytes(state.slot)
    ).digest()
    # Memoized per (slot, seed): block processing asks for the proposer
    # many times per block (header, randao, attestation rewards, sync
    # aggregate), each a full-registry shuffle without this.
    cache = getattr(state, "_proposer_cache", None)
    if cache and cache[0] == (state.slot, seed):
        return cache[1]
    indices = get_active_validator_indices(state, epoch)
    proposer = compute_proposer_index(state, indices, seed)
    state._proposer_cache = ((state.slot, seed), proposer)
    return proposer


def get_proposer_indices_for_epoch(state, epoch: int) -> List[int]:
    """All SLOTS_PER_EPOCH proposers from one epoch-aligned state.

    The per-slot seed only mixes the slot number into the epoch seed, so
    one state serves the whole epoch (reference:
    epochContext.ts proposers / computeProposers)."""
    assert compute_epoch_at_slot(state.slot) == epoch, (
        "state must be in the target epoch"
    )
    base_seed = get_seed(state, epoch, params.DOMAIN_BEACON_PROPOSER)
    indices = get_active_validator_indices(state, epoch)
    out = []
    start = compute_start_slot_at_epoch(epoch)
    for slot in range(start, start + P.SLOTS_PER_EPOCH):
        seed = hashlib.sha256(base_seed + uint_to_bytes(slot)).digest()
        out.append(compute_proposer_index(state, indices, seed))
    return out


# -- sync committee (spec get_next_sync_committee) --------------------------


def get_next_sync_committee_indices(state) -> List[int]:
    epoch = compute_epoch_at_slot(state.slot) + 1
    indices = get_active_validator_indices(state, epoch)
    total = len(indices)
    assert total > 0, "no active validators"
    seed = get_seed(state, epoch, params.DOMAIN_SYNC_COMMITTEE)
    perm = shuffled_positions(total, seed)
    eff = state.effective_balance
    max_eff = P.MAX_EFFECTIVE_BALANCE
    out: List[int] = []
    i = 0
    while len(out) < P.SYNC_COMMITTEE_SIZE:
        candidate = int(indices[perm[i % total]])
        rand_bytes = hashlib.sha256(seed + uint_to_bytes(i // 32)).digest()
        random_byte = rand_bytes[i % 32]
        if int(eff[candidate]) * 255 >= max_eff * random_byte:
            out.append(candidate)
        i += 1
    return out


def get_next_sync_committee(state) -> dict:
    """SyncCommittee value {pubkeys, aggregate_pubkey} for the next period."""
    from ..crypto import bls as _bls
    from ..crypto import curves as _curves

    indices = get_next_sync_committee_indices(state)
    pubkeys = [state.pubkeys[i] for i in indices]
    points = [_curves.g1_decompress(pk) for pk in pubkeys]
    agg = _bls.aggregate_pubkeys(points)
    return {
        "pubkeys": pubkeys,
        "aggregate_pubkey": _curves.g1_compress(agg),
    }


# -- committees (spec get_beacon_committee over the state) ------------------


def get_committee_count_per_slot(state, epoch: int) -> int:
    from .util import compute_committee_count_per_slot

    return compute_committee_count_per_slot(
        int(active_mask(state, epoch).sum())
    )


def get_shuffling(state, epoch: int) -> np.ndarray:
    """The epoch's active indices in the spec's shuffled committee order
    (DOMAIN_BEACON_ATTESTER seed), memoized on the state.

    The memo (the EpochContext caching idea: one shuffle per epoch serves
    every attestation in it) travels with `BeaconState.clone()`: the key
    (epoch, seed) fixes the active set, since activations and exits take
    effect at least MAX_SEED_LOOKAHEAD + 1 epochs after they are decided,
    before the seed's randao mix closes."""
    seed = get_seed(state, epoch, params.DOMAIN_BEACON_ATTESTER)
    cache = getattr(state, "_shuffle_cache", None)
    if cache is None:
        cache = {}
        state._shuffle_cache = cache
    key = (epoch, seed)
    shuffled = cache.get(key)
    if shuffled is None:
        shuffled = shuffle_list(get_active_validator_indices(state, epoch), seed)
        cache[key] = shuffled
        if len(cache) > 4:
            cache.pop(next(iter(cache)))
    return shuffled


def get_beacon_committee(state, slot: int, index: int) -> np.ndarray:
    """Committee `index` at `slot` (one shuffle per epoch, sliced)."""
    epoch = compute_epoch_at_slot(slot)
    per_slot = get_committee_count_per_slot(state, epoch)
    assert 0 <= index < per_slot, "committee index out of range"
    committees_per_epoch = per_slot * P.SLOTS_PER_EPOCH
    committee_global = (slot % P.SLOTS_PER_EPOCH) * per_slot + index
    shuffled = get_shuffling(state, epoch)
    n = len(shuffled)
    start = n * committee_global // committees_per_epoch
    end = n * (committee_global + 1) // committees_per_epoch
    return shuffled[start:end]


def get_attesting_indices(
    state, data: dict, aggregation_bits: Sequence[bool]
) -> List[int]:
    committee = get_beacon_committee(state, data["slot"], data["index"])
    assert len(aggregation_bits) == len(committee), (
        "aggregation bits length != committee size"
    )
    return sorted(
        int(v) for v, b in zip(committee, aggregation_bits) if b
    )
