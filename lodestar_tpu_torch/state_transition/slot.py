"""Slot processing + the multifork stateTransition entry.

The port's copy of `lodestar_tpu/state_transition/slot.py`; it imports nothing of the
JAX package.

Reference: packages/state-transition/src/slot/index.ts (processSlot),
stateTransition.ts (stateTransition / processSlots; the
eth2fastspec-style "cache roots then maybe epoch-transition" loop).
The canonical working state is the altair family; a phase0 state runs
the PendingAttestation epoch (`phase0.py`) and upgrades to altair at its
scheduled epoch.  The BELLATRIX fork upgrade runs at its
scheduled epoch boundary (reference: slot/upgradeStateToBellatrix.ts),
attaching the execution-payload header that process_execution_payload
maintains thereafter.
"""

from __future__ import annotations

from typing import Dict, Optional

from .. import params
from ..params import ForkName
from ..types import BeaconBlockHeader, ExecutionPayloadHeader
from .epoch import process_epoch

P = params.ACTIVE_PRESET
ZERO_ROOT = b"\x00" * 32


def process_slot(state) -> None:
    """Cache the state/block roots for the slot being closed.

    The state root here is THE per-slot merkleization hot path; it runs
    through the incremental engine (state_transition/state_root.py), so
    a slot that touched k validators re-hashes O(k log n) chunks, not
    the whole registry."""
    previous_state_root = state.hash_tree_root()
    state.state_roots[state.slot % P.SLOTS_PER_HISTORICAL_ROOT] = (
        previous_state_root
    )
    if state.latest_block_header["state_root"] == ZERO_ROOT:
        state.latest_block_header["state_root"] = previous_state_root
    state.block_roots[state.slot % P.SLOTS_PER_HISTORICAL_ROOT] = (
        BeaconBlockHeader.hash_tree_root(state.latest_block_header)
    )


def process_slots(state, slot: int, metrics: Optional[Dict] = None) -> None:
    """Advance state (in place) through empty slots up to `slot`."""
    assert state.slot < slot, (
        f"process_slots target {slot} not beyond state slot {state.slot}"
    )
    while state.slot < slot:
        process_slot(state)
        if (state.slot + 1) % P.SLOTS_PER_EPOCH == 0:
            if state.previous_epoch_attestations is not None:
                # PendingAttestation era (reference: phase0 processEpoch)
                from .phase0 import process_epoch_phase0

                process_epoch_phase0(state)
            else:
                process_epoch(state)
        state.slot += 1
        maybe_upgrade_state(state)


def maybe_upgrade_state(state) -> None:
    """Run the scheduled fork upgrade when the state enters the fork's
    first slot (reference: stateTransition.ts processSlotsWithTransientCache
    -> upgradeStateToX at epoch boundaries)."""
    if state.slot % P.SLOTS_PER_EPOCH != 0:
        return
    epoch = state.slot // P.SLOTS_PER_EPOCH
    altair_epoch = state.config.fork_epochs.get(ForkName.altair)
    if (
        altair_epoch is not None
        and epoch == altair_epoch
        and state.previous_epoch_attestations is not None
    ):
        # reference: slot/upgradeStateToAltair.ts (pending attestations
        # translate into participation flags; sync committees start)
        from .phase0 import upgrade_to_altair

        upgrade_to_altair(state)
    bellatrix_epoch = state.config.fork_epochs.get(ForkName.bellatrix)
    if (
        bellatrix_epoch is not None
        and epoch == bellatrix_epoch
        and state.latest_execution_payload_header is None
    ):
        upgrade_to_bellatrix(state)
    capella_epoch = state.config.fork_epochs.get(ForkName.capella)
    if (
        capella_epoch is not None
        and epoch == capella_epoch
        and state.next_withdrawal_index is None
    ):
        upgrade_to_capella(state)
    deneb_epoch = state.config.fork_epochs.get(ForkName.deneb)
    if (
        deneb_epoch is not None
        and epoch == deneb_epoch
        and state.next_withdrawal_index is not None
        and "blob_gas_used" not in (state.latest_execution_payload_header or {})
    ):
        upgrade_to_deneb(state)


def _bump_fork(state, fork: ForkName) -> None:
    state.fork = {
        "previous_version": state.fork["current_version"],
        "current_version": state.config.fork_versions[fork],
        "epoch": state.slot // P.SLOTS_PER_EPOCH,
    }


def upgrade_to_bellatrix(state) -> None:
    """reference: slot/upgradeStateToBellatrix.ts — bump the fork record
    and attach the default (pre-merge) execution payload header."""
    _bump_fork(state, ForkName.bellatrix)
    state.latest_execution_payload_header = ExecutionPayloadHeader.default()


def upgrade_to_capella(state) -> None:
    """reference: slot/upgradeStateToCapella.ts — the payload header gains
    withdrawals_root; withdrawal bookkeeping + historical summaries start."""
    _bump_fork(state, ForkName.capella)
    header = dict(state.latest_execution_payload_header or {})
    if not header:
        header = ExecutionPayloadHeader.default()
    header["withdrawals_root"] = ZERO_ROOT
    state.latest_execution_payload_header = header
    state.next_withdrawal_index = 0
    state.next_withdrawal_validator_index = 0
    state.historical_summaries = []


def upgrade_to_deneb(state) -> None:
    """reference: slot/upgradeStateToDeneb.ts — the payload header gains
    the blob gas fields."""
    _bump_fork(state, ForkName.deneb)
    header = dict(state.latest_execution_payload_header)
    header["blob_gas_used"] = 0
    header["excess_blob_gas"] = 0
    state.latest_execution_payload_header = header
