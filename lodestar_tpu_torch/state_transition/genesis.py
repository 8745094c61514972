"""Genesis state construction + the deposit merkle tree.

The port's copy of `lodestar_tpu/state_transition/genesis.py`; it imports nothing of the
JAX package.

Reference: packages/state-transition/src/util/genesis.ts
(initializeBeaconStateFromEth1 / applyDeposits) and the interop helpers
in beacon-node/test/utils/state.ts.  `create_genesis_state` is the
interop-style fast path (validators injected directly, already active);
`DepositTree` reproduces the eth1 deposit contract's incremental merkle
tree so process_deposit's branch verification is exercised for real.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Optional, Sequence

from .. import params
from ..config.chain_config import ChainConfig
from ..ssz.core import _ZERO_HASHES
from ..types import BeaconBlockBodyAltair, DepositDataType
from .accessors import get_next_sync_committee
from .state import BeaconState
from .state_root import StateRootEngine

P = params.ACTIVE_PRESET
FAR_FUTURE = params.FAR_FUTURE_EPOCH
DEPTH = params.DEPOSIT_CONTRACT_TREE_DEPTH


class DepositTree:
    """Incremental merkle tree of DepositData roots (eth1 contract shape).

    root() mixes in the leaf count (the +1 level process_deposit's
    branch check expects); proof(i) returns DEPTH siblings plus the
    count chunk as the final branch element.  push/root are O(DEPTH)
    via the deposit contract's partial-branch algorithm (the eth1
    tracker calls root() once per followed block); proof() rebuilds
    levels and is O(n) — it only runs per produced deposit op."""

    def __init__(self):
        self.leaves: List[bytes] = []
        self._branch: List[bytes] = [b"\x00" * 32] * DEPTH

    def push(self, deposit_data: Dict) -> None:
        node = DepositDataType.hash_tree_root(deposit_data)
        self.leaves.append(node)
        size = len(self.leaves)
        for h in range(DEPTH):
            if size & 1:
                self._branch[h] = node
                break
            node = hashlib.sha256(self._branch[h] + node).digest()
            size >>= 1

    def _levels(self) -> List[List[bytes]]:
        levels = [list(self.leaves)]
        for d in range(DEPTH):
            prev = levels[-1]
            nxt = []
            for i in range(0, len(prev), 2):
                left = prev[i]
                right = prev[i + 1] if i + 1 < len(prev) else _ZERO_HASHES[d]
                nxt.append(hashlib.sha256(left + right).digest())
            levels.append(nxt)
        return levels

    def _count_chunk(self) -> bytes:
        return len(self.leaves).to_bytes(32, "little")

    def root(self) -> bytes:
        """O(DEPTH) root from the partial branch (deposit contract
        get_deposit_root), count mixed in."""
        node = b"\x00" * 32
        size = len(self.leaves)
        for h in range(DEPTH):
            if size & 1:
                node = hashlib.sha256(self._branch[h] + node).digest()
            else:
                node = hashlib.sha256(node + _ZERO_HASHES[h]).digest()
            size >>= 1
        return hashlib.sha256(node + self._count_chunk()).digest()

    def proof(self, index: int) -> List[bytes]:
        assert 0 <= index < len(self.leaves)
        levels = self._levels()
        branch: List[bytes] = []
        pos = index
        for d in range(DEPTH):
            sibling = pos ^ 1
            level = levels[d]
            branch.append(
                level[sibling] if sibling < len(level) else _ZERO_HASHES[d]
            )
            pos //= 2
        branch.append(self._count_chunk())
        return branch


def create_genesis_state(
    config: ChainConfig,
    pubkeys: Sequence[bytes],
    genesis_time: int = 0,
    eth1_block_hash: bytes = b"\x42" * 32,
    balances: Optional[Sequence[int]] = None,
    deposit_count: Optional[int] = None,
) -> BeaconState:
    """Interop-style genesis: validators active at epoch 0."""
    state = BeaconState(config=config)
    state.genesis_time = genesis_time
    state.slot = params.GENESIS_SLOT

    fork_name = config.get_fork_name(params.GENESIS_SLOT)
    version = config.fork_versions[fork_name]
    state.fork = {
        "previous_version": version,
        "current_version": version,
        "epoch": params.GENESIS_EPOCH,
    }
    phase0_genesis = fork_name == params.ForkName.phase0
    if phase0_genesis:
        from ..types import BeaconBlockBody as _BodyPhase0

        body_root = _BodyPhase0.hash_tree_root(_BodyPhase0.default())
    else:
        body_root = BeaconBlockBodyAltair.hash_tree_root(
            BeaconBlockBodyAltair.default()
        )
    state.latest_block_header = {
        "slot": 0,
        "proposer_index": 0,
        "parent_root": b"\x00" * 32,
        "state_root": b"\x00" * 32,
        "body_root": body_root,
    }
    state.eth1_data = {
        "deposit_root": b"\x00" * 32,
        "deposit_count": (
            len(pubkeys) if deposit_count is None else deposit_count
        ),
        "block_hash": eth1_block_hash,
    }
    state.eth1_deposit_index = state.eth1_data["deposit_count"]
    state.randao_mixes = [eth1_block_hash] * P.EPOCHS_PER_HISTORICAL_VECTOR

    # columnar construction: no per-validator appends (1M-registry path)
    import numpy as np

    n = len(pubkeys)
    amounts = np.asarray(
        [P.MAX_EFFECTIVE_BALANCE] * n if balances is None else balances,
        np.uint64,
    )
    state.pubkeys = [bytes(pk) for pk in pubkeys]
    state.withdrawal_credentials = [
        b"\x00" + hashlib.sha256(pk).digest()[1:] for pk in pubkeys
    ]
    inc = np.uint64(P.EFFECTIVE_BALANCE_INCREMENT)
    state.effective_balance = np.minimum(
        amounts - amounts % inc, np.uint64(P.MAX_EFFECTIVE_BALANCE)
    )
    state.balances = amounts.copy()
    state.slashed = np.zeros(n, bool)
    state.activation_eligibility_epoch = np.full(
        n, params.GENESIS_EPOCH, np.uint64
    )
    state.activation_epoch = np.full(n, params.GENESIS_EPOCH, np.uint64)
    state.exit_epoch = np.full(n, FAR_FUTURE, np.uint64)
    state.withdrawable_epoch = np.full(n, FAR_FUTURE, np.uint64)
    state.previous_epoch_participation = np.zeros(n, np.uint8)
    state.current_epoch_participation = np.zeros(n, np.uint8)
    state.inactivity_scores = np.zeros(n, np.uint64)

    # the registry's list root through the state-root engine's validators
    # cell (one `validator_roots` launch on the card), equal to the host
    # SSZ list type's root of validators_value(); the warm engine stays
    # with the state, so its first state root does not hash the
    # registry again
    engine = state._root_engine = StateRootEngine()
    state.genesis_validators_root = engine.validators.root(state)

    if phase0_genesis:
        # PendingAttestation era: record lists instead of participation
        # flags; sync committees do not exist yet (the altair upgrade
        # computes them)
        state.previous_epoch_attestations = []
        state.current_epoch_attestations = []
        return state
    committee = get_next_sync_committee(state)
    state.current_sync_committee = committee
    state.next_sync_committee = dict(committee)
    return state
