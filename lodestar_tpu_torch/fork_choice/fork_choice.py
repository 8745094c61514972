"""ForkChoice facade: latest messages + head computation.

The port's copy of `lodestar_tpu/fork_choice/fork_choice.py`; it imports nothing of the
JAX package.

Reference: packages/fork-choice/src/forkChoice/forkChoice.ts — tracks
per-validator latest messages (epoch, block root), converts votes to
proto-array score changes on update_head, and exposes the IForkChoice
surface the chain/processor layers consume (hasBlock/getHead/onBlock/
onAttestation).

Hardening (round 4):
  - proposer boost: `on_timely_block` records the current slot's timely
    proposal; `update_head` applies the transient boost score =
    (total_active_balance / SLOTS_PER_EPOCH) * PROPOSER_SCORE_BOOST%
    (reference: forkChoice.ts:1188-1215 computeProposerBoostScore);
    `on_tick_slot` clears it at the slot boundary.
  - equivocation: `on_attester_slashing` zeroes the slashed validators'
    votes permanently (reference: forkChoice.ts onAttesterSlashing ->
    computeDeltas.ts:47-63).
  - prune: `prune(finalized_root)` forwards to ProtoArray.maybe_prune.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

import numpy as np

from .. import params
from .compute_deltas import compute_deltas
from .proto_array import ExecutionStatus, ProtoArray, ProtoNode

SLOTS_PER_EPOCH = params.SLOTS_PER_EPOCH  # preset-aware
PROPOSER_SCORE_BOOST_PCT = 40  # config presets mainnet.ts:73


@dataclass
class LatestMessage:
    epoch: int
    root: str


class ForkChoice:
    def __init__(
        self,
        proto_array: ProtoArray,
        justified_root: str,
        balances: Optional[np.ndarray] = None,
        proposer_score_boost_pct: int = PROPOSER_SCORE_BOOST_PCT,
        slots_per_epoch: int = SLOTS_PER_EPOCH,
    ):
        self.proto = proto_array
        self.justified_root = justified_root
        self.balances = (
            balances if balances is not None else np.zeros(0, np.int64)
        )
        self.proposer_score_boost_pct = proposer_score_boost_pct
        self.slots_per_epoch = slots_per_epoch
        self._latest: Dict[int, LatestMessage] = {}
        # vote state at the last update_head (for delta computation)
        self._applied_votes: Dict[int, str] = {}
        self._applied_balances = np.zeros_like(self.balances)
        # all known equivocators: their future attestations are ignored;
        # removal from _latest backs their standing vote out on the next
        # update_head (no extra delta plumbing needed)
        self._equivocating: set[int] = set()
        # current slot's timely proposal (cleared every slot tick)
        self.proposer_boost_root: Optional[str] = None
        self._boost_slot: Optional[int] = None

    # -- block / attestation ingestion ------------------------------------

    def has_block(self, root: str) -> bool:
        return root in self.proto

    def on_block(
        self,
        slot: int,
        root: str,
        parent_root: Optional[str],
        justified_epoch: int = None,
        finalized_epoch: int = None,
        unrealized_justified_epoch: int = None,
        unrealized_finalized_epoch: int = None,
        execution_status: str = ExecutionStatus.PreMerge,
        execution_block_hash: Optional[str] = None,
    ) -> None:
        self.proto.on_block(
            slot,
            root,
            parent_root,
            self.proto.justified_epoch if justified_epoch is None else justified_epoch,
            self.proto.finalized_epoch if finalized_epoch is None else finalized_epoch,
            unrealized_justified_epoch=unrealized_justified_epoch,
            unrealized_finalized_epoch=unrealized_finalized_epoch,
            execution_status=execution_status,
            execution_block_hash=execution_block_hash,
        )

    def validate_latest_hash(
        self,
        execution_status: str,
        latest_valid_exec_hash: Optional[str],
        invalidate_from_block_root: Optional[str] = None,
    ) -> None:
        """Forward an EL latestValidHash verdict to the proto array
        (reference: forkChoice.ts validateLatestHash passthrough)."""
        self.proto.validate_latest_hash(
            execution_status,
            latest_valid_exec_hash,
            invalidate_from_block_root,
        )

    def get_execution_status(self, root: str) -> Optional[str]:
        idx = self.proto.indices.get(root)
        return self.proto.nodes[idx].execution_status if idx is not None else None

    def get_node(self, root: str) -> Optional[ProtoNode]:
        """Read-only node lookup (reference: forkChoice.getBlock)."""
        idx = self.proto.indices.get(root)
        return self.proto.nodes[idx] if idx is not None else None

    def propagate_valid_root(self, root: str) -> None:
        self.proto.propagate_valid_root(root)

    def set_finalized_root(self, root: str) -> None:
        """Arm the spec-form finalized viability filter (nodes must
        descend from this root, not merely match its epoch)."""
        self.proto.finalized_root = root

    def descends_from_finalized(self, root: str) -> bool:
        """Does `root`'s chain contain the tracked finalized root?
        True when no finalized root is tracked yet (bootstrap)."""
        fin = self.proto.finalized_root
        if fin is None:
            return True
        node = self.get_node(root)
        if node is None:
            return False
        fin_slot = self.proto.finalized_epoch * self.slots_per_epoch
        return self.proto._ancestor_root_at_slot(node, fin_slot) == fin

    def on_timely_block(self, root: str, slot: Optional[int] = None) -> None:
        """Arm the proposer boost for a block arriving before 1/3 slot
        (reference: forkChoice.ts onBlock's blockDelaySec gate).

        First block wins: the spec only boosts when no boost is armed
        (`if store.proposer_boost_root == Root()`), so an equivocating
        proposer cannot move the boost to its second block."""
        if self.proposer_boost_root is not None:
            return
        self.proposer_boost_root = root
        self._boost_slot = slot

    def on_tick_slot(self) -> None:
        """Slot boundary: the boost is strictly per-slot."""
        self.proposer_boost_root = None
        self._boost_slot = None

    def set_current_slot(self, slot: int) -> None:
        """Clock surrogate for clock-less compositions (BeaconChain):
        any evidence that time moved past the boosted slot clears the
        boost (reference: forkChoice.ts updateTime); the proto array's
        clock drives the prev-epoch unrealized-checkpoint filter."""
        self.proto.current_slot = max(self.proto.current_slot, slot)
        if self._boost_slot is not None and slot > self._boost_slot:
            self.on_tick_slot()

    def on_attestation(self, validator_index: int, epoch: int, root: str) -> None:
        """Track the validator's latest message (newest epoch wins).
        Equivocating validators' messages are dead on arrival."""
        if validator_index in self._equivocating:
            return
        cur = self._latest.get(validator_index)
        if cur is None or epoch > cur.epoch:
            self._latest[validator_index] = LatestMessage(epoch, root)

    def on_attester_slashing(self, indices: Iterable[int]) -> None:
        """Zero the slashed validators' fork-choice influence, once and
        permanently (reference: computeDeltas.ts:47-63).  Dropping the
        validator from the latest-message map makes the next
        compute_deltas back out its standing vote (new index -1), and
        the on_attestation guard keeps it out forever."""
        for v in indices:
            self._equivocating.add(v)
            self._latest.pop(v, None)

    def set_balances(self, balances: np.ndarray) -> None:
        self.balances = np.asarray(balances, np.int64)

    # -- head (reference: forkChoice.updateHead) ---------------------------

    def _proposer_boost_score(self) -> int:
        """Committee-weight approximation of one slot's attesters
        (reference: forkChoice.ts computeProposerBoostScore)."""
        total = int(self.balances.sum())
        return (total // self.slots_per_epoch) * self.proposer_score_boost_pct // 100

    def update_head(self) -> str:
        n_val = max(
            len(self.balances),
            (max(self._latest) + 1) if self._latest else 0,
            (max(self._applied_votes) + 1) if self._applied_votes else 0,
            len(self._applied_balances),
        )
        old_votes = np.full(n_val, -1, np.int64)
        new_votes = np.full(n_val, -1, np.int64)
        for v, root in self._applied_votes.items():
            idx = self.proto.indices.get(root)
            if idx is not None:
                old_votes[v] = idx
        for v, msg in self._latest.items():
            idx = self.proto.indices.get(msg.root)
            if idx is not None:
                new_votes[v] = idx
        old_bal = np.zeros(n_val, np.int64)
        old_bal[: len(self._applied_balances)] = self._applied_balances
        new_bal = np.zeros(n_val, np.int64)
        new_bal[: len(self.balances)] = self.balances

        deltas = compute_deltas(
            len(self.proto), old_votes, new_votes, old_bal, new_bal
        )
        boost = None
        if (
            self.proposer_boost_root is not None
            and self.proposer_boost_root in self.proto
        ):
            boost = (self.proposer_boost_root, self._proposer_boost_score())
        self.proto.apply_score_changes(
            deltas,
            self.proto.justified_epoch,
            self.proto.finalized_epoch,
            proposer_boost=boost,
        )
        self._applied_votes = {v: m.root for v, m in self._latest.items()}
        self._applied_balances = new_bal
        return self.proto.find_head(self.justified_root)

    # -- prune (reference: forkChoice.prune) -------------------------------

    def prune(self, finalized_root: str) -> List[ProtoNode]:
        removed = self.proto.maybe_prune(finalized_root)
        if removed:
            # standing votes for pruned roots resolve to "not in indices"
            # next update (outside the tree == pre-finalization, ignored)
            gone = {n.root for n in removed}
            self._applied_votes = {
                v: r for v, r in self._applied_votes.items() if r not in gone
            }
        return removed
