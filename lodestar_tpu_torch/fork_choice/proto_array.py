"""ProtoArray — the append-only fork-choice DAG.

The port's copy of `lodestar_tpu/fork_choice/proto_array.py`; it imports nothing of the
JAX package.

Reference: packages/fork-choice/src/protoArray/protoArray.ts.  Nodes are
stored in insertion order (parents before children), so score/weight
propagation is two linear passes: deltas apply backwards (child -> parent
accumulation), then best-child/best-descendant links update in a second
backward sweep over fully-coherent weights; head lookup is O(1) through
the cached best-descendant.

Hardening (reference parity, round 4):
  - proposer boost: a transient score added to the current slot's timely
    block and removed on the next score application
    (protoArray.ts:137-150 currentBoost/previousBoost accounting);
  - prune below finalized: drops pre-finalized nodes and remaps indices
    (protoArray.ts:525-600 maybePrune).

Optimistic sync (round 5, reference parity):
  - ExecutionStatus per node (Valid/Syncing/PreMerge/Invalid —
    protoArray/interface.ts:16-21) with the full LVH response handling:
    `validate_latest_hash` propagates Valid down to the ancestors or
    invalidates the [LVH-child .. invalid-payload] chain plus every
    descendant (protoArray.ts:245-388 validateLatestHash /
    propagateInValidExecutionStatusByIndex);
  - consensus-failure latching: Valid->Invalid or Invalid->Valid flips
    set `lvh_error` and every subsequent find_head raises
    (protoArray.ts:391-446, findHead:449-455);
  - unrealized justification/finalization: prev-epoch nodes are
    head-filtered on their unrealized (pulled-up) checkpoints, with the
    two-epoch pulled-up allowance (protoArray.ts:725-753
    nodeIsViableForHead).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .. import params

ZERO_HASH_HEX = "00" * 32


class ExecutionStatus:
    """Payload verdict for a proto node (reference: interface.ts:16-21).

    PreMerge = no execution payload; Syncing = imported optimistically
    (EL said SYNCING/ACCEPTED); Valid/Invalid = EL verdicts.
    """

    Valid = "Valid"
    Syncing = "Syncing"
    PreMerge = "PreMerge"
    Invalid = "Invalid"


@dataclass
class ProtoNode:
    slot: int
    root: str
    parent: Optional[int]  # index into the array
    justified_epoch: int
    finalized_epoch: int
    # pulled-up checkpoints: what justification WOULD be if the epoch
    # transition ran right after this block (reference: ProtoBlock
    # unrealizedJustifiedEpoch/unrealizedFinalizedEpoch)
    unrealized_justified_epoch: int = 0
    unrealized_finalized_epoch: int = 0
    execution_status: str = ExecutionStatus.PreMerge
    execution_block_hash: Optional[str] = None  # hex, None = pre-merge
    weight: int = 0
    best_child: Optional[int] = None
    best_descendant: Optional[int] = None


class ProtoArrayError(Exception):
    pass


class LVHConsensusError(ProtoArrayError):
    """EL verdict contradicts an already-settled status (Valid->Invalid
    or Invalid->Valid): consensus failure, the array is perma-damaged
    (reference: protoArray.ts lvhError + LVHExecErrorCode)."""


# Pruning at small offsets costs more than it saves
# (reference: protoArray.ts DEFAULT_PRUNE_THRESHOLD = 256).
DEFAULT_PRUNE_THRESHOLD = 256


class ProtoArray:
    def __init__(
        self,
        finalized_root: str,
        finalized_slot: int = 0,
        justified_epoch: int = 0,
        finalized_epoch: int = 0,
        prune_threshold: int = DEFAULT_PRUNE_THRESHOLD,
    ):
        self.nodes: List[ProtoNode] = []
        self.indices: Dict[str, int] = {}
        self.justified_epoch = justified_epoch
        self.finalized_epoch = finalized_epoch
        # when set, correct-finalized viability uses the spec's ancestor
        # walk instead of the epoch-equality shortcut
        self.finalized_root: Optional[str] = None
        self.prune_threshold = prune_threshold
        # advances via apply_score_changes/set_current_slot; drives the
        # prev-epoch unrealized-checkpoint filter
        self.current_slot: int = finalized_slot
        # set on a consensus-failure status flip; poisons find_head
        self.lvh_error: Optional[str] = None
        # (root, score) applied last round, to be backed out next round
        # (reference: protoArray.ts previousProposerBoost)
        self.previous_proposer_boost: Optional[Tuple[str, int]] = None
        self.on_block(
            finalized_slot, finalized_root, None, justified_epoch, finalized_epoch
        )

    def __contains__(self, root: str) -> bool:
        return root in self.indices

    def __len__(self) -> int:
        return len(self.nodes)

    # -- insertion (reference: protoArray.ts onBlock) ----------------------

    def on_block(
        self,
        slot: int,
        root: str,
        parent_root: Optional[str],
        justified_epoch: int,
        finalized_epoch: int,
        unrealized_justified_epoch: Optional[int] = None,
        unrealized_finalized_epoch: Optional[int] = None,
        execution_status: str = ExecutionStatus.PreMerge,
        execution_block_hash: Optional[str] = None,
    ) -> None:
        if root in self.indices:
            return
        if execution_status == ExecutionStatus.Invalid:
            raise ProtoArrayError(f"cannot insert Invalid block {root}")
        parent = None
        if parent_root is not None:
            parent = self.indices.get(parent_root)
            if parent is None:
                raise ProtoArrayError(f"unknown parent {parent_root}")
        node = ProtoNode(
            slot,
            root,
            parent,
            justified_epoch,
            finalized_epoch,
            unrealized_justified_epoch=(
                justified_epoch
                if unrealized_justified_epoch is None
                else unrealized_justified_epoch
            ),
            unrealized_finalized_epoch=(
                finalized_epoch
                if unrealized_finalized_epoch is None
                else unrealized_finalized_epoch
            ),
            execution_status=execution_status,
            execution_block_hash=execution_block_hash,
        )
        idx = len(self.nodes)
        self.indices[root] = idx
        self.nodes.append(node)
        if parent is not None:
            # a Valid child proves its whole ancestry
            # (reference: protoArray.ts:227-229)
            if node.execution_status == ExecutionStatus.Valid:
                self._propagate_valid(parent)
            self._maybe_update_best_child(parent, idx)

    # -- execution-status transitions (optimistic sync) --------------------

    def validate_latest_hash(
        self,
        execution_status: str,
        latest_valid_exec_hash: Optional[str],
        invalidate_from_block_root: Optional[str] = None,
        current_slot: Optional[int] = None,
    ) -> None:
        """Apply an EL latestValidHash verdict to the DAG
        (reference: protoArray.ts:245-315 validateLatestHash).

        Valid: find the node carrying `latest_valid_exec_hash` and flip
        it plus all Syncing ancestors to Valid (forgiving: unknown hash
        is a no-op).

        Invalid: `invalidate_from_block_root` names the newest known
        block of the bad chain (the reference passes the invalid
        block's PARENT root, verifyBlocksExecutionPayloads.ts:307 —
        despite the field's "...BlockHash" name it is a beacon root).
        If the LVH is found among its ancestors, everything above the
        LVH is invalidated plus all descendants of invalid nodes; if
        not found, only the named node is invalidated (EL may be buggy
        or lazy — protoArray.ts:296-311).
        """
        if current_slot is not None:
            self.current_slot = max(self.current_slot, current_slot)
        if execution_status == ExecutionStatus.Valid:
            if latest_valid_exec_hash is None:
                return
            # reverse scan: the LVH is almost surely near the leaves
            for i in range(len(self.nodes) - 1, -1, -1):
                if self.nodes[i].execution_block_hash == latest_valid_exec_hash:
                    self._propagate_valid(i)
                    return
            return
        if execution_status != ExecutionStatus.Invalid:
            raise ProtoArrayError(
                f"validate_latest_hash: bad status {execution_status}"
            )
        if invalidate_from_block_root is None:
            raise ProtoArrayError("Invalid verdict without a from-root")
        from_idx = self.indices.get(invalidate_from_block_root)
        if from_idx is None:
            raise ProtoArrayError(
                f"unknown invalidate-from root {invalidate_from_block_root}"
            )
        lvh_idx = (
            self._node_index_from_lvh(latest_valid_exec_hash, from_idx)
            if latest_valid_exec_hash is not None
            else None
        )
        if lvh_idx is None:
            # LVH null/not-found: invalidate only the named payload and
            # let future responses resolve the rest
            self._invalidate_node(from_idx)
        else:
            # pass 1: up the ancestry until the LVH
            idx: Optional[int] = from_idx
            while idx is not None and idx > lvh_idx:
                idx = self._invalidate_node(idx).parent
            # pass 2: every child of an invalid node is invalid
            for i, node in enumerate(self.nodes):
                p = self.nodes[node.parent] if node.parent is not None else None
                if (
                    p is not None
                    and p.execution_status == ExecutionStatus.Invalid
                ):
                    self._invalidate_node(i)
        # refresh the DAG links under the new statuses (reference
        # re-runs applyScoreChanges with zero deltas; passing the
        # previous boost keeps its accounting net-zero)
        self.apply_score_changes(
            [0] * len(self.nodes),
            self.justified_epoch,
            self.finalized_epoch,
            proposer_boost=self.previous_proposer_boost,
        )

    def propagate_valid_root(self, root: str) -> None:
        """Flip `root` and its Syncing ancestry to Valid by known beacon
        root — O(branch depth), for callers that already know the node
        (the fcU-confirmed head) instead of the O(n) exec-hash scan."""
        idx = self.indices.get(root)
        if idx is not None:
            self._propagate_valid(idx)

    def _propagate_valid(self, idx: int) -> None:
        """Syncing -> Valid up the ancestry; stop at settled statuses
        (reference: propagateValidExecutionStatusByIndex:317-330)."""
        cur: Optional[int] = idx
        while cur is not None:
            node = self.nodes[cur]
            if node.execution_status in (
                ExecutionStatus.PreMerge,
                ExecutionStatus.Valid,
            ):
                break
            if node.execution_status == ExecutionStatus.Invalid:
                self.lvh_error = (
                    f"InvalidToValid at {node.root}"
                )
                raise LVHConsensusError(self.lvh_error)
            node.execution_status = ExecutionStatus.Valid
            cur = node.parent

    def _invalidate_node(self, idx: int) -> ProtoNode:
        """Flip one node to Invalid; a Valid/PreMerge victim is a
        consensus failure (reference: invalidateNodeByIndex:391-423)."""
        node = self.nodes[idx]
        if node.execution_status in (
            ExecutionStatus.Valid,
            ExecutionStatus.PreMerge,
        ):
            self.lvh_error = (
                f"{node.execution_status}ToInvalid at {node.root}"
            )
            raise LVHConsensusError(self.lvh_error)
        node.execution_status = ExecutionStatus.Invalid
        node.best_child = None
        node.best_descendant = None
        return node

    def _node_index_from_lvh(
        self, latest_valid_exec_hash: str, ancestor_of: int
    ) -> Optional[int]:
        """Walk the ancestry for the LVH node; a PreMerge ancestor
        matches the zero hash (reference: getNodeIndexFromLVH:374-389)."""
        idx = self.nodes[ancestor_of].parent
        while idx is not None:
            node = self.nodes[idx]
            if (
                node.execution_status == ExecutionStatus.PreMerge
                and latest_valid_exec_hash == ZERO_HASH_HEX
            ) or node.execution_block_hash == latest_valid_exec_hash:
                return idx
            idx = node.parent
        return None

    # -- scoring (reference: protoArray.ts applyScoreChanges) --------------

    def apply_score_changes(
        self,
        deltas: List[int],
        justified_epoch: int,
        finalized_epoch: int,
        proposer_boost: Optional[Tuple[str, int]] = None,
        current_slot: Optional[int] = None,
    ) -> None:
        """Apply per-node weight deltas and refresh all links.

        `deltas` is indexed like `nodes` (computeDeltas output).
        `proposer_boost` is (root, score) for the current slot's timely
        block; last round's boost is automatically backed out — the boost
        is transient, living exactly one score application.

        Two backward sweeps, like the reference: weights must be fully
        coherent before any best-child comparison, otherwise an
        equal-weight tiebreak can settle on a sibling whose delta had not
        landed yet (protoArray.ts:121-186).
        """
        if len(deltas) != len(self.nodes):
            raise ProtoArrayError("invalid deltas length")
        self.justified_epoch = justified_epoch
        self.finalized_epoch = finalized_epoch
        if current_slot is not None:
            self.current_slot = max(self.current_slot, current_slot)
        boost_root, boost_score = proposer_boost or (None, 0)
        prev_root, prev_score = self.previous_proposer_boost or (None, 0)
        for i in range(len(self.nodes) - 1, -1, -1):
            node = self.nodes[i]
            if node.execution_status == ExecutionStatus.Invalid:
                # an invalidated node's standing weight is taken out of
                # consideration entirely — its delta becomes -weight and
                # back-propagates, so votes parked on the invalid
                # subtree stop counting toward ancestors
                # (reference: protoArray.ts:146-150)
                d = -node.weight
            else:
                d = deltas[i]
                if node.root == boost_root:
                    d += boost_score
                if node.root == prev_root:
                    d -= prev_score
            node.weight += d
            if node.weight < 0:
                raise ProtoArrayError(f"negative weight at {node.root}")
            if node.parent is not None:
                deltas[node.parent] += d
        for i in range(len(self.nodes) - 1, -1, -1):
            node = self.nodes[i]
            if node.parent is not None:
                self._maybe_update_best_child(node.parent, i)
        self.previous_proposer_boost = proposer_boost

    # -- head (reference: protoArray.ts findHead) --------------------------

    def find_head(self, justified_root: str) -> str:
        if self.lvh_error is not None:
            raise LVHConsensusError(self.lvh_error)
        idx = self.indices.get(justified_root)
        if idx is None:
            raise ProtoArrayError(f"unknown justified root {justified_root}")
        node = self.nodes[idx]
        best = node.best_descendant
        head = self.nodes[best] if best is not None else node
        if not self._node_is_viable_for_head(head):
            raise ProtoArrayError("head is not viable")
        return head.root

    # -- prune (reference: protoArray.ts maybePrune) -----------------------

    def maybe_prune(self, finalized_root: str) -> List[ProtoNode]:
        """Drop all nodes before the finalized one; remap indices.

        Returns the removed nodes (the archiver migrates their data).
        No-op below `prune_threshold` — pruning tiny prefixes costs more
        than it saves.
        """
        fin = self.indices.get(finalized_root)
        if fin is None:
            raise ProtoArrayError(f"unknown finalized root {finalized_root}")
        if fin < self.prune_threshold:
            return []
        removed = self.nodes[:fin]
        for node in removed:
            del self.indices[node.root]
        self.nodes = self.nodes[fin:]
        for root in self.indices:
            self.indices[root] -= fin
        for node in self.nodes:
            if node.parent is not None:
                node.parent = node.parent - fin if node.parent >= fin else None
            for attr in ("best_child", "best_descendant"):
                v = getattr(node, attr)
                if v is not None:
                    if v < fin:
                        raise ProtoArrayError(f"{attr} points below finalized")
                    setattr(node, attr, v - fin)
        return removed

    # -- internals ---------------------------------------------------------

    def _ancestor_root_at_slot(self, node: ProtoNode, slot: int) -> str:
        """Root of the node's chain at `slot` (reference: getAncestor)."""
        idx = self.indices[node.root]
        while True:
            n = self.nodes[idx]
            if n.slot <= slot or n.parent is None:
                return n.root
            idx = n.parent

    def _node_is_viable_for_head(self, node: ProtoNode) -> bool:
        """filter_block_tree: FFG + execution viability
        (reference: nodeIsViableForHead, protoArray.ts:725-753)."""
        if node.execution_status == ExecutionStatus.Invalid:
            return False
        spe = params.SLOTS_PER_EPOCH
        current_epoch = self.current_slot // spe
        previous_epoch = current_epoch - 1
        # prev-epoch blocks are judged on unrealized (pulled-up)
        # justification; current-epoch blocks on their realized state
        is_from_prev = node.slot // spe < current_epoch
        voting_source = (
            node.unrealized_justified_epoch
            if is_from_prev
            else node.justified_epoch
        )
        correct_justified = (
            voting_source == self.justified_epoch or self.justified_epoch == 0
        )
        # pulled-up allowance: unrealized justification caught up and the
        # voting source is at most two epochs stale
        if (
            not correct_justified
            and current_epoch > 0
            and self.justified_epoch == previous_epoch
        ):
            correct_justified = (
                node.unrealized_justified_epoch >= previous_epoch
                and voting_source + 2 >= current_epoch
            )
        if self.finalized_epoch == 0:
            correct_finalized = True
        elif self.finalized_root is not None:
            # spec form: the node's chain must contain the finalized root
            fin_slot = self.finalized_epoch * spe
            correct_finalized = (
                self._ancestor_root_at_slot(node, fin_slot)
                == self.finalized_root
            )
        else:
            # epoch-equality shortcut for compositions that do not track
            # the finalized root
            correct_finalized = node.finalized_epoch == self.finalized_epoch
        return correct_justified and correct_finalized

    def _node_leads_to_viable_head(self, node: ProtoNode) -> bool:
        if node.best_descendant is not None:
            return self._node_is_viable_for_head(self.nodes[node.best_descendant])
        return self._node_is_viable_for_head(node)

    def _maybe_update_best_child(self, parent_idx: int, child_idx: int) -> None:
        """Re-evaluate parent's best child against `child_idx`
        (reference: maybeUpdateBestChildAndDescendant's three outcomes)."""
        parent = self.nodes[parent_idx]
        child = self.nodes[child_idx]
        child_viable = self._node_leads_to_viable_head(child)

        if parent.best_child == child_idx:
            if not child_viable:
                self._change_best_child(parent_idx, None)
            else:
                self._change_best_child(parent_idx, child_idx)  # refresh desc
            return
        if not child_viable:
            return
        if parent.best_child is None:
            self._change_best_child(parent_idx, child_idx)
            return
        best = self.nodes[parent.best_child]
        best_viable = self._node_leads_to_viable_head(best)
        if not best_viable:
            self._change_best_child(parent_idx, child_idx)
            return
        # Prefer the existing best unless strictly greater weight, with a
        # root-order tiebreak on exact equality (reference semantics).
        if child.weight > best.weight or (
            child.weight == best.weight and child.root > best.root
        ):
            self._change_best_child(parent_idx, child_idx)

    def _change_best_child(self, parent_idx: int, child_idx: Optional[int]):
        parent = self.nodes[parent_idx]
        parent.best_child = child_idx
        if child_idx is None:
            parent.best_descendant = None
        else:
            child = self.nodes[child_idx]
            parent.best_descendant = (
                child.best_descendant
                if child.best_descendant is not None
                else child_idx
            )
