"""Archiver — finalization-driven hot→cold block migration.

The port's copy of `lodestar_tpu/chain/archiver.py`; it imports nothing of the
JAX package.

Reference: packages/beacon-node/src/chain/archiver/index.ts (subscribes
to the finalized checkpoint event) + archiver/archiveBlocks.ts (move
finalized canonical blocks from the hot block repo into blockArchive
keyed by slot; delete non-canonical hot blocks at or below the
finalized slot) and archiver/archiveStates.ts (persist one state per
archived checkpoint).
"""

from __future__ import annotations

from typing import List, Optional

from .. import params
from ..state_transition.util import compute_start_slot_at_epoch
from ..utils.logger import get_logger
from .emitter import ChainEvent


class Archiver:
    def __init__(self, chain):
        self.chain = chain
        self.log = get_logger("chain/archiver")
        self.archived_blocks = 0
        self.pruned_blocks = 0
        self.archived_states = 0
        chain.emitter.on(ChainEvent.finalized, self.on_finalized)

    def on_finalized(self, checkpoint: dict) -> None:
        db = self.chain.db
        if db is None:
            return
        finalized_slot = compute_start_slot_at_epoch(int(checkpoint["epoch"]))
        root = checkpoint["root"]
        root_hex = root.hex() if isinstance(root, bytes) else str(root)

        # persist the finalized checkpoint state FIRST: regen may need to
        # replay hot blocks that the migration below deletes
        # (archiveStates.ts runs from the checkpoint cache for the same
        # reason)
        try:
            state = self.chain.regen.get_checkpoint_state(
                {"epoch": int(checkpoint["epoch"]), "root": root}
            )
            db.archive_state(finalized_slot, state.serialize())
            self.archived_states += 1
        except Exception as e:  # noqa: BLE001 - archive best-effort
            self.log.warn("state archive failed", error=str(e))

        # canonical chain at/below the finalized slot, via the proto array
        pa = self.chain.fork_choice.proto
        idx = pa.indices.get(root_hex)
        canonical: List[str] = []
        while idx is not None:
            node = pa.nodes[idx]
            canonical.append(node.root)
            idx = node.parent
        canonical_set = set(canonical)

        # migrate canonical finalized blocks to the slot-keyed archive
        for rhex in canonical:
            rbytes = bytes.fromhex(rhex) if len(rhex) == 64 else None
            if rbytes is None:
                continue  # synthetic anchor roots are not in the db
            signed = db.block.get(rbytes)
            if signed is None:
                continue
            slot = signed["message"]["slot"]
            if slot > finalized_slot:
                continue
            db.archive_block(slot, signed, root=rbytes)
            db.block.delete(rbytes)
            # blob sidecars ride along hot->cold (reference:
            # archiveBlocks.ts migrates blobsSidecar the same way)
            if hasattr(db, "blobs_sidecar"):
                sidecars = db.blobs_sidecar.get(rbytes)
                if sidecars is not None:
                    db.archive_blob_sidecars(slot, sidecars, root=rbytes)
            self.archived_blocks += 1

        # prune non-canonical forks at/below the finalized slot
        for node in pa.nodes:
            if node.slot > finalized_slot or node.root in canonical_set:
                continue
            if len(node.root) != 64:
                continue
            rbytes = bytes.fromhex(node.root)
            if db.block.has(rbytes):
                db.block.delete(rbytes)
                self.pruned_blocks += 1

        self.log.info(
            "archived finalized blocks",
            epoch=int(checkpoint["epoch"]),
            archived=self.archived_blocks,
            pruned=self.pruned_blocks,
        )
