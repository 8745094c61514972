"""Block import pipeline: queue -> verify -> import.

The port's copy of `lodestar_tpu/chain/block_processor.py`; it imports nothing of the
JAX package.

Reference: packages/beacon-node/src/chain/blocks/ — `BlockProcessor`
wraps processing in a JobItemQueue (cap 256, blocks/index.ts:20),
`verifyBlocksSignatures` extracts every block's signature sets and
issues ONE verifySignatureSets call per block with all blocks in flight
at once (verifyBlocksSignatures.ts:16-60), and `importBlock` lands the
block in fork choice + the db (importBlock.ts).

The state-transition and execution-payload legs of the reference's
Promise.all are out of the BLS-path scope (SURVEY.md §7 scope guard);
the signature leg — the TPU-relevant one — is complete.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..observability import trace_span as _trace_span
from ..state_transition.signature_sets import (
    BeaconStateView,
    get_block_signature_sets,
)
from ..types import BeaconBlockAltair
from ..utils.logger import get_logger
from ..utils.queue import JobItemQueue


class BlockError(Exception):
    def __init__(self, code: str, message: str = ""):
        super().__init__(f"{code}: {message}")
        self.code = code


class BlockProcessor:
    """Queued block import over the async BLS service."""

    def __init__(
        self,
        state_view: BeaconStateView,
        bls_service,
        fork_choice=None,
        db=None,
        max_queue: int = 256,  # reference: blocks/index.ts:20
        skip_proposer_signature: bool = False,
    ):
        self.state = state_view
        self.bls = bls_service
        self.fork_choice = fork_choice
        self.db = db
        self.skip_proposer_signature = skip_proposer_signature
        self.log = get_logger("chain/blocks")
        self.imported = 0
        self._queue = JobItemQueue(self._process_blocks, max_length=max_queue)

    def can_accept_work(self) -> bool:
        return self._queue.can_accept_work()

    def process_blocks(self, signed_blocks: Sequence[dict]):
        """Enqueue a segment; returns a Future of imported roots."""
        return self._queue.push(list(signed_blocks))

    # -- the pipeline (reference: blocks/index.ts processBlocks) -----------

    @_trace_span("blocks.process_segment")
    def _process_blocks(self, signed_blocks: List[dict]) -> List[bytes]:
        self._sanity_checks(signed_blocks)
        # signatures: one verify job per block, ALL dispatched before any
        # verdict is awaited (reference: verifyBlocksSignatures.ts:44-52).
        # Each block's root is published to the state view BEFORE the
        # next block's extraction, so an in-segment sync aggregate over
        # its parent resolves the correct root.
        # remember what each published slot held before this segment, so
        # ANY failure restores the exact prior state (including a prior
        # imported root that a failing fork block temporarily shadowed)
        _MISSING = object()
        prior = {}
        imported_here = set()
        futures = []
        extracted = []
        segment_roots = []
        try:
            for signed in signed_blocks:
                sets = get_block_signature_sets(
                    self.state,
                    signed,
                    skip_proposer_signature=self.skip_proposer_signature,
                )
                extracted.append(sets)
                block = signed["message"]
                root = self.state.config.get_fork_types(
                    block["slot"]
                )[0].hash_tree_root(block)
                segment_roots.append(root)
                slot = block["slot"]
                if slot not in prior:
                    prior[slot] = self.state.block_roots.get(slot, _MISSING)
                self.state.block_roots[slot] = root
                futures.append(
                    self.bls.verify_signature_sets_async(sets)
                    if hasattr(self.bls, "verify_signature_sets_async")
                    else None
                )
            roots = []
            for signed, root, sets, fut in zip(
                signed_blocks, segment_roots, extracted, futures
            ):
                ok = (
                    fut.result(timeout=600)
                    if fut is not None
                    else self.bls.verify_signature_sets(sets)
                )
                if not ok:
                    raise BlockError(
                        "INVALID_SIGNATURE",
                        f"slot {signed['message']['slot']}",
                    )
                roots.append(self._import_block(signed, root))
                imported_here.add(signed["message"]["slot"])
            return roots
        except BaseException:
            # restore every published slot this segment did not import
            for slot, prev in prior.items():
                if slot in imported_here:
                    continue
                if prev is _MISSING:
                    self.state.block_roots.pop(slot, None)
                else:
                    self.state.block_roots[slot] = prev
            raise

    def _sanity_checks(self, signed_blocks: List[dict]) -> None:
        """Pre-state checks (reference: verifyBlocksSanityChecks.ts)."""
        last = None
        for signed in signed_blocks:
            slot = signed["message"]["slot"]
            if last is not None and slot <= last:
                raise BlockError("NON_INCREASING_SLOTS", f"{slot} after {last}")
            last = slot

    def _import_block(self, signed: dict, root: bytes) -> bytes:
        """Land the block (reference: importBlock.ts)."""
        block = signed["message"]
        if self.fork_choice is not None:
            self.fork_choice.on_block(
                block["slot"], root.hex(), block["parent_root"].hex()
            )
        if self.db is not None:
            self.db.put_block(root, signed)
        self.imported += 1
        return root

    def close(self) -> None:
        self._queue.stop()
