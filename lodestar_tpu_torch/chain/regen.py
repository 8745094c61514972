"""State regeneration — replay blocks from the nearest cached state.

The port's copy of `lodestar_tpu/chain/regen.py`; it imports nothing of the
JAX package.

Reference: packages/beacon-node/src/chain/regen/regen.ts
(StateRegenerator: getPreState / getCheckpointState / getState walk the
fork-choice DAG back to a cached state, then replay blocks from the db
with the signature checks off — they were verified at import) and
chain/regen/queued.ts (QueuedStateRegenerator: the same API behind a
JobItemQueue so concurrent regen requests serialize).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from .. import params
from ..state_transition import state_transition
from ..state_transition.slot import process_slots
from ..state_transition.util import compute_start_slot_at_epoch
from ..utils.logger import get_logger
from ..utils.queue import JobItemQueue
from .state_cache import CheckpointStateCache, StateContextCache

P = params.ACTIVE_PRESET


class RegenError(Exception):
    def __init__(self, code: str, message: str = ""):
        super().__init__(f"{code}: {message}")
        self.code = code


class StateRegenerator:
    """Regen over (fork choice, db, caches).

    Blocks are looked up in the hot db by root; states come from the
    root-keyed LRU or the checkpoint cache, whichever is fewer replays
    away (reference regen.ts getState)."""

    def __init__(
        self,
        fork_choice,
        db,
        state_cache: Optional[StateContextCache] = None,
        checkpoint_cache: Optional[CheckpointStateCache] = None,
        governor=None,
    ):
        self.fork_choice = fork_choice
        self.db = db
        self.governor = governor  # StateMemoryGovernor or None
        self.state_cache = state_cache or StateContextCache(governor=governor)
        self.checkpoint_cache = checkpoint_cache or CheckpointStateCache(
            governor=governor
        )
        if governor is not None:
            governor.attach(self.state_cache, self.checkpoint_cache)
        # blockRoot(hex) -> stateRoot(hex), maintained on import and
        # PRUNED at finalization (chain.py's finalization hook calls
        # on_finalized with the proto nodes the fork-choice prune
        # removed), so it tracks the live proto nodes, not every block seen
        self.block_state_roots: Dict[str, str] = {}
        self.log = get_logger("chain/regen")
        self.replayed_blocks = 0

    # -- bookkeeping (called by the import pipeline) -----------------------

    def on_imported_block(self, block_root: bytes, post_state) -> None:
        # post_state carries a warm incremental-merkleization engine
        # (BeaconState.clone() shares it copy-on-write), so this root is
        # a cache compose and replayed/checkpoint states regenerated
        # from the cached state inherit warm trees
        state_root = post_state.hash_tree_root().hex()
        self.block_state_roots[block_root.hex()] = state_root
        self.state_cache.add_with_root(state_root, post_state)

    def live_states(self):
        """Every state currently held by the caches (LRU + checkpoint)
        — the residency set the engine-bytes metric walks."""
        yield from self.state_cache.states()
        yield from self.checkpoint_cache.states()

    def engine_bytes(self) -> int:
        """Live incremental-merkleization plane bytes across the cached
        states, COW-shared planes counted once — the full O(live-states)
        WALK.  Kept as the governor ledger's reconciliation oracle;
        hot-path consumers read resident_bytes() instead."""
        from ..state_transition.state_root import state_root_engine_bytes

        return state_root_engine_bytes(self.live_states())

    def resident_bytes(self) -> int:
        """Engine plane bytes for metrics sampling — the same quantity
        engine_bytes() measures, read from the governor's incremental
        ledger when one is attached (O(1) — the old per-head-update
        walk re-counted every plane), else the walk.  Spill bytes are
        reported separately by the governor's own gauges."""
        if self.governor is not None:
            return self.governor.ledger.plane_bytes
        return self.engine_bytes()

    def on_finalized(self, removed_nodes) -> int:
        """Finalization sweep: forget block->state-root entries (and
        their cached states) for the proto nodes the fork-choice prune
        removed — they are at/below finalization or on dead side forks
        and can never anchor a regen again."""
        dropped = 0
        for node in removed_nodes:
            root = getattr(node, "root", node)
            state_root = self.block_state_roots.pop(root, None)
            if state_root is not None:
                dropped += 1
                self.state_cache.delete(state_root)
        return dropped

    # -- public API (reference regen.ts) -----------------------------------

    def get_state(self, state_root: str):
        """State by exact state root: cache hit or RegenError (the
        reference also refuses to regen by bare state root)."""
        st = self.state_cache.get(state_root)
        if st is None:
            raise RegenError("STATE_NOT_IN_CACHE", state_root)
        return st

    def get_block_slot_state(self, block_root_hex: str, slot: int):
        """State at `slot` on the chain of `block_root` (advancing through
        empty slots as needed)."""
        state = self._get_post_state(block_root_hex)
        if state.slot > slot:
            raise RegenError(
                "SLOT_BEFORE_BLOCK",
                f"slot {slot} < block state slot {state.slot}",
            )
        if state.slot == slot:
            return state
        advanced = state.clone()
        process_slots(advanced, slot)
        return advanced

    def get_pre_state(self, block: dict):
        """Pre-state for a block: parent's post-state advanced to the
        block's slot (reference getPreState)."""
        parent_hex = block["parent_root"].hex()
        return self.get_block_slot_state(parent_hex, block["slot"])

    def get_checkpoint_state(self, checkpoint: dict):
        cached = self.checkpoint_cache.get(checkpoint)
        if cached is not None:
            return cached
        root = checkpoint["root"]
        root_hex = root.hex() if isinstance(root, bytes) else str(root)
        state = self.get_block_slot_state(
            root_hex, compute_start_slot_at_epoch(int(checkpoint["epoch"]))
        )
        self.checkpoint_cache.add(checkpoint, state)
        return state

    # -- internals ---------------------------------------------------------

    def _get_post_state(self, block_root_hex: str):
        """Post-state of an imported block: cache hit, else walk ancestors
        to the nearest cached state and replay the gap from the db."""
        state_root = self.block_state_roots.get(block_root_hex)
        if state_root is not None:
            st = self.state_cache.get(state_root)
            if st is not None:
                return st

        # walk the proto array back to a block whose post-state is cached
        pa = getattr(self.fork_choice, "proto", self.fork_choice)
        idx = pa.indices.get(block_root_hex)
        if idx is None:
            raise RegenError("BLOCK_NOT_IN_FORKCHOICE", block_root_hex)
        to_replay: List[str] = []
        base_state = None
        while idx is not None:
            node = pa.nodes[idx]
            sroot = self.block_state_roots.get(node.root)
            if sroot is not None:
                base_state = self.state_cache.get(sroot)
                if base_state is not None:
                    break
            to_replay.append(node.root)
            idx = node.parent
        if base_state is None:
            raise RegenError(
                "NO_ANCHOR_STATE",
                f"no cached ancestor state for {block_root_hex}",
            )
        if self.governor is not None and self.governor.regen_rejected(
            len(to_replay)
        ):
            # degradation-ladder rung 3: under sustained memory
            # pressure a deep-fork replay would evict exactly the
            # states it is about to recreate — refuse instead of
            # thrashing (typed, so callers can distinguish from a
            # missing anchor)
            raise RegenError(
                "MEMORY_PRESSURE",
                f"replay depth {len(to_replay)} exceeds the pressure "
                f"bound {self.governor.replay_depth_bound}",
            )

        state = base_state
        for root_hex in reversed(to_replay):
            signed = self.db.block.get(bytes.fromhex(root_hex))
            if signed is None:
                raise RegenError("BLOCK_NOT_IN_DB", root_hex)
            # signatures were verified at import; state roots still checked
            state = state_transition(
                state,
                signed,
                verify_state_root=True,
                verify_proposer=False,
                verify_signatures=False,
            )
            self.replayed_blocks += 1
            self.on_imported_block(bytes.fromhex(root_hex), state)
        return state


class QueuedStateRegenerator:
    """StateRegenerator behind a JobItemQueue (reference regen/queued.ts:
    serializes concurrent regen; queue cap 256)."""

    MAX_QUEUE = 256

    def __init__(self, regen: StateRegenerator, max_queue: int = MAX_QUEUE):
        self.regen = regen
        self._queue = JobItemQueue(self._run, max_length=max_queue)

    def _run(self, job):
        method, args = job
        return getattr(self.regen, method)(*args)

    def get_pre_state(self, block: dict):
        return self._queue.push(("get_pre_state", (block,)))

    def get_checkpoint_state(self, checkpoint: dict):
        return self._queue.push(("get_checkpoint_state", (checkpoint,)))

    def get_block_slot_state(self, block_root_hex: str, slot: int):
        return self._queue.push(
            ("get_block_slot_state", (block_root_hex, slot))
        )

    def get_state(self, state_root: str):
        return self._queue.push(("get_state", (state_root,)))

    def close(self) -> None:
        self._queue.stop()
