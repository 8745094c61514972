"""BeaconChain — the chain composition: STF import, head, duties, pools.

The port's copy of `lodestar_tpu/chain/chain.py`; it imports nothing of the
JAX package.

Reference: packages/beacon-node/src/chain/chain.ts (BeaconChain: clock,
fork choice, regen, state caches, op pools, emitter, produceBlock,
verifier selection via opts.blsVerifier) and chain/blocks/importBlock.ts
(import side effects: fork choice insert, head update, finalization
pruning, emitter events).

Two verification planes, as in the reference:
  - per-block signatures: batched through the injected BLS verifier
    (the port's service on the card) via the signature-set extractors
    when provided, else checked inside the state transition by the CPU
    oracle;
  - the state transition itself (always), its state root through the
    port's state-root engine.

Not ported yet, and raising NotImplementedError where reached (ROADMAP
Queue A): the execution-payload leg with an engine wired (item 7.1b),
deneb data availability and blob sidecars (item 7.1c), blinded
production and the builder (item 7.1d).  With no engine wired a block
that carries a payload is rejected, as in the JAX package.
"""

from __future__ import annotations

import time as _time
from contextlib import contextmanager
from typing import List, Optional

from .. import params
from ..observability import trace_span as _trace_span
from ..config.chain_config import ChainConfig
from ..state_transition import state_transition
from ..state_transition.accessors import (
    get_beacon_committee,
    get_committee_count_per_slot,
    get_proposer_indices_for_epoch,
)
from ..state_transition.slot import process_slots
from ..state_transition.util import (
    compute_epoch_at_slot,
    compute_start_slot_at_epoch,
)
from .. import types as T
from ..types import BeaconBlockAltair, BeaconBlockHeader
from ..utils.logger import get_logger
from .emitter import ChainEvent, ChainEventEmitter
from .op_pools import (
    AggregatedAttestationPool,
    AttestationPool,
    OpPool,
    SyncCommitteeMessagePool,
    SyncContributionAndProofPool,
)
from .produce_block import produce_block_from_pools
from .regen import StateRegenerator
from .seen_cache import SeenAttesters
from ..fork_choice import ExecutionStatus, ForkChoice, ProtoArray

P = params.ACTIVE_PRESET


_EXECUTION = (
    "the execution-payload leg with an engine wired is not ported yet: "
    "ROADMAP Queue A item 7.1b"
)
_BLOBS = (
    "deneb data availability and blob sidecars are not ported yet: "
    "ROADMAP Queue A item 7.1c"
)
_BUILDER = (
    "blinded production and the builder are not ported yet: "
    "ROADMAP Queue A item 7.1d"
)


class BeaconChain:
    def __init__(
        self,
        config: ChainConfig,
        anchor_state,
        *,
        db=None,
        bls_verifier=None,
        eth1=None,
        execution=None,
        monitor=None,
        emitter: Optional[ChainEventEmitter] = None,
        proposer_cache=None,
        kzg_setup=None,
        state_budget_bytes: Optional[int] = None,
        registry=None,
    ):
        if execution is not None:
            raise NotImplementedError(_EXECUTION)
        if kzg_setup is not None:
            raise NotImplementedError(_BLOBS)
        self.config = config
        self.log = get_logger("chain")
        self.emitter = emitter or ChainEventEmitter()
        # prepare_beacon_proposer registrations (a BeaconProposerCache),
        # which only the payload leg reads
        self.proposer_cache = proposer_cache
        self.db = db
        self.bls = bls_verifier  # optional batched signature service
        self.eth1 = eth1  # optional Eth1DepositDataTracker
        self.execution = execution  # optional IExecutionEngine
        self.monitor = monitor  # optional ValidatorMonitor
        self.kzg_setup = kzg_setup  # deneb blob verification/production
        # optional SlasherService (slasher/service.py): fed every
        # imported block header; pruned on finalization below
        self.slasher = None
        # optional import-completion observer `fn(slot)`:
        # the SLO engine timestamps completed imports against the slot
        # deadlines here.  Distinct from ChainEvent.block because it
        # must fire exception-isolated and AFTER the head update — the
        # moment the imported block is actually usable downstream.
        self.on_import_complete = None
        anchor_root = BeaconBlockHeader.hash_tree_root(
            dict(
                anchor_state.latest_block_header,
                state_root=anchor_state.hash_tree_root(),
            )
        )
        self.anchor_root_hex = anchor_root.hex()
        # head BEFORE the regen wiring below: the anchor-state add can
        # fire a governor eviction wave whose pin provider reads it
        self.head_root_hex = self.anchor_root_hex
        self.fork_choice = ForkChoice(
            ProtoArray(
                self.anchor_root_hex,
                finalized_slot=anchor_state.slot,
            ),
            justified_root=self.anchor_root_hex,
        )
        # state-plane memory governance: a byte-budgeted
        # residency governor over the regen LRU + checkpoint cache.
        # `state_budget_bytes` overrides the env (None = read
        # LODESTAR_TPU_STATE_BUDGET; <= 0 = disabled, the pre-governor
        # count-based LRU bounds apply unchanged).
        from .memory_governor import StateMemoryGovernor, budget_from_env

        if state_budget_bytes is None:
            budget = budget_from_env()
        else:
            budget = state_budget_bytes if state_budget_bytes > 0 else None
        self.memory_governor = None
        if budget is not None:
            self.memory_governor = StateMemoryGovernor(
                budget, config=config, registry=registry
            )
        self.regen = StateRegenerator(
            self.fork_choice, db, governor=self.memory_governor
        )
        # pinned checkpoint keys (epoch, blockRoot hex) the governor
        # must keep resident: the CHAIN-WIDE justified + finalized
        # checkpoints.  Updated only inside the monotonic FFG branches
        # below — a side-fork import's post-state carries STALE
        # checkpoints and must not replace the canonical pins.
        self._pin_justified = (
            int(anchor_state.current_justified_checkpoint["epoch"]),
            bytes(anchor_state.current_justified_checkpoint["root"]).hex(),
        )
        self._pin_finalized = (
            int(anchor_state.finalized_checkpoint["epoch"]),
            bytes(anchor_state.finalized_checkpoint["root"]).hex(),
        )
        if self.memory_governor is not None:
            self.memory_governor.pinned_fn = self._governor_pins
        self.regen.on_imported_block(anchor_root, anchor_state)

        self._finalized_epoch = int(
            anchor_state.finalized_checkpoint["epoch"]
        )

        # op pools (reference chain.ts constructor)
        self.attestation_pool = AttestationPool()
        self.aggregated_attestation_pool = AggregatedAttestationPool()
        self.op_pool = OpPool()
        self.sync_committee_message_pool = SyncCommitteeMessagePool()
        self.sync_contribution_pool = SyncContributionAndProofPool()
        self.seen_attesters = SeenAttesters()

        self.imported_blocks = 0

    def _block_type(self, slot: int):
        """Fork-aware block container (reference: config.getForkTypes)."""
        return self.config.get_fork_types(slot)[0]

    # -- memory-governor pin provider ------------------------------------

    def _governor_pins(self):
        """(pinned state roots, pinned-checkpoint predicate): the set
        the StateMemoryGovernor must NEVER evict — the head state, the
        anchor, the justified block's post-state, and the proto array's
        root node (every regen walk terminates there, so pinning it
        makes NO_ANCHOR_STATE structurally impossible).  Checkpoint
        entries pin when they are the justified/finalized checkpoints
        or sit on the head root (incl. the next-slot proposal state
        prepare_next_slot precomputes).  Reads only dict lookups — no
        regen, no hashing."""
        regen = self.regen
        roots = set()
        for block_hex in (
            self.head_root_hex,
            self.anchor_root_hex,
            self.fork_choice.justified_root,
        ):
            state_root = regen.block_state_roots.get(block_hex)
            if state_root is not None:
                roots.add(state_root)
        proto = self.fork_choice.proto
        if proto.nodes:
            state_root = regen.block_state_roots.get(proto.nodes[0].root)
            if state_root is not None:
                roots.add(state_root)
        head_hex = self.head_root_hex
        pinned_cp = {self._pin_justified, self._pin_finalized}

        def cp_pinned(epoch: int, root_hex: str) -> bool:
            return root_hex == head_hex or (epoch, root_hex) in pinned_cp

        return roots, cp_pinned

    # -- head --------------------------------------------------------------

    @property
    def head_state(self):
        return self.regen._get_post_state(self.head_root_hex)

    def get_head_root(self, slot: Optional[int] = None) -> bytes:
        return bytes.fromhex(self.head_root_hex)

    # -- block import (reference importBlock.ts) ---------------------------

    def process_block(self, signed_block: dict, timely: bool = False) -> bytes:
        """Import one signed block.  `timely` marks a proposal that
        arrived before 1/3 slot — it receives the proposer score boost
        (reference: forkChoice.ts onBlock blockDelaySec gate)."""
        t0 = _time.perf_counter()
        block = signed_block["message"]
        root = self._block_type(int(block["slot"])).hash_tree_root(block)
        if self.fork_choice.has_block(root.hex()):
            return root  # already imported
        try:
            with _trace_span(
                "chain.import", slot=int(block["slot"]), root=root.hex()[:12]
            ):
                return self._process_block_inner(
                    signed_block, block, root, timely
                )
        finally:
            timer = getattr(self, "import_timer", None)
            if timer is not None:
                timer.observe(_time.perf_counter() - t0)

    @contextmanager
    def _phase(self, name: str):
        """One import-pipeline phase: a `import.<name>` trace span plus
        an observation into the `lodestar_block_import_phase_seconds`
        labeled histogram (utils/beacon_metrics.py wires `phase_timer`).
        Failed phases raise through without observing — the histogram
        measures completed work, the span records the error."""
        t0 = _time.perf_counter()
        with _trace_span("import." + name):
            yield
        timer = getattr(self, "phase_timer", None)
        if timer is not None:
            timer.observe(name, _time.perf_counter() - t0)

    def _observe_phase(self, name: str, seconds: float) -> None:
        timer = getattr(self, "phase_timer", None)
        if timer is not None:
            timer.observe(name, seconds)

    def _process_block_inner(
        self, signed_block: dict, block: dict, root: bytes, timely: bool
    ) -> bytes:

        # phase "validation": availability gate + pre-state regen +
        # execution-payload verdict — everything that must hold before
        # the expensive signature/STF legs run.  Without an engine a
        # payload-carrying block is rejected here; deneb blobs raise.
        with self._phase("validation"):
            self._check_data_availability(block, root)
            pre_state = self.regen.get_pre_state(block)
            self._verify_execution_payload(block)

        with self._phase("signature_verify"):
            view = None
            if self.bls is not None or (
                self.monitor is not None and self.monitor.tracked_indices
            ):
                # ONE view serves both signature extraction and
                # monitoring (the two-epoch committee shuffling is the
                # expensive part)
                from ..state_transition.signature_sets import (
                    BeaconStateView,
                )

                view = BeaconStateView.from_state(pre_state)
            if self.bls is not None:
                ok = self._verify_signatures_batched(view, signed_block)
                if not ok:
                    raise ValueError(
                        "block signature verification failed"
                    )
        # without an injected verifier the signatures check inside the
        # STF (verify_signatures=True), so they account to the stf
        # phase; the reference's breakdown has the same ambiguity
        verify_in_stf = self.bls is None
        with self._phase("stf"):
            post = state_transition(
                pre_state,
                signed_block,
                verify_state_root=False,
                verify_proposer=verify_in_stf,
                verify_signatures=verify_in_stf,
            )
        with self._phase("state_root"):
            # the state-root leg of state_transition(), split out so the
            # merkleization cost is its own named phase (the incremental
            # state-root engine's win shows up HERE); the check is
            # bit-identical to transition.py's verify_state_root branch
            actual = post.hash_tree_root()
            if block["state_root"] != actual:
                from ..state_transition.block import BlockProcessError

                raise BlockProcessError(
                    f"state root mismatch at slot {block['slot']}: "
                    f"block {block['state_root'].hex()} != computed "
                    f"{actual.hex()}"
                )

        # land it (fork choice + caches + db)
        t_fc = _time.perf_counter()
        fc_seconds = 0.0
        unrealized = self._unrealized_checkpoints(block, post)
        self.fork_choice.on_block(
            block["slot"],
            root.hex(),
            block["parent_root"].hex(),
            justified_epoch=int(post.current_justified_checkpoint["epoch"]),
            finalized_epoch=int(post.finalized_checkpoint["epoch"]),
            unrealized_justified_epoch=unrealized["justified_epoch"],
            unrealized_finalized_epoch=unrealized["finalized_epoch"],
            execution_status=ExecutionStatus.PreMerge,
            execution_block_hash=None,
        )
        # clock surrogate: a block at a later slot clears any stale boost
        self.fork_choice.set_current_slot(int(block["slot"]))
        if timely:
            self.fork_choice.on_timely_block(root.hex(), int(block["slot"]))
        fc_seconds += _time.perf_counter() - t_fc
        self.regen.on_imported_block(root, post)
        if self.db is not None:
            self.db.put_block(root, signed_block)
        self.imported_blocks += 1
        self.emitter.emit(ChainEvent.block, signed_block, root)
        if self.slasher is not None:
            # ONE ingestion point for imported blocks (gossip, range
            # sync, and API publishes all funnel through here); the
            # gossip layer separately feeds never-imported duplicate-
            # proposer blocks
            try:
                # the STF already merkleized the body into the header —
                # reuse it, the import hot path must not re-hash
                self.slasher.ingest_block(
                    signed_block,
                    body_root=bytes(post.latest_block_header["body_root"]),
                    # this import VERIFIED the proposer signature —
                    # trusted headers bypass the forged-duplicate cap
                    trusted=True,
                )
            except Exception as e:  # noqa: BLE001 — detection must not
                # break the import pipeline
                self.log.warn("slasher block ingestion failed", error=str(e))
            # block-BODY attestations feed surround detection too: an
            # attacker can route one half of an equivocation only
            # through a block (it never transits gossip on this node —
            # range sync, API publish, or a proposer packing its own
            # vote), and the span window must still see it.  They are
            # STF-validated (signatures batch-verified at import) and
            # the per-(validator, data) dedupe makes gossip-seen copies
            # no-ops.  Committee translation rides the post-state's
            # per-epoch shuffle memo, so this is index arithmetic, not
            # a re-shuffle.
            from ..state_transition.accessors import get_attesting_indices

            for att in block["body"].get("attestations", ()):
                # per-attestation fault isolation: one untranslatable
                # attestation must not blind the span window to the
                # rest of the body
                try:
                    self.slasher.ingest_attestation(
                        {
                            "attesting_indices": get_attesting_indices(
                                post, att["data"], att["aggregation_bits"]
                            ),
                            "data": att["data"],
                            "signature": att["signature"],
                        }
                    )
                except Exception as e:  # noqa: BLE001
                    self.log.warn(
                        "slasher body-attestation ingestion failed",
                        error=str(e),
                    )

        # FFG bookkeeping: move the proto array's justified/finalized
        # filter + justified root as the chain justifies (reference
        # forkChoice.updateCheckpoints)
        jep = int(post.current_justified_checkpoint["epoch"])
        if jep > self._pin_justified[0]:
            # the governor's checkpoint pin advances MONOTONICALLY with
            # the chain-wide justification — never regressed by a
            # side-fork import's stale post-state
            self._pin_justified = (
                jep, bytes(post.current_justified_checkpoint["root"]).hex()
            )
        if jep > self.fork_choice.proto.justified_epoch:
            self.fork_choice.proto.justified_epoch = jep
            jroot = post.current_justified_checkpoint["root"].hex()
            if self.fork_choice.has_block(jroot):
                self.fork_choice.justified_root = jroot
            self.emitter.emit(
                ChainEvent.justified,
                dict(post.current_justified_checkpoint),
            )
        fin = int(post.finalized_checkpoint["epoch"])
        if fin > self._pin_finalized[0]:
            self._pin_finalized = (
                fin, bytes(post.finalized_checkpoint["root"]).hex()
            )
        if fin > self._finalized_epoch:
            self._finalized_epoch = fin
            self.fork_choice.proto.finalized_epoch = fin
            self.regen.checkpoint_cache.prune_finalized(fin)
            self.op_pool.prune_all(post)
            if self.slasher is not None:
                # epoch-windowed slasher pruning rides finalization
                try:
                    self.slasher.on_finalized(fin)
                except Exception as e:  # noqa: BLE001
                    self.log.warn("slasher prune failed", error=str(e))
            froot = post.finalized_checkpoint["root"].hex()
            if self.fork_choice.has_block(froot):
                # spec-form finalized viability: nodes must DESCEND from
                # this root, not merely match its epoch
                self.fork_choice.set_finalized_root(froot)
                # drop pre-finalized proto nodes (reference maybePrune;
                # no-op below the prune threshold)
                removed = self.fork_choice.prune(froot)
                # regen bookkeeping rides the same sweep: the pruned
                # nodes' block->state-root entries (and their cached
                # states) can never anchor a regen again — before this,
                # block_state_roots grew for the process lifetime
                self.regen.on_finalized(removed)
            self.emitter.emit(
                ChainEvent.finalized, dict(post.finalized_checkpoint)
            )

        # head via proto-array vote accounting (reference updateHead)
        from ..fork_choice import LVHConsensusError

        t_head = _time.perf_counter()
        try:
            with _trace_span("import.fork_choice"):
                self.fork_choice.set_balances(
                    post.effective_balance.astype("int64")
                )
                self.head_root_hex = self.fork_choice.update_head()
        except LVHConsensusError:
            # EL verdict flip-flop latched the array as perma-damaged:
            # this is irrecoverable consensus failure — escalate, never
            # fall back to "newest block wins" (reference:
            # cli/cmds/beacon/handler.ts:37-41 escalates to SIGINT)
            raise
        except Exception:
            self.head_root_hex = root.hex()
        fc_seconds += _time.perf_counter() - t_head
        # proto-array insert + head update as ONE phase: the two legs
        # bracket the db/slasher/FFG side effects above
        self._observe_phase("fork_choice", fc_seconds)
        self.emitter.emit(
            ChainEvent.head, bytes.fromhex(self.head_root_hex), block["slot"]
        )
        self._notify_forkchoice()
        if self.monitor is not None and self.monitor.tracked_indices:
            self._monitor_imported_block(view, post, signed_block)
        if self.on_import_complete is not None:
            try:
                self.on_import_complete(int(block["slot"]))
            except Exception as e:  # noqa: BLE001 — SLO bookkeeping
                # must never fail an already-landed import
                self.log.warn("import-complete observer failed", error=str(e))
        return root

    def _monitor_imported_block(self, view, post, signed_block) -> None:
        """Feed the ValidatorMonitor from IMPORTED data (reference:
        validatorMonitor.ts — the chain, not the validator client, is
        the ground truth for duty performance)."""
        from ..state_transition.accessors import get_block_root_at_slot

        block = signed_block["message"]
        mon = self.monitor
        mon.register_beacon_block(
            int(block["proposer_index"]), int(block["slot"])
        )
        parent_idx = self.fork_choice.proto.indices.get(
            block["parent_root"].hex()
        )
        parent_slot = (
            self.fork_choice.proto.nodes[parent_idx].slot
            if parent_idx is not None
            else int(block["slot"]) - 1
        )
        for att in block["body"].get("attestations", []):
            try:
                indexed = view.get_indexed_attestation(att)
            except Exception:
                continue
            if not mon.tracked_indices.intersection(
                int(v) for v in indexed["attesting_indices"]
            ):
                continue
            data = att["data"]
            try:
                actual = get_block_root_at_slot(post, int(data["slot"]))
                correct_head = bytes(data["beacon_block_root"]) == bytes(actual)
            except Exception:
                correct_head = False
            mon.register_attestation_in_block(indexed, parent_slot, correct_head)
        sync_agg = block["body"].get("sync_aggregate")
        if sync_agg is not None:
            epoch = int(block["slot"]) // P.SLOTS_PER_EPOCH
            participants = view.epoch_cache.get_sync_committee_participant_indices(
                sync_agg["sync_committee_bits"]
            )
            tracked = [
                int(v) for v in participants if int(v) in mon.tracked_indices
            ]
            if tracked:
                mon.register_sync_aggregate_in_block(epoch, tracked)
        # epoch close: when the chain enters epoch E, the summaries of
        # E-2 are final (reference subtracts two for the inclusion
        # tail).  The PARENT's epoch is the last one already entered —
        # pre_state is advanced to the block slot, so comparing pre/post
        # would never fire; skipped epochs each close in turn.
        parent_epoch = compute_epoch_at_slot(parent_slot)
        block_epoch = compute_epoch_at_slot(int(block["slot"]))
        for entered in range(parent_epoch + 1, block_epoch + 1):
            if entered >= 2:
                mon.on_epoch_close(entered - 2)

    # -- data availability (deneb) -----------------------------------------

    def on_blob_sidecar(self, block_root: bytes, index: int, commitment: bytes,
                        slot: Optional[int] = None, sidecar: Optional[dict] = None) -> None:
        raise NotImplementedError(_BLOBS)

    def get_blob_sidecars(self, block_root: bytes) -> Optional[list]:
        raise NotImplementedError(_BLOBS)

    def _check_data_availability(self, block: dict, root: bytes) -> None:
        """A block with blob commitments needs its sidecars' availability,
        which is not ported: it raises rather than importing unchecked."""
        body = block.get("body", {})
        commitments = (
            body.get("blob_kzg_commitments")
            if isinstance(body, dict)
            else None
        )
        if commitments:
            raise NotImplementedError(_BLOBS)

    def _unrealized_checkpoints(self, block: dict, post) -> dict:
        """Pulled-up checkpoints for the fork-choice node (reference:
        forkChoice.ts:377-415).  If the parent's unrealized justification
        already reached this block's epoch (and finalization is at most
        one epoch behind), the child cannot move them — reuse the
        parent's values and skip the clone+epoch-weighing entirely."""
        block_epoch = compute_epoch_at_slot(int(block["slot"]))
        parent_idx = self.fork_choice.proto.indices.get(
            block["parent_root"].hex()
        )
        if parent_idx is not None:
            p = self.fork_choice.proto.nodes[parent_idx]
            if (
                p.unrealized_justified_epoch == block_epoch
                and p.unrealized_finalized_epoch + 1 >= block_epoch
            ):
                return {
                    "justified_epoch": p.unrealized_justified_epoch,
                    "finalized_epoch": p.unrealized_finalized_epoch,
                }
        from ..state_transition.epoch import compute_unrealized_checkpoints

        cps = compute_unrealized_checkpoints(post)
        return {
            "justified_epoch": int(cps["justified"]["epoch"]),
            "finalized_epoch": int(cps["finalized"]["epoch"]),
        }

    def _verify_execution_payload(self, block: dict) -> None:
        """The third verification leg (reference: verifyBlock.ts
        verifyBlocksExecutionPayload -> engine notifyNewPayload).  A
        payload with no engine wired rejects the block, as in the JAX
        package."""
        body = block.get("body", {})
        payload = (
            body.get("execution_payload") if isinstance(body, dict) else None
        )
        if payload is None:
            return
        if self.execution is None:
            raise ValueError("execution payload present but no engine wired")
        raise NotImplementedError(_EXECUTION)

    def _notify_forkchoice(self) -> None:
        """Push the beacon head to the EL after head updates (reference:
        importBlock.ts -> executionEngine.notifyForkchoiceUpdate); no
        engine, nothing to push."""
        if self.execution is None:
            return
        raise NotImplementedError(_EXECUTION)

    def _verify_signatures_batched(self, view, signed_block) -> bool:
        """One batched job through the injected verifier service using the
        wire signature-set extractors (reference
        verifyBlocksSignatures.ts).  The port submits the block's sets as
        one batchable, block-critical job (an RLC batch on the card's
        short-deadline lane, bisected only when it fails); the JAX
        package's chain passes no options.  The verdict is the same."""
        from ..bls.verifier import VerifyOptions
        from ..state_transition.signature_sets import (
            get_block_signature_sets,
        )

        sets = get_block_signature_sets(view, signed_block)
        opts = VerifyOptions(batchable=True, priority=True)
        if hasattr(self.bls, "verify_signature_sets_async"):
            fut = self.bls.verify_signature_sets_async(sets, opts)
            return bool(fut.result(timeout=600))
        return bool(self.bls.verify_signature_sets(sets, opts))

    # -- produce (reference produceBlock/index.ts) -------------------------

    def produce_block(
        self,
        slot: int,
        randao_reveal: bytes,
        graffiti: bytes = b"\x00" * 32,
    ) -> dict:
        head = self.head_state
        block, _post = produce_block_from_pools(
            head,
            slot,
            randao_reveal,
            aggregated_attestation_pool=self.aggregated_attestation_pool,
            op_pool=self.op_pool,
            contribution_pool=self.sync_contribution_pool,
            head_root=self.get_head_root(),
            graffiti=graffiti,
            eth1=self.eth1,
            execution=self.execution,
        )
        return block

    def produce_blinded_block(
        self,
        slot: int,
        randao_reveal: bytes,
        graffiti: bytes = b"\x00" * 32,
    ) -> dict:
        raise NotImplementedError(_BUILDER)

    def submit_blinded_block(self, signed_blinded: dict) -> bytes:
        raise NotImplementedError(_BUILDER)

    # -- duties (reference api/impl/validator/duties) ----------------------

    def _state_at_epoch(self, epoch: int):
        """Epoch-aligned state on the head chain (checkpoint-cached)."""
        head = self.head_state
        target = compute_start_slot_at_epoch(epoch)
        if head.slot >= target:
            if compute_epoch_at_slot(head.slot) == epoch:
                return head
            raise ValueError(f"epoch {epoch} is before the head epoch")
        cp = {"epoch": epoch, "root": self.get_head_root()}
        return self.regen.get_checkpoint_state(cp)

    def get_proposer_duties(self, epoch: int) -> List[dict]:
        state = self._state_at_epoch(epoch)
        proposers = get_proposer_indices_for_epoch(state, epoch)
        start = compute_start_slot_at_epoch(epoch)
        return [
            {
                "validator_index": v,
                "pubkey": state.pubkeys[v],
                "slot": start + i,
            }
            for i, v in enumerate(proposers)
        ]

    def get_attester_duties(
        self, epoch: int, indices: List[int]
    ) -> List[dict]:
        state = self._state_at_epoch(epoch)
        wanted = set(indices)
        duties = []
        start = compute_start_slot_at_epoch(epoch)
        for slot in range(start, start + P.SLOTS_PER_EPOCH):
            for ci in range(get_committee_count_per_slot(state, epoch)):
                committee = get_beacon_committee(state, slot, ci)
                for pos, v in enumerate(committee):
                    if int(v) in wanted:
                        duties.append(
                            {
                                "validator_index": int(v),
                                "committee_index": ci,
                                "committee_length": len(committee),
                                "validator_committee_index": pos,
                                "slot": slot,
                            }
                        )
        return duties

    def get_sync_committee_duties(
        self, epoch: int, indices: List[int]
    ) -> List[dict]:
        head = self.head_state
        duties = []
        for vindex in indices:
            if vindex >= head.num_validators:
                continue
            pk = head.pubkeys[vindex]
            positions = [
                i
                for i, cpk in enumerate(
                    head.current_sync_committee["pubkeys"]
                )
                if cpk == pk
            ]
            if positions:
                duties.append(
                    {"validator_index": vindex, "positions": positions}
                )
        return duties

    def resolve_block_id(self, block_id: str) -> Optional[bytes]:
        """Spec block-id forms: head | genesis | finalized | <slot> |
        0x<root> (reference: api/impl/beacon/blocks/utils.ts)."""
        if block_id == "head":
            return bytes.fromhex(self.head_root_hex)
        if block_id == "genesis":
            return bytes.fromhex(self.anchor_root_hex)
        if block_id == "finalized":
            root = self.head_state.finalized_checkpoint["root"]
            return root if any(root) else bytes.fromhex(self.anchor_root_hex)
        if block_id.startswith("0x"):
            return bytes.fromhex(block_id[2:])
        if block_id.isdigit():
            # canonical chain walk: head ancestors via the proto array
            slot = int(block_id)
            pa = self.fork_choice.proto
            idx = pa.indices.get(self.head_root_hex)
            while idx is not None:
                node = pa.nodes[idx]
                if node.slot == slot:
                    return bytes.fromhex(node.root)
                if node.slot < slot:
                    return None  # empty slot
                idx = node.parent
            return None
        return None

    def produce_attestation_data(
        self, committee_index: int, slot: int
    ) -> dict:
        """AttestationData for the current head (reference:
        api/impl/validator/produceAttestationData)."""
        from ..state_transition.accessors import get_block_root_at_slot

        head = self.head_state
        head_root = self.get_head_root()
        epoch = slot // P.SLOTS_PER_EPOCH
        start = compute_start_slot_at_epoch(epoch)
        target_root = (
            head_root
            if start >= head.slot
            else get_block_root_at_slot(head, start)
        )
        return {
            "slot": slot,
            "index": committee_index,
            "beacon_block_root": head_root,
            "source": dict(head.current_justified_checkpoint),
            "target": {"epoch": epoch, "root": target_root},
        }

    # -- op validation at pool ingress (reference chain/validation/*) ------
    # Each op is dry-run through its own state-transition handler on a
    # head-state clone (full checks including signatures): an op the STF
    # would reject must never enter the pool, where it would poison
    # every subsequent block production.

    def validate_voluntary_exit(self, signed_exit: dict) -> None:
        from ..state_transition.block import process_voluntary_exit

        process_voluntary_exit(self.head_state.clone(), signed_exit, True)

    def validate_proposer_slashing(self, slashing: dict) -> None:
        from ..state_transition.block import process_proposer_slashing

        process_proposer_slashing(self.head_state.clone(), slashing, True)

    def validate_attester_slashing(self, slashing: dict) -> None:
        from ..state_transition.block import process_attester_slashing

        process_attester_slashing(self.head_state.clone(), slashing, True)

    def validate_bls_to_execution_change(self, signed_change: dict) -> None:
        from ..state_transition.block import (
            process_bls_to_execution_change,
        )

        process_bls_to_execution_change(
            self.head_state.clone(), signed_change, True
        )

    def on_attester_slashing(self, slashing: dict) -> None:
        """Zero the equivocating validators' fork-choice influence
        (reference: chain.ts emitter AttesterSlashing ->
        forkChoice.onAttesterSlashing)."""
        from .op_pools import attester_slashing_intersection

        self.fork_choice.on_attester_slashing(
            attester_slashing_intersection(slashing)
        )

    # -- gossip op ingress (reference chain.ts pool adders) ----------------

    def add_attestation(self, attestation: dict) -> str:
        status = self.attestation_pool.add(attestation)
        self.emitter.emit(ChainEvent.attestation, attestation)
        return status

    def add_aggregate(self, aggregate_and_proof: dict) -> str:
        return self.aggregated_attestation_pool.add(
            aggregate_and_proof["message"]["aggregate"]
            if "message" in aggregate_and_proof
            else aggregate_and_proof
        )

    def prune_pools(self, clock_slot: int) -> None:
        self.attestation_pool.prune(clock_slot)
        self.aggregated_attestation_pool.prune(clock_slot)
        self.sync_committee_message_pool.prune(clock_slot)
        self.sync_contribution_pool.prune(clock_slot)
