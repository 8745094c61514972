"""BeaconNode — the composition root of the port, a copy of
`lodestar_tpu/node.py`'s `NodeOptions` and `BeaconNode` (:38-241) over
the port's modules; it imports nothing of the JAX package.

Mirror of the reference's BeaconNode.init wiring order (reference:
packages/beacon-node/src/node/nodejs.ts:134-307): metrics, db, chain
components (clock, fork choice, seen caches, the BLS verifier service)
and the network processor — composed over the port's verifier stack
(`TorchBlsVerifier` under `create_bls_service`) instead of worker
threads.

The node's gossip entry (`on_gossip_attestation`) is the framework-level
end-to-end slice: bytes -> queues -> seen caches -> wire sets -> device
verification -> verdict, mirroring SURVEY.md §3.2's hot loop.

Where the port differs from the JAX node:
  - the REST API server is not ported yet: `NodeOptions.serve_api`
    defaults to False, and True raises NotImplementedError;
  - `NodeOptions.device` picks the verifier's device when the node builds
    it (None: the CUDA device; "cpu": the kernels' plain versions);
  - `NodeOptions` keeps only the fields BeaconNode reads; the JAX
    package's FullBeaconNode, and its options, are not ported yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

from . import params
from .bls.pipeline import create_bls_service
from .bls.signature_set import WireSignatureSet
from .bls.verifier import TorchBlsVerifier, VerifyOptions
from .chain.clock import Clock
from .chain.seen_cache import SeenAttesters
from .config.chain_config import ChainConfig
from .db.beacon_db import BeaconDb
from .fork_choice import ForkChoice, ProtoArray
from .network.gossip_queues import GossipType
from .network.processor import NetworkProcessor, PendingGossipMessage
from .utils.logger import get_logger
from .utils.metrics import BlsPoolMetrics, Registry


@dataclass
class NodeOptions:
    db_path: Optional[str] = None
    # the REST API is not ported yet: True raises NotImplementedError
    serve_api: bool = False
    verifier: Optional[object] = None  # injected IBlsVerifier (tests)
    # the device of the verifier the node builds when none is injected
    # (None: the CUDA device; "cpu": the kernels' plain versions)
    device: Optional[object] = None


class BeaconNode:
    """Wires the framework; start() brings subsystems up in the
    reference's order, close() tears them down in reverse."""

    def __init__(
        self,
        config: ChainConfig,
        pubkey_table,
        genesis_root: str = "genesis",
        opts: Optional[NodeOptions] = None,
    ):
        opts = opts or NodeOptions()
        if opts.serve_api:
            raise NotImplementedError(
                "the port has no REST API server yet (ROADMAP Queue A item 7); "
                "build the node with NodeOptions(serve_api=False)"
            )
        self.config = config
        self.log = get_logger("node")
        self.registry = Registry()
        self.metrics = BlsPoolMetrics(self.registry)

        self.db = BeaconDb(opts.db_path, config=config)
        self.clock = Clock(genesis_time=config.genesis_time)
        self.fork_choice = ForkChoice(ProtoArray(genesis_root), genesis_root)

        verifier = opts.verifier or TorchBlsVerifier(
            pubkey_table, device=opts.device, metrics=self.metrics
        )
        # the accumulate-and-flush pipeline by default; the flat service
        # under LODESTAR_TPU_BLS_PIPELINE=0 (bls/pipeline.py)
        self.bls = create_bls_service(verifier)

        self.seen_attesters = SeenAttesters()
        self.processor = NetworkProcessor(
            self._validate_gossip_message,
            [self.bls.can_accept_work],
            has_block_root=self.fork_choice.has_block,
            registry=self.registry,
        )
        self.clock.on_slot(self.processor.on_clock_slot)
        # proposer boost is strictly per-slot (reference: forkChoice.ts
        # onBlock/updateTime)
        self.clock.on_slot(lambda _slot: self.fork_choice.on_tick_slot())

        self._futures = []
        self._pending_attesters = set()
        # verdict observer: fn(validator_index, seen_at, future), called as
        # each submitted verification resolves, on the thread resolving it
        self.on_verdict: Optional[Callable[[int, float, object], None]] = None

    def start(self) -> None:
        """Nothing to bring up until the REST API is ported."""

    # -- gossip ingress (reference hot loop, SURVEY.md §3.2) ---------------

    def on_gossip_attestation(
        self,
        validator_index: int,
        slot: int,
        data_key: bytes,
        signing_root: bytes,
        signature: bytes,
        block_root: Optional[str] = None,
        peer_id: Optional[str] = None,
    ) -> None:
        """Enqueue one attestation's validation (async verdict).
        `peer_id` attributes the publish so overflow drops under
        backpressure charge the flooding peer (processor scorer hook)."""
        self.processor.on_gossip_message(
            PendingGossipMessage(
                GossipType.beacon_attestation,
                (validator_index, slot, data_key, signing_root, signature),
                slot=slot,
                block_root=block_root,
                seen_at=time.time(),
                peer_id=peer_id,
            )
        )

    def _validate_gossip_message(self, msg: PendingGossipMessage) -> None:
        validator_index, slot, data_key, signing_root, signature = msg.data
        epoch = slot // params.SLOTS_PER_EPOCH
        # dedup against ACCEPTED attesters and in-flight verifications; a
        # validator is only marked seen once their signature verifies, so
        # a garbage attestation cannot suppress the real one
        # (reference race guard: validation/attestation.ts:267-278)
        if self.seen_attesters.is_known(epoch, validator_index) or (
            (epoch, validator_index) in self._pending_attesters
        ):
            return
        # NOTE: the caller-supplied signing_root is used as-is — a
        # SeenAttestationDatas substitution here would let the FIRST
        # sender poison the root for every later honest attester.  The
        # reference caches values DERIVED from the attestation data
        # itself (committee indices, root computed from the data); that
        # derivation lives with the extractors, and hash-to-curve reuse
        # already happens in the verifier's MessageCache keyed by root.
        ws = WireSignatureSet.single(validator_index, signing_root, signature)
        # subnet attestations ride the pipeline's standard (long-window)
        # lane — where the pre-verify aggregation stage buckets them by
        # signing root; block-critical topics (aggregate_and_proof,
        # blocks) would pass priority=True for the short-deadline lane.
        # peer_id/topic attribute the publish so a contributor isolated
        # as invalid by aggregate bisection charges its publisher through
        # the gossip scorer.
        fut = self.bls.verify_signature_sets_async(
            [ws],
            VerifyOptions(
                batchable=True,
                priority=msg.topic is not GossipType.beacon_attestation,
                peer_id=msg.peer_id,
                topic=msg.topic.value if msg.topic is not None else None,
            ),
        )
        self._pending_attesters.add((epoch, validator_index))
        self._futures.append((validator_index, epoch, fut))
        if self.on_verdict is not None:
            observe, seen_at = self.on_verdict, msg.seen_at
            fut.add_done_callback(lambda f: observe(validator_index, seen_at, f))

    def drain_verdicts(self, timeout: float = 60.0) -> int:
        """Resolve outstanding verifications; count accepted.

        Accepted attesters become seen (dedup for the rest of the
        epoch); rejected ones are released so a later valid attestation
        from the same validator still gets through.
        """
        accepted = 0
        for idx, epoch, fut in self._futures:
            ok = fut.result(timeout=timeout)
            self._pending_attesters.discard((epoch, idx))
            if ok:
                self.seen_attesters.add(epoch, idx)
                accepted += 1
        self._futures = []
        return accepted

    def close(self) -> None:
        self.bls.close()
        self.db.close()
