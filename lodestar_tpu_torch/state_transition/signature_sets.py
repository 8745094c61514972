"""Block/gossip signature-set extraction.

The port's copy of `lodestar_tpu/state_transition/signature_sets.py`; it imports nothing of the
JAX package.

Mirror of the reference's extractor family (reference:
packages/state-transition/src/signatureSets/index.ts:26-73 and siblings;
block/processSyncCommittee.ts getSyncCommitteeSignatureSet): walk a
signed block (or gossip object) and emit every BLS statement it carries
as a wire-level set {validator indices, signing root, signature bytes}
ready for the TPU verifier's batched ingest.

Deposits are intentionally excluded — they may legally carry invalid
signatures (reference: signatureSets/index.ts:23-25).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .. import params
from ..bls.signature_set import WireSignatureSet
from ..config.chain_config import ChainConfig
from ..params import ForkName
from .. import types as T
from .epoch_cache import EpochCache
from .util import compute_epoch_at_slot, compute_start_slot_at_epoch


@dataclass
class BeaconStateView:
    """The slice of beacon state the extractors need: config + epoch
    cache + recent block roots (the reference passes the full
    CachedBeaconState; the TPU build's state surface is exactly this)."""

    config: ChainConfig
    slot: int
    epoch_cache: EpochCache
    # slot -> block root for sync-aggregate signing (reference:
    # getSyncCommitteeSignatureSet reads state.blockRoots)
    block_roots: Dict[int, bytes] = field(default_factory=dict)
    # previous-epoch committees (blocks carry prev-epoch attestations)
    prev_epoch_cache: Optional[EpochCache] = None
    # the STATE's genesis validators root — fork-agnostic domains
    # (deposits, BLS changes, EIP-7044 exits) must use the live chain's
    # value, not whatever the ChainConfig preset was built with
    _genesis_validators_root: Optional[bytes] = None

    @property
    def genesis_validators_root(self) -> bytes:
        if self._genesis_validators_root is not None:
            return self._genesis_validators_root
        return self.config.genesis_validators_root

    def get_block_root_at_slot(self, slot: int) -> bytes:
        return self.block_roots.get(slot, b"\x00" * 32)

    def get_indexed_attestation(self, attestation: dict) -> dict:
        """Dispatch to the committee cache of the attestation's epoch."""
        epoch = compute_epoch_at_slot(attestation["data"]["slot"])
        for cache in (self.epoch_cache, self.prev_epoch_cache):
            if cache is not None and cache.epoch == epoch:
                return cache.get_indexed_attestation(attestation)
        raise ValueError(f"no committee cache for epoch {epoch}")

    @classmethod
    def from_state(cls, state) -> "BeaconStateView":
        """Build the view from a full columnar BeaconState — the bridge
        from the state machine to the wire extractors (the reference
        passes CachedBeaconState straight through)."""
        from .accessors import get_active_validator_indices, get_seed, get_shuffling

        epoch = compute_epoch_at_slot(state.slot)
        sync_indices = [
            state.pubkey_index(pk)
            for pk in state.current_sync_committee["pubkeys"]
        ]

        def _cache(ep: int) -> EpochCache:
            return EpochCache(
                state.pubkeys,
                ep,
                get_seed(state, ep, params.DOMAIN_BEACON_ATTESTER),
                active_indices=get_active_validator_indices(state, ep),
                sync_committee_indices=sync_indices,
                # the state's memoized shuffle (the JAX package's view
                # shuffles the registry anew for each epoch)
                shuffling=get_shuffling(state, ep),
            )

        window = {
            s: state.block_roots[s % params.SLOTS_PER_HISTORICAL_ROOT]
            for s in range(
                max(0, state.slot - params.SLOTS_PER_HISTORICAL_ROOT),
                state.slot,
            )
        }
        return cls(
            config=state.config,
            slot=state.slot,
            epoch_cache=_cache(epoch),
            block_roots=window,
            prev_epoch_cache=_cache(epoch - 1) if epoch > 0 else None,
            _genesis_validators_root=state.genesis_validators_root,
        )


def _block_types(config: ChainConfig, slot: int):
    block, _signed, body = config.get_fork_types(slot)
    return block, body


def _signing_root(config: ChainConfig, state_slot, domain_type, msg_slot, obj_root):
    domain = config.get_domain(state_slot, domain_type, msg_slot)
    return config.compute_signing_root(obj_root, domain)


# -- proposer (reference: signatureSets/proposer.ts) ------------------------


def get_proposer_signature_set(
    state: BeaconStateView, signed_block: dict
) -> WireSignatureSet:
    block = signed_block["message"]
    block_type, _ = _block_types(state.config, block["slot"])
    root = _signing_root(
        state.config,
        state.slot,
        params.DOMAIN_BEACON_PROPOSER,
        block["slot"],
        block_type.hash_tree_root(block),
    )
    return WireSignatureSet.single(
        block["proposer_index"], root, signed_block["signature"]
    )


# -- randao (reference: signatureSets/randao.ts) ----------------------------


def get_randao_reveal_signature_set(
    state: BeaconStateView, block: dict
) -> WireSignatureSet:
    epoch = compute_epoch_at_slot(block["slot"])
    root = _signing_root(
        state.config,
        state.slot,
        params.DOMAIN_RANDAO,
        block["slot"],
        T.Epoch.hash_tree_root(epoch),
    )
    return WireSignatureSet.single(
        block["proposer_index"], root, block["body"]["randao_reveal"]
    )


# -- attestations (reference: signatureSets/indexedAttestation.ts) ----------


def get_attestation_data_signing_root(state: BeaconStateView, data: dict) -> bytes:
    slot = compute_start_slot_at_epoch(data["target"]["epoch"])
    return _signing_root(
        state.config,
        state.slot,
        params.DOMAIN_BEACON_ATTESTER,
        slot,
        T.AttestationData.hash_tree_root(data),
    )


def get_indexed_attestation_signature_set(
    state: BeaconStateView, indexed: dict
) -> WireSignatureSet:
    return WireSignatureSet.aggregate(
        indexed["attesting_indices"],
        get_attestation_data_signing_root(state, indexed["data"]),
        indexed["signature"],
    )


def get_attestation_signature_sets(
    state: BeaconStateView, signed_block: dict
) -> List[WireSignatureSet]:
    return [
        get_indexed_attestation_signature_set(
            state, state.get_indexed_attestation(att)
        )
        for att in signed_block["message"]["body"]["attestations"]
    ]


# -- slashings (reference: signatureSets/{proposer,attester}Slashings.ts) ---


def get_proposer_slashings_signature_sets(
    state: BeaconStateView, signed_block: dict
) -> List[WireSignatureSet]:
    out = []
    for slashing in signed_block["message"]["body"]["proposer_slashings"]:
        for key in ("signed_header_1", "signed_header_2"):
            signed_header = slashing[key]
            header = signed_header["message"]
            root = _signing_root(
                state.config,
                state.slot,
                params.DOMAIN_BEACON_PROPOSER,
                header["slot"],
                T.BeaconBlockHeader.hash_tree_root(header),
            )
            out.append(
                WireSignatureSet.single(
                    header["proposer_index"], root, signed_header["signature"]
                )
            )
    return out


def get_attester_slashings_signature_sets(
    state: BeaconStateView, signed_block: dict
) -> List[WireSignatureSet]:
    out = []
    for slashing in signed_block["message"]["body"]["attester_slashings"]:
        for key in ("attestation_1", "attestation_2"):
            out.append(
                get_indexed_attestation_signature_set(state, slashing[key])
            )
    return out


# -- exits (reference: signatureSets/voluntaryExits.ts) ---------------------


def voluntary_exit_signing_root(
    config: ChainConfig,
    genesis_validators_root: bytes,
    in_deneb: bool,
    state_slot: int,
    exit_msg: dict,
) -> bytes:
    """THE exit signing root — shared by the STF's per-op check
    (block.py process_voluntary_exit) and the wire extractor so the two
    verification paths cannot diverge.  EIP-7044 (deneb): exits verify
    against the CAPELLA fork domain permanently."""
    if in_deneb:
        domain = config.compute_domain(
            params.DOMAIN_VOLUNTARY_EXIT,
            config.fork_versions[ForkName.capella],
            genesis_validators_root,
        )
    else:
        domain = config.get_domain(
            state_slot,
            params.DOMAIN_VOLUNTARY_EXIT,
            compute_start_slot_at_epoch(exit_msg["epoch"]),
        )
    return config.compute_signing_root(
        T.VoluntaryExit.hash_tree_root(exit_msg), domain
    )


def get_voluntary_exits_signature_sets(
    state: BeaconStateView, signed_block: dict
) -> List[WireSignatureSet]:
    deneb = (
        state.config.get_fork_seq(state.slot)
        >= params.FORK_SEQ[ForkName.deneb]
    )
    out = []
    for signed_exit in signed_block["message"]["body"]["voluntary_exits"]:
        exit_msg = signed_exit["message"]
        root = voluntary_exit_signing_root(
            state.config,
            state.genesis_validators_root,
            deneb,
            state.slot,
            exit_msg,
        )
        out.append(
            WireSignatureSet.single(
                exit_msg["validator_index"], root, signed_exit["signature"]
            )
        )
    return out


# -- capella BLS-to-execution changes (reference: signatureSets/
# blsToExecutionChange.ts) — signed by the WITHDRAWAL key, which lives
# outside the validator signing-key registry, against the genesis fork
# domain so pre-signed changes survive forks ---------------------------------


def get_bls_to_execution_change_signature_sets(
    state: BeaconStateView, signed_block: dict
) -> List[WireSignatureSet]:
    out = []
    for signed_change in signed_block["message"]["body"].get(
        "bls_to_execution_changes", ()
    ):
        change = signed_change["message"]
        domain = state.config.compute_domain(
            params.DOMAIN_BLS_TO_EXECUTION_CHANGE,
            state.config.fork_versions[ForkName.phase0],
            state.genesis_validators_root,
        )
        root = state.config.compute_signing_root(
            T.BLSToExecutionChange.hash_tree_root(change), domain
        )
        out.append(
            WireSignatureSet.external(
                [bytes(change["from_bls_pubkey"])],
                root,
                signed_change["signature"],
            )
        )
    return out


# -- sync aggregate (reference: block/processSyncCommittee.ts) --------------


def get_sync_committee_signature_set(
    state: BeaconStateView, block: dict
) -> Optional[WireSignatureSet]:
    sync_aggregate = block["body"].get("sync_aggregate")
    if sync_aggregate is None:
        return None
    participants = state.epoch_cache.get_sync_committee_participant_indices(
        sync_aggregate["sync_committee_bits"]
    )
    # no participants -> nothing to verify (reference: index.ts:56-60)
    if not participants:
        return None
    # the aggregate signs the PREVIOUS slot's block root
    previous_slot = max(block["slot"], 1) - 1
    block_root = state.get_block_root_at_slot(previous_slot)
    root = _signing_root(
        state.config,
        state.slot,
        params.DOMAIN_SYNC_COMMITTEE,
        previous_slot,
        T.Root.hash_tree_root(block_root),
    )
    return WireSignatureSet.aggregate(
        participants, root, sync_aggregate["sync_committee_signature"]
    )


# -- aggregate-and-proof (gossip; reference: chain/validation) --------------


def get_selection_proof_signature_set(
    state: BeaconStateView, slot: int, aggregator_index: int, selection_proof: bytes
) -> WireSignatureSet:
    root = _signing_root(
        state.config,
        state.slot,
        params.DOMAIN_SELECTION_PROOF,
        slot,
        T.Slot.hash_tree_root(slot),
    )
    return WireSignatureSet.single(aggregator_index, root, selection_proof)


def get_aggregate_and_proof_signature_set(
    state: BeaconStateView, signed_agg: dict
) -> WireSignatureSet:
    msg = signed_agg["message"]
    slot = msg["aggregate"]["data"]["slot"]
    root = _signing_root(
        state.config,
        state.slot,
        params.DOMAIN_AGGREGATE_AND_PROOF,
        slot,
        T.AggregateAndProof.hash_tree_root(msg),
    )
    return WireSignatureSet.single(
        msg["aggregator_index"], root, signed_agg["signature"]
    )


# -- sync-committee gossip objects (reference: chain/validation/
# syncCommittee.ts, syncCommitteeContributionAndProof.ts) -------------------


def get_sync_committee_message_signature_set(
    state: BeaconStateView, message: dict
) -> WireSignatureSet:
    """A SyncCommitteeMessage signs the beacon block root with
    DOMAIN_SYNC_COMMITTEE at the message slot."""
    root = _signing_root(
        state.config,
        state.slot,
        params.DOMAIN_SYNC_COMMITTEE,
        message["slot"],
        T.Root.hash_tree_root(message["beacon_block_root"]),
    )
    return WireSignatureSet.single(
        message["validator_index"], root, message["signature"]
    )


def get_sync_committee_selection_proof_signature_set(
    state: BeaconStateView, contribution_and_proof: dict
) -> WireSignatureSet:
    """Selection proof over SyncAggregatorSelectionData{slot, subnet}."""
    contribution = contribution_and_proof["contribution"]
    data = {
        "slot": contribution["slot"],
        "subcommittee_index": contribution["subcommittee_index"],
    }
    root = _signing_root(
        state.config,
        state.slot,
        params.DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF,
        contribution["slot"],
        T.SyncAggregatorSelectionData.hash_tree_root(data),
    )
    return WireSignatureSet.single(
        contribution_and_proof["aggregator_index"],
        root,
        contribution_and_proof["selection_proof"],
    )


def get_contribution_and_proof_signature_set(
    state: BeaconStateView, signed: dict
) -> WireSignatureSet:
    """The aggregator's signature over the ContributionAndProof."""
    msg = signed["message"]
    root = _signing_root(
        state.config,
        state.slot,
        params.DOMAIN_CONTRIBUTION_AND_PROOF,
        msg["contribution"]["slot"],
        T.ContributionAndProof.hash_tree_root(msg),
    )
    return WireSignatureSet.single(
        msg["aggregator_index"], root, signed["signature"]
    )


def get_contribution_signature_set(
    state: BeaconStateView,
    contribution: dict,
    participant_indices,
) -> WireSignatureSet:
    """The contribution's aggregate over the subcommittee participants."""
    root = _signing_root(
        state.config,
        state.slot,
        params.DOMAIN_SYNC_COMMITTEE,
        contribution["slot"],
        T.Root.hash_tree_root(contribution["beacon_block_root"]),
    )
    return WireSignatureSet.aggregate(
        participant_indices, root, contribution["signature"]
    )


# -- the block-level aggregator (reference: signatureSets/index.ts:26-73) ---


def get_block_signature_sets(
    state: BeaconStateView,
    signed_block: dict,
    skip_proposer_signature: bool = False,
) -> List[WireSignatureSet]:
    """Every signature on the block except deposits."""
    block = signed_block["message"]
    sets: List[WireSignatureSet] = [
        get_randao_reveal_signature_set(state, block)
    ]
    sets.extend(get_proposer_slashings_signature_sets(state, signed_block))
    sets.extend(get_attester_slashings_signature_sets(state, signed_block))
    sets.extend(get_attestation_signature_sets(state, signed_block))
    sets.extend(get_voluntary_exits_signature_sets(state, signed_block))
    sets.extend(
        get_bls_to_execution_change_signature_sets(state, signed_block)
    )
    if not skip_proposer_signature:
        sets.append(get_proposer_signature_set(state, signed_block))
    if state.config.get_fork_seq(block["slot"]) >= params.FORK_SEQ[ForkName.altair]:
        sync_set = get_sync_committee_signature_set(state, block)
        if sync_set is not None:
            sets.append(sync_set)
    return sets
