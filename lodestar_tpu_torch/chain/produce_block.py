"""Block production — assemble, compute state root, (optionally) sign.

The port's copy of `lodestar_tpu/chain/produce_block.py`; it imports nothing of the
JAX package.

Reference: packages/beacon-node/src/chain/produceBlock/produceBlockBody.ts
(body assembly from op pools + eth1 vote + randao reveal) and
chain/produceBlock/index.ts (block shell + post-state root).  The op
pools live in chain/op_pools.py; this module is the pure assembly step
shared by the beacon API's produceBlockV2 and the test utilities.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .. import params
from ..state_transition import state_transition
from ..state_transition.accessors import get_beacon_proposer_index
from ..state_transition.slot import process_slots
from ..types import BeaconBlockHeader

P = params.ACTIVE_PRESET
_G2_INFINITY = bytes([0xC0]) + b"\x00" * 95


def default_sync_aggregate() -> Dict:
    """Empty participation + infinity signature (valid under
    eth_fast_aggregate_verify)."""
    return {
        "sync_committee_bits": [False] * P.SYNC_COMMITTEE_SIZE,
        "sync_committee_signature": _G2_INFINITY,
    }


def produce_block_body(
    state,
    randao_reveal: bytes,
    *,
    graffiti: bytes = b"\x00" * 32,
    attestations: Optional[List[Dict]] = None,
    proposer_slashings: Optional[List[Dict]] = None,
    attester_slashings: Optional[List[Dict]] = None,
    deposits: Optional[List[Dict]] = None,
    voluntary_exits: Optional[List[Dict]] = None,
    sync_aggregate: Optional[Dict] = None,
    eth1_data: Optional[Dict] = None,
    execution_payload: Optional[Dict] = None,
    bls_to_execution_changes: Optional[List[Dict]] = None,
    blob_kzg_commitments: Optional[List[bytes]] = None,
) -> Dict:
    """Assemble a fork-appropriate block body (reference
    produceBlockBody.ts; the payload/withdrawal/blob slots activate with
    their forks)."""
    body = {
        "randao_reveal": randao_reveal,
        "eth1_data": dict(eth1_data or state.eth1_data),
        "graffiti": graffiti,
        "proposer_slashings": list(proposer_slashings or []),
        "attester_slashings": list(attester_slashings or []),
        "attestations": list(attestations or []),
        "deposits": list(deposits or []),
        "voluntary_exits": list(voluntary_exits or []),
    }
    if state.fork_at_least(params.ForkName.altair):
        body["sync_aggregate"] = dict(
            sync_aggregate or default_sync_aggregate()
        )
    if execution_payload is not None:
        if "transactions" in execution_payload:
            body["execution_payload"] = dict(execution_payload)
        else:
            # builder flow: the body is BLINDED — it carries the payload
            # header the relay bid (reference: produceBlindedBlockBody)
            body["execution_payload_header"] = dict(execution_payload)
    if state.fork_at_least(params.ForkName.capella):
        body["bls_to_execution_changes"] = list(bls_to_execution_changes or [])
    if state.fork_at_least(params.ForkName.deneb):
        body["blob_kzg_commitments"] = list(blob_kzg_commitments or [])
    return body


def produce_block_from_pools(
    state,
    slot: int,
    randao_reveal: bytes,
    *,
    aggregated_attestation_pool=None,
    op_pool=None,
    contribution_pool=None,
    head_root: Optional[bytes] = None,
    graffiti: bytes = b"\x00" * 32,
    eth1_data: Optional[Dict] = None,
    deposits: Optional[List[Dict]] = None,
    eth1=None,
    execution=None,
    builder=None,
) -> Tuple[Dict, object]:
    """produceBlockBody from the op pools (reference
    produceBlockBody.ts:66-118): attestations ranked by participation,
    slashings/exits still applicable, the merged sync contribution for
    the parent root."""
    pre = state.clone()
    if pre.slot < slot:
        process_slots(pre, slot)
    if eth1 is not None:
        # eth1 vote/deposit accounting MUST see the slot-advanced state:
        # a voting-period boundary resets eth1_data_votes (reference
        # computes getEth1DataAndDeposits on the proposal-slot state)
        bundle = eth1.get_eth1_data_and_deposits(pre)
        eth1_data = bundle["eth1_data"]
        deposits = bundle["deposits"]
    attestations = (
        aggregated_attestation_pool.get_attestations_for_block(pre)
        if aggregated_attestation_pool is not None
        else []
    )
    proposer_slashings, attester_slashings, voluntary_exits = (
        op_pool.get_slashings_and_exits(pre)
        if op_pool is not None
        else ([], [], [])
    )
    bls_changes = (
        op_pool.get_bls_to_execution_changes(pre)
        if op_pool is not None and pre.fork_at_least(params.ForkName.capella)
        else []
    )
    sync_aggregate = None
    if contribution_pool is not None and head_root is not None:
        sync_aggregate = contribution_pool.produce_sync_aggregate(
            slot - 1, head_root
        )
    # `pre` is already advanced to `slot` — reuse it so the epoch
    # transition does not run a second time inside produce_block
    return produce_block(
        pre,
        slot,
        randao_reveal,
        execution=execution,
        builder=builder,
        graffiti=graffiti,
        eth1_data=eth1_data,
        deposits=deposits,
        attestations=attestations,
        proposer_slashings=proposer_slashings,
        attester_slashings=attester_slashings,
        voluntary_exits=voluntary_exits,
        sync_aggregate=sync_aggregate,
        bls_to_execution_changes=bls_changes,
    )


def produce_block(
    state,
    slot: int,
    randao_reveal: bytes,
    execution=None,
    builder=None,  # IExecutionBuilder for the blinded flow
    **body_kwargs,
) -> Tuple[Dict, object]:
    """Build an unsigned block at `slot` on top of `state`.

    Returns (block_value, post_state); block.state_root is the real
    post-state root, so signing it yields an importable block.  With a
    `builder`, the body is BLINDED: it carries the relay's payload
    header instead of a payload (reference: produceBlindedBlock); the
    payload leg and the builder are not ported yet (ROADMAP Queue A
    items 7.1b, 7.1d)."""
    pre = state.clone()
    if pre.slot < slot:
        process_slots(pre, slot)
    proposer_index = get_beacon_proposer_index(pre)
    parent_root = BeaconBlockHeader.hash_tree_root(pre.latest_block_header)
    if (
        pre.latest_execution_payload_header is not None
        and body_kwargs.get("execution_payload") is None
    ):
        if builder is not None:
            raise NotImplementedError(
                "blinded production and the builder are not ported yet: "
                "ROADMAP Queue A item 7.1d"
            )
        # bellatrix proposal: the payload comes from the EL (reference:
        # produceBlockBody.ts engine getPayload leg)
        if execution is None:
            raise ValueError(
                "post-bellatrix proposal requires an execution engine"
            )
        raise NotImplementedError(
            "the execution-payload leg with an engine wired is not ported "
            "yet: ROADMAP Queue A item 7.1b"
        )
    body = produce_block_body(pre, randao_reveal, **body_kwargs)
    block = {
        "slot": slot,
        "proposer_index": proposer_index,
        "parent_root": parent_root,
        "state_root": b"\x00" * 32,
        "body": body,
    }
    post = state_transition(
        pre,
        {"message": block, "signature": b"\x00" * 96},
        verify_state_root=False,
    )
    # the STF clone shared the head state's merkle engine, so the
    # proposal's state root only re-hashes what this block touched
    block["state_root"] = post.hash_tree_root()
    return block, post
