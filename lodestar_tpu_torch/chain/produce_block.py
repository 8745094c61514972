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
    merge_tracker=None,
    fee_recipient_fn=None,
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
        merge_tracker=merge_tracker,
        fee_recipient_fn=fee_recipient_fn,
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


def build_payload_attributes(advanced, slot: int, fee_recipient: bytes):
    """THE payload attributes for proposing at `slot` on `advanced` (the
    state already processed to `slot`).  Shared by the proposal-time
    fetch and the next-slot preparation — the EL serves the pre-built
    payload only when the two match byte-for-byte."""
    from ..execution import PayloadAttributes
    from ..state_transition.accessors import get_randao_mix
    from ..state_transition.block import get_expected_withdrawals

    withdrawals = (
        get_expected_withdrawals(advanced)
        if advanced.next_withdrawal_index is not None
        else None
    )
    parent_beacon_root = None
    if advanced.fork_at_least(params.ForkName.deneb):
        # fcU V3 rejects attributes without the parent beacon root
        parent_beacon_root = BeaconBlockHeader.hash_tree_root(
            advanced.latest_block_header
        )
    return PayloadAttributes(
        timestamp=int(advanced.genesis_time) + slot * params.SECONDS_PER_SLOT,
        prev_randao=get_randao_mix(advanced, slot // P.SLOTS_PER_EPOCH),
        suggested_fee_recipient=bytes(fee_recipient),
        withdrawals=withdrawals,
        parent_beacon_block_root=parent_beacon_root,
    )


def _fetch_payload(
    execution,
    pre,
    fee_recipient: bytes = b"\x00" * 20,
    merge_tracker=None,
) -> Dict:
    """engine_forkchoiceUpdated(attributes) + engine_getPayload against
    the state's latest header (reference: produceBlockBody.ts
    prepareExecutionPayload).  `fee_recipient` comes from the proposer's
    prepare_beacon_proposer registration.  Pre-merge, the payload parent
    is the TERMINAL PoW block discovered by the Eth1MergeBlockTracker
    (produceBlockBody.ts prepareExecutionPayload's
    getTerminalPowBlockHash leg) — producing the transition block."""
    from ..state_transition.block import is_merge_transition_complete

    if is_merge_transition_complete(pre):
        parent_hash = bytes(pre.latest_execution_payload_header["block_hash"])
    else:
        parent_hash = b"\x00" * 32
        if merge_tracker is not None:
            try:
                terminal = merge_tracker.get_terminal_pow_block()
            except Exception:  # noqa: BLE001 — an eth1 flake must not
                # kill the proposal; pre-tracker behavior (zero parent)
                # is the safe fallback
                terminal = None
            if terminal is not None:
                parent_hash = bytes.fromhex(terminal.block_hash)
    r = execution.notify_forkchoice_update(
        parent_hash,
        parent_hash,
        b"\x00" * 32,
        build_payload_attributes(pre, pre.slot, fee_recipient),
    )
    if r.payload_id is None:
        raise ValueError(f"EL did not prepare a payload ({r.status})")
    # engine API version follows the proposal fork (deneb requires
    # getPayloadV3 on real ELs; V1 for pre-capella)
    if pre.fork_at_least(params.ForkName.deneb):
        version = 3
    elif pre.fork_at_least(params.ForkName.capella):
        version = 2
    else:
        version = 1
    payload = execution.get_payload(r.payload_id, version)
    if pre.fork_at_least(params.ForkName.deneb) and "blob_gas_used" not in payload:
        # a mock/dev EL without blob support: default the blob gas fields
        payload = {**payload, "blob_gas_used": 0, "excess_blob_gas": 0}
    return payload


def produce_block(
    state,
    slot: int,
    randao_reveal: bytes,
    execution=None,
    builder=None,  # IExecutionBuilder for the blinded flow
    merge_tracker=None,  # Eth1MergeBlockTracker for the transition block
    fee_recipient_fn=None,  # proposer_index -> bytes|None (the cache)
    **body_kwargs,
) -> Tuple[Dict, object]:
    """Build an unsigned block at `slot` on top of `state`.

    Returns (block_value, post_state); block.state_root is the real
    post-state root, so signing it yields an importable block.  With a
    `builder`, the body is BLINDED: it carries the relay's payload
    header instead of a payload (reference: produceBlindedBlock)."""
    from ..state_transition.block import is_merge_transition_complete

    pre = state.clone()
    if pre.slot < slot:
        process_slots(pre, slot)
    proposer_index = get_beacon_proposer_index(pre)
    parent_root = BeaconBlockHeader.hash_tree_root(pre.latest_block_header)
    fee_recipient = b"\x00" * 20
    if fee_recipient_fn is not None:
        # the proposer's prepare_beacon_proposer registration (looked up
        # HERE where the advanced state already names the proposer)
        registered = fee_recipient_fn(int(proposer_index))
        if registered is not None:
            fee_recipient = registered
    if (
        pre.latest_execution_payload_header is not None
        and body_kwargs.get("execution_payload") is None
    ):
        if builder is not None:
            # builder flow requires a settled parent payload (the relay
            # bids on top of a known EL block)
            if not is_merge_transition_complete(pre):
                raise ValueError("builder flow requires a post-merge head")
            parent_hash = bytes(
                pre.latest_execution_payload_header["block_hash"]
            )
            bid = builder.get_header(
                slot,
                parent_hash,
                bytes(pre.pubkeys[int(proposer_index)]),
                payload_attributes=build_payload_attributes(
                    pre, slot, fee_recipient
                ),
            )
            body_kwargs["execution_payload"] = dict(bid.header)
            if bid.blob_kzg_commitments is not None:
                body_kwargs.setdefault(
                    "blob_kzg_commitments", list(bid.blob_kzg_commitments)
                )
        else:
            # bellatrix proposal: fetch the payload from the EL
            # (reference: produceBlockBody.ts engine getPayload leg)
            if execution is None:
                raise ValueError(
                    "post-bellatrix proposal requires an execution engine"
                )
            body_kwargs["execution_payload"] = _fetch_payload(
                execution, pre, fee_recipient, merge_tracker=merge_tracker
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
