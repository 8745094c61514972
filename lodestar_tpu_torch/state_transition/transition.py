"""stateTransition() — the top-level block STF.

The port's copy of `lodestar_tpu/state_transition/transition.py`; it imports nothing of the
JAX package.

Reference: packages/state-transition/src/stateTransition.ts:42-113
(clone → processSlots → verify proposer signature → processBlock →
verify state root).  Options mirror StateTransitionOpts
{verifyStateRoot, verifyProposer, verifySignatures}: in the import
pipeline all signatures (proposer included) are pre-verified in one
batched job on the card, so the defaults here match the reference's
"signatures already checked by chain/bls" call site
(beacon-node/src/chain/blocks/verifyBlock.ts flow).
"""

from __future__ import annotations

from typing import Dict

from .. import params
from ..types import BeaconBlock, BeaconBlockAltair, BeaconBlockHeader
from .block import BlockProcessError, _count_host_check, process_block
from .slot import process_slots

P = params.ACTIVE_PRESET


def _block_type(config, slot: int):
    return config.get_fork_types(slot)[0]


def verify_proposer_signature(state, signed_block: Dict) -> bool:
    from ..crypto import bls as _bls

    block = signed_block["message"]
    block_type = _block_type(state.config, block["slot"])
    domain = state.config.get_domain(
        state.slot, params.DOMAIN_BEACON_PROPOSER, block["slot"]
    )
    root = state.config.compute_signing_root(
        block_type.hash_tree_root(block), domain
    )
    proposer = block["proposer_index"]
    if proposer >= state.num_validators:
        return False
    _count_host_check()
    return _bls.verify_bytes(
        state.pubkeys[proposer], root, signed_block["signature"]
    )


def state_transition(
    state,
    signed_block: Dict,
    *,
    verify_state_root: bool = True,
    verify_proposer: bool = False,
    verify_signatures: bool = False,
):
    """Clone, advance, apply, verify; returns the post-state."""
    block = signed_block["message"]
    post = state.clone()

    if post.slot < block["slot"]:
        process_slots(post, block["slot"])

    if verify_proposer and not verify_proposer_signature(post, signed_block):
        raise BlockProcessError("invalid proposer signature")

    process_block(post, block, verify_signatures)

    if verify_state_root:
        actual = post.hash_tree_root()
        if block["state_root"] != actual:
            raise BlockProcessError(
                f"state root mismatch at slot {block['slot']}: "
                f"block {block['state_root'].hex()} != computed {actual.hex()}"
            )
    return post
