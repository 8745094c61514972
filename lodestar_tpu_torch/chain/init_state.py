"""Anchor-state selection: resume from db, checkpoint sync, or genesis.

The port's copy of `lodestar_tpu/chain/init_state.py`; it imports nothing of the
JAX package.  Checkpoint sync from a URL
(`fetch_checkpoint_state`) needs the REST client, which is not ported
yet (ROADMAP Queue A item 7.3): it raises.

Mirror of the reference's initBeaconState (reference:
packages/cli/src/cmds/beacon/initBeaconState.ts:85-131): priority order

  1. RESUME — the db's state archive has a stored state: continue from
     the latest one (initBeaconState.ts:85-100, db.stateArchive.lastKey),
  2. CHECKPOINT — explicit state bytes or a trusted REST URL serving
     the debug state endpoint (fetchWeakSubjectivityState,
     initBeaconState.ts:115-131), then BackfillSync authenticates the
     missing history backward,
  3. GENESIS — the caller's interop/genesis builder.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

from ..state_transition.state import BeaconState
from ..utils.logger import get_logger

log = get_logger("chain/init_state")


def state_from_checkpoint_bytes(config, state_bytes: bytes) -> BeaconState:
    """Deserialize + sanity-check a checkpoint state (the trust anchor
    is the OPERATOR's choice of source, as in weak subjectivity).

    Checks: validators present, the latest block header is not from
    the future of the state's own slot, and the genesis time is set —
    cheap self-consistency guards against truncated/corrupt files (the
    cryptographic trust comes from the operator's choice of source)."""
    state = BeaconState.deserialize(state_bytes, config)
    if state.num_validators == 0:
        raise ValueError("checkpoint state has no validators")
    header_slot = int(state.latest_block_header["slot"])
    if header_slot > state.slot:
        raise ValueError(
            f"checkpoint header slot {header_slot} is beyond the state "
            f"slot {state.slot} (corrupt state)"
        )
    if int(state.genesis_time) == 0:
        raise ValueError("checkpoint state has no genesis time")
    return state


def fetch_checkpoint_state(config, url: str):
    """Checkpoint sync over REST (reference fetchWeakSubjectivityState):
    GET {url}/eth/v2/debug/beacon/states/finalized.  The port has no
    REST client yet."""
    raise NotImplementedError(
        "checkpoint sync from a URL needs the REST client (api/client.py), "
        "not ported yet: ROADMAP Queue A item 7.3"
    )


def init_beacon_state(
    config,
    db=None,
    checkpoint_state_bytes: Optional[bytes] = None,
    checkpoint_sync_url: Optional[str] = None,
    genesis_fn: Optional[Callable[[], BeaconState]] = None,
) -> Tuple[BeaconState, str]:
    """-> (anchor_state, source) with source in
    {"resume", "checkpoint", "genesis"}."""
    if db is not None:
        last = db.state_archive.last_key()
        if last is not None:
            state = BeaconState.deserialize(
                db.state_archive.get(last), config
            )
            log.info("resuming from state archive", slot=state.slot)
            return state, "resume"
    if checkpoint_state_bytes is not None:
        state = state_from_checkpoint_bytes(config, checkpoint_state_bytes)
        log.info("bootstrapping from checkpoint state", slot=state.slot)
        return state, "checkpoint"
    if checkpoint_sync_url is not None:
        state = fetch_checkpoint_state(config, checkpoint_sync_url)
        log.info(
            "bootstrapping from checkpoint url",
            url=checkpoint_sync_url,
            slot=state.slot,
        )
        return state, "checkpoint"
    if genesis_fn is None:
        raise ValueError("no anchor source: db empty, no checkpoint, no genesis")
    return genesis_fn(), "genesis"
