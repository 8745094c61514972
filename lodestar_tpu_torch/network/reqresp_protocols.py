"""Req/resp wire types of the port: only the light-client update and
bootstrap containers and the update's value codecs, which the
light-client server's persistence needs (a part of the JAX package's
`lodestar_tpu/network/reqresp_protocols.py`; the protocols, handlers and
the rest of its containers wait for the req/resp port, ROADMAP Queue A
item 7.5).

Altair light-client wire containers (reference: types/src/altair/
sszTypes.ts LightClientUpdate/LightClientBootstrap); absent optional
parts travel zero-filled, as in the spec containers.
"""

from __future__ import annotations

from .. import types as T
from ..light_client.lightclient import (
    FINALIZED_ROOT_DEPTH,
    NEXT_SYNC_COMMITTEE_DEPTH,
    LightClientUpdate,
)
from ..ssz import Bytes32, Container, Vector

LightClientUpdateType = Container(
    (
        ("attested_header", T.BeaconBlockHeader),
        ("next_sync_committee", T.SyncCommittee),
        (
            "next_sync_committee_branch",
            Vector(Bytes32, NEXT_SYNC_COMMITTEE_DEPTH),
        ),
        ("finalized_header", T.BeaconBlockHeader),
        ("finality_branch", Vector(Bytes32, FINALIZED_ROOT_DEPTH)),
        ("sync_aggregate", T.SyncAggregate),
        ("signature_slot", T.Slot),
    ),
    name="LightClientUpdate",
)

LightClientBootstrapType = Container(
    (
        ("header", T.BeaconBlockHeader),
        ("current_sync_committee", T.SyncCommittee),
        (
            "current_sync_committee_branch",
            Vector(Bytes32, NEXT_SYNC_COMMITTEE_DEPTH),
        ),
    ),
    name="LightClientBootstrap",
)

_ZERO_BRANCH5 = [b"\x00" * 32] * NEXT_SYNC_COMMITTEE_DEPTH
_ZERO_BRANCH6 = [b"\x00" * 32] * FINALIZED_ROOT_DEPTH


def light_client_update_to_value(upd) -> dict:
    """LightClientUpdate dataclass -> spec-shaped container value."""
    empty_committee = T.SyncCommittee.default()
    return {
        "attested_header": dict(upd.attested_header),
        "next_sync_committee": dict(
            upd.next_sync_committee or empty_committee
        ),
        "next_sync_committee_branch": list(
            upd.next_sync_committee_branch or _ZERO_BRANCH5
        ),
        "finalized_header": dict(
            upd.finalized_header or T.BeaconBlockHeader.default()
        ),
        "finality_branch": list(upd.finality_branch or _ZERO_BRANCH6),
        "sync_aggregate": {
            "sync_committee_bits": list(upd.sync_committee_bits),
            "sync_committee_signature": bytes(upd.sync_committee_signature),
        },
        "signature_slot": int(upd.signature_slot),
    }


def light_client_update_from_value(value: dict):
    """Container value -> LightClientUpdate dataclass (zero-filled parts
    become None)."""
    branch5 = [bytes(b) for b in value["next_sync_committee_branch"]]
    branch6 = [bytes(b) for b in value["finality_branch"]]
    has_committee = branch5 != _ZERO_BRANCH5
    has_finality = branch6 != _ZERO_BRANCH6
    agg = value["sync_aggregate"]
    return LightClientUpdate(
        attested_header=dict(value["attested_header"]),
        sync_committee_bits=list(agg["sync_committee_bits"]),
        sync_committee_signature=bytes(agg["sync_committee_signature"]),
        signature_slot=int(value["signature_slot"]),
        finalized_header=(
            dict(value["finalized_header"]) if has_finality else None
        ),
        finality_branch=branch6 if has_finality else None,
        next_sync_committee=(
            dict(value["next_sync_committee"]) if has_committee else None
        ),
        next_sync_committee_branch=branch5 if has_committee else None,
    )
