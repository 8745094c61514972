"""builder-specs JSON codecs (fork-aware where the wire is).

The port's copy of `lodestar_tpu/execution/builder_codec.py`; it imports nothing of the
JAX package.

Reference: the @lodestar/api builder route serializers
(packages/api/src/builder/routes.ts) — registrations, bids, blinded
blocks and revealed payloads travel as the standard beacon-API JSON
encoding of their SSZ types.
"""

from __future__ import annotations

from typing import List

from .. import types as T
from ..api.encoding import from_json, to_json


def registrations_to_json(registrations: List[dict]) -> list:
    return [
        to_json(T.SignedValidatorRegistrationV1, r) for r in registrations
    ]


def registrations_from_json(data: list) -> List[dict]:
    return [
        from_json(T.SignedValidatorRegistrationV1, r) for r in data
    ]


def _header_type_for(header_json: dict):
    if "blob_gas_used" in header_json:
        return T.ExecutionPayloadHeaderDeneb
    if "withdrawals_root" in header_json:
        return T.ExecutionPayloadHeaderCapella
    return T.ExecutionPayloadHeader


def bid_from_json(data: dict):
    """SignedBuilderBid JSON -> BuilderBidResult (signature checked by
    the caller if it tracks relay keys; the reference trusts the relay
    it configured)."""
    from .builder import BuilderBidResult

    msg = data["message"]
    header = from_json(_header_type_for(msg["header"]), msg["header"])
    commitments = None
    if "blob_kzg_commitments" in msg:
        commitments = [
            bytes.fromhex(c[2:] if c.startswith("0x") else c)
            for c in msg["blob_kzg_commitments"]
        ]
    pk = msg["pubkey"]
    return BuilderBidResult(
        header,
        int(msg["value"]),
        bytes.fromhex(pk[2:] if pk.startswith("0x") else pk),
        blob_kzg_commitments=commitments,
    )


def bid_to_json(header: dict, value: int, pubkey: bytes, signature: bytes = b"\x00" * 96) -> dict:
    return {
        "message": {
            "header": to_json(_header_type_for(header), header),
            "value": str(int(value)),
            "pubkey": "0x" + bytes(pubkey).hex(),
        },
        "signature": "0x" + bytes(signature).hex(),
    }


def _blinded_types_for(body: dict):
    if "blob_kzg_commitments" in body:
        return T.SignedBlindedBeaconBlockDeneb
    if "bls_to_execution_changes" in body:
        return T.SignedBlindedBeaconBlockCapella
    return T.SignedBlindedBeaconBlockBellatrix


def signed_blinded_to_json(signed_blinded: dict) -> dict:
    t = _blinded_types_for(signed_blinded["message"]["body"])
    return to_json(t, signed_blinded)


def signed_blinded_from_json(data: dict) -> dict:
    t = _blinded_types_for(data["message"]["body"])
    return from_json(t, data)


def _payload_type_for(payload: dict):
    if "blob_gas_used" in payload:
        return T.ExecutionPayloadDeneb
    if "withdrawals" in payload:
        return T.ExecutionPayloadCapella
    return T.ExecutionPayload


def payload_from_json(data: dict) -> dict:
    return from_json(_payload_type_for(data), data)


def reveal_from_json(data: dict):
    """submitBlindedBlock response -> (payload, blobs_bundle|None).

    Pre-deneb relays answer with a bare ExecutionPayload; deneb relays
    with ExecutionPayloadAndBlobsBundle {execution_payload,
    blobs_bundle: {commitments, proofs, blobs}} (builder-specs)."""

    def _hex(b):
        return bytes.fromhex(b[2:] if b.startswith("0x") else b)

    if "execution_payload" in data:
        bundle_json = data.get("blobs_bundle")
        bundle = None
        if bundle_json is not None:
            bundle = {
                "commitments": [_hex(c) for c in bundle_json["commitments"]],
                "proofs": [_hex(p) for p in bundle_json["proofs"]],
                "blobs": [_hex(b) for b in bundle_json["blobs"]],
            }
        return payload_from_json(data["execution_payload"]), bundle
    return payload_from_json(data), None


def payload_to_json(payload: dict) -> dict:
    return to_json(_payload_type_for(payload), payload)
