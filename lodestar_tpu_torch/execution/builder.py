"""MEV builder API client + in-process mock builder.

The port's copy of `lodestar_tpu/execution/builder.py`; it imports nothing of the
JAX package.

Mirror of the reference's ExecutionBuilderHttp (reference:
packages/beacon-node/src/execution/builder/http.ts:30-160): the
builder-specs REST surface (status / registerValidator / getHeader /
submitBlindedBlock), the explicit enable-on-status contract, and the
circuit breaker (faultInspectionWindow / allowedFaults randomized per
boot, http.ts:54-71).  submitBlindedBlock verifies the returned
payload's transactions_root against the header the proposer signed
(http.ts:108-121) — a builder cannot substitute a different payload.

The mock builder plays the relay side for tests and dev mode: it
builds payloads through an ExecutionEngineMock, serves signed bids,
and reveals the payload only for a correctly-signed blinded block —
the full builder-specs happy path without a network.
"""

from __future__ import annotations

import json
import urllib.request
from typing import Dict, List, Optional

from .. import params
from ..utils.logger import get_logger


class BuilderError(Exception):
    pass


class BuilderBidResult:
    """getHeader result (reference: http.ts getHeader return shape)."""

    def __init__(
        self,
        header: dict,
        value: int,
        pubkey: bytes,
        blob_kzg_commitments: Optional[list] = None,
    ):
        self.header = header
        self.value = value
        self.pubkey = pubkey
        self.blob_kzg_commitments = blob_kzg_commitments


class _FaultWindow:
    """Circuit breaker: disable the builder after `allowed_faults`
    faults inside a sliding `window` of slots (reference: http.ts:54-71
    — ALLOWED_FAULTS in [1, SLOTS_PER_EPOCH/2], FAULT_INSPECTION_WINDOW
    in [SLOTS_PER_EPOCH, 2*SLOTS_PER_EPOCH])."""

    def __init__(self, window: int, allowed: int):
        self.window = max(window, params.SLOTS_PER_EPOCH)
        # the documented bound: ALLOWED_FAULTS in [1, SLOTS_PER_EPOCH/2]
        # (stricter than http.ts's code-level window/2 clamp)
        self.allowed = max(
            1, min(allowed, self.window // 2, params.SLOTS_PER_EPOCH // 2)
        )
        self.fault_slots: List[int] = []

    def record_fault(self, slot: int) -> bool:
        """Returns True when the breaker trips."""
        self.fault_slots.append(slot)
        self.fault_slots = [
            s for s in self.fault_slots if s > slot - self.window
        ]
        return len(self.fault_slots) > self.allowed

    def record_success(self, slot: int) -> None:
        self.fault_slots = [
            s for s in self.fault_slots if s > slot - self.window
        ]


class ExecutionBuilderHttp:
    """builder-specs REST client.

    Must be explicitly enabled via update_status(True) after a
    successful check_status() — the reference keeps the builder dark
    until the node proves it reachable (http.ts:36 `status = false`).
    """

    def __init__(
        self,
        base_url: str,
        config=None,
        timeout: float = 12.0,
        fault_inspection_window: Optional[int] = None,
        allowed_faults: Optional[int] = None,
    ):
        self.base_url = base_url.rstrip("/")
        self.config = config
        self.timeout = timeout
        self.log = get_logger("execution/builder")
        self.status = False
        spe = params.SLOTS_PER_EPOCH
        self._faults = _FaultWindow(
            fault_inspection_window or spe + spe // 2,
            allowed_faults or (spe + spe // 2) // 2,
        )

    # -- transport ---------------------------------------------------------

    def _request(self, method: str, path: str, body=None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.base_url + path,
            data=data,
            method=method,
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            raw = resp.read()
            return json.loads(raw) if raw else None

    # -- builder-specs surface ---------------------------------------------

    def update_status(self, enable: bool) -> None:
        self.status = enable

    def check_status(self) -> None:
        """GET /eth/v1/builder/status; a failure disables the builder
        (http.ts:78-86)."""
        try:
            self._request("GET", "/eth/v1/builder/status")
        except Exception:
            self.status = False
            raise

    def register_validator(self, registrations: List[dict]) -> None:
        """POST the signed registrations (fee recipient / gas limit per
        key) to the relay (http.ts:88-90)."""
        from .builder_codec import registrations_to_json

        self._request(
            "POST",
            "/eth/v1/builder/validators",
            registrations_to_json(registrations),
        )

    def get_header(
        self,
        slot: int,
        parent_hash: bytes,
        pubkey: bytes,
        payload_attributes=None,  # uniform interface; a real relay
        # derives attributes from its own chain view
    ) -> BuilderBidResult:
        from .builder_codec import bid_from_json

        res = self._request(
            "GET",
            f"/eth/v1/builder/header/{int(slot)}/0x{bytes(parent_hash).hex()}"
            f"/0x{bytes(pubkey).hex()}",
        )
        if res is None or "data" not in res:
            raise BuilderError("builder returned no bid")
        return bid_from_json(res["data"])

    def submit_blinded_block(self, signed_blinded: dict):
        """POST the signed blinded block; returns
        (payload, blobs_bundle|None) after verifying the payload's
        transactions_root matches the header the proposer committed to
        (http.ts:108-121).  Deneb relays answer with
        ExecutionPayloadAndBlobsBundle — the bundle carries the blobs
        the sidecars are built from (builder-specs deneb)."""
        from .builder_codec import (
            reveal_from_json,
            signed_blinded_to_json,
        )

        res = self._request(
            "POST",
            "/eth/v1/builder/blinded_blocks",
            signed_blinded_to_json(signed_blinded),
        )
        if res is None or "data" not in res:
            raise BuilderError("builder revealed no payload")
        payload, blobs_bundle = reveal_from_json(res["data"])
        verify_revealed_payload(signed_blinded, payload)
        return payload, blobs_bundle

    # -- circuit breaker ---------------------------------------------------

    def on_slot_fault(self, slot: int) -> None:
        if self._faults.record_fault(int(slot)) and self.status:
            self.log.warn("builder circuit breaker tripped", slot=slot)
            self.status = False

    def on_slot_success(self, slot: int) -> None:
        self._faults.record_success(int(slot))


def verify_revealed_payload(signed_blinded: dict, payload: dict) -> None:
    """The revealed payload must be the one the proposer signed:
    transactions (and withdrawals) must hash to the header's roots
    (reference: http.ts:111-121)."""
    from .. import types as T
    from ..ssz import List as SszList

    header = signed_blinded["message"]["body"]["execution_payload_header"]
    tx_root = SszList(T.Transaction, 1_048_576).hash_tree_root(
        list(payload.get("transactions", []))
    )
    if bytes(tx_root) != bytes(header["transactions_root"]):
        raise BuilderError("revealed payload transactions_root mismatch")
    if "withdrawals_root" in header:
        w_root = SszList(
            T.Withdrawal, T.MAX_WITHDRAWALS_PER_PAYLOAD
        ).hash_tree_root(list(payload.get("withdrawals", [])))
        if bytes(w_root) != bytes(header["withdrawals_root"]):
            raise BuilderError("revealed payload withdrawals_root mismatch")
    if bytes(payload["block_hash"]) != bytes(header["block_hash"]):
        raise BuilderError("revealed payload block_hash mismatch")


def unblind_signed_block(signed_blinded: dict, payload: dict) -> dict:
    """Blinded + revealed payload -> the full SignedBeaconBlock (the
    signature carries over unchanged: blinded and full blocks share the
    same hash_tree_root, reference http.ts:122-133)."""
    blinded = signed_blinded["message"]
    body = {
        k: v
        for k, v in blinded["body"].items()
        if k != "execution_payload_header"
    }
    body["execution_payload"] = dict(payload)
    return {
        "message": {**blinded, "body": body},
        "signature": signed_blinded["signature"],
    }


class ExecutionBuilderMock:
    """In-process relay: builds payloads via an ExecutionEngineMock,
    signs bids with a builder key, reveals on submit (the mock side of
    the builder-specs flow, playing the role the reference's test
    mocks play for ExecutionBuilderHttp)."""

    def __init__(self, engine, kzg_setup=None):
        from ..crypto import bls as B
        from ..crypto import curves as C

        self.engine = engine  # an ExecutionEngineMock
        self.pubkey = C.g1_compress(B.sk_to_pk(B.keygen(b"builder-mock")))
        self.bid_value = 10**9
        self.kzg_setup = kzg_setup
        self.status_ok = True
        self.registrations: Dict[bytes, dict] = {}  # pubkey -> registration
        # header root hex -> full payload, revealed on submit
        self._payloads: Dict[str, dict] = {}
        # header root hex -> blobs bundle (deneb bids)
        self._bundles: Dict[str, dict] = {}
        # blobs the next bid will commit to (test injection)
        self._pending_blobs: Optional[list] = None
        self.revealed = 0

    def set_blobs(self, blobs: Optional[list]) -> None:
        """Arm the next bid with blob content (deneb test injection —
        a real relay sources blobs from its own mempool)."""
        self._pending_blobs = list(blobs) if blobs else None

    # mock fault injection
    def check_status(self) -> None:
        if not self.status_ok:
            raise BuilderError("mock builder down")

    def update_status(self, enable: bool) -> None:
        self.status_ok = enable

    @property
    def status(self) -> bool:
        return self.status_ok

    def register_validator(self, registrations: List[dict]) -> None:
        for signed in registrations:
            msg = signed["message"]
            self.registrations[bytes(msg["pubkey"])] = dict(msg)

    def get_header(
        self,
        slot: int,
        parent_hash: bytes,
        pubkey: bytes,
        payload_attributes=None,
    ) -> BuilderBidResult:
        """Build a payload and bid its header.  `payload_attributes` is
        the mock's side-channel for the randao/timestamp the payload
        must satisfy — a real relay derives these from its own view of
        the chain; the HTTP client has no such parameter."""
        if not self.status_ok:
            raise BuilderError("mock builder down")
        if payload_attributes is None:
            raise BuilderError("mock builder needs payload attributes")
        r = self.engine.notify_forkchoice_update(
            parent_hash, parent_hash, b"\x00" * 32, payload_attributes
        )
        if r.payload_id is None:
            raise BuilderError(f"mock engine has no parent {parent_hash.hex()}")
        payload = self.engine.get_payload(r.payload_id)
        from ..state_transition.block import payload_to_header

        header = payload_to_header(payload)
        from .. import types as T

        key = bytes(T.ExecutionPayloadHeader.hash_tree_root(header)).hex()
        self._payloads[key] = payload
        commitments = None
        if self._pending_blobs is not None:
            if self.kzg_setup is None:
                raise BuilderError("mock builder has blobs but no KZG setup")
            from ..crypto import kzg as K

            blobs = self._pending_blobs
            self._pending_blobs = None
            commitments = [
                K.blob_to_kzg_commitment(b, self.kzg_setup) for b in blobs
            ]
            self._bundles[key] = {
                "commitments": commitments,
                "proofs": [
                    K.compute_blob_kzg_proof(b, c, self.kzg_setup)
                    for b, c in zip(blobs, commitments)
                ],
                "blobs": blobs,
            }
        return BuilderBidResult(
            header,
            self.bid_value,
            self.pubkey,
            blob_kzg_commitments=commitments,
        )

    def submit_blinded_block(self, signed_blinded: dict):
        from .. import types as T

        header = signed_blinded["message"]["body"][
            "execution_payload_header"
        ]
        key = bytes(T.ExecutionPayloadHeader.hash_tree_root(header)).hex()
        payload = self._payloads.get(key)
        if payload is None:
            raise BuilderError("unknown header: builder never bid this")
        verify_revealed_payload(signed_blinded, payload)
        self.revealed += 1
        return payload, self._bundles.get(key)
