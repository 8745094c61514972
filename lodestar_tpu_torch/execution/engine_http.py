"""Engine API over authenticated JSON-RPC.

The port's copy of `lodestar_tpu/execution/engine_http.py`; it imports nothing of the
JAX package.

Mirror of the reference's ExecutionEngineHttp (reference:
packages/beacon-node/src/execution/engine/http.ts:1-376): the beacon
node speaks engine_newPayloadV1 / engine_forkchoiceUpdatedV1 /
engine_getPayloadV1 to the execution client over HTTP with JWT (HS256)
bearer auth derived from a shared hex secret (Engine API auth spec).

`EngineApiServer` hosts any IExecutionEngine (normally the mock) behind
the same wire protocol, so client<->server tests exercise real HTTP +
JWT + JSON-RPC — the reference tests the http client against its mock
the same way.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .engine import (
    ExecutePayloadStatus,
    ExecutionPayloadStatus,
    ForkchoiceUpdateResult,
    PayloadAttributes,
)

JWT_VALID_SECS = 60  # engine API spec: iat must be fresh (+-60s)


def _b64url(data: bytes) -> bytes:
    return base64.urlsafe_b64encode(data).rstrip(b"=")


def jwt_encode_hs256(secret: bytes, claims: dict) -> str:
    """Minimal HS256 JWT (the engine-API auth token carries one `iat`
    claim — http.ts jwt.ts equivalent)."""
    header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    body = _b64url(json.dumps(claims).encode())
    signing_input = header + b"." + body
    sig = _b64url(hmac.new(secret, signing_input, hashlib.sha256).digest())
    return (signing_input + b"." + sig).decode()


def jwt_verify_hs256(secret: bytes, token: str) -> dict:
    parts = token.encode().split(b".")
    if len(parts) != 3:
        raise ValueError("malformed JWT")
    signing_input = parts[0] + b"." + parts[1]
    want = _b64url(hmac.new(secret, signing_input, hashlib.sha256).digest())
    if not hmac.compare_digest(want, parts[2]):
        raise ValueError("bad JWT signature")
    pad = b"=" * (-len(parts[1]) % 4)
    claims = json.loads(base64.urlsafe_b64decode(parts[1] + pad))
    iat = int(claims.get("iat", 0))
    if abs(time.time() - iat) > JWT_VALID_SECS:
        raise ValueError("stale JWT iat")
    return claims


# -- JSON wire shapes (hex at the boundary, bytes inside) -------------------

_BYTES_FIELDS = (
    "parent_hash", "fee_recipient", "state_root", "receipts_root",
    "logs_bloom", "prev_randao", "extra_data", "block_hash",
)
_INT_FIELDS = ("block_number", "gas_limit", "gas_used", "timestamp",
               "base_fee_per_gas")


def withdrawal_to_json(w: dict) -> dict:
    return {
        "index": hex(int(w["index"])),
        "validatorIndex": hex(int(w["validator_index"])),
        "address": "0x" + bytes(w["address"]).hex(),
        "amount": hex(int(w["amount"])),
    }


def withdrawal_from_json(w: dict) -> dict:
    return {
        "index": int(w["index"], 16),
        "validator_index": int(w["validatorIndex"], 16),
        "address": bytes.fromhex(w["address"][2:]),
        "amount": int(w["amount"], 16),
    }


def payload_to_json(payload: dict) -> dict:
    out = {}
    for k in _BYTES_FIELDS:
        out[k] = "0x" + bytes(payload[k]).hex()
    for k in _INT_FIELDS:
        out[k] = hex(int(payload[k]))
    out["transactions"] = [
        "0x" + bytes(tx).hex() for tx in payload.get("transactions", [])
    ]
    if "withdrawals" in payload:  # capella (V2 shapes)
        out["withdrawals"] = [
            withdrawal_to_json(w) for w in payload["withdrawals"]
        ]
    if "blob_gas_used" in payload:  # deneb (V3 shapes)
        out["blobGasUsed"] = hex(int(payload["blob_gas_used"]))
        out["excessBlobGas"] = hex(int(payload["excess_blob_gas"]))
    return out


def payload_from_json(obj: dict) -> dict:
    out = {}
    for k in _BYTES_FIELDS:
        out[k] = bytes.fromhex(obj[k][2:])
    for k in _INT_FIELDS:
        out[k] = int(obj[k], 16)
    out["transactions"] = [
        bytes.fromhex(tx[2:]) for tx in obj.get("transactions", [])
    ]
    if "withdrawals" in obj:
        out["withdrawals"] = [
            withdrawal_from_json(w) for w in obj["withdrawals"]
        ]
    if "blobGasUsed" in obj:
        out["blob_gas_used"] = int(obj["blobGasUsed"], 16)
        out["excess_blob_gas"] = int(obj["excessBlobGas"], 16)
    return out


class EngineHttpError(Exception):
    pass


class ExecutionEngineHttp:
    """JSON-RPC client implementing IExecutionEngine over the wire."""

    def __init__(self, url: str, jwt_secret: bytes, timeout: float = 12.0):
        self.url = url
        self.jwt_secret = jwt_secret
        self.timeout = timeout
        self._id = 0

    def _call(self, method: str, params: list):
        self._id += 1
        body = json.dumps(
            {"jsonrpc": "2.0", "id": self._id, "method": method,
             "params": params}
        ).encode()
        token = jwt_encode_hs256(self.jwt_secret, {"iat": int(time.time())})
        req = urllib.request.Request(
            self.url,
            data=body,
            headers={
                "Content-Type": "application/json",
                "Authorization": f"Bearer {token}",
            },
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            reply = json.loads(resp.read())
        if "error" in reply:
            raise EngineHttpError(str(reply["error"]))
        return reply["result"]

    def notify_new_payload(
        self,
        payload: dict,
        versioned_hashes=None,
        parent_beacon_block_root=None,
    ) -> ExecutionPayloadStatus:
        # method version follows the payload's fork shape (engine API:
        # newPayloadV1 bellatrix, V2 capella, V3 deneb)
        if "blob_gas_used" in payload:
            # V3 REQUIRES the 3-param form: [payload, versionedHashes,
            # parentBeaconBlockRoot]
            params = [
                payload_to_json(payload),
                ["0x" + bytes(h).hex() for h in (versioned_hashes or [])],
                "0x" + bytes(parent_beacon_block_root or b"\x00" * 32).hex(),
            ]
            method = "engine_newPayloadV3"
        elif "withdrawals" in payload:
            params = [payload_to_json(payload)]
            method = "engine_newPayloadV2"
        else:
            params = [payload_to_json(payload)]
            method = "engine_newPayloadV1"
        r = self._call(method, params)
        return ExecutionPayloadStatus(
            ExecutePayloadStatus(r["status"]),
            latest_valid_hash=r.get("latestValidHash"),
            validation_error=r.get("validationError"),
        )

    def notify_forkchoice_update(
        self,
        head_block_hash: bytes,
        safe_block_hash: bytes,
        finalized_block_hash: bytes,
        payload_attributes: Optional[PayloadAttributes] = None,
    ) -> ForkchoiceUpdateResult:
        state = {
            "headBlockHash": "0x" + bytes(head_block_hash).hex(),
            "safeBlockHash": "0x" + bytes(safe_block_hash).hex(),
            "finalizedBlockHash": "0x" + bytes(finalized_block_hash).hex(),
        }
        attrs = None
        method = "engine_forkchoiceUpdatedV1"
        if payload_attributes is not None:
            attrs = {
                "timestamp": hex(payload_attributes.timestamp),
                "prevRandao": "0x" + bytes(payload_attributes.prev_randao).hex(),
                "suggestedFeeRecipient": "0x"
                + bytes(payload_attributes.suggested_fee_recipient).hex(),
            }
            if payload_attributes.withdrawals is not None:
                method = "engine_forkchoiceUpdatedV2"
                attrs["withdrawals"] = [
                    withdrawal_to_json(w)
                    for w in payload_attributes.withdrawals
                ]
            if payload_attributes.parent_beacon_block_root is not None:
                # deneb: post-Cancun ELs require fcuV3 + the parent root
                method = "engine_forkchoiceUpdatedV3"
                attrs["parentBeaconBlockRoot"] = (
                    "0x"
                    + bytes(
                        payload_attributes.parent_beacon_block_root
                    ).hex()
                )
        r = self._call(method, [state, attrs])
        ps = r["payloadStatus"]
        return ForkchoiceUpdateResult(
            ExecutePayloadStatus(ps["status"]),
            latest_valid_hash=ps.get("latestValidHash"),
            payload_id=r.get("payloadId"),
        )

    def get_payload(self, payload_id: str, version: int = 2) -> dict:
        # deneb payload_ids require getPayloadV3 on real ELs ("Unsupported
        # fork" otherwise); the caller passes the fork-appropriate version.
        # V2/V3 responses wrap the payload ({executionPayload, ...});
        # V1 returns it bare — accept both.
        r = self._call(f"engine_getPayloadV{version}", [payload_id])
        if "executionPayload" in r:
            r = r["executionPayload"]
        return payload_from_json(r)


class EngineApiServer:
    """Hosts an IExecutionEngine behind the engine JSON-RPC wire
    (reference: the mock EL's server role in e2e tests)."""

    def __init__(self, engine, jwt_secret: bytes, port: int = 0):
        self.engine = engine
        self.jwt_secret = jwt_secret
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # quiet
                pass

            def do_POST(self):
                try:
                    auth = self.headers.get("Authorization", "")
                    if not auth.startswith("Bearer "):
                        raise ValueError("missing bearer token")
                    jwt_verify_hs256(outer.jwt_secret, auth[len("Bearer "):])
                except ValueError as e:
                    self.send_response(401)
                    self.end_headers()
                    self.wfile.write(str(e).encode())
                    return
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                try:
                    result = outer._dispatch(req["method"], req["params"])
                    reply = {"jsonrpc": "2.0", "id": req["id"],
                             "result": result}
                except Exception as e:  # noqa: BLE001 - rpc error surface
                    reply = {
                        "jsonrpc": "2.0",
                        "id": req.get("id"),
                        "error": {"code": -32000, "message": str(e)},
                    }
                data = json.dumps(reply).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )

    def _dispatch(self, method: str, params: list):
        if method in (
            "engine_newPayloadV1",
            "engine_newPayloadV2",
            "engine_newPayloadV3",
        ):
            if method == "engine_newPayloadV3":
                if len(params) < 3:
                    raise ValueError("newPayloadV3 requires 3 params")
                hashes = [bytes.fromhex(h[2:]) for h in params[1]]
                parent_root = bytes.fromhex(params[2][2:])
                st = self.engine.notify_new_payload(
                    payload_from_json(params[0]), hashes, parent_root
                )
            else:
                st = self.engine.notify_new_payload(
                    payload_from_json(params[0])
                )
            return {
                "status": st.status.value,
                "latestValidHash": st.latest_valid_hash,
                "validationError": st.validation_error,
            }
        if method in (
            "engine_forkchoiceUpdatedV1",
            "engine_forkchoiceUpdatedV2",
            "engine_forkchoiceUpdatedV3",
        ):
            state, attrs = params
            pa = None
            if attrs:
                withdrawals = None
                if attrs.get("withdrawals") is not None:
                    withdrawals = [
                        withdrawal_from_json(w) for w in attrs["withdrawals"]
                    ]
                if method == "engine_forkchoiceUpdatedV3" and not attrs.get(
                    "parentBeaconBlockRoot"
                ):
                    raise ValueError(
                        "forkchoiceUpdatedV3 requires parentBeaconBlockRoot"
                    )
                parent_root = (
                    bytes.fromhex(attrs["parentBeaconBlockRoot"][2:])
                    if attrs.get("parentBeaconBlockRoot")
                    else None
                )
                pa = PayloadAttributes(
                    timestamp=int(attrs["timestamp"], 16),
                    prev_randao=bytes.fromhex(attrs["prevRandao"][2:]),
                    suggested_fee_recipient=bytes.fromhex(
                        attrs["suggestedFeeRecipient"][2:]
                    ),
                    withdrawals=withdrawals,
                    parent_beacon_block_root=parent_root,
                )
            r = self.engine.notify_forkchoice_update(
                bytes.fromhex(state["headBlockHash"][2:]),
                bytes.fromhex(state["safeBlockHash"][2:]),
                bytes.fromhex(state["finalizedBlockHash"][2:]),
                pa,
            )
            return {
                "payloadStatus": {
                    "status": r.status.value,
                    "latestValidHash": r.latest_valid_hash,
                    "validationError": None,
                },
                "payloadId": r.payload_id,
            }
        if method == "engine_getPayloadV1":
            return payload_to_json(self.engine.get_payload(params[0]))
        if method in ("engine_getPayloadV2", "engine_getPayloadV3"):
            return {
                "executionPayload": payload_to_json(
                    self.engine.get_payload(params[0])
                ),
                "blockValue": "0x0",
            }
        raise ValueError(f"unknown method {method}")

    def listen(self) -> None:
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
