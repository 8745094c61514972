"""eth2 API JSON <-> SSZ value encoding.

The port's copy of `lodestar_tpu/api/encoding.py`; it imports nothing of the
JAX package.

Reference: the @chainsafe/ssz `toJson`/`fromJson` conventions the
reference's api package relies on (packages/api/src/utils/serdes.ts):
uints as decimal strings, byte vectors/lists as 0x-hex, bit collections
as 0x-hex of their SSZ serialization, containers as objects with the
field names, lists as arrays.
"""

from __future__ import annotations

from typing import Any

from ..ssz.core import (
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    Container,
    List as SszList,
    UintN,
    Vector,
    _Boolean,
)


def to_json(ssz_type, value) -> Any:
    if isinstance(ssz_type, UintN):
        return str(int(value))
    if isinstance(ssz_type, _Boolean):
        return bool(value)
    if isinstance(ssz_type, (ByteVector, ByteList)):
        return "0x" + bytes(value).hex()
    if isinstance(ssz_type, (Bitlist, Bitvector)):
        return "0x" + ssz_type.serialize(value).hex()
    if isinstance(ssz_type, (Vector, SszList)):
        return [to_json(ssz_type.elem, v) for v in value]
    if isinstance(ssz_type, Container):
        return {
            name: to_json(ftype, value[name])
            for name, ftype in ssz_type.fields
        }
    raise TypeError(f"unsupported SSZ type {type(ssz_type)}")


def from_json(ssz_type, data: Any):
    """Decode API JSON into an SSZ value, enforcing the type's bounds
    (limits/lengths) exactly as SSZ deserialization would."""
    if isinstance(ssz_type, UintN):
        return int(data)
    if isinstance(ssz_type, _Boolean):
        return bool(data)
    if isinstance(ssz_type, (ByteVector, ByteList)):
        raw = bytes.fromhex(
            str(data)[2:] if str(data).startswith("0x") else str(data)
        )
        if isinstance(ssz_type, ByteVector) and len(raw) != ssz_type.length:
            raise ValueError(
                f"ByteVector[{ssz_type.length}]: got {len(raw)}"
            )
        if isinstance(ssz_type, ByteList) and len(raw) > ssz_type.limit:
            raise ValueError("ByteList over limit")
        return raw
    if isinstance(ssz_type, (Bitlist, Bitvector)):
        raw = bytes.fromhex(str(data)[2:] if str(data).startswith("0x") else str(data))
        return ssz_type.deserialize(raw)  # enforces limit/length
    if isinstance(ssz_type, Vector):
        if len(data) != ssz_type.length:
            raise ValueError("Vector length mismatch")
        return [from_json(ssz_type.elem, v) for v in data]
    if isinstance(ssz_type, SszList):
        if len(data) > ssz_type.limit:
            raise ValueError("List over limit")
        return [from_json(ssz_type.elem, v) for v in data]
    if isinstance(ssz_type, Container):
        return {
            name: from_json(ftype, data[name])
            for name, ftype in ssz_type.fields
        }
    raise TypeError(f"unsupported SSZ type {type(ssz_type)}")
