"""SSZ type objects: serialization + merkleization, the port's copy of
`lodestar_tpu/ssz/core.py` (of its proof helpers only `is_valid_merkle_branch`).

Implements the consensus-spec SSZ rules the reference relies on through
`@chainsafe/ssz` (reference: packages/types/src/sszTypes.ts):

  - little-endian uintN, booleans, fixed byte vectors,
  - vectors/lists of fixed- and variable-size elements with 4-byte
    offset tables,
  - bitvectors/bitlists (delimiter-bit encoding),
  - containers with ordered fields,
  - hash_tree_root: 32-byte chunking, power-of-two zero-padded binary
    merkle trees, mix_in_length for lists/bitlists.

Values are plain Python: int, bool, bytes, list, dict (for containers).
Every hash runs on the host (`ssz/hasher.py`, hashlib); the state-root
engine's columnar fields take the card's kernels through `ChunkTree`.
"""

from __future__ import annotations

from typing import Dict, List as PyList, Optional, Sequence, Tuple

from .hasher import digest, hash_pairs

BYTES_PER_CHUNK = 32
ZERO_CHUNK = b"\x00" * BYTES_PER_CHUNK

# _ZERO_HASHES[d]: root of a depth-d subtree of zero chunks
_ZERO_HASHES: PyList[bytes] = [ZERO_CHUNK]
for _ in range(64):
    _ZERO_HASHES.append(digest(_ZERO_HASHES[-1] * 2))


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def merkleize_chunks(chunks: Sequence[bytes], limit: Optional[int] = None) -> bytes:
    """Binary merkle root of 32-byte chunks, zero-padded to limit leaves."""
    count = len(chunks)
    leaves = _next_pow2(limit if limit is not None else count)
    if limit is not None and count > limit:
        raise ValueError(f"chunk count {count} exceeds limit {limit}")
    if count == 0:
        return _ZERO_HASHES[leaves.bit_length() - 1]
    depth = leaves.bit_length() - 1
    level = b"".join(chunks)
    n = count
    for d in range(depth):
        if n % 2 == 1:
            level += _ZERO_HASHES[d]
            n += 1
        level = hash_pairs(level)
        n //= 2
        # the rest of this tree level is implicit zeros; parents of two
        # zeros come from the zero-hash table on the way up
    return level[:32] if n >= 1 else _ZERO_HASHES[depth]


def _mix_in_length(root: bytes, length: int) -> bytes:
    return digest(root + length.to_bytes(32, "little"))


def _pack_bytes(data: bytes) -> PyList[bytes]:
    """Pad bytes to whole 32-byte chunks."""
    if not data:
        return []
    pad = (-len(data)) % BYTES_PER_CHUNK
    data = data + b"\x00" * pad
    return [data[i : i + 32] for i in range(0, len(data), 32)]


class SszType:
    """Base: fixed_size is None for variable-size types."""

    fixed_size: Optional[int] = None

    def serialize(self, value) -> bytes:
        raise NotImplementedError

    def deserialize(self, data: bytes):
        raise NotImplementedError

    def hash_tree_root(self, value) -> bytes:
        raise NotImplementedError

    def default(self):
        raise NotImplementedError


class UintN(SszType):
    def __init__(self, byte_length: int):
        self.fixed_size = byte_length

    def serialize(self, value) -> bytes:
        return int(value).to_bytes(self.fixed_size, "little")

    def deserialize(self, data: bytes) -> int:
        if len(data) != self.fixed_size:
            raise ValueError("bad uint length")
        return int.from_bytes(data, "little")

    def hash_tree_root(self, value) -> bytes:
        return self.serialize(value).ljust(32, b"\x00")

    def default(self) -> int:
        return 0


uint8 = UintN(1)
uint16 = UintN(2)
uint32 = UintN(4)
uint64 = UintN(8)
uint128 = UintN(16)
uint256 = UintN(32)


class _Boolean(SszType):
    fixed_size = 1

    def serialize(self, value) -> bytes:
        return b"\x01" if value else b"\x00"

    def deserialize(self, data: bytes) -> bool:
        if data == b"\x01":
            return True
        if data == b"\x00":
            return False
        raise ValueError("bad boolean")

    def hash_tree_root(self, value) -> bytes:
        return self.serialize(value).ljust(32, b"\x00")

    def default(self) -> bool:
        return False


Boolean = _Boolean()


class ByteVector(SszType):
    def __init__(self, length: int):
        self.length = length
        self.fixed_size = length

    def serialize(self, value: bytes) -> bytes:
        if len(value) != self.length:
            raise ValueError(f"ByteVector[{self.length}]: got {len(value)}")
        return bytes(value)

    def deserialize(self, data: bytes) -> bytes:
        return self.serialize(data)

    def hash_tree_root(self, value: bytes) -> bytes:
        return merkleize_chunks(_pack_bytes(self.serialize(value)))

    def default(self) -> bytes:
        return b"\x00" * self.length


Bytes4 = ByteVector(4)
Bytes32 = ByteVector(32)
Bytes48 = ByteVector(48)
Bytes96 = ByteVector(96)


class ByteList(SszType):
    def __init__(self, limit: int):
        self.limit = limit

    def serialize(self, value: bytes) -> bytes:
        if len(value) > self.limit:
            raise ValueError("ByteList over limit")
        return bytes(value)

    def deserialize(self, data: bytes) -> bytes:
        return self.serialize(data)

    def hash_tree_root(self, value: bytes) -> bytes:
        limit_chunks = (self.limit + 31) // 32
        root = merkleize_chunks(_pack_bytes(self.serialize(value)), limit_chunks)
        return _mix_in_length(root, len(value))

    def default(self) -> bytes:
        return b""


class Vector(SszType):
    def __init__(self, elem: SszType, length: int):
        self.elem = elem
        self.length = length
        if elem.fixed_size is not None:
            self.fixed_size = elem.fixed_size * length

    def serialize(self, value) -> bytes:
        if len(value) != self.length:
            raise ValueError("Vector length mismatch")
        return _serialize_elems(self.elem, value)

    def deserialize(self, data: bytes):
        out = _deserialize_elems(self.elem, data)
        if len(out) != self.length:
            raise ValueError("Vector length mismatch")
        return out

    def hash_tree_root(self, value) -> bytes:
        return _elems_root(self.elem, value, None)

    def default(self):
        return [self.elem.default() for _ in range(self.length)]


class List(SszType):
    def __init__(self, elem: SszType, limit: int):
        self.elem = elem
        self.limit = limit

    def serialize(self, value) -> bytes:
        if len(value) > self.limit:
            raise ValueError("List over limit")
        return _serialize_elems(self.elem, value)

    def deserialize(self, data: bytes):
        out = _deserialize_elems(self.elem, data)
        if len(out) > self.limit:
            raise ValueError("List over limit")
        return out

    def hash_tree_root(self, value) -> bytes:
        root = _elems_root(self.elem, value, self.limit)
        return _mix_in_length(root, len(value))

    def default(self):
        return []


class Bitvector(SszType):
    def __init__(self, length: int):
        self.length = length
        self.fixed_size = (length + 7) // 8

    def serialize(self, value: Sequence[bool]) -> bytes:
        if len(value) != self.length:
            raise ValueError("Bitvector length mismatch")
        out = bytearray(self.fixed_size)
        for i, bit in enumerate(value):
            if bit:
                out[i // 8] |= 1 << (i % 8)
        return bytes(out)

    def deserialize(self, data: bytes):
        if len(data) != self.fixed_size:
            raise ValueError("Bitvector size mismatch")
        if self.length % 8 and data[-1] >> (self.length % 8):
            raise ValueError("Bitvector padding bits set")
        return [bool(data[i // 8] >> (i % 8) & 1) for i in range(self.length)]

    def hash_tree_root(self, value) -> bytes:
        return merkleize_chunks(_pack_bytes(self.serialize(value)))

    def default(self):
        return [False] * self.length


class Bitlist(SszType):
    def __init__(self, limit: int):
        self.limit = limit

    def serialize(self, value: Sequence[bool]) -> bytes:
        if len(value) > self.limit:
            raise ValueError("Bitlist over limit")
        out = bytearray(len(value) // 8 + 1)
        for i, bit in enumerate(value):
            if bit:
                out[i // 8] |= 1 << (i % 8)
        out[len(value) // 8] |= 1 << (len(value) % 8)  # delimiter bit
        return bytes(out)

    def deserialize(self, data: bytes):
        if not data or data[-1] == 0:
            raise ValueError("Bitlist missing delimiter")
        last = data[-1]
        nbits = (len(data) - 1) * 8 + last.bit_length() - 1
        if nbits > self.limit:
            raise ValueError("Bitlist over limit")
        return [bool(data[i // 8] >> (i % 8) & 1) for i in range(nbits)]

    def hash_tree_root(self, value) -> bytes:
        if len(value) > self.limit:
            raise ValueError("Bitlist over limit")
        out = bytearray((len(value) + 7) // 8)
        for i, bit in enumerate(value):
            if bit:
                out[i // 8] |= 1 << (i % 8)
        limit_chunks = (self.limit + 255) // 256
        root = merkleize_chunks(_pack_bytes(bytes(out)), limit_chunks)
        return _mix_in_length(root, len(value))

    def default(self):
        return []


class Container(SszType):
    """Ordered named fields; values are dicts (attribute-style access via
    `ssz_obj`)."""

    def __init__(self, fields: Sequence[Tuple[str, SszType]], name: str = "Container"):
        self.fields = tuple(fields)
        self.name = name
        if all(t.fixed_size is not None for _, t in self.fields):
            self.fixed_size = sum(t.fixed_size for _, t in self.fields)

    def serialize(self, value: Dict) -> bytes:
        fixed_parts: PyList[Optional[bytes]] = []
        var_parts: PyList[bytes] = []
        for fname, ftype in self.fields:
            v = value[fname]
            if ftype.fixed_size is not None:
                fixed_parts.append(ftype.serialize(v))
            else:
                fixed_parts.append(None)
                var_parts.append(ftype.serialize(v))
        fixed_len = sum(
            len(p) if p is not None else 4 for p in fixed_parts
        )
        out = bytearray()
        offset = fixed_len
        vi = 0
        for p in fixed_parts:
            if p is not None:
                out += p
            else:
                out += offset.to_bytes(4, "little")
                offset += len(var_parts[vi])
                vi += 1
        for p in var_parts:
            out += p
        return bytes(out)

    def deserialize(self, data: bytes) -> Dict:
        pos = 0
        offsets: PyList[Tuple[str, SszType, int]] = []
        value: Dict = {}
        for fname, ftype in self.fields:
            if ftype.fixed_size is not None:
                value[fname] = ftype.deserialize(data[pos : pos + ftype.fixed_size])
                pos += ftype.fixed_size
            else:
                offsets.append((fname, ftype, int.from_bytes(data[pos : pos + 4], "little")))
                pos += 4
        for i, (fname, ftype, off) in enumerate(offsets):
            end = offsets[i + 1][2] if i + 1 < len(offsets) else len(data)
            value[fname] = ftype.deserialize(data[off:end])
        return value

    def hash_tree_root(self, value: Dict) -> bytes:
        chunks = [ftype.hash_tree_root(value[fname]) for fname, ftype in self.fields]
        return merkleize_chunks(chunks)

    def default(self) -> Dict:
        return {fname: ftype.default() for fname, ftype in self.fields}


# -- element helpers --------------------------------------------------------


def _serialize_elems(elem: SszType, value) -> bytes:
    if elem.fixed_size is not None:
        return b"".join(elem.serialize(v) for v in value)
    parts = [elem.serialize(v) for v in value]
    offset = 4 * len(parts)
    out = bytearray()
    for p in parts:
        out += offset.to_bytes(4, "little")
        offset += len(p)
    for p in parts:
        out += p
    return bytes(out)


def _deserialize_elems(elem: SszType, data: bytes):
    if elem.fixed_size is not None:
        k = elem.fixed_size
        if len(data) % k:
            raise ValueError("bad element stream length")
        return [elem.deserialize(data[i : i + k]) for i in range(0, len(data), k)]
    if not data:
        return []
    first = int.from_bytes(data[:4], "little")
    if first % 4:
        raise ValueError("bad first offset")
    n = first // 4
    offs = [int.from_bytes(data[i * 4 : i * 4 + 4], "little") for i in range(n)]
    offs.append(len(data))
    return [elem.deserialize(data[offs[i] : offs[i + 1]]) for i in range(n)]


_BASIC = (UintN, _Boolean)


def _elems_root(elem: SszType, value, limit: Optional[int]) -> bytes:
    if isinstance(elem, _BASIC):
        data = b"".join(elem.serialize(v) for v in value)
        chunk_limit = (
            None if limit is None else (limit * elem.fixed_size + 31) // 32
        )
        return merkleize_chunks(_pack_bytes(data), chunk_limit)
    if isinstance(elem, ByteVector) and elem.length == 32:
        # a 32-byte vector's root IS its value — skip per-element
        # merkleization (the Bytes32-vector hot path: block/state roots,
        # randao mixes in the beacon state)
        chunks = []
        for v in value:
            b = bytes(v)
            if len(b) != 32:
                raise ValueError(f"ByteVector[32]: got {len(b)}")
            chunks.append(b)
    else:
        chunks = [elem.hash_tree_root(v) for v in value]
    return merkleize_chunks(chunks, limit)


def hash_tree_root(sztype: SszType, value) -> bytes:
    return sztype.hash_tree_root(value)


def is_valid_merkle_branch(
    leaf: bytes, branch: Sequence[bytes], depth: int, index: int, root: bytes
) -> bool:
    """Spec is_valid_merkle_branch — proves `leaf` sits at generalized
    index (2**depth + index) under `root` (deposit proofs against the
    eth1 deposit root)."""
    if len(branch) != depth:
        return False
    node = leaf
    for i in range(depth):
        if (index >> i) & 1:
            node = digest(branch[i] + node)
        else:
            node = digest(node + branch[i])
    return node == root
