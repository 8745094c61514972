"""The port's SSZ type layer (`lodestar_tpu_torch/ssz/core.py`) and
containers (`lodestar_tpu_torch/types/`) against the JAX package's
(`lodestar_tpu/ssz/core.py`, `lodestar_tpu/types/`): for every ported
container and the basic types' edges, on values made with numpy from
fixed seeds, serialize, deserialize and hash_tree_root are byte-equal,
and the two packages refuse the same malformed encodings.
"""

import dataclasses

import numpy as np
import pytest

from lodestar_tpu import params as JP
from lodestar_tpu import ssz as JS
from lodestar_tpu import types as JT
from lodestar_tpu_torch import params as TP
from lodestar_tpu_torch import ssz as TS
from lodestar_tpu_torch import types as TT
from lodestar_tpu_torch.ssz import core as TC

# every container the port defines, by its module name
CONTAINERS = sorted(name for name, v in vars(TT).items() if isinstance(v, TC.Container))

# list lengths drawn for values: enough to cross a chunk and an offset table,
# small enough that a block body stays cheap to hash on the host
MAX_ELEMS = 3


def _value(t, rng):
    """A random value of the port's type `t` (plain Python; both packages
    take it)."""
    if isinstance(t, TC.UintN):
        bits = 8 * t.fixed_size
        edges = [0, 1, (1 << bits) - 1] + ([1 << 63, (1 << 64) - 1] if bits >= 64 else [])
        if rng.random() < 0.3:
            return int(edges[rng.integers(len(edges))])
        return int.from_bytes(rng.bytes(t.fixed_size), "little")
    if isinstance(t, TC._Boolean):
        return bool(rng.integers(2))
    if isinstance(t, TC.ByteVector):
        return rng.bytes(t.length)
    if isinstance(t, TC.ByteList):
        return rng.bytes(int(rng.integers(0, min(t.limit, 40) + 1)))
    if isinstance(t, TC.Bitvector):
        return [bool(b) for b in rng.integers(0, 2, t.length)]
    if isinstance(t, TC.Bitlist):
        n = int(rng.choice([0, 1, 7, 8, 9, 255, 256, 257, min(t.limit, 600)]))
        return [bool(b) for b in rng.integers(0, 2, n)]
    if isinstance(t, TC.Vector):
        return [_value(t.elem, rng) for _ in range(t.length)]
    if isinstance(t, TC.List):
        return [_value(t.elem, rng) for _ in range(int(rng.integers(0, min(t.limit, MAX_ELEMS) + 1)))]
    if isinstance(t, TC.Container):
        return {name: _value(ft, rng) for name, ft in t.fields}
    raise TypeError(t)


def _structure(t):
    """The type's shape, comparable across the two packages."""
    kind = type(t).__name__.lstrip("_")
    if isinstance(t, (TC.Container, JS.Container)):
        return (kind, t.name, tuple((n, _structure(ft)) for n, ft in t.fields))
    if hasattr(t, "elem"):
        return (kind, getattr(t, "length", None), getattr(t, "limit", None), _structure(t.elem))
    return (kind, t.fixed_size, getattr(t, "length", None), getattr(t, "limit", None))


def test_the_port_defines_every_phase0_and_altair_container():
    assert len(CONTAINERS) >= 35
    for name in ("AttestationData", "IndexedAttestation", "BeaconBlockHeader", "BeaconBlockBodyAltair",
                 "SignedBLSToExecutionChange", "SyncCommittee", "HistoricalBatch"):
        assert name in CONTAINERS
    assert dataclasses.asdict(TP.ACTIVE_PRESET) == dataclasses.asdict(JP.ACTIVE_PRESET)
    assert (TP.DEPOSIT_CONTRACT_TREE_DEPTH, TP.SYNC_COMMITTEE_SUBNET_COUNT, TP.SLOTS_PER_EPOCH) == (
        JP.DEPOSIT_CONTRACT_TREE_DEPTH, JP.SYNC_COMMITTEE_SUBNET_COUNT, JP.SLOTS_PER_EPOCH)


@pytest.mark.parametrize("name", CONTAINERS)
def test_container_bytes_and_root_equal_jax(name):
    ours, theirs = getattr(TT, name), getattr(JT, name)
    assert _structure(ours) == _structure(theirs)
    assert ours.fixed_size == theirs.fixed_size
    rng = np.random.default_rng(sum(map(ord, name)))
    for _ in range(2):
        v = _value(ours, rng)
        data = ours.serialize(v)
        assert data == theirs.serialize(v)
        back = ours.deserialize(data)
        assert back == theirs.deserialize(data) == v
        assert ours.hash_tree_root(v) == theirs.hash_tree_root(v) == TS.hash_tree_root(ours, v)
    d = ours.default()
    assert d == theirs.default()
    assert ours.serialize(d) == theirs.serialize(d) and ours.hash_tree_root(d) == theirs.hash_tree_root(d)


BASIC = [
    ("uint8", [0, 1, 255]),
    ("uint16", [0, 0xABCD, 0xFFFF]),
    ("uint32", [0, 1, 2**32 - 1]),
    ("uint64", [0, 1, 2**63 - 1, 2**63, 2**64 - 1]),
    ("uint128", [0, 2**64, 2**128 - 1]),
    ("uint256", [0, 2**255, 2**256 - 1]),
]


@pytest.mark.parametrize("name,values", BASIC, ids=[b[0] for b in BASIC])
def test_uint_edges_equal_jax(name, values):
    ours, theirs = getattr(TS, name), getattr(JS, name)
    for x in values:
        assert ours.serialize(x) == theirs.serialize(x)
        assert ours.deserialize(ours.serialize(x)) == x
        assert ours.hash_tree_root(x) == theirs.hash_tree_root(x)


def _pair(make):
    """The same type built in both packages."""
    return make(TS), make(JS)


COMPOSITES = {
    "boolean": (lambda m: m.Boolean, [True, False]),
    "bytes48": (lambda m: m.Bytes48, [bytes(range(48))]),
    "bytelist_20": (lambda m: m.ByteList(20), [b"", b"\x01", bytes(20)]),
    "bytelist_100": (lambda m: m.ByteList(100), [bytes(range(33)), bytes(range(64)), bytes(100)]),
    "bitvector_4": (lambda m: m.Bitvector(4), [[True, False, True, True]]),
    "bitvector_512": (lambda m: m.Bitvector(512), [[i % 3 == 0 for i in range(512)]]),
    # the delimiter bit at each byte boundary, and at the limit
    "bitlist_2048": (lambda m: m.Bitlist(2048), [[], [True], [False] * 7, [True] * 8, [True] * 9,
                                                 [i % 2 == 1 for i in range(256)], [True] * 257, [True] * 2048]),
    "bitlist_1": (lambda m: m.Bitlist(1), [[], [True], [False]]),
    # the length mix-in: empty, one element, a full chunk and past it
    "list_uint64": (lambda m: m.List(m.uint64, 1024), [[], [2**64 - 1], list(range(4)), list(range(5))]),
    "list_uint8_limit": (lambda m: m.List(m.uint8, 32), [[], list(range(32))]),
    "list_bytes32": (lambda m: m.List(m.Bytes32, 8), [[], [bytes([i]) * 32 for i in range(3)]]),
    "list_bytelist": (lambda m: m.List(m.ByteList(40), 4), [[], [b"", b"ab", bytes(40)]]),
    "vector_uint16": (lambda m: m.Vector(m.uint16, 17), [list(range(17))]),
    "vector_bytes32": (lambda m: m.Vector(m.Bytes32, 3), [[bytes([i]) * 32 for i in range(3)]]),
    "vector_container": (
        lambda m: m.Vector(m.Container((("a", m.uint64), ("b", m.ByteList(8))), name="C"), 2),
        [[{"a": 1, "b": b""}, {"a": 2**64 - 1, "b": b"xyz"}]],
    ),
    # field order: the same fields in two orders hash differently, in both packages alike
    "container_ab": (lambda m: m.Container((("a", m.uint64), ("b", m.uint64)), name="AB"), [{"a": 1, "b": 2}]),
    "container_ba": (lambda m: m.Container((("b", m.uint64), ("a", m.uint64)), name="BA"), [{"a": 1, "b": 2}]),
}


@pytest.mark.parametrize("case", sorted(COMPOSITES))
def test_composite_edges_equal_jax(case):
    make, values = COMPOSITES[case]
    ours, theirs = _pair(make)
    for v in values:
        data = ours.serialize(v)
        assert data == theirs.serialize(v)
        assert ours.deserialize(data) == theirs.deserialize(data) == v
        assert ours.hash_tree_root(v) == theirs.hash_tree_root(v)


def test_field_order_changes_the_root():
    ab, ba = COMPOSITES["container_ab"][0](TS), COMPOSITES["container_ba"][0](TS)
    v = {"a": 1, "b": 2}
    assert ab.hash_tree_root(v) != ba.hash_tree_root(v)
    assert ab.serialize(v) == b"\x01" + bytes(7) + b"\x02" + bytes(7)


MALFORMED = [
    ("bool_2", lambda m: m.Boolean, "deserialize", b"\x02"),
    ("uint64_short", lambda m: m.uint64, "deserialize", b"\x00" * 7),
    ("bytes32_long", lambda m: m.Bytes32, "serialize", b"\x00" * 33),
    ("bytelist_over", lambda m: m.ByteList(4), "serialize", b"\x00" * 5),
    ("bitvector_padding", lambda m: m.Bitvector(4), "deserialize", b"\x10"),
    ("bitlist_no_delimiter", lambda m: m.Bitlist(16), "deserialize", b"\x01\x00"),
    ("bitlist_empty_bytes", lambda m: m.Bitlist(16), "deserialize", b""),
    ("bitlist_over_limit", lambda m: m.Bitlist(4), "deserialize", b"\x3f"),
    ("bitlist_root_over_limit", lambda m: m.Bitlist(2), "hash_tree_root", [True] * 3),
    ("list_over", lambda m: m.List(m.uint8, 2), "serialize", [1, 2, 3]),
    ("vector_short", lambda m: m.Vector(m.uint8, 3), "serialize", [1, 2]),
    ("elements_ragged", lambda m: m.List(m.uint16, 8), "deserialize", b"\x00" * 3),
    ("first_offset", lambda m: m.List(m.ByteList(8), 4), "deserialize", b"\x05\x00\x00\x00\x00"),
]


@pytest.mark.parametrize("case", MALFORMED, ids=[m[0] for m in MALFORMED])
def test_both_refuse_the_same_malformed_input(case):
    _, make, method, arg = case
    for t in _pair(make):
        with pytest.raises(ValueError):
            getattr(t, method)(arg)
