"""Bucket-prefixed repositories over the KV controller.

The port's copy of `lodestar_tpu/db/repository.py`; it imports nothing of the
JAX package.

Reference: packages/db/src/abstractRepository.ts (typed get/put/getMany
over one bucket) and db/src/schema.ts (the bucket id registry).  Keys
are `bucket byte + id bytes`; range scans stay inside the bucket via
the (prefix, prefix+1) bounds.
"""

from __future__ import annotations

import enum
from typing import Generic, Iterator, List, Optional, Tuple, TypeVar

from .controller import KvController

T = TypeVar("T")


class Bucket(enum.IntEnum):
    """Bucket ids (the subset of the reference's schema the framework
    uses; reference: db/src/schema.ts)."""

    block = 0
    block_archive = 1
    state_archive = 2
    checkpoint_state = 3
    deposit_event = 4
    eth1_data = 5
    proposer_slashing = 6
    attester_slashing = 7
    voluntary_exit = 8
    bls_to_execution_change = 9
    light_client_update = 10
    backfilled_ranges = 11
    block_archive_root_index = 12
    blobs_sidecar = 13
    blobs_sidecar_archive = 14
    deposit_data_root = 15
    # slasher column families (slasher/store.py)
    slasher_min_span = 16
    slasher_max_span = 17
    slasher_attestation = 18
    slasher_header = 19


class Repository(Generic[T]):
    """One bucket of encoded values.

    Subclasses (or callers) provide encode/decode; the default is
    identity over bytes.  SSZ-typed repositories pass the type object's
    serialize/deserialize (see BeaconDb).
    """

    def __init__(self, db: KvController, bucket: Bucket, ssz_type=None):
        self.db = db
        self.bucket = bucket
        self._prefix = bytes([int(bucket)])
        self._end = bytes([int(bucket) + 1])
        self.ssz_type = ssz_type

    def _key(self, id_: bytes) -> bytes:
        return self._prefix + id_

    def encode_value(self, value: T) -> bytes:
        if self.ssz_type is not None:
            return self.ssz_type.serialize(value)
        return value

    def decode_value(self, data: bytes) -> T:
        if self.ssz_type is not None:
            return self.ssz_type.deserialize(data)
        return data

    def put(self, id_: bytes, value: T) -> None:
        self.db.put(self._key(id_), self.encode_value(value))

    def get(self, id_: bytes) -> Optional[T]:
        data = self.db.get(self._key(id_))
        return None if data is None else self.decode_value(data)

    def has(self, id_: bytes) -> bool:
        return self.db.get(self._key(id_)) is not None

    def delete(self, id_: bytes) -> None:
        self.db.delete(self._key(id_))

    def batch_put(self, items: List[Tuple[bytes, T]]) -> None:
        self.db.batch_put(
            [(self._key(i), self.encode_value(v)) for i, v in items]
        )

    def keys(self) -> Iterator[bytes]:
        for k in self.db.keys(self._prefix, self._end):
            yield k[1:]

    def entries(self) -> Iterator[Tuple[bytes, T]]:
        for k, v in self.db.entries(self._prefix, self._end):
            yield k[1:], self.decode_value(v)

    def first_key(self) -> Optional[bytes]:
        for k in self.keys():
            return k
        return None

    def last_key(self) -> Optional[bytes]:
        last = None
        for k in self.keys():
            last = k
        return last
