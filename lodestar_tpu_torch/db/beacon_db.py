"""BeaconDb — the typed repository bundle.

The port's copy of `lodestar_tpu/db/beacon_db.py`; it imports nothing of the
JAX package.

Reference: packages/beacon-node/src/db/beaconDb.ts (20 repositories over
@lodestar/db).  The subset here covers the framework's persistence
needs: blocks (hot + archive), op pools, and backfill ranges — each an
SSZ-typed repository keyed by root or slot.
"""

from __future__ import annotations

from .. import types as T
from .controller import KvController
from .repository import Bucket, Repository


def _slot_key(slot: int) -> bytes:
    return slot.to_bytes(8, "big")  # big-endian keeps slot order == byte order


class ForkAwareSignedBlockCodec:
    """serialize/deserialize signed blocks with the container of the
    block's OWN fork (reference: db repositories use
    config.getForkTypes(slot) — db/repositories/block.ts).

    An altair-typed repository silently DROPS execution payloads on put;
    this codec reads the slot straight out of the value/bytes and
    dispatches.  Serialized layout of every SignedBeaconBlock fork:
    [message offset u32 | signature 96B | message...], and slot is the
    message's first (fixed) field."""

    def __init__(self, config):
        self.config = config

    def serialize(self, signed: dict) -> bytes:
        slot = int(signed["message"]["slot"])
        return self.config.get_fork_types(slot)[1].serialize(signed)

    def deserialize(self, data: bytes) -> dict:
        offset = int.from_bytes(data[0:4], "little")
        slot = int.from_bytes(data[offset : offset + 8], "little")
        return self.config.get_fork_types(slot)[1].deserialize(data)


class BlobSidecarListCodec:
    """Binary codec for a block's sidecar list.

    Blobs are length-prefixed instead of using the preset-width SSZ
    ByteVector so dev-width test blobs (and future preset changes)
    store without re-encoding; everything else is fixed-width
    (reference: db/repositories/blobsSidecar.ts stores the SSZ
    BlobSidecars — same content, self-describing width here)."""

    _HEADER_LEN = 112  # slot u64 + proposer u64 + 3 roots
    _PROOF_DEPTH = 17

    def serialize(self, sidecars) -> bytes:
        out = [len(sidecars).to_bytes(4, "little")]
        for sc in sidecars:
            h = sc["signed_block_header"]["message"]
            blob = bytes(sc["blob"])
            out.append(int(sc["index"]).to_bytes(8, "little"))
            out.append(len(blob).to_bytes(4, "little"))
            out.append(blob)
            out.append(bytes(sc["kzg_commitment"]))
            out.append(bytes(sc["kzg_proof"]))
            out.append(int(h["slot"]).to_bytes(8, "little"))
            out.append(int(h["proposer_index"]).to_bytes(8, "little"))
            out.append(bytes(h["parent_root"]))
            out.append(bytes(h["state_root"]))
            out.append(bytes(h["body_root"]))
            out.append(bytes(sc["signed_block_header"]["signature"]))
            proof = list(sc["kzg_commitment_inclusion_proof"])
            assert len(proof) == self._PROOF_DEPTH
            out.extend(bytes(p) for p in proof)
        return b"".join(out)

    # each sidecar is at least this many bytes after the blob
    # (index 8 + blen 4 + commitment 48 + proof 48 + header 112 +
    # sig 96 + branch 17*32)
    _FIXED_PART = 8 + 4 + 48 + 48 + 112 + 96 + 17 * 32
    _MAX_BLOB_LEN = 32 * 4096  # largest preset width

    def deserialize(self, data: bytes):
        """Strict bounds checks throughout: this codec decodes UNTRUSTED
        peer responses (blob_sidecars_by_range/root), so a hostile
        count/length must be a decode error, not a 4-billion-iteration
        loop or silently misaligned fields."""
        if len(data) < 4:
            raise ValueError("blob sidecar list: truncated header")
        n = int.from_bytes(data[0:4], "little")
        if n * self._FIXED_PART > len(data):
            raise ValueError(f"blob sidecar list: count {n} exceeds data")
        pos = 4
        sidecars = []
        for _ in range(n):
            if pos + 12 > len(data):
                raise ValueError("blob sidecar list: truncated entry")
            index = int.from_bytes(data[pos : pos + 8], "little"); pos += 8
            blen = int.from_bytes(data[pos : pos + 4], "little"); pos += 4
            if blen > self._MAX_BLOB_LEN or pos + blen + (
                self._FIXED_PART - 12
            ) > len(data):
                raise ValueError("blob sidecar list: bad blob length")
            blob = data[pos : pos + blen]; pos += blen
            commitment = data[pos : pos + 48]; pos += 48
            proof = data[pos : pos + 48]; pos += 48
            slot = int.from_bytes(data[pos : pos + 8], "little"); pos += 8
            proposer = int.from_bytes(data[pos : pos + 8], "little"); pos += 8
            parent = data[pos : pos + 32]; pos += 32
            state = data[pos : pos + 32]; pos += 32
            body = data[pos : pos + 32]; pos += 32
            sig = data[pos : pos + 96]; pos += 96
            branch = [
                data[pos + i * 32 : pos + (i + 1) * 32]
                for i in range(self._PROOF_DEPTH)
            ]
            pos += self._PROOF_DEPTH * 32
            sidecars.append(
                {
                    "index": index,
                    "blob": blob,
                    "kzg_commitment": commitment,
                    "kzg_proof": proof,
                    "signed_block_header": {
                        "message": {
                            "slot": slot,
                            "proposer_index": proposer,
                            "parent_root": parent,
                            "state_root": state,
                            "body_root": body,
                        },
                        "signature": sig,
                    },
                    "kzg_commitment_inclusion_proof": branch,
                }
            )
        return sidecars


class BeaconDb:
    def __init__(self, path=None, config=None):
        self.controller = KvController(path)
        db = self.controller
        # fork-aware block codec when a config is wired; the altair
        # container otherwise (legacy tests)
        block_codec = (
            ForkAwareSignedBlockCodec(config)
            if config is not None
            else T.SignedBeaconBlockAltair
        )
        self.block = Repository(db, Bucket.block, block_codec)
        self.block_archive = Repository(
            db, Bucket.block_archive, block_codec
        )
        # root -> slot key for archived blocks (reference:
        # blockArchiveRootIndex in db/repositories/blockArchive.ts)
        self.block_archive_root_index = Repository(
            db, Bucket.block_archive_root_index
        )
        self.state_archive = Repository(db, Bucket.state_archive)
        self.proposer_slashing = Repository(
            db, Bucket.proposer_slashing, T.ProposerSlashing
        )
        self.attester_slashing = Repository(
            db, Bucket.attester_slashing, T.AttesterSlashing
        )
        self.voluntary_exit = Repository(
            db, Bucket.voluntary_exit, T.SignedVoluntaryExit
        )
        self.backfilled_ranges = Repository(db, Bucket.backfilled_ranges)
        self.bls_to_execution_change = Repository(
            db, Bucket.bls_to_execution_change, T.SignedBLSToExecutionChange
        )
        # deneb blob sidecars: hot by block root; archive slot-keyed
        # (reference: db/repositories/blobsSidecar.ts + archive)
        blob_codec = BlobSidecarListCodec()
        self.blobs_sidecar = Repository(
            db, Bucket.blobs_sidecar, blob_codec
        )
        self.blobs_sidecar_archive = Repository(
            db, Bucket.blobs_sidecar_archive, blob_codec
        )
        # eth1 follow state (reference: depositEvent.ts,
        # depositDataRoot.ts, eth1Data.ts) — deposit events keyed by
        # deposit index, roots likewise, eth1 data by block timestamp
        self.deposit_event = Repository(db, Bucket.deposit_event)
        self.deposit_data_root = Repository(db, Bucket.deposit_data_root)
        self.eth1_data = Repository(db, Bucket.eth1_data)
        # light-client best update per sync-committee period
        # (reference: db/repositories/lightclientBestUpdate.ts)
        self.light_client_best_update = Repository(
            db, Bucket.light_client_update
        )
        # slasher state (slasher/store.py): span-array blobs, indexed-
        # attestation evidence by hash root, proposer headers by
        # slot||proposer
        self.slasher_min_span = Repository(db, Bucket.slasher_min_span)
        self.slasher_max_span = Repository(db, Bucket.slasher_max_span)
        self.slasher_attestation = Repository(
            db, Bucket.slasher_attestation, T.IndexedAttestation
        )
        self.slasher_header = Repository(
            db, Bucket.slasher_header, T.SignedBeaconBlockHeader
        )

    def put_block(self, root: bytes, signed_block: dict) -> None:
        self.block.put(root, signed_block)

    def archive_block(
        self, slot: int, signed_block: dict, root: bytes = None
    ) -> None:
        self.block_archive.put(_slot_key(slot), signed_block)
        if root is not None:
            self.block_archive_root_index.put(root, _slot_key(slot))

    def get_block_anywhere(self, root: bytes):
        """Hot repo first, then the slot-keyed archive via the root
        index — blocks survive archiver migration for readers."""
        signed = self.block.get(root)
        if signed is not None:
            return signed
        slot_key = self.block_archive_root_index.get(root)
        if slot_key is None:
            return None
        return self.block_archive.get(slot_key)

    def archive_state(self, slot: int, state_bytes: bytes) -> None:
        self.state_archive.put(_slot_key(slot), state_bytes)

    # -- blob sidecars (deneb) ---------------------------------------------

    def put_blob_sidecars(self, root: bytes, sidecars: list) -> None:
        self.blobs_sidecar.put(bytes(root), sidecars)

    def get_blob_sidecars(self, root: bytes):
        """Hot repo first, then the slot-keyed archive via the block
        root index (same pattern as get_block_anywhere)."""
        sidecars = self.blobs_sidecar.get(bytes(root))
        if sidecars is not None:
            return sidecars
        slot_key = self.block_archive_root_index.get(bytes(root))
        if slot_key is None:
            return None
        return self.blobs_sidecar_archive.get(slot_key)

    def archive_blob_sidecars(
        self, slot: int, sidecars: list, root: bytes = None
    ) -> None:
        self.blobs_sidecar_archive.put(_slot_key(slot), sidecars)
        if root is not None:
            self.blobs_sidecar.delete(bytes(root))

    def close(self) -> None:
        self.controller.close()
