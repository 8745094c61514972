"""Blob sidecar helpers: commitment inclusion proofs + gossip checks.

The port's copy of `lodestar_tpu/chain/blobs.py`; it imports nothing of the
JAX package.

Mirror of the reference's blob handling role (reference:
packages/beacon-node/src/chain/validation/blobsSidecar.ts and
util/kzg.ts) updated to the per-blob BlobSidecar shape that shipped on
mainnet deneb: each sidecar binds (blob, commitment, proof) to a signed
block header through a depth-17 merkle inclusion proof of the
commitment inside the block body.

Depth arithmetic: body container (12 fields -> 16 chunks, depth 4) *
commitments List(4096) (vector depth 12 + length mix 1 = 13) = 17 —
the KZG_COMMITMENT_INCLUSION_PROOF_DEPTH constant in types.
"""

from __future__ import annotations

from typing import List, Optional

from .. import params
from .. import types as T
from ..ssz.core import _merkle_branch, is_valid_merkle_branch

_COMMITMENT_LIMIT = T.MAX_BLOB_COMMITMENTS_PER_BLOCK  # 4096, depth 12
_LIST_DEPTH = _COMMITMENT_LIMIT.bit_length() - 1  # 12


def _body_field_index(body_type) -> int:
    names = [fname for fname, _ in body_type.fields]
    return names.index("blob_kzg_commitments")


def blob_inclusion_proof(
    body_type, body_value: dict, index: int
) -> List[bytes]:
    """The sidecar producer side: the depth-17 branch proving
    body.blob_kzg_commitments[index] under the body root."""
    commitments = list(body_value["blob_kzg_commitments"])
    assert index < len(commitments)
    # leaves inside the commitments vector (padded to the full limit so
    # the branch matches the List's limit-merkleization)
    leaves = [T.KZGCommitment.hash_tree_root(c) for c in commitments]
    leaves += [b"\x00" * 32] * (_COMMITMENT_LIMIT - len(leaves))
    vector_branch = _merkle_branch(leaves, index)  # depth 12
    length_chunk = len(commitments).to_bytes(32, "little")
    # body-level branch for the commitments field (depth 4)
    field_idx = _body_field_index(body_type)
    chunks = [
        ftype.hash_tree_root(body_value[fname])
        for fname, ftype in body_type.fields
    ]
    body_branch = _merkle_branch(chunks, field_idx)
    return vector_branch + [length_chunk] + body_branch


def blob_inclusion_gindex(body_type, index: int) -> int:
    """The leaf index at depth 17 (composed the same way
    container_branch composes nested indices)."""
    field_idx = _body_field_index(body_type)
    return field_idx * (1 << (_LIST_DEPTH + 1)) + index


def verify_blob_inclusion(sidecar: dict, body_type) -> bool:
    """Check the sidecar's commitment inclusion proof against the signed
    header's body root (spec verify_blob_sidecar_inclusion_proof)."""
    header = sidecar["signed_block_header"]["message"]
    index = int(sidecar["index"])
    return is_valid_merkle_branch(
        T.KZGCommitment.hash_tree_root(sidecar["kzg_commitment"]),
        list(sidecar["kzg_commitment_inclusion_proof"]),
        T.KZG_COMMITMENT_INCLUSION_PROOF_DEPTH,
        blob_inclusion_gindex(body_type, index),
        bytes(header["body_root"]),
    )


def make_blob_sidecars(
    signed_block: dict, body_type, blobs: List[bytes], setup
) -> List[dict]:
    """Sidecars for a produced block (reference: the block production
    side packs sidecars next to the block for gossip)."""
    from ..crypto import kzg as K

    block = signed_block["message"]
    body = block["body"]
    commitments = list(body["blob_kzg_commitments"])
    assert len(blobs) == len(commitments)
    header = {
        "slot": block["slot"],
        "proposer_index": block["proposer_index"],
        "parent_root": bytes(block["parent_root"]),
        "state_root": bytes(block["state_root"]),
        "body_root": body_type.hash_tree_root(body),
    }
    out = []
    for i, (blob, commitment) in enumerate(zip(blobs, commitments)):
        out.append(
            {
                "index": i,
                "blob": blob,
                "kzg_commitment": bytes(commitment),
                "kzg_proof": K.compute_blob_kzg_proof(
                    blob, bytes(commitment), setup
                ),
                "signed_block_header": {
                    "message": header,
                    "signature": bytes(signed_block["signature"]),
                },
                "kzg_commitment_inclusion_proof": blob_inclusion_proof(
                    body_type, body, i
                ),
            }
        )
    return out
