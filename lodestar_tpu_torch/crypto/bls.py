"""BLS signatures over BLS12-381 (pubkeys in G1, signatures in G2) — CPU
ground truth, mirroring the blst API surface the reference consumes via
`@chainsafe/bls`:

  - `verify(pk, msg, sig)`          (blst one-shot verify)
  - `aggregate_pubkeys` / `aggregate_signatures`
        (reference: chain/bls/utils.ts:5-16 aggregates pubkeys on the main
         thread for `aggregate`-type signature sets)
  - `verify_multiple_signatures`    (random-linear-combination batch —
         reference: chain/bls/maybeBatch.ts:16-27 and multithread/worker.ts:52-87)

This CPU implementation is the correctness oracle and the small-batch /
latency-critical fallback path (the analog of the reference's
`verifyOnMainThread` option, chain/validation/block.ts:146).
"""

from __future__ import annotations

import hashlib
import os
from typing import List, Optional, Sequence, Tuple

from . import fields as F
from .curves import (
    FP2_OPS,
    FP_OPS,
    Affine,
    G1_GEN,
    affine_neg,
    g1_compress,
    g1_decompress,
    g2_compress,
    g2_decompress,
    g1_subgroup_check,
    g2_subgroup_check,
    is_on_curve,
    multi_add,
    scalar_mul,
)
from .hash_to_curve import DST_G2, hash_to_g2
from .pairing import multi_pairing_is_one

NEG_G1_GEN = affine_neg(FP_OPS, G1_GEN)

# Random coefficient width for batch verification.  The reference's blst
# backend uses 64-bit randomizers ("RAND_BITS" in blst); soundness error
# 2^-64 per batch.
RAND_BITS = 64


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------


def keygen(ikm: bytes) -> int:
    """Deterministic test keygen (HKDF-free simplification): sk from hash."""
    h = hashlib.sha256(b"lodestar-tpu-keygen" + ikm).digest()
    sk = int.from_bytes(h, "big") % F.R
    return sk if sk != 0 else 1


def sk_to_pk(sk: int) -> Affine:
    return scalar_mul(FP_OPS, G1_GEN, sk % F.R)


# ---------------------------------------------------------------------------
# Core sign / verify
# ---------------------------------------------------------------------------


def sign(sk: int, msg: bytes, dst: bytes = DST_G2) -> Affine:
    return scalar_mul(FP2_OPS, hash_to_g2(msg, dst), sk % F.R)


def verify(pk: Affine, msg: bytes, sig: Affine, dst: bytes = DST_G2) -> bool:
    """e(pk, H(msg)) == e(G1, sig)  <=>  e(-G1, sig) * e(pk, H(msg)) == 1."""
    if pk is None or sig is None:
        return False
    if not (is_on_curve(FP_OPS, pk) and is_on_curve(FP2_OPS, sig)):
        return False
    # KeyValidate + signature subgroup check (IETF BLS / blst semantics)
    if not (g1_subgroup_check(pk) and g2_subgroup_check(sig)):
        return False
    return multi_pairing_is_one(
        [(NEG_G1_GEN, sig), (pk, hash_to_g2(msg, dst))]
    )


def aggregate_pubkeys(pks: Sequence[Affine]) -> Affine:
    return multi_add(FP_OPS, pks)


def aggregate_signatures(sigs: Sequence[Affine]) -> Affine:
    return multi_add(FP2_OPS, sigs)


def fast_aggregate_verify(
    pks: Sequence[Affine], msg: bytes, sig: Affine, dst: bytes = DST_G2
) -> bool:
    """n pubkeys, one message, one aggregate signature (sync-committee shape).

    KeyValidate (IETF BLS / blst) applies per pubkey: infinity, off-curve,
    or out-of-subgroup members fail the whole verification even when their
    torsion components would cancel in the aggregate.
    """
    if not pks or any(pk is None for pk in pks):
        return False
    for pk in pks:
        if not (is_on_curve(FP_OPS, pk) and g1_subgroup_check(pk)):
            return False
    return verify(aggregate_pubkeys(pks), msg, sig, dst)


# ---------------------------------------------------------------------------
# Batch verification (random linear combination)
# ---------------------------------------------------------------------------


def _rand_scalars(n: int, entropy: Optional[bytes] = None) -> List[int]:
    if entropy is None:
        entropy = os.urandom(32)
    out = []
    for i in range(n):
        h = hashlib.sha256(entropy + i.to_bytes(4, "big")).digest()
        r = int.from_bytes(h[: RAND_BITS // 8], "big") | 1  # nonzero, odd
        out.append(r)
    return out


def verify_multiple_signatures(
    sets: Sequence[Tuple[Affine, bytes, Affine]],
    dst: bytes = DST_G2,
    entropy: Optional[bytes] = None,
) -> bool:
    """Batch-verify [(pk, msg, sig)] with random linear combination.

    prod_i e(r_i * pk_i, H(m_i)) * e(-G1, sum_i r_i * sig_i) == 1

    One shared final exponentiation for n+1 Miller loops — the same
    amortization blst's `verifyMultipleSignatures` exploits (reference:
    chain/bls/multithread/worker.ts:52-66).
    """
    if not sets:
        return True
    for pk, _msg, sig in sets:
        if pk is None or sig is None:
            return False
        if not (is_on_curve(FP_OPS, pk) and is_on_curve(FP2_OPS, sig)):
            return False
        if not (g1_subgroup_check(pk) and g2_subgroup_check(sig)):
            return False
    rs = _rand_scalars(len(sets), entropy)
    pairs = []
    rsigs = []
    for (pk, msg, sig), r in zip(sets, rs):
        pairs.append((scalar_mul(FP_OPS, pk, r), hash_to_g2(msg, dst)))
        rsigs.append(scalar_mul(FP2_OPS, sig, r))
    agg_rsig = multi_add(FP2_OPS, rsigs)
    pairs.append((NEG_G1_GEN, agg_rsig))
    return multi_pairing_is_one(pairs)


# ---------------------------------------------------------------------------
# Byte-level convenience (compressed keys/signatures)
# ---------------------------------------------------------------------------


def sign_bytes(sk: int, msg: bytes) -> bytes:
    return g2_compress(sign(sk, msg))


def verify_bytes(pk48: bytes, msg: bytes, sig96: bytes) -> bool:
    try:
        pk = g1_decompress(pk48)
        sig = g2_decompress(sig96)
    except ValueError:
        return False
    # verify() performs KeyValidate (None / on-curve / subgroup) itself.
    return verify(pk, msg, sig)
