"""The operation pools' offender rule, copied from
`lodestar_tpu/chain/op_pools.py` (only `attester_slashing_intersection`,
which the slasher service's emission path calls; the pools themselves are
not ported).
"""

from __future__ import annotations

from typing import List


def attester_slashing_intersection(slashing: dict) -> List[int]:
    """THE offender set of an AttesterSlashing (spec: indices attesting
    in both conflicting attestations) — shared by pool keying, fork-
    choice equivocation zeroing, and the slasher's emission path."""
    return sorted(
        set(int(i) for i in slashing["attestation_1"]["attesting_indices"])
        & set(int(i) for i in slashing["attestation_2"]["attesting_indices"])
    )
