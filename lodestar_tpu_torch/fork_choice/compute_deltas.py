"""compute_deltas — latest-message vote movement, vectorized.

The port's copy of `lodestar_tpu/fork_choice/compute_deltas.py`; it imports nothing of the
JAX package.

Reference: packages/fork-choice/src/protoArray/computeDeltas.ts — for
each validator whose latest message or effective balance changed,
subtract the old balance at the old vote target and add the new balance
at the new target.  Here the per-validator loop is numpy-vectorized
(np.add.at scatter), matching the framework's batch-first shape.

Equivocating (slashed) validators need no special case at this layer:
ForkChoice removes them from the latest-message map, so their new vote
index is already -1 and the unconditional old-balance subtraction backs
their standing vote out exactly once (the reference's
computeDeltas.ts:47-63 semantics, achieved structurally).
"""

from __future__ import annotations

from typing import List

import numpy as np


def compute_deltas(
    num_nodes: int,
    vote_indices_old: np.ndarray,  # int64[V], -1 = no vote
    vote_indices_new: np.ndarray,  # int64[V], -1 = no vote
    old_balances: np.ndarray,  # int64[V] effective balances
    new_balances: np.ndarray,
) -> List[int]:
    deltas = np.zeros(num_nodes, np.int64)
    old_mask = vote_indices_old >= 0
    new_mask = vote_indices_new >= 0
    np.subtract.at(deltas, vote_indices_old[old_mask], old_balances[old_mask])
    np.add.at(deltas, vote_indices_new[new_mask], new_balances[new_mask])
    return deltas.tolist()
