"""The port's fork choice (`lodestar_tpu_torch/fork_choice/`) against the
JAX package's, driven by the same `on_block` / `on_attestation` script
made with numpy from a seed: random block trees with justified and
finalized epochs on the blocks, votes that move between branches,
balance changes, checkpoint updates, proposer boosts, equivocations and
a prune; after every step the heads, every node's weight, best child and
best descendant are compared exactly.
"""

import numpy as np
import pytest

from lodestar_tpu import fork_choice as JF
from lodestar_tpu_torch import fork_choice as TF


def _snapshot(fc):
    return [(n.root, n.slot, n.parent, n.weight, n.best_child, n.best_descendant, n.justified_epoch,
             n.finalized_epoch) for n in fc.proto.nodes]


def test_compute_deltas_equals_jax():
    rng = np.random.default_rng(0)
    for _ in range(20):
        n_nodes, n_val = int(rng.integers(1, 40)), int(rng.integers(1, 300))
        old, new = (rng.integers(-1, n_nodes, n_val) for _ in range(2))
        ob, nb = (rng.integers(0, 2**35, n_val) for _ in range(2))
        assert TF.compute_deltas(n_nodes, old, new, ob, nb) == JF.compute_deltas(n_nodes, old, new, ob, nb)


@pytest.mark.parametrize("seed", range(6))
def test_fork_choice_script_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n_val = int(rng.integers(16, 200))
    sides = [(F.ForkChoice(F.ProtoArray("g"), "g"), F) for F in (TF, JF)]
    roots, slots, epochs = ["g"], {"g": 0}, {"g": (0, 0)}
    seen_heads = set()
    for step in range(60):
        op = rng.random()
        if op < 0.35 or len(roots) < 3:  # a block on a random known parent
            parent = roots[int(rng.integers(len(roots)))]
            slot = slots[parent] + int(rng.integers(1, 4))
            root = f"b{step}"
            pj, pf = epochs[parent]
            j = pj + int(rng.integers(0, 2)) if rng.random() < 0.3 else pj
            f = min(j, pf + int(rng.integers(0, 2))) if rng.random() < 0.2 else pf
            for fc, _ in sides:
                fc.on_block(slot, root, parent, justified_epoch=j, finalized_epoch=f)
            roots.append(root)
            slots[root], epochs[root] = slot, (j, f)
            if rng.random() < 0.2:
                for fc, _ in sides:
                    fc.on_timely_block(root, slot)
        elif op < 0.75:  # votes, some moving, some stale
            for _ in range(int(rng.integers(1, 40))):
                v, root = int(rng.integers(n_val)), roots[int(rng.integers(len(roots)))]
                epoch = int(rng.integers(0, 6))
                for fc, _ in sides:
                    fc.on_attestation(v, epoch, root)
        elif op < 0.85:  # balances
            bal = rng.integers(0, 32 * 10**9, n_val + int(rng.integers(0, 5)))
            for fc, _ in sides:
                fc.set_balances(bal)
        elif op < 0.92:  # a checkpoint update: the store's justified epoch moves
            j = max(e[0] for e in epochs.values())
            for fc, _ in sides:
                fc.proto.justified_epoch = j
                fc.proto.finalized_epoch = min(j, max(e[1] for e in epochs.values()))
        elif op < 0.96:  # an equivocation
            slashed = rng.choice(n_val, 3, replace=False).tolist()
            for fc, _ in sides:
                fc.on_attester_slashing(slashed)
        else:  # the slot ticks: the boost clears
            for fc, _ in sides:
                fc.on_tick_slot()
        heads = []
        for fc, F in sides:
            try:
                heads.append(fc.update_head())
            except F.ProtoArrayError as e:
                heads.append(("error", str(e)))
        assert heads[0] == heads[1]
        seen_heads.add(str(heads[0]))
        assert _snapshot(sides[0][0]) == _snapshot(sides[1][0])
        assert sides[0][0].has_block(roots[-1]) and sides[0][0].descends_from_finalized(roots[-1]) == \
            sides[1][0].descends_from_finalized(roots[-1])
    assert len(seen_heads) > 2  # the head moved between branches
    # a prune at the finalized root removes the same nodes
    keep = roots[len(roots) // 3]
    removed = [[n.root for n in fc.prune(keep)] for fc, _ in sides]
    assert removed[0] == removed[1]
    assert _snapshot(sides[0][0]) == _snapshot(sides[1][0])
