"""O(log n) Merkle proofs read straight off the warm hash forest.

The port's copy of `lodestar_tpu/proofs/plane_reader.py`; it imports nothing of the
JAX package.

The host proof producer (`ssz/core.py::container_branch`) re-merkleizes
every top-level field root per request — O(state size), dominated by
the validator registry.  But the state-root engine already
holds every internal node of the hot state: the top-level field tree
(`StateRootEngine.top`), one `ChunkTree` per big packed field, and the
per-validator root plane.  A proof is then a pure READ: one sibling per
level, zero hashing.

Seam convention (the established None-falls-through contract): every
entry point returns None whenever the planes cannot serve the request —
engine absent (spilled/evicted state), planes released, engine stale
(`LODESTAR_TPU_HTR=full` bypasses it), or a path shape the planes do
not cover.  Callers MUST fall through to `container_branch` /
`container_branches`; the host path always completes the request, so a
cold plane can never produce a wrong or missing proof.

What the planes cover:
  - any top-level field leaf (one `top.branch()` read),
  - a trailing numeric chunk index inside a ChunkTree-backed field
    (balances, validators, block_roots, ... — `cell.tree.branch()`
    plus the mix-in length chunk for lists),
  - nested paths below memo-backed container fields
    (finalized_checkpoint.root, latest_block_header.state_root, ...)
    via host recursion over the SMALL sub-container only — O(sub
    fields), never O(state).

The descending-multiproof packer dedupes branch nodes shared across
leaves (sibling overlap grows with path locality), and
`verify_multiproof` folds the packed form back to the root.
"""

from __future__ import annotations

from typing import Dict, List as PyList, Optional, Sequence, Tuple

from ..ssz.core import (
    Container,
    List as SszList,
    Vector,
    _is_leaf_index,
    container_branch,
    leaf_chunk_branch,
)
from ..ssz.hasher import digest

# (leaf, branch, depth, index) — container_branch's shape, verbatim
Proof = Tuple[bytes, PyList[bytes], int, int]


def _warm_engine(state):
    """The resident engine when it can serve plane reads for `state`,
    else None.

    The one hash_tree_root() call here is the warm incremental sync —
    O(dirty chunks), which is what makes the subsequent branch reads
    current.  It is only issued when the engine AND its top tree are
    already resident: an engineless (spilled/evicted) or released
    state returns None immediately rather than paying a full cold
    rebuild that would fight the governor's eviction decision.  A
    fault of the sync raises, as every state root does in the port:
    it never turns into a host re-merkleization in the caller (the
    JAX package's copy returns None).  The root equality check covers
    `LODESTAR_TPU_HTR=full`, which bypasses the engine and can leave
    it stale."""
    engine = getattr(state, "_root_engine", None)
    if engine is None or getattr(engine, "top", None) is None:
        return None
    root = state.hash_tree_root()
    engine = getattr(state, "_root_engine", None)
    if engine is None or engine.top is None or engine.top.count == 0:
        return None
    if engine.top.root != root:
        return None
    return engine


def state_proof(state, path: Sequence) -> Optional[Proof]:
    """Proof of `path` under `state`'s root, or None (fall through to
    container_branch).  Bit-identical to the host path when served."""
    engine = _warm_engine(state)
    if engine is None:
        return None
    return _proof_from_engine(engine, state, list(path))


def state_multiproof(
    state, paths: Sequence[Sequence]
) -> Optional[PyList[Proof]]:
    """Proofs for every path in `paths` (ONE engine sync), or None when
    ANY path cannot be served from planes — all-or-nothing so the
    caller's host fallback (container_branches) keeps its one-pass
    economics instead of splitting per path."""
    engine = _warm_engine(state)
    if engine is None:
        return None
    out: PyList[Proof] = []
    for path in paths:
        proof = _proof_from_engine(engine, state, list(path))
        if proof is None:
            return None
        out.append(proof)
    return out


def _proof_from_engine(engine, state, path: list) -> Optional[Proof]:
    container = state._container()
    names = [fname for fname, _ in container.fields]
    if not path:
        return engine.top.root, [], 0, 0
    name = str(path[0])
    if name not in names:
        return None  # unknown field: the host path raises the caller's 400
    idx = names.index(name)
    top = engine.top
    here_branch = top.branch(idx)
    here_depth = top.depth
    if len(path) == 1:
        return top.leaf(idx), here_branch, here_depth, idx
    sub = _sub_proof(engine, state, name, container.fields[idx][1], path[1:])
    if sub is None:
        return None
    leaf, sub_branch, sub_depth, sub_index = sub
    return (
        leaf,
        sub_branch + here_branch,
        sub_depth + here_depth,
        idx * (1 << sub_depth) + sub_index,
    )


def _sub_proof(engine, state, fname: str, ftype, rest: list):
    """Proof inside one field's subtree, anchored at the field root."""
    if len(rest) == 1 and _is_leaf_index(rest[0]):
        chunk_index = int(rest[0])
        cell = engine.leaf_cell(fname)
        if cell is not None:
            # ChunkTree-backed field: pure plane reads
            tree, length, mixin = cell
            if not (0 <= chunk_index < (1 << tree.depth)):
                return None
            branch = tree.branch(chunk_index)
            depth = tree.depth
            leaf = tree.leaf(chunk_index)
            if mixin:
                branch = branch + [length.to_bytes(32, "little")]
                depth += 1
            return leaf, branch, depth, chunk_index
        if isinstance(ftype, (SszList, Vector)):
            # memo-backed list/vector (historical_roots, eth1 votes):
            # small host oracle over the live value
            try:
                return leaf_chunk_branch(
                    ftype, getattr(state, fname), chunk_index
                )
            except (IndexError, TypeError, ValueError):
                return None
        return None
    if engine.leaf_cell(fname) is not None:
        return None  # deep paths into packed cells: host path owns these
    if not isinstance(ftype, Container):
        return None
    # memo-backed sub-container: its cached field chunk is current as of
    # the snapshot's hash_tree_root, and the sub-container is SMALL
    # (Checkpoint, BeaconBlockHeader, Eth1Data) — recursing the host
    # producer over it costs O(sub fields), never O(state)
    try:
        return container_branch(
            ftype, getattr(state, fname), [str(p) for p in rest]
        )
    except (KeyError, IndexError, TypeError, ValueError):
        return None


# -- descending multiproof ---------------------------------------------------


def pack_multiproof(proofs: Sequence[Proof]) -> dict:
    """Pack proofs that share ONE anchoring root into the descending
    multiproof form: every distinct tree node appears ONCE, helper
    nodes are exactly the siblings no proof path computes, and both
    sequences are sorted by DESCENDING generalized index (the order a
    verifier folds bottom-up in a single pass).

    Returns {"leaves": {gindex: node}, "helpers": [(gindex, node)...]}.
    Shared branch nodes across leaves are deduped — the whole point of
    multiproofs: k proofs of depth d cost well under k*d nodes when
    paths share ancestry."""
    leaves: Dict[int, bytes] = {}
    nodes: Dict[int, bytes] = {}
    for leaf, branch, depth, index in proofs:
        g = (1 << depth) + index
        leaves[g] = leaf
        for i, sibling in enumerate(branch):
            nodes[(g >> i) ^ 1] = sibling
    on_path = set()
    for g in leaves:
        while g >= 1:
            on_path.add(g)
            g >>= 1
    helper_g = sorted((g for g in nodes if g not in on_path), reverse=True)
    return {
        "leaves": {g: leaves[g] for g in sorted(leaves, reverse=True)},
        "helpers": [(g, nodes[g]) for g in helper_g],
    }


def verify_multiproof(leaves, helpers, root: bytes) -> bool:
    """Fold a packed multiproof bottom-up (descending gindex order) and
    compare against `root`.  False on a mismatch OR a malformed node
    set — never raises on malformed input.

    Fails CLOSED against helper placement attacks: a helper whose
    gindex sits ON any leaf's path to the root (including at a leaf's
    own gindex) would shadow the honest recomputation and let a forged
    leaf verify, so any such helper — or a duplicate, or one whose
    sibling is off every leaf path (it could never be consumed) — is
    rejected outright.  Every on-path internal node is recomputed from
    its two children, so each leaf is consumed by digests on an
    unbroken path to gindex 1; when one requested leaf is an ancestor
    of another, its claimed value must MATCH the value recomputed from
    below."""
    try:
        leaf_map = {int(g): bytes(n) for g, n in dict(leaves).items()}
        helper_list = [(int(g), bytes(n)) for g, n in helpers]
        want = bytes(root)
    except (TypeError, ValueError):
        return False
    if not leaf_map or any(g < 1 for g in leaf_map):
        return False
    on_path = set()
    for g in leaf_map:
        while g >= 1:
            on_path.add(g)
            g >>= 1
    nodes: Dict[int, bytes] = dict(leaf_map)
    for g, node in helper_list:
        if g in nodes or g in on_path or (g ^ 1) not in on_path:
            return False
        nodes[g] = node
    # descending gindex order: children always exceed their parent, so
    # both child values are final before the parent folds
    for parent in sorted({g >> 1 for g in on_path if g > 1}, reverse=True):
        left = nodes.get(2 * parent)
        right = nodes.get(2 * parent + 1)
        if left is None or right is None:
            return False
        node = digest(left + right)
        if parent in leaf_map and nodes[parent] != node:
            return False  # a claimed leaf that is another leaf's ancestor
        nodes[parent] = node
    return nodes.get(1) == want
