"""Incremental BeaconState merkleization, a copy of
`lodestar_tpu/state_transition/state_root.py` on the port's merkle tree
and device backend (ssz/merkle_tree.py, ssz/device_backend.py).

  - the big per-validator fields (`validators`, `balances`,
    `inactivity_scores`, both participation arrays) and the big root
    vectors (`block_roots`, `state_roots`, `randao_mixes`, `slashings`)
    each own a `ChunkTree` whose leaf planes are packed straight from the
    state's numpy columns;
  - dirty tracking is conservative: a chunk re-hashes iff its packed bytes
    differ from the plane the tree last hashed, so an untracked mutation
    can cost extra hashing but never a stale root;
  - every other field memoizes (serialized bytes -> root) through the
    field types of the state's fork container (`state._container()`:
    the port's `BeaconState` gives the port's own SSZ types);
  - `clone()` shares the whole engine copy-on-write.

On the card a cold root is one `validator_roots` launch over the
registry, `hash_pairs` for the pubkey roots and every tree level of at
least `min_level_rows` pairs, and a slot's update of at most 512 dirty
chunks per field one `forest_sweep` launch per field.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..ssz import ChunkTree, hash_pairs_plane
from ..ssz.core import _mix_in_length

# the registry's list limit, the same in the mainnet and minimal presets
# (lodestar_tpu/params)
VALIDATOR_REGISTRY_LIMIT = 2**40
_U8 = np.uint8


def _htr_device():
    """The process merkleization backend (None: the host path)."""
    from ..ssz import device_backend

    return device_backend.maybe_backend()

# numeric validator-record columns in Validator-container chunk order
_VAL_COLS = (
    ("effective_balance", 2),
    ("activation_eligibility_epoch", 4),
    ("activation_epoch", 5),
    ("exit_epoch", 6),
    ("withdrawable_epoch", 7),
)


def _pack_u64(arr: np.ndarray) -> np.ndarray:
    """uint64 column -> (nchunks, 32) little-endian leaf plane (copy)."""
    n = arr.shape[0]
    out = np.zeros(((n + 3) // 4, 32), _U8)
    if n:
        raw = np.ascontiguousarray(arr, dtype="<u8").view(_U8)
        out.reshape(-1)[: raw.size] = raw
    return out


def _pack_u8(arr: np.ndarray) -> np.ndarray:
    """uint8 column -> (nchunks, 32) leaf plane (copy)."""
    n = arr.shape[0]
    out = np.zeros(((n + 31) // 32, 32), _U8)
    if n:
        out.reshape(-1)[:n] = np.ascontiguousarray(arr, dtype=_U8)
    return out


def _pack_roots(values) -> np.ndarray:
    """List of 32-byte values -> (n, 32) leaf plane."""
    if not values:
        return np.zeros((0, 32), _U8)
    return np.frombuffer(b"".join(values), _U8).reshape(-1, 32)


class _PackedCell:
    """ChunkTree over a packable field; `mixin` adds the list length."""

    def __init__(self, limit_chunks: int, mixin: bool):
        self.tree = ChunkTree(limit_chunks)
        self.mixin = mixin
        # element count as of the last root() — the mixin length a
        # plane-read proof must append (proofs/plane_reader.py)
        self.length = 0

    def root(self, plane: np.ndarray, length: int) -> bytes:
        self.tree.update(plane)
        self.length = length
        r = self.tree.root
        return _mix_in_length(r, length) if self.mixin else r

    def clone(self) -> "_PackedCell":
        out = _PackedCell.__new__(_PackedCell)
        out.tree = self.tree.clone()
        out.mixin = self.mixin
        out.length = self.length
        return out

    def plane_bytes(self, seen: set) -> int:
        return self.tree.plane_bytes(seen)

    def planes(self):
        return self.tree.planes()


class _ValidatorsCell:
    """Per-validator container roots, batch-hashed for dirty rows only.

    A validator's root is a fixed 8-chunk tree:
      [pubkey_root, withdrawal_credentials, effective_balance, slashed,
       activation_eligibility_epoch, activation_epoch, exit_epoch,
       withdrawable_epoch]
    Dirty rows come from vectorized column diffs (numpy columns) plus
    list comparison for the two byte-string columns; pubkey roots are
    cached separately (pubkeys are immutable once registered, so that
    plane only ever grows).
    """

    def __init__(self):
        self.tree = ChunkTree(VALIDATOR_REGISTRY_LIMIT)
        self.count = 0
        self.cols: Optional[Dict[str, np.ndarray]] = None
        self.pubkeys: List[bytes] = []
        self.creds: List[bytes] = []
        self.pk_roots = np.zeros((0, 32), _U8)
        self._shared = False

    def clone(self) -> "_ValidatorsCell":
        out = _ValidatorsCell.__new__(_ValidatorsCell)
        out.tree = self.tree.clone()
        out.count = self.count
        out.cols = self.cols
        out.pubkeys = self.pubkeys
        out.creds = self.creds
        out.pk_roots = self.pk_roots
        out._shared = True
        self._shared = True
        return out

    def _own(self) -> None:
        if self._shared:
            if self.cols is not None:
                self.cols = {k: v.copy() for k, v in self.cols.items()}
            self.pubkeys = list(self.pubkeys)
            self.creds = list(self.creds)
            self.pk_roots = self.pk_roots.copy()
            self._shared = False

    def plane_bytes(self, seen: set) -> int:
        """Tree node planes + the cached pubkey-root plane + the
        per-validator diff columns (all COW-shared across clones until
        the first owning mutation; the columns are a second full copy
        of the registry's numeric columns, same magnitude as the state's
        own — an owned engine that omitted them would under-count by
        ~7x8n bytes).  The pubkeys/creds pointer lists stay uncounted:
        their elements are shared bytes objects and the list copies are
        pointer-sized."""
        total = self.tree.plane_bytes(seen)
        for arr in self._aux_planes():
            if id(arr) not in seen:
                seen.add(id(arr))
                total += arr.nbytes
        return total

    def _aux_planes(self):
        out = [self.pk_roots]
        if self.cols is not None:
            out.extend(self.cols.values())
        return out

    def planes(self):
        return self.tree.planes() + self._aux_planes()

    @staticmethod
    def _list_mismatches(cached: List[bytes], current: List[bytes], m: int):
        """Indices in [0, m) where the byte-string columns differ.
        Fast path: one C-level list compare when nothing changed."""
        a = cached[:m]
        b = current[:m]
        if a == b:
            return ()
        return [i for i in range(m) if a[i] != b[i]]

    def root(self, state) -> bytes:
        n = len(state.pubkeys)
        cold = self.cols is None or n < self.count
        old_n = 0 if cold else self.count
        m = min(n, old_n)

        if cold:
            dirty = np.arange(n, dtype=np.intp)
            pk_dirty = dirty
        else:
            mask = np.zeros(m, bool)
            for name, _chunk in _VAL_COLS:
                cur = getattr(state, name)
                mask |= self.cols[name][:m] != cur[:m]
            mask |= self.cols["slashed"][:m] != state.slashed[:m]
            cred_mis = self._list_mismatches(
                self.creds, state.withdrawal_credentials, m
            )
            if cred_mis:
                mask[cred_mis] = True
            pk_mis = self._list_mismatches(self.pubkeys, state.pubkeys, m)
            if pk_mis:
                mask[pk_mis] = True
            dirty = np.nonzero(mask)[0].astype(np.intp)
            if n > old_n:
                dirty = np.concatenate(
                    [dirty, np.arange(old_n, n, dtype=np.intp)]
                )
            pk_dirty = (
                np.concatenate(
                    [
                        np.asarray(pk_mis, dtype=np.intp),
                        np.arange(old_n, n, dtype=np.intp),
                    ]
                )
                if (pk_mis or n > old_n)
                else np.zeros(0, np.intp)
            )

        if not (cold or dirty.size or pk_dirty.size):
            return _mix_in_length(self.tree.root, n)

        self._own()

        # pubkey roots: H(pk[0:32] || pk[32:48] + 16 zero bytes)
        if self.pk_roots.shape[0] < n:
            grown = np.zeros((max(n, self.pk_roots.shape[0] * 2, 8), 32), _U8)
            grown[: self.pk_roots.shape[0]] = self.pk_roots
            self.pk_roots = grown
        if pk_dirty.size:
            pk_plane = np.zeros((pk_dirty.size, 64), _U8)
            pk_plane[:, :48] = np.frombuffer(
                b"".join(state.pubkeys[int(i)] for i in pk_dirty), _U8
            ).reshape(-1, 48)
            self.pk_roots[pk_dirty] = hash_pairs_plane(pk_plane)

        if dirty.size:
            d = dirty.size
            cred_rows = np.frombuffer(
                b"".join(state.withdrawal_credentials[int(i)] for i in dirty),
                _U8,
            ).reshape(-1, 32)
            vroots = None
            backend = _htr_device()
            if backend is not None:
                # leaf packing + the fixed 8-chunk subtree in one launch
                # (kernels/sha256.py validator_roots); any fault degrades
                # to the host packing below, bit-identical
                vroots = backend.validator_roots(
                    self.pk_roots[dirty],
                    cred_rows,
                    [
                        np.ascontiguousarray(getattr(state, name)[dirty])
                        for name, _chunk in _VAL_COLS
                    ],
                    state.slashed[dirty],
                )
            if vroots is None:
                blk = np.zeros((d, 8, 32), _U8)
                blk[:, 0] = self.pk_roots[dirty]
                blk[:, 1] = cred_rows
                for name, chunk in _VAL_COLS:
                    blk[:, chunk, :8] = (
                        np.ascontiguousarray(
                            getattr(state, name)[dirty], "<u8"
                        )
                        .view(_U8)
                        .reshape(-1, 8)
                    )
                blk[:, 3, 0] = state.slashed[dirty].astype(_U8)
                # three batched levels: 8 chunks -> 4 -> 2 -> 1 root per row
                lvl = hash_pairs_plane(blk.reshape(d * 4, 64))
                lvl = hash_pairs_plane(lvl.reshape(d * 2, 64))
                vroots = hash_pairs_plane(lvl.reshape(d, 64))
            if cold:
                self.tree.reset(vroots)
            else:
                self.tree.apply(dirty, vroots, n)
        elif cold:
            # shrink-to-empty: the tree must forget stale leaves
            self.tree.reset(np.zeros((0, 32), _U8))

        # sync the caches to what the tree now reflects
        if self.cols is None:
            self.cols = {}
        for name in [c for c, _ in _VAL_COLS] + ["slashed"]:
            cur = getattr(state, name)
            cached = self.cols.get(name)
            if cached is None or cached.shape[0] != n:
                fresh = np.empty(n, cur.dtype)
                if cached is not None and m:
                    fresh[:m] = cached[:m]
                self.cols[name] = cached = fresh
            cached[dirty] = cur[dirty]
        self.pubkeys = list(state.pubkeys)
        self.creds = list(state.withdrawal_credentials)
        self.count = n

        return _mix_in_length(self.tree.root, n)


class StateRootEngine:
    """Per-field root cache composed through the fork's container."""

    def __init__(self):
        self.validators = _ValidatorsCell()
        self.cells: Dict[str, _PackedCell] = {}
        # fname -> (serialized bytes, root) for every non-columnar field
        self.memo: Dict[str, tuple] = {}
        # top-level tree over the per-field root chunks — the root-most
        # planes the proof-serving plane reads field branches from
        self.top: Optional[ChunkTree] = None

    def clone(self) -> "StateRootEngine":
        out = StateRootEngine.__new__(StateRootEngine)
        out.validators = self.validators.clone()
        out.cells = {k: v.clone() for k, v in self.cells.items()}
        out.memo = dict(self.memo)
        out.top = self.top.clone() if self.top is not None else None
        return out

    # -- mutation-surface hints (performance only, never correctness) ------

    def note_participation_rotation(self) -> None:
        """Epoch transition rotates current -> previous participation;
        swapping the cached trees keeps the rotated field's diff clean.
        A wrong or missing hint only costs extra hashing: the diff
        against whichever plane is cached still finds every change."""
        a = self.cells.pop("previous_epoch_participation", None)
        b = self.cells.pop("current_epoch_participation", None)
        if b is not None:
            self.cells["previous_epoch_participation"] = b
        if a is not None:
            self.cells["current_epoch_participation"] = a

    # -- per-field roots ---------------------------------------------------

    def _cell(self, fname: str, limit_chunks: int, mixin: bool) -> _PackedCell:
        cell = self.cells.get(fname)
        if cell is None:
            cell = self.cells[fname] = _PackedCell(limit_chunks, mixin)
        return cell

    def _field_root(self, state, fname: str, ftype) -> bytes:
        reg = VALIDATOR_REGISTRY_LIMIT
        if fname == "validators":
            return self.validators.root(state)
        if fname in ("balances", "inactivity_scores"):
            arr = getattr(state, fname)
            cell = self._cell(fname, (reg * 8 + 31) // 32, mixin=True)
            return cell.root(_pack_u64(arr), arr.shape[0])
        if fname in (
            "previous_epoch_participation",
            "current_epoch_participation",
        ):
            arr = getattr(state, fname)
            cell = self._cell(fname, (reg + 31) // 32, mixin=True)
            return cell.root(_pack_u8(arr), arr.shape[0])
        if fname in ("block_roots", "state_roots", "randao_mixes"):
            values = getattr(state, fname)
            cell = self._cell(fname, len(values), mixin=False)
            return cell.root(_pack_roots(values), len(values))
        if fname == "slashings":
            arr = state.slashings
            cell = self._cell(fname, (arr.shape[0] * 8 + 31) // 32, mixin=False)
            return cell.root(_pack_u64(arr), arr.shape[0])
        # serialize-memo: byte-equal serialization proves the cached
        # root is current (serialization is memcpy; hashing is not)
        value = getattr(state, fname)
        ser = ftype.serialize(value)
        hit = self.memo.get(fname)
        if hit is not None and hit[0] == ser:
            return hit[1]
        root = ftype.hash_tree_root(value)
        self.memo[fname] = (ser, root)
        return root

    def hash_tree_root(self, state) -> bytes:
        container = state._container()
        chunks = [
            self._field_root(state, fname, ftype)
            for fname, ftype in container.fields
        ]
        # ChunkTree(n) pads to the same next-pow2 leaf count
        # merkleize_chunks(chunks) does, so the root is bit-identical —
        # but the internal planes stay resident for O(log n) field
        # branches (proofs/plane_reader.py)
        top = self.top
        if top is None or top.limit_chunks != len(chunks):
            top = self.top = ChunkTree(len(chunks))
        top.update(np.frombuffer(b"".join(chunks), _U8).reshape(-1, 32))
        return top.root

    def leaf_cell(self, fname: str):
        """(tree, length, mixin) for a ChunkTree-backed field as of the
        last hash_tree_root(), or None for memo-backed fields."""
        if fname == "validators":
            v = self.validators
            return (v.tree, v.count, True)
        cell = self.cells.get(fname)
        if cell is None:
            return None
        return (cell.tree, cell.length, cell.mixin)

    def engine_bytes(self, seen: Optional[set] = None) -> int:
        """Live ChunkTree plane bytes held by this engine.  Thread one
        `seen` set across engines to count COW-shared planes once."""
        if seen is None:
            seen = set()
        total = self.validators.plane_bytes(seen)
        for cell in self.cells.values():
            total += cell.plane_bytes(seen)
        if self.top is not None:
            total += self.top.plane_bytes(seen)
        return total

    def iter_planes(self):
        """Every live node-plane array this engine holds (the exact set
        plane_bytes() walks, in the same id() identity space) — the
        residency ledger's per-state enumeration.  O(fields x levels)
        attribute reads, no hashing."""
        yield from self.validators.planes()
        for cell in self.cells.values():
            yield from cell.planes()
        if self.top is not None:
            yield from self.top.planes()

    def release_planes(self) -> int:
        """Tier-1 demotion (the JAX package's chain/memory_governor.py):
        free every ChunkTree node plane, the pubkey-root plane, the
        validators diff columns, and the serialize memos.  Returns the
        plane bytes freed.  The next hash_tree_root() through this engine
        rebuilds cold: one full merkleization, bit-identical (incremental
        equals full)."""
        freed = self.engine_bytes()
        self.validators = _ValidatorsCell()
        self.cells = {}
        self.memo = {}
        self.top = None
        return freed


def state_root_engine_bytes(states) -> int:
    """Aggregate live engine plane bytes across `states` (e.g. the regen
    state-cache LRU + checkpoint cache): COW-shared planes — the normal
    case right after clone() — are counted ONCE, so the number tracks
    real residency, not per-state virtual size.  The first step toward
    bounding warm-engine memory (ROADMAP)."""
    seen: set = set()
    total = 0
    for st in states:
        engine = getattr(st, "_root_engine", None)
        if engine is not None:
            total += engine.engine_bytes(seen)
    return total
