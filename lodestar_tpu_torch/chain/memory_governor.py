"""StateMemoryGovernor — byte-budgeted residency for the state plane.

The port's copy of `lodestar_tpu/chain/memory_governor.py`; it imports nothing of the
JAX package.

The verification data plane has a fault domain (the breaker); this module
is the state plane's equivalent bound.  The warm incremental-merkleization
planes held by the regen LRU + checkpoint cache (the
``lodestar_state_root_engine_bytes`` gauge) grow without limit at the
ROADMAP's million-validator target — a fork-churn burst turns into
allocator death instead of graceful degradation.  The ACE-runtime paper
(arXiv:2603.10242) makes the same point for its state engine: sub-second
finality survives only if hot-state residency is explicitly budgeted,
with cold state demoted to cheap re-derivable forms.

Three pieces:

  - **ResidencyLedger** — a COW-aware byte ledger over the engines'
    node planes, updated INCREMENTALLY at add/evict/clone time (plane
    arrays refcounted by id(), shared planes counted once) instead of
    the old O(live-states) ``engine_bytes()`` walk per head update.
    The walk survives as the reconciliation oracle
    (tests/test_memory_governor.py: ledger == walk after randomized
    add/evict/clone sequences).
  - **The demotion ladder** — when residency exceeds the budget, cold
    unpinned entries demote in two steps: tier "demote" drops a state's
    live object (ChunkTree planes + columns) but keeps its serialized
    SSZ bytes in the cache slot (a ``SpilledState`` marker; a later
    touch deserializes lazily and the engine rebuilds cold,
    bit-identical roots by the incremental==full equivalence);
    tier "evict" drops entries outright (spilled bytes first, then
    cold live states) and lets ``StateRegenerator`` replay from db.
    Demotion is ECONOMIC: it only runs when the planes an entry holds
    alone exceed the serialized bytes it would add — consecutive chain
    states share most planes COW and would GROW residency if spilled,
    while replayed/rehydrated states (cold engines, fully owned
    planes) free ~3x their spill size.  A PINNED set — head state,
    justified + finalized
    checkpoint states, the regen anchor chain's terminus (so
    ``NO_ANCHOR_STATE`` is structurally impossible), and the next-slot
    proposal state — is never touched, even at a budget of ~0.
  - **The degradation ladder** — when eviction waves cannot reach the
    budget (irreducible working set), pressure escalates instead of
    thrashing: rung 1 shrinks the checkpoint-cache epoch window, rung 2
    skips the ``prepare_next_slot`` precompute, rung 3 rejects
    deep-fork regen beyond a replay-depth bound with a typed
    ``RegenError("MEMORY_PRESSURE")``.

A pressure EPISODE opens when an add first crosses the budget and
closes at the first slot tick that observes residency at-or-under
budget with no evictions since the previous tick.  While an episode is
open the SLO engine reports ``degraded`` (node.py registers
``pressure_active`` as a degraded source) and exactly one rate-limited
flight bundle is requested at episode start (``on_pressure`` ->
``slo.anomaly("state_memory_pressure")``).

Default-on with a generous budget; ``LODESTAR_TPU_STATE_BUDGET=0``
is the escape hatch (no governor: the PR-era count-based LRU bounds
apply unchanged).  A positive value is the budget in bytes (``k``/
``m``/``g`` suffixes accepted).
"""

from __future__ import annotations

import os
import threading
import weakref
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Tuple

from .. import params
from ..utils.logger import get_logger
from ..utils.metrics import Registry, global_registry

P = params.ACTIVE_PRESET

# Generous default: roughly two orders of magnitude above the measured
# devnet working set, small enough that a million-validator fork-churn
# burst degrades instead of OOMing.
DEFAULT_BUDGET_BYTES = 2 << 30

# rung-3 bound: a regen that would replay deeper than this under
# sustained pressure is rejected (MEMORY_PRESSURE) instead of paying an
# unbounded replay whose intermediate states re-trigger eviction
DEFAULT_REPLAY_DEPTH_BOUND = 2 * P.SLOTS_PER_EPOCH


def budget_from_env() -> Optional[int]:
    """The configured budget in bytes, or None when the governor is
    disabled (``LODESTAR_TPU_STATE_BUDGET=0`` or unparseable <= 0)."""
    raw = os.environ.get("LODESTAR_TPU_STATE_BUDGET")
    if raw is None or raw.strip() == "":
        return DEFAULT_BUDGET_BYTES
    original = raw
    raw = raw.strip().lower()
    mult = 1
    if raw and raw[-1] in ("k", "m", "g"):
        mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}[raw[-1]]
        raw = raw[:-1]
    try:
        value = int(raw) * mult
    except ValueError:
        # fail SAFE (the generous default) but never silently: the
        # operator believes they configured a budget
        get_logger("chain/memory_governor").warn(
            "LODESTAR_TPU_STATE_BUDGET unparseable; using the default",
            value=original,
            default_bytes=DEFAULT_BUDGET_BYTES,
        )
        return DEFAULT_BUDGET_BYTES
    return value if value > 0 else None


class SpilledState:
    """Cache-slot marker for a tier-1-demoted state: the serialized SSZ
    bytes stand in for the live object until the next touch."""

    __slots__ = ("data", "root_hex")

    def __init__(self, data: bytes, root_hex: str):
        self.data = data
        self.root_hex = root_hex

    def __len__(self) -> int:
        return len(self.data)


def state_column_bytes(state) -> int:
    """The per-state COLUMNAR payload: the numpy arrays clone() copies
    for every state (balances, participation, epochs, slashings...).
    Unlike the engine planes these are NOT COW-shared between clones,
    so a state whose planes are fully shared still holds this much on
    its own — the budget must see it or a churn burst of plane-sharing
    clones blows past the budget uncounted."""
    total = 0
    for name in (
        "balances",
        "effective_balance",
        "slashed",
        "activation_eligibility_epoch",
        "activation_epoch",
        "exit_epoch",
        "withdrawable_epoch",
        "inactivity_scores",
        "previous_epoch_participation",
        "current_epoch_participation",
        "slashings",
    ):
        arr = getattr(state, name, None)
        if arr is not None and hasattr(arr, "nbytes"):
            total += arr.nbytes
    # list-of-bytes columns: the element bytes are shared across
    # clones, the pointer arrays are not (8 bytes per slot)
    for name in (
        "block_roots",
        "state_roots",
        "randao_mixes",
        "pubkeys",
        "withdrawal_credentials",
    ):
        values = getattr(state, name, None)
        if values is not None:
            total += 8 * len(values)
    return total


class _LiveEntry:
    __slots__ = ("pids", "engine_ref", "state_id")

    def __init__(self, pids, engine_ref, state_id):
        self.pids = pids
        self.engine_ref = engine_ref  # weakref to the engine, or None
        self.state_id = state_id


class ResidencyLedger:
    """Incremental COW-aware byte ledger over cache entries.

    ``plane_bytes`` tracks the engines' node-plane bytes with shared
    planes counted ONCE (each plane array refcounted by id(); the entry
    snapshot holds a reference so a counted id can never be recycled by
    the allocator while counted — it exactly equals the
    ``engine_bytes()`` walk).  ``column_bytes`` tracks the per-state
    columnar arrays, refcounted by state-object identity so an entry
    aliased in both caches counts once.  ``spill_bytes`` tracks
    serialized SSZ bytes of demoted entries.  Updates are O(one
    state's planes) per add/drop — never a walk over every live
    state."""

    def __init__(self):
        # id(plane) -> [nbytes, refcount, plane-ref]
        self._plane_rc: Dict[int, list] = {}
        # id(state) -> [column nbytes, refcount, state-ref]
        self._obj_rc: Dict[int, list] = {}
        # key -> _LiveEntry | ("spill", nbytes)
        self._entries: Dict[tuple, object] = {}
        self.plane_bytes = 0
        self.column_bytes = 0
        self.spill_bytes = 0

    @property
    def resident_bytes(self) -> int:
        return self.plane_bytes + self.column_bytes + self.spill_bytes

    def __len__(self) -> int:
        return len(self._entries)

    def add_live(self, key: tuple, state) -> None:
        self.drop(key)
        pids: List[int] = []
        seen_here = set()
        engine = getattr(state, "_root_engine", None)
        if engine is not None:
            for plane in engine.iter_planes():
                pid = id(plane)
                if pid in seen_here:
                    continue
                seen_here.add(pid)
                rc = self._plane_rc.get(pid)
                if rc is None:
                    self._plane_rc[pid] = [plane.nbytes, 1, plane]
                    self.plane_bytes += plane.nbytes
                else:
                    rc[1] += 1
                pids.append(pid)
        sid = id(state)
        orc = self._obj_rc.get(sid)
        if orc is None:
            try:
                cols = state_column_bytes(state)
            except Exception:  # noqa: BLE001 — test doubles without
                cols = 0  # columns still ledger (planes only)
            self._obj_rc[sid] = [cols, 1, state]
            self.column_bytes += cols
        else:
            orc[1] += 1
        self._entries[key] = _LiveEntry(
            pids,
            weakref.ref(engine) if engine is not None else None,
            sid,
        )

    def add_spill(self, key: tuple, nbytes: int) -> None:
        self.drop(key)
        self._entries[key] = ("spill", int(nbytes))
        self.spill_bytes += int(nbytes)

    def drop(self, key: tuple) -> None:
        entry = self._entries.pop(key, None)
        if entry is None:
            return
        if isinstance(entry, _LiveEntry):
            for pid in entry.pids:
                rc = self._plane_rc[pid]
                rc[1] -= 1
                if rc[1] == 0:
                    self.plane_bytes -= rc[0]
                    del self._plane_rc[pid]
            orc = self._obj_rc[entry.state_id]
            orc[1] -= 1
            if orc[1] == 0:
                self.column_bytes -= orc[0]
                del self._obj_rc[entry.state_id]
        else:
            self.spill_bytes -= entry[1]

    def engine_current(self, key: tuple, engine) -> bool:
        """Whether `key`'s snapshot was taken against exactly `engine`
        — via a WEAK reference, so a freed engine whose id() the
        allocator recycled can never masquerade as current."""
        entry = self._entries.get(key)
        if not isinstance(entry, _LiveEntry):
            return False
        if engine is None:
            return entry.engine_ref is None
        return (
            entry.engine_ref is not None
            and entry.engine_ref() is engine
        )

    def unique_bytes(self, key: tuple) -> int:
        """Bytes held by `key` ALONE — planes at refcount 1 plus the
        state's unshared columns: what a demotion of this entry would
        actually free.  Consecutive chain states share most planes
        COW; their columns never are."""
        entry = self._entries.get(key)
        if not isinstance(entry, _LiveEntry):
            return 0
        total = 0
        for pid in entry.pids:
            rc = self._plane_rc.get(pid)
            if rc is not None and rc[1] == 1:
                total += rc[0]
        orc = self._obj_rc.get(entry.state_id)
        if orc is not None and orc[1] == 1:
            total += orc[0]
        return total

    def entry_bytes(self, keys, seen: Optional[set] = None) -> int:
        """Bytes attributable to `keys`, shared planes/objects counted
        once within the group (the pinned-bytes gauge)."""
        seen = set() if seen is None else seen
        seen_objs: set = set()
        total = 0
        for key in keys:
            entry = self._entries.get(key)
            if entry is None:
                continue
            if not isinstance(entry, _LiveEntry):
                total += entry[1]
                continue
            for pid in entry.pids:
                if pid in seen:
                    continue
                seen.add(pid)
                rc = self._plane_rc.get(pid)
                if rc is not None:
                    total += rc[0]
            if entry.state_id not in seen_objs:
                seen_objs.add(entry.state_id)
                orc = self._obj_rc.get(entry.state_id)
                if orc is not None:
                    total += orc[0]
        return total


# process-wide weak registry so bench.py can snapshot aggregate
# governor state without holding references (the breaker_snapshot
# pattern, bls/supervisor.py)
_GOVERNORS: "weakref.WeakSet" = weakref.WeakSet()


def memory_snapshot() -> dict:
    """Aggregate governor state across live instances — the ``memory``
    field bench.py attaches to every record."""
    out = {
        "governors": 0,
        "budget_bytes": None,
        "resident_bytes": 0,
        "plane_bytes": 0,
        "column_bytes": 0,
        "spill_bytes": 0,
        "aux_bytes": 0,
        "evictions": {"demote": 0, "evict": 0, "drain": 0},
        "pressure_events": 0,
        "pressure_active": False,
    }
    for gov in list(_GOVERNORS):
        st = gov.status()
        out["governors"] += 1
        if st["budget_bytes"] is not None:
            out["budget_bytes"] = (out["budget_bytes"] or 0) + st[
                "budget_bytes"
            ]
        out["resident_bytes"] += st["resident_bytes"]
        out["plane_bytes"] += st["plane_bytes"]
        out["column_bytes"] += st["column_bytes"]
        out["spill_bytes"] += st["spill_bytes"]
        out["aux_bytes"] += st.get("aux_bytes", 0)
        for tier in ("demote", "evict", "drain"):
            out["evictions"][tier] += st["evictions"].get(tier, 0)
        out["pressure_events"] += st["pressure_events"]
        out["pressure_active"] |= st["pressure_active"]
    # the device merkleization plane (ssz/device_backend.py): transient
    # dispatch working-set bytes, so the memory story covers the HTR
    # offload path too (inactive/zeroed when the backend is off); the
    # port always has its backend module, so a failure here raises
    from ..ssz.device_backend import device_memory_snapshot

    out["htr_device"] = device_memory_snapshot()
    return out


class StateMemoryGovernor:
    """Byte-budgeted residency governor over StateContextCache +
    CheckpointStateCache (see module docstring).

    ``pinned_fn`` (installed by BeaconChain) returns
    ``(state_roots, cp_pinned)`` — a set of state-root hexes that must
    stay resident and a predicate ``cp_pinned(epoch, root_hex)`` over
    checkpoint keys.  If the provider raises, the wave pins EVERYTHING
    (fail closed: a broken pin provider must not let the anchor chain
    evict)."""

    def __init__(
        self,
        budget_bytes: Optional[int],
        config=None,
        registry: Optional[Registry] = None,
        replay_depth_bound: int = DEFAULT_REPLAY_DEPTH_BOUND,
    ):
        self.budget = budget_bytes
        self.config = config  # ChainConfig, needed to rehydrate spills
        self.replay_depth_bound = int(replay_depth_bound)
        self.ledger = ResidencyLedger()
        self.log = get_logger("chain/memory_governor")
        self.pinned_fn: Optional[Callable[[], tuple]] = None
        self.on_pressure: Optional[Callable[[dict], None]] = None
        self.state_cache = None
        self.checkpoint_cache = None
        self._lock = threading.RLock()
        # spilled payload sizes live in the cache slots themselves
        # (SpilledState); the governor tracks episode/ladder state
        self._episode_active = False
        self._pressure_events = 0
        self._strain = 0  # consecutive waves that ended over budget
        self._evictions_since_tick = 0
        self._base_cp_epochs: Optional[int] = None
        self.evictions = {"demote": 0, "evict": 0, "drain": 0}
        # aux drainables (proof-bundle caches): byte-accounted into the
        # budget and emptied FIRST under squeeze — bundles rebuild for
        # one request each, live states cost a replay
        self._aux: Dict[str, object] = {}
        # residency leases: (kind, ...) ledger keys the eviction waves
        # must skip while a plane read is mid-extraction
        self._leases: Dict[tuple, int] = {}

        r = registry or global_registry()
        self.m_budget = r.gauge(
            "lodestar_state_budget_bytes",
            "Configured state-plane residency budget",
        )
        self.m_resident = r.gauge(
            "lodestar_state_resident_bytes",
            "Ledger-tracked state residency (engine planes + spills)",
        )
        self.m_pinned = r.gauge(
            "lodestar_state_budget_pinned_bytes",
            "Residency attributable to the pinned (never-evicted) set",
        )
        self.m_evictions = r.labeled_counter(
            "lodestar_state_budget_evictions_total",
            "Governor demotions/evictions by ladder tier",
            "tier",
        )
        self.m_pressure = r.counter(
            "lodestar_state_budget_pressure_events_total",
            "Memory-pressure episodes opened",
        )
        if self.budget is not None:
            self.m_budget.set(float(self.budget))
        _GOVERNORS.add(self)

    # -- cache attachment ---------------------------------------------------

    def attach(self, state_cache, checkpoint_cache) -> None:
        self.state_cache = state_cache
        self.checkpoint_cache = checkpoint_cache
        self._base_cp_epochs = checkpoint_cache.max_epochs

    # -- aux drainables (proofs/bundle_cache.py) -----------------------------

    def register_aux(self, name: str, cache) -> None:
        """Register a drainable cache: must expose ``resident_bytes()``
        and ``drain(target_bytes) -> freed_bytes``.  Its bytes count
        against the budget, and under squeeze it drains BEFORE any live
        state demotes."""
        with self._lock:
            self._aux[name] = cache
        self.enforce()

    def unregister_aux(self, name: str) -> None:
        with self._lock:
            self._aux.pop(name, None)

    @staticmethod
    def _aux_bytes_one(cache) -> int:
        try:
            return int(cache.resident_bytes())
        except Exception:  # noqa: BLE001 — a broken aux cache counts
            # zero rather than wedging enforcement
            return 0

    def _aux_bytes(self) -> int:
        return sum(self._aux_bytes_one(c) for c in self._aux.values())

    # -- residency leases ----------------------------------------------------

    @contextmanager
    def lease(self, *keys):
        """Hold the given ledger keys (e.g. ``("state", root_hex)``)
        out of eviction candidacy for the duration — a proof read
        mid-extraction must not race its state's demotion.  Reentrant
        and thread-safe; a lease guards candidacy only (its bytes still
        count against the budget)."""
        norm = [tuple(k) for k in keys]
        with self._lock:
            for k in norm:
                self._leases[k] = self._leases.get(k, 0) + 1
        try:
            yield
        finally:
            with self._lock:
                for k in norm:
                    n = self._leases.get(k, 0) - 1
                    if n <= 0:
                        self._leases.pop(k, None)
                    else:
                        self._leases[k] = n

    # -- cache hooks (called by state_cache.py under normal operation) ------

    def on_state_add(self, root_hex: str, state) -> None:
        with self._lock:
            self.ledger.add_live(("state", root_hex), state)
        self.enforce()

    def on_state_drop(self, root_hex: str, _entry=None) -> None:
        with self._lock:
            self.ledger.drop(("state", root_hex))

    def on_state_get(self, root_hex: str, entry):
        """Touch: rehydrate a spilled entry back to a live state (the
        lazy half of tier-1 demotion).  Returns the live state.  The
        rehydration books new ledger bytes, so the budget enforces
        HERE too — a read-heavy burst over spilled entries must not
        overshoot the budget until the next import or slot tick."""
        if not isinstance(entry, SpilledState):
            return entry
        with self._lock:
            state = self._rehydrate(entry)
            self.state_cache._map[root_hex] = state
            self.ledger.add_live(("state", root_hex), state)
        self.enforce()
        return state

    def on_checkpoint_add(self, key: Tuple[int, str], state) -> None:
        with self._lock:
            self.ledger.add_live(("cp",) + tuple(key), state)
        self.enforce()

    def on_checkpoint_drop(self, key: Tuple[int, str], _entry=None) -> None:
        with self._lock:
            self.ledger.drop(("cp",) + tuple(key))

    def on_checkpoint_get(self, key: Tuple[int, str], entry):
        if not isinstance(entry, SpilledState):
            return entry
        with self._lock:
            state = self._rehydrate(entry)
            self.checkpoint_cache._map[tuple(key)] = state
            self.ledger.add_live(("cp",) + tuple(key), state)
        self.enforce()
        return state

    def checkpoint_pin_predicate(self) -> Callable[[int, str], bool]:
        """One resolved pin predicate for the checkpoint cache's own
        count-based prune paths (epoch-window eviction must not bypass
        the pinned-set guarantee) — fetched ONCE per prune sweep, not
        per entry.  Fails CLOSED like the eviction waves."""
        pins, cp_pinned = self._pins()
        if pins is None:
            return lambda _e, _r: True
        return lambda e, r: cp_pinned(int(e), r)

    def _rehydrate(self, spilled: SpilledState):
        from ..state_transition.state import BeaconState

        if self.config is None:
            raise RuntimeError(
                "governor holds a spilled state but no ChainConfig to "
                "rehydrate it"
            )
        return BeaconState.deserialize(spilled.data, self.config)

    # -- the eviction waves -------------------------------------------------

    def _pins(self) -> Tuple[set, Callable[[int, str], bool]]:
        if self.pinned_fn is None:
            return set(), lambda _e, _r: False
        try:
            return self.pinned_fn()
        except Exception as e:  # noqa: BLE001 — fail CLOSED: a broken
            # pin provider pins everything rather than risk the anchor
            self.log.warn("pin provider failed; pinning all", error=str(e))
            return None, None

    def enforce(self) -> Optional[dict]:
        """One eviction wave: demote cold entries, then evict spills,
        until residency is at-or-under budget or only pinned/irreducible
        entries remain.  Returns wave stats (None = nothing to do)."""
        fire_pressure = None
        with self._lock:
            if self.budget is None:
                return None
            if self.ledger.resident_bytes + self._aux_bytes() <= self.budget:
                self._strain = 0
                return None
            if not self._episode_active:
                self._episode_active = True
                self._pressure_events += 1
                self.m_pressure.inc()
                fire_pressure = {
                    "resident_bytes": self.ledger.resident_bytes,
                    "budget_bytes": self.budget,
                    "episode": self._pressure_events,
                }
            stats = {"demote": 0, "evict": 0, "drain": 0}
            # aux drainables empty FIRST: after this pass either the
            # whole budget overage was absorbed by the caches, or they
            # are empty and the waves below run on ledger bytes alone
            self._drain_aux(stats)
            pinned_roots, cp_pinned = self._pins()
            if (
                pinned_roots is not None
                and self.state_cache is not None
                and self.ledger.resident_bytes > self.budget
            ):
                self._demote_wave(pinned_roots, cp_pinned, stats)
                if self.ledger.resident_bytes > self.budget:
                    self._evict_wave(pinned_roots, cp_pinned, stats)
            over = (
                self.ledger.resident_bytes + self._aux_bytes() > self.budget
            )
            if over:
                self._strain += 1
                self._escalate()
            else:
                self._strain = 0
            self.m_resident.set(float(self.ledger.resident_bytes))
            result = dict(
                stats,
                over_budget=over,
                resident_bytes=self.ledger.resident_bytes,
            )
        if fire_pressure is not None and self.on_pressure is not None:
            try:
                self.on_pressure(fire_pressure)
            except Exception as e:  # noqa: BLE001 — pressure reporting
                # must never break the eviction path
                self.log.warn("on_pressure hook failed", error=str(e))
        return result

    def _drain_aux(self, stats: dict) -> None:
        """Drain every registered aux cache down to the budget headroom
        the ledger leaves it (0 when the ledger alone is over budget).

        The 'drain' tier is booked in ENTRIES freed, matching the
        cache's own `drained` counter when it exposes one (read as a
        before/after delta); a cache without that counter books one
        per draining pass."""
        for name, cache in list(self._aux.items()):
            others = sum(
                self._aux_bytes_one(c)
                for n, c in self._aux.items()
                if n != name
            )
            target = max(
                0, self.budget - self.ledger.resident_bytes - others
            )
            if self._aux_bytes_one(cache) <= target:
                continue
            before = getattr(cache, "drained", None)
            try:
                freed = cache.drain(target)
            except Exception as e:  # noqa: BLE001 — a broken aux cache
                # must not wedge the eviction path
                self.log.warn("aux drain failed", cache=name, error=str(e))
                continue
            if freed:
                after = getattr(cache, "drained", None)
                entries = (
                    after - before
                    if isinstance(before, int)
                    and isinstance(after, int)
                    and after > before
                    else 1
                )
                self._book("drain", stats, entries)

    def _candidates(self, pinned_roots, cp_pinned):
        """Cold-first eviction order: state-LRU oldest first (stale
        fork tips), then checkpoint entries oldest-epoch first.
        Leased entries (a proof read mid-extraction) are skipped."""
        for root_hex in list(self.state_cache._map.keys()):
            if root_hex in pinned_roots or (
                ("state", root_hex) in self._leases
            ):
                continue
            yield ("state", root_hex), root_hex, None
        cp_keys = sorted(self.checkpoint_cache._map.keys())
        for key in cp_keys:
            if cp_pinned(key[0], key[1]) or ("cp",) + key in self._leases:
                continue
            yield ("cp",) + key, None, key

    @staticmethod
    def _estimated_spill_bytes(state) -> int:
        """Cheap serialized-size estimate (attribute reads only): the
        demote-or-skip economics must not serialize every candidate it
        then declines to spill.  Dominated by the fixed history vectors
        plus the per-validator columns; within a few percent of the
        real SSZ length for mainnet-shape states."""
        n = state.num_validators
        return (
            len(state.randao_mixes) * 32
            + len(state.block_roots) * 32
            + len(state.state_roots) * 32
            + n * 121  # Validator container records
            + state.balances.nbytes
            + state.previous_epoch_participation.nbytes
            + state.current_epoch_participation.nbytes
            + state.inactivity_scores.nbytes
            + state.slashings.nbytes
        )

    def _try_demote(self, cache_map, mkey, lkey, root_hex, stats,
                    force: bool = False) -> bool:
        """Tier 1 on one entry.  Demotion only PAYS when the planes
        this entry holds alone exceed the serialized bytes it would
        add (consecutive chain states share most planes COW — spilling
        them would GROW residency); entries where it does not pay are
        left for tier 2's outright eviction.  `force` bypasses the
        economics (tests/chaos drive the ladder explicitly)."""
        entry = cache_map.get(mkey)
        if entry is None or isinstance(entry, SpilledState):
            return False
        if not force:
            try:
                if self._estimated_spill_bytes(entry) >= (
                    self.ledger.unique_bytes(lkey)
                ):
                    return False
            except Exception:  # noqa: BLE001 — a shape this estimate
                # cannot read (test doubles) never pays; tier 2 evicts
                return False
        try:
            data = entry.serialize()
        except Exception:  # noqa: BLE001 — an unserializable entry
            # falls straight through to tier 2
            cache_map.pop(mkey, None)
            self.ledger.drop(lkey)
            self._book("evict", stats)
            return True
        cache_map[mkey] = SpilledState(data, root_hex)
        self.ledger.add_spill(lkey, len(data))
        engine = getattr(entry, "_root_engine", None)
        if engine is not None and not any(
            id(p) in self.ledger._plane_rc for p in engine.iter_planes()
        ):
            # actively free the node planes (StateRootEngine.release_
            # planes): GC reclaims them with the cache slot in the
            # normal case, but a lingering external reference to the
            # demoted object must not pin megabytes of planes.  Aliased
            # entries (the same object live in the other cache) still
            # hold ledger plane refs and skip this; a racy reader of a
            # released engine only pays a cold rebuild (the engine's
            # conservative-diff invariant), never a stale root.
            engine.release_planes()
        self._book("demote", stats)
        return True

    def _demote_wave(self, pinned_roots, cp_pinned, stats) -> None:
        for lkey, sroot, cpkey in self._candidates(pinned_roots, cp_pinned):
            if self.ledger.resident_bytes <= self.budget:
                return
            cache_map = (
                self.state_cache._map
                if sroot is not None
                else self.checkpoint_cache._map
            )
            mkey = sroot if sroot is not None else cpkey
            root_hex = sroot if sroot is not None else mkey[1]
            self._try_demote(cache_map, mkey, lkey, root_hex, stats)

    def demote_state(self, root_hex: str) -> bool:
        """Force tier-1 demotion of one state-cache entry (chaos/
        property tests exercise the ladder deterministically)."""
        with self._lock:
            stats = {"demote": 0, "evict": 0}
            return self._try_demote(
                self.state_cache._map,
                root_hex,
                ("state", root_hex),
                root_hex,
                stats,
                force=True,
            )

    def _evict_wave(self, pinned_roots, cp_pinned, stats) -> None:
        # spilled bytes first (they already gave up their planes),
        # then cold live entries outright — regen replays from db
        for spilled_first in (True, False):
            for lkey, sroot, cpkey in self._candidates(
                pinned_roots, cp_pinned
            ):
                if self.ledger.resident_bytes <= self.budget:
                    return
                cache_map = (
                    self.state_cache._map
                    if sroot is not None
                    else self.checkpoint_cache._map
                )
                mkey = sroot if sroot is not None else cpkey
                entry = cache_map.get(mkey)
                if entry is None:
                    continue
                if isinstance(entry, SpilledState) != spilled_first:
                    continue
                cache_map.pop(mkey, None)
                self.ledger.drop(lkey)
                self._book("evict", stats)

    def _book(self, tier: str, stats: dict, n: int = 1) -> None:
        stats[tier] += n
        self.evictions[tier] += n
        self._evictions_since_tick += n
        self.m_evictions.inc(tier, float(n))

    def _escalate(self) -> None:
        """Rung 1: shrink the checkpoint-cache epoch window (future
        growth slows); rungs 2/3 are read by prepare_next_slot/regen."""
        if (
            self._strain >= 1
            and self.checkpoint_cache is not None
            and self._base_cp_epochs is not None
        ):
            shrunk = max(2, self._base_cp_epochs // 2)
            if self.checkpoint_cache.max_epochs != shrunk:
                self.checkpoint_cache.max_epochs = shrunk
                self.log.warn(
                    "memory pressure: checkpoint window shrunk",
                    epochs=shrunk,
                )

    # -- the degradation ladder (read by prepare_next_slot / regen) ---------

    @property
    def pressure_active(self) -> bool:
        # RLock: re-entrant when the caller already holds it (status())
        with self._lock:
            return self._episode_active

    @property
    def pressure_level(self) -> int:
        with self._lock:
            return min(self._strain, 3)

    def skip_precompute(self) -> bool:
        """Rung 2: the next-slot epoch precompute is advisory work that
        ADDS a state under pressure — skip it."""
        return self.pressure_level >= 2

    def regen_rejected(self, replay_depth: int) -> bool:
        """Rung 3: a deep-fork regen whose replay would thrash the
        budget is refused (RegenError MEMORY_PRESSURE at the caller)."""
        return (
            self.pressure_level >= 3
            and replay_depth > self.replay_depth_bound
        )

    # -- slot tick (node clock) ---------------------------------------------

    def on_slot(self, slot: int) -> None:
        with self._lock:
            # self-healing drift bound FIRST: hashing a cached object
            # in place (e.g. head_state.hash_tree_root()) builds planes
            # its snapshot predates.  The per-tick check is O(entries)
            # id comparisons; only entries whose engine identity
            # changed re-snapshot their plane list
            self._reconcile_locked()
            over = (
                self.budget is not None
                and self.ledger.resident_bytes + self._aux_bytes()
                > self.budget
            )
        if over:
            # reconcile surfaced planes the adds never booked — the
            # budget binds here too, not only at add time
            self.enforce()
        with self._lock:
            resident = self.ledger.resident_bytes
            quiet = self._evictions_since_tick == 0
            self._evictions_since_tick = 0
            self.m_resident.set(float(resident))
            if self.budget is not None:
                self.m_budget.set(float(self.budget))
            pins, cp_pinned = self._pins()
            if pins is not None:
                keys = [("state", r) for r in pins]
                if self.checkpoint_cache is not None:
                    # the checkpoint side of the pinned set (justified/
                    # finalized/next-slot-proposal states) counts too —
                    # the gauge is the budget's irreducible floor
                    keys += [
                        ("cp",) + k
                        for k in self.checkpoint_cache._map
                        if cp_pinned(k[0], k[1])
                    ]
                self.m_pinned.set(float(self.ledger.entry_bytes(keys)))
            if (
                self._episode_active
                and quiet
                and (
                    self.budget is None
                    or resident + self._aux_bytes() <= self.budget
                )
            ):
                self._episode_active = False
                self._strain = 0
                if (
                    self.checkpoint_cache is not None
                    and self._base_cp_epochs is not None
                ):
                    self.checkpoint_cache.max_epochs = self._base_cp_epochs
                self.log.info(
                    "memory-pressure episode closed",
                    resident_bytes=resident,
                )

    def set_budget(self, budget_bytes: Optional[int]) -> None:
        """Re-budget at runtime (chaos scenarios tighten mid-run); a
        tighter budget enforces immediately."""
        with self._lock:
            self.budget = budget_bytes
            if budget_bytes is not None:
                self.m_budget.set(float(budget_bytes))
        self.enforce()

    # -- reconciliation ------------------------------------------------------

    def reconcile(self) -> None:
        with self._lock:
            self._reconcile_locked()

    def _reconcile_locked(self) -> None:
        """Re-snapshot entries whose engine identity changed since the
        last snapshot (O(live entries) attribute reads, no hashing)."""
        if self.state_cache is None:
            return
        for root_hex, entry in list(self.state_cache._map.items()):
            if isinstance(entry, SpilledState):
                continue
            key = ("state", root_hex)
            engine = getattr(entry, "_root_engine", None)
            if not self.ledger.engine_current(key, engine):
                self.ledger.add_live(key, entry)
        if self.checkpoint_cache is None:
            return
        for cpkey, entry in list(self.checkpoint_cache._map.items()):
            if isinstance(entry, SpilledState):
                continue
            key = ("cp",) + tuple(cpkey)
            engine = getattr(entry, "_root_engine", None)
            if not self.ledger.engine_current(key, engine):
                self.ledger.add_live(key, entry)

    # -- introspection -------------------------------------------------------

    def status(self) -> dict:
        with self._lock:
            spilled = 0
            live = 0
            for cache in (self.state_cache, self.checkpoint_cache):
                if cache is None:
                    continue
                # list() snapshot: the API thread reads status() while
                # the import thread inserts BEFORE taking this lock
                for entry in list(cache._map.values()):
                    if isinstance(entry, SpilledState):
                        spilled += 1
                    else:
                        live += 1
            return {
                "budget_bytes": self.budget,
                "resident_bytes": self.ledger.resident_bytes,
                "plane_bytes": self.ledger.plane_bytes,
                "column_bytes": self.ledger.column_bytes,
                "spill_bytes": self.ledger.spill_bytes,
                "aux_bytes": self._aux_bytes(),
                "pinned_bytes": self.m_pinned.value,
                "pressure_active": self._episode_active,
                "pressure_level": self.pressure_level,
                "pressure_events": self._pressure_events,
                "replay_depth_bound": self.replay_depth_bound,
                "evictions": dict(self.evictions),
                "leases": len(self._leases),
                "entries": {"live": live, "spilled": spilled},
            }
