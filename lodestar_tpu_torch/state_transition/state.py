"""BeaconState — altair, struct-of-arrays working representation.

The port's copy of `lodestar_tpu/state_transition/state.py`; it imports nothing of the
JAX package.

The reference keeps the state as a persistent SSZ tree-of-nodes ViewDU
(reference: packages/state-transition/src/cache/stateCache.ts, types
re-exported via types/src/altair/sszTypes.ts BeaconState).  On
accelerator-era hardware the profitable layout is the opposite: the per-validator
columns (balances, effective balances, participation flags, inactivity
scores, activation/exit epochs) live as contiguous numpy vectors so the
whole epoch transition is a handful of vectorized array passes instead
of a per-validator interpreter loop.  SSZ view (serialize /
hash_tree_root) is materialized on demand from the columns.

Reference parity map:
  - field set:        types/src/altair/sszTypes.ts (BeaconState)
  - clone-on-write:   stateTransition.ts:59 (state.clone() before mutate)
  - hashTreeRoot:     stateTransition.ts:101-104 (verifyStateRoot)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .. import params
from ..config.chain_config import ChainConfig
from ..ssz import Bitvector, Bytes32, Container, List as SszList, Vector, uint8, uint64
from ..types import (
    BeaconBlockHeader,
    Checkpoint,
    Eth1Data,
    Fork,
    SyncCommittee,
    Validator,
)

P = params.ACTIVE_PRESET

# Full altair BeaconState SSZ type (reference: types/src/altair/sszTypes.ts)
_altair_state_fields = (
        ("genesis_time", uint64),
        ("genesis_validators_root", Bytes32),
        ("slot", uint64),
        ("fork", Fork),
        ("latest_block_header", BeaconBlockHeader),
        ("block_roots", Vector(Bytes32, P.SLOTS_PER_HISTORICAL_ROOT)),
        ("state_roots", Vector(Bytes32, P.SLOTS_PER_HISTORICAL_ROOT)),
        ("historical_roots", SszList(Bytes32, P.HISTORICAL_ROOTS_LIMIT)),
        ("eth1_data", Eth1Data),
        (
            "eth1_data_votes",
            SszList(
                Eth1Data, P.EPOCHS_PER_ETH1_VOTING_PERIOD * P.SLOTS_PER_EPOCH
            ),
        ),
        ("eth1_deposit_index", uint64),
        ("validators", SszList(Validator, P.VALIDATOR_REGISTRY_LIMIT)),
        ("balances", SszList(uint64, P.VALIDATOR_REGISTRY_LIMIT)),
        ("randao_mixes", Vector(Bytes32, P.EPOCHS_PER_HISTORICAL_VECTOR)),
        ("slashings", Vector(uint64, P.EPOCHS_PER_SLASHINGS_VECTOR)),
        (
            "previous_epoch_participation",
            SszList(uint8, P.VALIDATOR_REGISTRY_LIMIT),
        ),
        (
            "current_epoch_participation",
            SszList(uint8, P.VALIDATOR_REGISTRY_LIMIT),
        ),
        ("justification_bits", Bitvector(params.JUSTIFICATION_BITS_LENGTH)),
        ("previous_justified_checkpoint", Checkpoint),
        ("current_justified_checkpoint", Checkpoint),
        ("finalized_checkpoint", Checkpoint),
        ("inactivity_scores", SszList(uint64, P.VALIDATOR_REGISTRY_LIMIT)),
        ("current_sync_committee", SyncCommittee),
        ("next_sync_committee", SyncCommittee),
)

BeaconStateAltair = Container(_altair_state_fields, name="BeaconStateAltair")

# phase0 replaces the participation/inactivity/sync tail with the
# PendingAttestation record lists (reference: types/src/phase0/sszTypes.ts
# BeaconState)
from ..types import PendingAttestation as _PendingAttestation  # noqa: E402

_PENDING_ATT_LIMIT = P.MAX_ATTESTATIONS * P.SLOTS_PER_EPOCH

BeaconStatePhase0 = Container(
    _altair_state_fields[:15]  # ... through slashings
    + (
        (
            "previous_epoch_attestations",
            SszList(_PendingAttestation, _PENDING_ATT_LIMIT),
        ),
        (
            "current_epoch_attestations",
            SszList(_PendingAttestation, _PENDING_ATT_LIMIT),
        ),
    )
    + _altair_state_fields[17:21],  # justification bits + checkpoints
    name="BeaconStatePhase0",
)

# bellatrix appends the execution-payload header
# (reference: types/src/bellatrix/sszTypes.ts BeaconState)
from ..types import ExecutionPayloadHeader as _ExecutionPayloadHeader  # noqa: E402

BeaconStateBellatrix = Container(
    _altair_state_fields
    + (("latest_execution_payload_header", _ExecutionPayloadHeader),),
    name="BeaconStateBellatrix",
)

# capella appends withdrawal bookkeeping + historical summaries, and the
# payload header gains withdrawals_root
# (reference: types/src/capella/sszTypes.ts BeaconState)
from ..types import (  # noqa: E402
    ExecutionPayloadHeaderCapella as _HeaderCapella,
    ExecutionPayloadHeaderDeneb as _HeaderDeneb,
    HistoricalSummary as _HistoricalSummary,
)

_capella_extra_fields = (
    ("next_withdrawal_index", uint64),
    ("next_withdrawal_validator_index", uint64),
    (
        "historical_summaries",
        SszList(_HistoricalSummary, P.HISTORICAL_ROOTS_LIMIT),
    ),
)

BeaconStateCapella = Container(
    _altair_state_fields
    + (("latest_execution_payload_header", _HeaderCapella),)
    + _capella_extra_fields,
    name="BeaconStateCapella",
)

# deneb only swaps the payload header type (blob gas fields)
BeaconStateDeneb = Container(
    _altair_state_fields
    + (("latest_execution_payload_header", _HeaderDeneb),)
    + _capella_extra_fields,
    name="BeaconStateDeneb",
)

_U64 = np.uint64
FAR_FUTURE = params.FAR_FUTURE_EPOCH


@dataclass
class BeaconState:
    """Mutable working state; columns are numpy, the rest plain Python."""

    config: ChainConfig
    genesis_time: int = 0
    genesis_validators_root: bytes = b"\x00" * 32
    slot: int = 0
    fork: Dict = field(
        default_factory=lambda: Fork.default()
    )
    latest_block_header: Dict = field(
        default_factory=lambda: BeaconBlockHeader.default()
    )
    block_roots: List[bytes] = field(
        default_factory=lambda: [b"\x00" * 32] * P.SLOTS_PER_HISTORICAL_ROOT
    )
    state_roots: List[bytes] = field(
        default_factory=lambda: [b"\x00" * 32] * P.SLOTS_PER_HISTORICAL_ROOT
    )
    historical_roots: List[bytes] = field(default_factory=list)
    eth1_data: Dict = field(default_factory=lambda: Eth1Data.default())
    eth1_data_votes: List[Dict] = field(default_factory=list)
    eth1_deposit_index: int = 0
    # -- validator registry, struct-of-arrays ------------------------------
    pubkeys: List[bytes] = field(default_factory=list)
    withdrawal_credentials: List[bytes] = field(default_factory=list)
    effective_balance: np.ndarray = field(
        default_factory=lambda: np.zeros(0, _U64)
    )
    slashed: np.ndarray = field(default_factory=lambda: np.zeros(0, bool))
    activation_eligibility_epoch: np.ndarray = field(
        default_factory=lambda: np.zeros(0, _U64)
    )
    activation_epoch: np.ndarray = field(
        default_factory=lambda: np.zeros(0, _U64)
    )
    exit_epoch: np.ndarray = field(default_factory=lambda: np.zeros(0, _U64))
    withdrawable_epoch: np.ndarray = field(
        default_factory=lambda: np.zeros(0, _U64)
    )
    balances: np.ndarray = field(default_factory=lambda: np.zeros(0, _U64))
    # ----------------------------------------------------------------------
    randao_mixes: List[bytes] = field(
        default_factory=lambda: [b"\x00" * 32] * P.EPOCHS_PER_HISTORICAL_VECTOR
    )
    slashings: np.ndarray = field(
        default_factory=lambda: np.zeros(P.EPOCHS_PER_SLASHINGS_VECTOR, _U64)
    )
    previous_epoch_participation: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.uint8)
    )
    current_epoch_participation: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.uint8)
    )
    justification_bits: List[bool] = field(
        default_factory=lambda: [False] * params.JUSTIFICATION_BITS_LENGTH
    )
    previous_justified_checkpoint: Dict = field(
        default_factory=lambda: Checkpoint.default()
    )
    current_justified_checkpoint: Dict = field(
        default_factory=lambda: Checkpoint.default()
    )
    finalized_checkpoint: Dict = field(
        default_factory=lambda: Checkpoint.default()
    )
    inactivity_scores: np.ndarray = field(
        default_factory=lambda: np.zeros(0, _U64)
    )
    current_sync_committee: Dict = field(
        default_factory=lambda: SyncCommittee.default()
    )
    next_sync_committee: Dict = field(
        default_factory=lambda: SyncCommittee.default()
    )
    # phase0-era pending attestation records; None = altair or later
    # (the altair upgrade translates them into participation flags)
    previous_epoch_attestations: Optional[List[Dict]] = None
    current_epoch_attestations: Optional[List[Dict]] = None
    # None = pre-bellatrix state; set by upgrade_to_bellatrix
    latest_execution_payload_header: Optional[Dict] = None
    # None = pre-capella state; set by upgrade_to_capella
    next_withdrawal_index: Optional[int] = None
    next_withdrawal_validator_index: Optional[int] = None
    historical_summaries: Optional[List[Dict]] = None

    # -- fork identity ------------------------------------------------------

    @property
    def fork_name(self) -> params.ForkName:
        """The fork this state is in, from Fork.current_version (the
        reference's config.getForkName(state.slot) equivalent)."""
        version = bytes(self.fork["current_version"])
        for name, v in self.config.fork_versions.items():
            if bytes(v) == version:
                return name
        return (
            params.ForkName.phase0
            if self.previous_epoch_attestations is not None
            else params.ForkName.altair
        )

    def fork_at_least(self, fork: params.ForkName) -> bool:
        return params.FORK_SEQ[self.fork_name] >= params.FORK_SEQ[fork]

    # -- registry ----------------------------------------------------------

    @property
    def num_validators(self) -> int:
        return len(self.pubkeys)

    def pubkey_index(self, pubkey: bytes) -> Optional[int]:
        """O(1) pubkey → validator index (the pubkey2index cache; lazily
        built, incrementally maintained by add_validator)."""
        m = getattr(self, "_pubkey_map", None)
        # keyed on the rows the map covers, not its size: a registry that
        # repeats a key (the interop keys of a test or a card run) has
        # fewer keys than rows, and must not rebuild on every lookup
        if m is None or getattr(self, "_pubkey_map_rows", -1) != len(self.pubkeys):
            m = {pk: i for i, pk in enumerate(self.pubkeys)}
            self._pubkey_map = m
            self._pubkey_map_rows = len(self.pubkeys)
        return m.get(bytes(pubkey))

    def add_validator(
        self,
        pubkey: bytes,
        withdrawal_credential: bytes,
        amount: int,
        *,
        effective_balance: Optional[int] = None,
        activation_eligibility_epoch: int = FAR_FUTURE,
        activation_epoch: int = FAR_FUTURE,
        exit_epoch: int = FAR_FUTURE,
        withdrawable_epoch: int = FAR_FUTURE,
    ) -> int:
        """Append a validator (spec add_validator_to_registry)."""
        if effective_balance is None:
            effective_balance = min(
                amount - amount % P.EFFECTIVE_BALANCE_INCREMENT,
                P.MAX_EFFECTIVE_BALANCE,
            )
        self.pubkeys.append(bytes(pubkey))
        self.withdrawal_credentials.append(bytes(withdrawal_credential))
        m = getattr(self, "_pubkey_map", None)
        if m is not None and getattr(self, "_pubkey_map_rows", -1) == len(self.pubkeys) - 1:
            m[bytes(pubkey)] = len(self.pubkeys) - 1
            self._pubkey_map_rows = len(self.pubkeys)

        def _app(arr, v, dtype=_U64):
            return np.append(arr, np.asarray([v], dtype))

        self.effective_balance = _app(self.effective_balance, effective_balance)
        self.slashed = _app(self.slashed, False, bool)
        self.activation_eligibility_epoch = _app(
            self.activation_eligibility_epoch, activation_eligibility_epoch
        )
        self.activation_epoch = _app(self.activation_epoch, activation_epoch)
        self.exit_epoch = _app(self.exit_epoch, exit_epoch)
        self.withdrawable_epoch = _app(
            self.withdrawable_epoch, withdrawable_epoch
        )
        self.balances = _app(self.balances, amount)
        self.previous_epoch_participation = _app(
            self.previous_epoch_participation, 0, np.uint8
        )
        self.current_epoch_participation = _app(
            self.current_epoch_participation, 0, np.uint8
        )
        self.inactivity_scores = _app(self.inactivity_scores, 0)
        return self.num_validators - 1

    def increase_balance(self, index: int, delta: int) -> None:
        self.balances[index] = _U64(int(self.balances[index]) + int(delta))

    def decrease_balance(self, index: int, delta: int) -> None:
        self.balances[index] = _U64(
            max(0, int(self.balances[index]) - int(delta))
        )

    # -- clone / SSZ view --------------------------------------------------

    def clone(self) -> "BeaconState":
        """Deep copy (the reference's state.clone() before mutation)."""
        import copy

        out = BeaconState(config=self.config)
        out.genesis_time = self.genesis_time
        out.genesis_validators_root = self.genesis_validators_root
        out.slot = self.slot
        out.fork = copy.deepcopy(self.fork)
        out.latest_block_header = copy.deepcopy(self.latest_block_header)
        out.block_roots = list(self.block_roots)
        out.state_roots = list(self.state_roots)
        out.historical_roots = list(self.historical_roots)
        out.eth1_data = copy.deepcopy(self.eth1_data)
        out.eth1_data_votes = copy.deepcopy(self.eth1_data_votes)
        out.eth1_deposit_index = self.eth1_deposit_index
        out.pubkeys = list(self.pubkeys)
        out.withdrawal_credentials = list(self.withdrawal_credentials)
        for col in (
            "effective_balance",
            "slashed",
            "activation_eligibility_epoch",
            "activation_epoch",
            "exit_epoch",
            "withdrawable_epoch",
            "balances",
            "slashings",
            "previous_epoch_participation",
            "current_epoch_participation",
            "inactivity_scores",
        ):
            setattr(out, col, getattr(self, col).copy())
        out.randao_mixes = list(self.randao_mixes)
        out.justification_bits = list(self.justification_bits)
        out.previous_justified_checkpoint = dict(
            self.previous_justified_checkpoint
        )
        out.current_justified_checkpoint = dict(
            self.current_justified_checkpoint
        )
        out.finalized_checkpoint = dict(self.finalized_checkpoint)
        out.current_sync_committee = copy.deepcopy(self.current_sync_committee)
        out.next_sync_committee = copy.deepcopy(self.next_sync_committee)
        if self.previous_epoch_attestations is not None:
            out.previous_epoch_attestations = copy.deepcopy(
                self.previous_epoch_attestations
            )
            out.current_epoch_attestations = copy.deepcopy(
                self.current_epoch_attestations
            )
        out.latest_execution_payload_header = copy.deepcopy(
            self.latest_execution_payload_header
        )
        out.next_withdrawal_index = self.next_withdrawal_index
        out.next_withdrawal_validator_index = (
            self.next_withdrawal_validator_index
        )
        out.historical_summaries = (
            [dict(h) for h in self.historical_summaries]
            if self.historical_summaries is not None
            else None
        )
        # share the incremental-merkleization engine copy-on-write: the
        # clone inherits warm trees (state_transition pre->post, regen
        # replay, checkpoint states), and either side copies a plane
        # only when its first dirty path touches it
        engine = getattr(self, "_root_engine", None)
        if engine is not None:
            out._root_engine = engine.clone()
        # the epochs' committee shuffles (accessors.get_shuffling): pure
        # functions of (epoch, seed), so the clone keeps them (a copy of
        # the memo, the arrays shared and never written)
        shuffles = getattr(self, "_shuffle_cache", None)
        if shuffles is not None:
            out._shuffle_cache = dict(shuffles)
        return out

    def validators_value(self) -> List[Dict]:
        return [
            {
                "pubkey": self.pubkeys[i],
                "withdrawal_credentials": self.withdrawal_credentials[i],
                "effective_balance": int(self.effective_balance[i]),
                "slashed": bool(self.slashed[i]),
                "activation_eligibility_epoch": int(
                    self.activation_eligibility_epoch[i]
                ),
                "activation_epoch": int(self.activation_epoch[i]),
                "exit_epoch": int(self.exit_epoch[i]),
                "withdrawable_epoch": int(self.withdrawable_epoch[i]),
            }
            for i in range(self.num_validators)
        ]

    def to_value(self) -> Dict:
        """Materialize the SSZ container value."""
        out = {
            "genesis_time": self.genesis_time,
            "genesis_validators_root": self.genesis_validators_root,
            "slot": self.slot,
            "fork": self.fork,
            "latest_block_header": self.latest_block_header,
            "block_roots": list(self.block_roots),
            "state_roots": list(self.state_roots),
            "historical_roots": list(self.historical_roots),
            "eth1_data": self.eth1_data,
            "eth1_data_votes": list(self.eth1_data_votes),
            "eth1_deposit_index": self.eth1_deposit_index,
            "validators": self.validators_value(),
            "balances": [int(b) for b in self.balances],
            "randao_mixes": list(self.randao_mixes),
            "slashings": [int(s) for s in self.slashings],
            "previous_epoch_participation": [
                int(x) for x in self.previous_epoch_participation
            ],
            "current_epoch_participation": [
                int(x) for x in self.current_epoch_participation
            ],
            "justification_bits": list(self.justification_bits),
            "previous_justified_checkpoint": self.previous_justified_checkpoint,
            "current_justified_checkpoint": self.current_justified_checkpoint,
            "finalized_checkpoint": self.finalized_checkpoint,
            "inactivity_scores": [int(x) for x in self.inactivity_scores],
            "current_sync_committee": self.current_sync_committee,
            "next_sync_committee": self.next_sync_committee,
        }
        if self.previous_epoch_attestations is not None:
            # phase0 view: the pending-attestation lists replace the
            # participation/inactivity/sync tail
            out["previous_epoch_attestations"] = [
                dict(a) for a in self.previous_epoch_attestations
            ]
            out["current_epoch_attestations"] = [
                dict(a) for a in self.current_epoch_attestations
            ]
            for k in (
                "previous_epoch_participation",
                "current_epoch_participation",
                "inactivity_scores",
                "current_sync_committee",
                "next_sync_committee",
            ):
                del out[k]
        if self.latest_execution_payload_header is not None:
            out["latest_execution_payload_header"] = (
                self.latest_execution_payload_header
            )
        if self.next_withdrawal_index is not None:
            out["next_withdrawal_index"] = self.next_withdrawal_index
            out["next_withdrawal_validator_index"] = (
                self.next_withdrawal_validator_index
            )
            out["historical_summaries"] = list(self.historical_summaries)
        return out

    @classmethod
    def from_value(cls, value: Dict, config: ChainConfig) -> "BeaconState":
        st = cls(config=config)
        st.genesis_time = value["genesis_time"]
        st.genesis_validators_root = value["genesis_validators_root"]
        st.slot = value["slot"]
        st.fork = dict(value["fork"])
        st.latest_block_header = dict(value["latest_block_header"])
        st.block_roots = list(value["block_roots"])
        st.state_roots = list(value["state_roots"])
        st.historical_roots = list(value["historical_roots"])
        st.eth1_data = dict(value["eth1_data"])
        st.eth1_data_votes = [dict(v) for v in value["eth1_data_votes"]]
        st.eth1_deposit_index = value["eth1_deposit_index"]
        vals = value["validators"]
        st.pubkeys = [v["pubkey"] for v in vals]
        st.withdrawal_credentials = [
            v["withdrawal_credentials"] for v in vals
        ]
        st.effective_balance = np.asarray(
            [v["effective_balance"] for v in vals], _U64
        )
        st.slashed = np.asarray([v["slashed"] for v in vals], bool)
        st.activation_eligibility_epoch = np.asarray(
            [v["activation_eligibility_epoch"] for v in vals], _U64
        )
        st.activation_epoch = np.asarray(
            [v["activation_epoch"] for v in vals], _U64
        )
        st.exit_epoch = np.asarray([v["exit_epoch"] for v in vals], _U64)
        st.withdrawable_epoch = np.asarray(
            [v["withdrawable_epoch"] for v in vals], _U64
        )
        st.balances = np.asarray(value["balances"], _U64)
        st.randao_mixes = list(value["randao_mixes"])
        st.slashings = np.asarray(value["slashings"], _U64)
        n_val = len(vals)
        if "previous_epoch_attestations" in value:
            # phase0 value: pending lists in, flag columns defaulted
            st.previous_epoch_attestations = [
                dict(a) for a in value["previous_epoch_attestations"]
            ]
            st.current_epoch_attestations = [
                dict(a) for a in value["current_epoch_attestations"]
            ]
            st.previous_epoch_participation = np.zeros(n_val, np.uint8)
            st.current_epoch_participation = np.zeros(n_val, np.uint8)
        else:
            st.previous_epoch_participation = np.asarray(
                value["previous_epoch_participation"], np.uint8
            )
            st.current_epoch_participation = np.asarray(
                value["current_epoch_participation"], np.uint8
            )
        st.justification_bits = list(value["justification_bits"])
        st.previous_justified_checkpoint = dict(
            value["previous_justified_checkpoint"]
        )
        st.current_justified_checkpoint = dict(
            value["current_justified_checkpoint"]
        )
        st.finalized_checkpoint = dict(value["finalized_checkpoint"])
        if "inactivity_scores" in value:
            st.inactivity_scores = np.asarray(value["inactivity_scores"], _U64)
            st.current_sync_committee = dict(value["current_sync_committee"])
            st.next_sync_committee = dict(value["next_sync_committee"])
        else:
            st.inactivity_scores = np.zeros(n_val, _U64)
        if "latest_execution_payload_header" in value:
            st.latest_execution_payload_header = dict(
                value["latest_execution_payload_header"]
            )
        if "next_withdrawal_index" in value:
            st.next_withdrawal_index = value["next_withdrawal_index"]
            st.next_withdrawal_validator_index = value[
                "next_withdrawal_validator_index"
            ]
            st.historical_summaries = [
                dict(h) for h in value["historical_summaries"]
            ]
        return st

    # -- fork-aware container selection ------------------------------------

    @staticmethod
    def _container_for_fork(name: params.ForkName):
        seq = params.FORK_SEQ[name]
        if seq >= params.FORK_SEQ[params.ForkName.deneb]:
            return BeaconStateDeneb
        if seq >= params.FORK_SEQ[params.ForkName.capella]:
            return BeaconStateCapella
        if seq >= params.FORK_SEQ[params.ForkName.bellatrix]:
            return BeaconStateBellatrix
        if seq >= params.FORK_SEQ[params.ForkName.altair]:
            return BeaconStateAltair
        return BeaconStatePhase0

    def _container(self):
        # Prefer the schema implied by the materialized fields over the
        # fork version: tests build altair-shaped states with arbitrary
        # fork records, and a capella state always carries the fields.
        if self.next_withdrawal_index is not None:
            c = self._container_for_fork(self.fork_name)
            return c if c in (BeaconStateCapella, BeaconStateDeneb) else BeaconStateCapella
        if self.latest_execution_payload_header is not None:
            return BeaconStateBellatrix
        if self.previous_epoch_attestations is not None:
            return BeaconStatePhase0
        return BeaconStateAltair

    @staticmethod
    def _container_for_bytes(data: bytes, config: ChainConfig):
        """Pick the SSZ container from the fork version embedded in the
        serialized state (Fork.current_version at fixed offset 52:56 —
        genesis_time 8 + genesis_validators_root 32 + slot 8 +
        previous_version 4)."""
        version = bytes(data[52:56])
        for name, v in config.fork_versions.items():
            if v == version:
                return BeaconState._container_for_fork(name)
        return BeaconStateAltair

    def hash_tree_root(self) -> bytes:
        """State root via the incremental engine (state_root.py): cached
        per-field roots + dirty-chunk re-hash, O(touched validators) per
        slot, on the process merkle backend (the card's kernels unless
        the process asked for the host).  `LODESTAR_TPU_HTR=full`
        restores the full recompute; `=check` runs both and asserts
        bit-identity.  An engine fault raises: there is no silent
        recompute on the host (the JAX package's copy has one)."""
        import os

        mode = os.environ.get("LODESTAR_TPU_HTR", "incremental")
        if mode == "full":
            return self._container().hash_tree_root(self.to_value())
        from .state_root import StateRootEngine

        engine = getattr(self, "_root_engine", None)
        if engine is None:
            engine = self._root_engine = StateRootEngine()
        try:
            root = engine.hash_tree_root(self)
        except Exception:
            # the engine may hold half-updated planes: the next call
            # rebuilds cold
            self._root_engine = None
            raise
        if mode == "check":
            full = self._container().hash_tree_root(self.to_value())
            if root != full:  # not an assert: must survive python -O
                raise RuntimeError(
                    "incremental state root diverged from full recompute"
                )
        return root

    def invalidate_root_cache(self) -> None:
        """Drop the incremental-merkleization engine; the next
        hash_tree_root() rebuilds cold.  Correctness never requires
        this (dirty tracking is diff-based and conservative) — it is an
        escape hatch for memory pressure or debugging."""
        self._root_engine = None

    def serialize(self) -> bytes:
        return self._container().serialize(self.to_value())

    @classmethod
    def deserialize(cls, data: bytes, config: ChainConfig) -> "BeaconState":
        container = cls._container_for_bytes(data, config)
        return cls.from_value(container.deserialize(data), config)
