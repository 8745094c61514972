"""State-transition layer of the port (copies of the JAX package's
`lodestar_tpu/state_transition/` modules, without JAX):

  - `util`: epoch/slot math, swap-or-not shuffling (vectorized numpy —
    whole-registry batch shuffles instead of per-index loops),
  - `accessors`: spec get_* over the columnar state (seeds, committees,
    proposer/sync-committee rejection sampling),
  - `state`: BeaconState — phase0 onward, struct-of-arrays columns + SSZ
    view over the port's own types, its root through `state_root`,
  - `slot` / `block` / `epoch` / `transition`: processSlots,
    processBlock (every fork's operations), the altair-onward epoch
    transition and stateTransition() itself,
  - `genesis`: interop-style genesis + the eth1 DepositTree,
  - `EpochCache`: committee assignments + validator pubkey maps,
  - `signature_sets`: BeaconStateView and the per-object extractors
    feeding the port's verifier as WireSignatureSets,
  - `state_root`: the state-root engine on the port's merkle tree and
    device backend,
  - `phase0`: the PendingAttestation-era epoch and `upgrade_to_altair`.
"""

from .epoch_cache import EpochCache  # noqa: F401
from .block import BlockProcessError, process_block  # noqa: F401
from .epoch import process_epoch  # noqa: F401
from .genesis import DepositTree, create_genesis_state  # noqa: F401
from .slot import process_slot, process_slots  # noqa: F401
from .state import BeaconState, BeaconStateAltair  # noqa: F401
from .transition import (  # noqa: F401
    state_transition,
    verify_proposer_signature,
)
from .signature_sets import (  # noqa: F401
    BeaconStateView,
    get_aggregate_and_proof_signature_set,
    get_attestation_data_signing_root,
    get_attestation_signature_sets,
    get_attester_slashings_signature_sets,
    get_block_signature_sets,
    get_indexed_attestation_signature_set,
    get_proposer_signature_set,
    get_proposer_slashings_signature_sets,
    get_randao_reveal_signature_set,
    get_sync_committee_signature_set,
    get_voluntary_exits_signature_sets,
)
from .state_root import StateRootEngine, state_root_engine_bytes  # noqa: F401
from .util import (  # noqa: F401
    compute_committee_count_per_slot,
    compute_epoch_at_slot,
    compute_start_slot_at_epoch,
    shuffle_list,
    unshuffle_list,
)
