"""Slasher of the port — vectorized slashing detection (double votes,
min-max surround, double proposals), the JAX package's
`lodestar_tpu/slasher/` on the port's own modules.

Reference: lighthouse/slasher (chunked min-max span arrays, epoch
windowed, batched updates) and the reference node's opPool/gossip
wiring.  The span planes live on the card (`TorchSpanState`), updated by
the span-update kernel (`kernels/spans.py span_update`, `csrc/spans.cu`);
the numpy `SpanState` stays the ground truth.
"""

from ..kernels.spans import span_update
from .attester import (
    AttesterSlasher,
    NaiveAttesterSlasher,
    is_double_vote,
    is_surround_vote,
)
from .batch import SpanState, span_update_rows
from .device import TorchSpanState
from .metrics import SlasherMetrics
from .proposer import ProposerSlasher
from .service import SlasherService
from .store import SlasherStore

__all__ = [
    "AttesterSlasher",
    "NaiveAttesterSlasher",
    "ProposerSlasher",
    "SlasherMetrics",
    "SlasherService",
    "SlasherStore",
    "SpanState",
    "TorchSpanState",
    "is_double_vote",
    "is_surround_vote",
    "span_update",
    "span_update_rows",
]
