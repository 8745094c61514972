"""ChainEventEmitter — typed chain events.

The port's copy of `lodestar_tpu/chain/emitter.py`; it imports nothing of the
JAX package.

Reference: packages/beacon-node/src/chain/emitter.ts (ChainEvent enum +
EventEmitter): block, head, checkpoint/justified/finalized,
attestation.  Listener errors are isolated (a bad subscriber cannot
break the import pipeline), matching the reference's emitter contract.
"""

from __future__ import annotations

import enum
from collections import defaultdict
from typing import Callable, Dict, List

from ..utils.logger import get_logger


class ChainEvent(str, enum.Enum):
    block = "block"
    head = "head"
    attestation = "attestation"
    justified = "justified"
    finalized = "finalized"
    checkpoint = "checkpoint"
    light_client_update = "light_client_update"


class ChainEventEmitter:
    def __init__(self, logger=None):
        self._subs: Dict[ChainEvent, List[Callable]] = defaultdict(list)
        self.log = logger or get_logger("chain/emitter")

    def on(self, event: ChainEvent, callback: Callable) -> Callable:
        self._subs[event].append(callback)
        return callback

    def off(self, event: ChainEvent, callback: Callable) -> None:
        try:
            self._subs[event].remove(callback)
        except ValueError:
            pass

    def emit(self, event: ChainEvent, *args, **kwargs) -> int:
        n = 0
        for cb in list(self._subs[event]):
            try:
                cb(*args, **kwargs)
                n += 1
            except Exception as e:  # noqa: BLE001 - listener isolation
                self.log.warn(
                    "chain event listener failed", event=event.value, error=str(e)
                )
        return n
