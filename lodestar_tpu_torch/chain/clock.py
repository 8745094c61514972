"""Slot clock.

The port's copy of `lodestar_tpu/chain/clock.py`; it imports nothing of the
JAX package.

Mirror of the reference's Clock (reference:
packages/beacon-node/src/util/clock.ts): derives the current slot/epoch
from genesis time, emits per-slot callbacks.  The replay harness drives
it manually (set_time) — a live node would tick it from wall time.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List

from .. import params

_log = logging.getLogger("clock")


class Clock:
    def __init__(self, genesis_time: float = 0.0):
        self.genesis_time = genesis_time
        self._now = genesis_time
        self._slot_listeners: List[Callable[[int], None]] = []  # tpulint: disable=cache-hygiene -- composition-time listener registry: grows only during node init, bounded by subsystem count
        self._last_emitted_slot = -1

    def on_slot(self, fn: Callable[[int], None]) -> None:
        self._slot_listeners.append(fn)

    @property
    def now(self) -> float:
        """The clock's own time — subsystems measuring intervals must
        use THIS, not wall time, so simulated/replayed time works."""
        return self._now

    @property
    def current_slot(self) -> int:
        elapsed = max(self._now - self.genesis_time, 0.0)
        return int(elapsed // params.SECONDS_PER_SLOT)

    @property
    def current_epoch(self) -> int:
        return self.current_slot // params.SLOTS_PER_EPOCH

    def slot_start(self, slot: int) -> float:
        return self.genesis_time + slot * params.SECONDS_PER_SLOT

    def set_time(self, t: float) -> None:
        """Advance the clock (replay harness); emits slot events.

        Listeners are ISOLATED: one misbehaving subsystem (e.g. a peer
        returning garbage mid-heartbeat) must not starve the listeners
        registered after it or abort the tick."""
        self._now = t
        slot = self.current_slot
        while self._last_emitted_slot < slot:
            self._last_emitted_slot += 1
            for fn in self._slot_listeners:
                try:
                    fn(self._last_emitted_slot)
                except Exception:  # noqa: BLE001 — isolate slot listeners
                    _log.exception(
                        "slot listener failed at slot %d",
                        self._last_emitted_slot,
                    )

    def tick_wall(self) -> None:
        self.set_time(time.time())
