"""Device circuit breaker of the BLS data plane, a copy of
`lodestar_tpu/bls/supervisor.py` for the port.

Every device seam of `TorchBlsVerifier` runs behind one breaker:

  - **CLOSED** (healthy): jobs dispatch to the card.  Every supervised
    failure is classified: ``timeout`` (the per-job watchdog deadline
    fired), ``backend_init`` (the runtime is sick: the TPU
    runtime's words of the JAX package, and the CUDA runtime's
    initialization, no-device, devices-unavailable, uncorrectable-ECC and
    device-lost errors), ``bad_output`` (a malformed verdict plane),
    ``error`` (anything else, an illegal address or a launch failure
    among them), and ``failure_threshold`` consecutive failures trip the
    breaker.
  - **OPEN** (degraded): no device dispatch at all.  The verifier resolves
    every job on the host ground truth (`_verify_set_host`), so verdicts
    keep flowing; a background task re-probes on a jittered exponential
    backoff.
  - **HALF_OPEN**: the re-probe window arrived; ONE canary job runs on the
    card.  Success closes the breaker, failure re-opens it and doubles the
    backoff (capped).  A kernel that timed out cannot be cancelled and a
    sticky CUDA error poisons the context: the canary then keeps failing
    and the breaker stays open, with host verdicts, as in the JAX package.

Metrics (`lodestar_bls_breaker_*`): state gauge (0 closed / 1 half-open /
2 open), trip counter, per-outcome failure counter, probe counter,
cumulative degraded seconds, host-fallback set counter.

Hooks: ``on_trip(info)`` / ``on_recover(info)``, which the node wires into
its SLO engine, and ``is_open`` for its health surface.

``LODESTAR_TPU_BLS_BREAKER=0`` disables supervision (calls pass through,
failures propagate).  The watchdog deadline is keyed to the verifier's
device: 60 s by default on a CUDA device, off on the CPU, where the plain
versions take seconds a call (``LODESTAR_TPU_BLS_JOB_DEADLINE_S``
overrides; ``0`` disables).
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
import re
import threading
import time
import weakref
from typing import Callable, Optional

from ..utils.metrics import Registry
from ..utils.misc import DeadlineExceeded, run_with_deadline

STATE_CLOSED = 0
STATE_HALF_OPEN = 1
STATE_OPEN = 2
_STATE_NAMES = {STATE_CLOSED: "closed", STATE_HALF_OPEN: "half_open",
                STATE_OPEN: "open"}

OUTCOME_TIMEOUT = "timeout"
OUTCOME_BACKEND_INIT = "backend_init"
OUTCOME_BAD_OUTPUT = "bad_output"
OUTCOME_ERROR = "error"

DEFAULT_BACKOFF_INITIAL_S = 1.0
DEFAULT_BACKOFF_MAX_S = 60.0
DEFAULT_FAILURE_THRESHOLD = 1
# watchdog default on a CUDA device: a device job takes milliseconds (the
# kernels are built before any supervised call); a minute without a
# verdict is a hang, not a slow batch
DEFAULT_CUDA_JOB_DEADLINE_S = 60.0


class BreakerOpen(RuntimeError):
    """The device path is unavailable (breaker open/half-open)."""


class DeviceTimeout(RuntimeError):
    """A supervised device call exceeded its watchdog deadline."""


class BadDeviceOutput(RuntimeError):
    """A device call returned a malformed result (wrong shape/dtype)."""


# error text that indicates the BACKEND (the TPU runtime or its tunnel,
# the CUDA runtime) is sick, as opposed to a bug in one job's
# inputs.  A CUDA illegal address or launch failure is not matched: it
# stays ``error``.
_BACKEND_INIT_PAT = re.compile(
    r"backend|initializ|UNAVAILABLE|DEADLINE_EXCEEDED|failed to connect"
    r"|tunnel|socket|libtpu|DataLoss|ABORTED|device.*(lost|reset)"
    r"|no CUDA-capable device|cudaErrorNoDevice"
    r"|cudaErrorDevicesUnavailable|cudaErrorInitializationError"
    r"|uncorrectable ECC|cudaErrorECCUncorrectable|GPU is lost|fallen off the bus",
    re.IGNORECASE,
)


def classify_failure(exc: BaseException) -> str:
    """Map one device-path exception to a breaker outcome label."""
    if isinstance(exc, DeviceTimeout):
        return OUTCOME_TIMEOUT
    if isinstance(exc, BadDeviceOutput):
        return OUTCOME_BAD_OUTPUT
    if isinstance(
        exc,
        (concurrent.futures.TimeoutError, TimeoutError, DeadlineExceeded),
    ):
        return OUTCOME_TIMEOUT
    if _BACKEND_INIT_PAT.search(f"{type(exc).__name__}: {exc}"):
        return OUTCOME_BACKEND_INIT
    return OUTCOME_ERROR


def check_verdict_plane(arr, n_expected: int, name: str = "device"):
    """Validate one per-set verdict plane: the bad-output classifier's
    entry point.  Returns the array; raises BadDeviceOutput on a
    malformed shape (a truncated or empty result must trip the breaker,
    not silently zero-fill verdicts)."""
    import numpy as np

    a = np.asarray(arr)
    if a.ndim < 1 or a.shape[0] < n_expected:
        raise BadDeviceOutput(
            f"{name}: verdict plane shape {a.shape} < {n_expected} sets"
        )
    return a


# live supervisors, for `breaker_snapshot`
_ACTIVE: "weakref.WeakSet[DeviceSupervisor]" = weakref.WeakSet()


def breaker_snapshot() -> dict:
    """Aggregate state of every live supervisor in this process —
    zeros/closed when none exist."""
    sups = list(_ACTIVE)
    if not sups:
        return {
            "state": "closed",
            "trips": 0,
            "time_in_degraded_s": 0.0,
            "supervisors": 0,
        }
    worst = max(s.state for s in sups)
    return {
        "state": _STATE_NAMES[worst],
        "trips": sum(s.trip_count for s in sups),
        "time_in_degraded_s": round(
            sum(s.time_in_degraded_s() for s in sups), 3
        ),
        "supervisors": len(sups),
    }


def _device_type(device) -> str:
    """"cuda" or "cpu" of a `torch.device`, a device name or None."""
    if device is None:
        return "cpu"
    return getattr(device, "type", None) or str(device).split(":")[0]


def breaker_enabled_env() -> bool:
    env = os.environ.get("LODESTAR_TPU_BLS_BREAKER", "1")
    return env.strip().lower() not in ("0", "false", "no", "off")


class DeviceSupervisor:
    """The breaker state machine + watchdog + re-probe task.

    `canary` is a zero-arg callable returning truthy when one minimal
    device job succeeded (the verifier binds `_device_canary`).  `device`
    is the verifier's device (a `torch.device` or its name): it keys the
    watchdog's default deadline.  `clock`
    is injectable (chaos tests drive backoff deterministically with a
    fake clock); `rng` seeds the backoff jitter.  With
    `auto_probe=True` (production) a daemon thread wakes at each
    re-probe deadline; tests pass False and call `poll()` themselves.
    """

    def __init__(
        self,
        registry: Optional[Registry] = None,
        canary: Optional[Callable[[], bool]] = None,
        clock: Callable[[], float] = time.monotonic,
        failure_threshold: int = DEFAULT_FAILURE_THRESHOLD,
        job_deadline_s: Optional[float] = None,
        backoff_initial_s: float = DEFAULT_BACKOFF_INITIAL_S,
        backoff_max_s: float = DEFAULT_BACKOFF_MAX_S,
        auto_probe: bool = True,
        enabled: Optional[bool] = None,
        rng=None,
        device=None,
    ):
        self.enabled = breaker_enabled_env() if enabled is None else enabled
        self.canary = canary
        self.clock = clock
        self.failure_threshold = max(1, int(failure_threshold))
        self.backoff_initial_s = backoff_initial_s
        self.backoff_max_s = backoff_max_s
        self.auto_probe = auto_probe
        if rng is None:
            import random

            rng = random.Random()
        self._rng = rng
        if job_deadline_s is None:
            env = os.environ.get("LODESTAR_TPU_BLS_JOB_DEADLINE_S")
            env_valid = False
            if env is not None:
                try:
                    job_deadline_s = float(env) or None
                    env_valid = True
                except ValueError:
                    # a malformed override must NOT silently disable
                    # the hang watchdog — warn and fall through to the
                    # device default below
                    logging.getLogger("lodestar_tpu_torch").warning(
                        "ignoring malformed LODESTAR_TPU_BLS_JOB_DEADLINE_S=%r "
                        "(expected seconds as a float; 0 disables)",
                        env,
                    )
            if not env_valid and _device_type(device) == "cuda":
                # the plain versions on the CPU take seconds a call: the
                # watchdog is armed only on the card
                job_deadline_s = DEFAULT_CUDA_JOB_DEADLINE_S
        self.job_deadline_s = job_deadline_s

        # hooks the node composition wires (exception-isolated at call)
        self.on_trip: Optional[Callable[[dict], None]] = None
        self.on_recover: Optional[Callable[[dict], None]] = None

        self._lock = threading.Lock()
        self.state = STATE_CLOSED
        self.trip_count = 0
        self._consecutive = 0
        self._t_opened: Optional[float] = None
        self._degraded_total_s = 0.0
        self._backoff_s = backoff_initial_s
        self._next_probe_t: Optional[float] = None
        self._last_failure: Optional[dict] = None
        self._probe_thread: Optional[threading.Thread] = None
        self._probe_wake = threading.Event()
        self._closed = False

        r = registry or Registry()
        self.m_state = r.gauge(
            "lodestar_bls_breaker_state",
            "BLS device breaker state (0 closed, 1 half-open, 2 open)",
        )
        self.m_trips = r.counter(
            "lodestar_bls_breaker_trips_total",
            "BLS device breaker trips (device path -> degraded host path)",
        )
        self.m_failures = r.labeled_counter(
            "lodestar_bls_breaker_failures_total",
            "Supervised device-path failures by classified outcome",
            "outcome",
        )
        self.m_probes = r.labeled_counter(
            "lodestar_bls_breaker_probes_total",
            "Canary re-probe attempts by result",
            "result",
        )
        self.m_degraded_seconds = r.counter(
            "lodestar_bls_breaker_degraded_seconds_total",
            "Cumulative seconds spent with the breaker open",
        )
        self.m_host_fallback_sets = r.counter(
            "lodestar_bls_breaker_host_fallback_sets_total",
            "Signature sets resolved through the degraded host path",
        )
        self.m_state.set(0.0)
        if self.enabled:
            _ACTIVE.add(self)

    # -- gating (read on every job) ----------------------------------------

    @property
    def active(self) -> bool:
        return self.enabled

    def device_allowed(self) -> bool:
        """True when jobs may dispatch to the device (breaker closed, or
        supervision disabled)."""
        if not self.enabled:
            return True
        # tpulint: disable=guarded-by -- benign race: per-job hot-path advisory read; a stale breaker state costs one extra probe/shed, and transitions settle under the lock
        return self.state == STATE_CLOSED

    def is_open(self) -> bool:
        """True while degraded (open or half-open) — the health
        endpoint's `degraded` source."""
        # tpulint: disable=guarded-by -- benign race: health-endpoint advisory read; staleness is bounded by one watchdog tick and the value is monotonic within a probe window
        return self.enabled and self.state != STATE_CLOSED

    # -- the watchdog ------------------------------------------------------

    def run_guarded(self, fn: Callable[[], object], name: str = "device"):
        """Run one device-path call under the per-job deadline.  With no
        deadline configured (or supervision disabled) this is `fn()`;
        otherwise the call runs on its OWN expendable thread
        (utils/misc.run_with_deadline) and a hang past the deadline
        raises DeviceTimeout — the thread is abandoned so the
        dispatcher/resolver can never be wedged by a dead device
        stream.  Thread-per-call, not a shared worker: concurrent seams
        (the resolver's finish_job vs the dispatcher's agg_g2_sum) must
        never have queue wait behind each other counted against their
        own deadline."""
        if not self.enabled or not self.job_deadline_s:
            return fn()
        try:
            return run_with_deadline(fn, self.job_deadline_s, name)
        except DeadlineExceeded:
            raise DeviceTimeout(
                f"{name} exceeded the {self.job_deadline_s:.1f}s job deadline"
            ) from None

    # -- failure/success accounting ----------------------------------------

    def record_success(self) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._consecutive = 0

    def record_failure(
        self, outcome: str, seam: str, detail: str = ""
    ) -> None:
        """One classified device-path failure at `seam` (begin_job /
        finish_job / agg_g2_sum / export:<entry>).  Trips the breaker at
        the consecutive-failure threshold."""
        if not self.enabled:
            return
        self.m_failures.inc(outcome, 1.0)
        info = None
        with self._lock:
            self._last_failure = {
                "outcome": outcome,
                "seam": seam,
                "detail": detail[:500],
            }
            self._consecutive += 1
            if (
                self.state == STATE_CLOSED
                and self._consecutive >= self.failure_threshold
            ):
                info = self._trip_locked()
        if info is not None:
            self._fire(self.on_trip, info)
            if self.auto_probe:
                self._ensure_probe_thread()

    def note_host_fallback(self, n_sets: int) -> None:
        self.m_host_fallback_sets.inc(n_sets)

    def note_nonfatal(self, outcome: str, seam: str, detail: str = "") -> None:
        """Surface a device-adjacent fault on the failure metric WITHOUT
        advancing the trip streak — for faults whose fallback already
        proved the device alive (an export-stage error followed by a
        successful direct dispatch)."""
        if not self.enabled:
            return
        self.m_failures.inc(outcome, 1.0)
        with self._lock:
            self._last_failure = {
                "outcome": outcome,
                "seam": seam,
                "detail": detail[:500],
            }

    def _trip_locked(self) -> dict:
        # a trip AFTER close() re-arms the supervisor: services that
        # share one verifier across lifecycles (bench probes, test
        # worlds) keep supervision for as long as the verifier is used
        _ACTIVE.add(self)
        self.state = STATE_OPEN
        self.trip_count += 1
        self.m_trips.inc()
        self.m_state.set(float(STATE_OPEN))
        self._t_opened = self.clock()
        self._backoff_s = self.backoff_initial_s
        self._next_probe_t = self._t_opened + self._jittered(self._backoff_s)
        self._probe_wake.set()
        info = dict(self._last_failure or {})
        info["trip_count"] = self.trip_count
        return info

    def _jittered(self, backoff: float) -> float:
        # +/- 25% jitter decorrelates re-probes across a fleet sharing
        # one sick tunnel
        return backoff * (0.75 + 0.5 * self._rng.random())

    def _fire(self, hook, info: dict) -> None:
        if hook is None:
            return
        try:
            hook(info)
        except Exception:  # noqa: BLE001 — observers must never break
            pass  # the breaker itself

    # -- re-probe ----------------------------------------------------------

    def poll(self) -> None:
        """Run the canary if the re-probe window arrived.  Idempotent
        and cheap when closed or not yet due; chaos tests call this
        directly with a fake clock, production rides the probe thread."""
        with self._lock:
            if (
                not self.enabled
                or self.state != STATE_OPEN
                or self._next_probe_t is None
                or self.clock() < self._next_probe_t
            ):
                return
            self.state = STATE_HALF_OPEN
            self.m_state.set(float(STATE_HALF_OPEN))
        ok = False
        try:
            ok = bool(self.canary()) if self.canary is not None else True
        except Exception:  # noqa: BLE001 — a failing canary is a failed
            ok = False  # probe, never an escape
        info = None
        with self._lock:
            self.m_probes.inc("success" if ok else "failure", 1.0)
            if ok:
                info = self._close_locked()
            else:
                self.state = STATE_OPEN
                self.m_state.set(float(STATE_OPEN))
                self._backoff_s = min(
                    self._backoff_s * 2.0, self.backoff_max_s
                )
                self._next_probe_t = self.clock() + self._jittered(
                    self._backoff_s
                )
        if info is not None:
            self._fire(self.on_recover, info)

    def _close_locked(self) -> dict:
        self.state = STATE_CLOSED
        self.m_state.set(float(STATE_CLOSED))
        self._consecutive = 0
        degraded = 0.0
        if self._t_opened is not None:
            degraded = max(self.clock() - self._t_opened, 0.0)
            self._degraded_total_s += degraded
            self.m_degraded_seconds.inc(degraded)
        self._t_opened = None
        self._next_probe_t = None
        return {
            "trip_count": self.trip_count,
            "degraded_s": round(degraded, 3),
        }

    def _ensure_probe_thread(self) -> None:
        with self._lock:
            self._closed = False  # a new trip re-arms a closed supervisor
            if (
                self._probe_thread is not None
                and self._probe_thread.is_alive()
            ):
                return
            self._probe_thread = threading.Thread(
                target=self._probe_loop,
                name="bls-breaker-probe",
                daemon=True,
            )
            self._probe_thread.start()

    def _probe_loop(self) -> None:
        while True:
            with self._lock:
                if self._closed or self.state == STATE_CLOSED:
                    self._probe_thread = None
                    return
                wait = (
                    max(self._next_probe_t - self.clock(), 0.0)
                    if self._next_probe_t is not None
                    else 0.5
                )
            self._probe_wake.clear()
            if self.clock is time.monotonic:
                # real clock: the computed wait IS wall time, and every
                # schedule change sets the wake event — sleep the full
                # window instead of polling
                self._probe_wake.wait(timeout=max(wait, 0.01))
            else:
                # injectable clock (chaos tests): wall sleeps say
                # nothing about fake time — poll at a short cadence so
                # an advanced clock is observed promptly
                self._probe_wake.wait(timeout=min(max(wait, 0.01), 0.05))
            self.poll()

    # -- lifecycle / introspection -----------------------------------------

    def time_in_degraded_s(self) -> float:
        with self._lock:
            total = self._degraded_total_s
            if self._t_opened is not None:
                total += max(self.clock() - self._t_opened, 0.0)
        return total

    def status(self) -> dict:
        with self._lock:
            next_probe = (
                max(self._next_probe_t - self.clock(), 0.0)
                if self._next_probe_t is not None
                and self.state != STATE_CLOSED
                else None
            )
            return {
                "enabled": self.enabled,
                "state": _STATE_NAMES[self.state],
                "trips": self.trip_count,
                "consecutive_failures": self._consecutive,
                "time_in_degraded_s": round(
                    self._degraded_total_s
                    + (
                        max(self.clock() - self._t_opened, 0.0)
                        if self._t_opened is not None
                        else 0.0
                    ),
                    3,
                ),
                "last_failure": self._last_failure,
                "next_probe_in_s": (
                    round(next_probe, 3) if next_probe is not None else None
                ),
                "job_deadline_s": self.job_deadline_s,
                "failure_threshold": self.failure_threshold,
            }

    def close(self) -> None:
        with self._lock:
            self._closed = True
        self._probe_wake.set()
        _ACTIVE.discard(self)


__all__ = [
    "DeviceSupervisor",
    "BreakerOpen",
    "DeviceTimeout",
    "BadDeviceOutput",
    "classify_failure",
    "check_verdict_plane",
    "breaker_snapshot",
    "breaker_enabled_env",
    "STATE_CLOSED",
    "STATE_HALF_OPEN",
    "STATE_OPEN",
    "OUTCOME_TIMEOUT",
    "OUTCOME_BACKEND_INIT",
    "OUTCOME_BAD_OUTPUT",
    "OUTCOME_ERROR",
]
