"""The span tracer of the service layer, a copy of
`lodestar_tpu/observability/tracer.py`: named, timestamped,
parent-linked intervals kept in a bounded ring.

  - Near-zero cost when disabled: `trace_span` is one allocation and one
    flag check; call sites that compute attributes guard on `enabled()`.
  - The current span rides a `contextvars.ContextVar`; threads do not
    inherit it, so cross-thread links pass `parent_id` explicitly (the
    service's `_Job` records its submitter's span).
  - The ring keeps the most recent N finished spans.

Enable with `LODESTAR_TPU_TRACE=1` (or `=N` for a capacity of N) or at
run time with `configure(True)`.
"""

from __future__ import annotations

import contextvars
import functools
import itertools
import os
import threading
import time
from collections import deque
from typing import Callable, List, Optional

DEFAULT_CAPACITY = 65536

_CURRENT: contextvars.ContextVar[Optional[int]] = contextvars.ContextVar("lodestar_tpu_torch_trace_span", default=None)

# monotonic origin, so span timestamps compare process-wide
_T0_NS = time.perf_counter_ns()


def _parse_env(raw: Optional[str]):
    """LODESTAR_TPU_TRACE: unset/0/false -> disabled; 1/true -> default
    capacity; an integer N > 1 -> enabled with ring capacity N."""
    if raw is None:
        return False, DEFAULT_CAPACITY
    val = raw.strip().lower()
    if val in ("", "0", "false", "no", "off"):
        return False, DEFAULT_CAPACITY
    try:
        n = int(val)
    except ValueError:
        return True, DEFAULT_CAPACITY
    if n <= 0:
        return False, DEFAULT_CAPACITY
    return True, (DEFAULT_CAPACITY if n == 1 else n)


class SpanRecord:
    """One finished span; times in µs from the process trace origin."""

    __slots__ = ("name", "span_id", "parent_id", "tid", "ts_us", "dur_us", "attrs")

    def __init__(self, name, span_id, parent_id, tid, ts_us, dur_us, attrs):
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.tid = tid
        self.ts_us = ts_us
        self.dur_us = dur_us
        self.attrs = attrs


class Tracer:
    """Bounded, thread-safe store of finished spans."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)

    def next_id(self) -> int:
        return next(self._ids)

    def record(self, rec: SpanRecord) -> None:
        with self._lock:
            self._ring.append(rec)

    def snapshot(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()


class _State:
    __slots__ = ("enabled", "tracer")

    def __init__(self, enabled: bool, tracer: Tracer):
        self.enabled = enabled
        self.tracer = tracer


_env_enabled, _env_capacity = _parse_env(os.environ.get("LODESTAR_TPU_TRACE"))
_STATE = _State(_env_enabled, Tracer(_env_capacity))


def enabled() -> bool:
    return _STATE.enabled


def get_tracer() -> Tracer:
    return _STATE.tracer


def current_id() -> Optional[int]:
    """The active span's id in this context (None when disabled or no span
    is open): capture it to parent spans across threads."""
    if not _STATE.enabled:
        return None
    return _CURRENT.get()


def configure(enabled: bool) -> Tracer:
    """Turn tracing on or off at run time."""
    _STATE.enabled = enabled
    return _STATE.tracer


class trace_span:
    """`with trace_span("bls.verify", batch_size=n): ...`; `parent_id`
    overrides the context's parent for cross-thread links."""

    __slots__ = ("name", "attrs", "parent_id", "_span_id", "_t0", "_token")

    def __init__(self, name: str, parent_id: Optional[int] = None, **attrs):
        self.name = name
        self.attrs = attrs
        self.parent_id = parent_id
        self._span_id = None
        self._t0 = 0
        self._token = None

    def set(self, **attrs) -> "trace_span":
        """Attach attributes mid-span (no-op when disabled)."""
        if self._span_id is not None:
            self.attrs.update(attrs)
        return self

    def __enter__(self) -> "trace_span":
        if not _STATE.enabled:
            return self
        self._span_id = _STATE.tracer.next_id()
        if self.parent_id is None:
            self.parent_id = _CURRENT.get()
        self._token = _CURRENT.set(self._span_id)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        span_id = self._span_id
        if span_id is None:
            return False
        t1 = time.perf_counter_ns()
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None
        self._span_id = None
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        _STATE.tracer.record(
            SpanRecord(
                self.name,
                span_id,
                self.parent_id,
                threading.get_ident(),
                (self._t0 - _T0_NS) // 1000,
                (t1 - self._t0) // 1000,
                self.attrs,
            )
        )
        return False

    def __call__(self, fn: Callable) -> Callable:
        """As a decorator: each call of `fn` runs inside the span."""
        name, attrs = self.name, self.attrs

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _STATE.enabled:
                return fn(*args, **kwargs)
            with trace_span(name, **attrs):
                return fn(*args, **kwargs)

        return wrapper
