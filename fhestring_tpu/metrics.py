"""Structured per-op metrics: PBS counts, batch widths, wall-clock.

The reference's only observability is one ``Instant::now()`` per method
printed to stdout (reference src/main.rs:103-114) and a pass/fail line
(src/utils.rs:114-120). For a production service the currency is
*bootstraps*: every homomorphic string op lowers to a fixed number of
batched PBS calls, and PBS/s per card is the capacity metric. This module counts them at the one chokepoint every LUT
evaluation passes through (``ShortintContext._pbs_padded``) and exposes:

- a global, always-on counter (negligible overhead: pure Python ints
  incremented at *dispatch* time, not per device op);
- ``measure(name)``: a context manager that snapshots counters + wall time
  and records a ``MetricsRecord``;
- ``report()``: a structured summary (dict) suitable for JSON logging.

Accuracy: the server API evaluates eagerly (ops dispatch through Python on
every call), so the default counters are execution-accurate — warm calls
re-run ``record_pbs`` and count identically to cold calls
(tests/test_metrics.py::test_warm_counts_match_cold). Inside engine
``lax.scan`` bodies (traced once, executed `length` times per call) the
``scan_scope`` multiplier restores per-execution counts. The one remaining
blind spot is a CALLER-jitted whole method (e.g. ``jax.jit(server.contains)``):
its cached re-executions skip Python entirely. For measurement runs over
such code, wrap in ``exec_count_scope()``, which counts at device-execution
time via ``io_callback`` instead.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time


@dataclasses.dataclass
class Counters:
    """Monotonic global tallies."""

    pbs_calls: int = 0        # number of pbs_batch dispatches
    pbs_items: int = 0        # sum of logical (unpadded) batch sizes
    pbs_items_padded: int = 0  # sum of padded batch sizes actually executed

    def snapshot(self) -> "Counters":
        return Counters(self.pbs_calls, self.pbs_items, self.pbs_items_padded)

    def delta(self, since: "Counters") -> "Counters":
        return Counters(
            self.pbs_calls - since.pbs_calls,
            self.pbs_items - since.pbs_items,
            self.pbs_items_padded - since.pbs_items_padded,
        )


@dataclasses.dataclass
class MetricsRecord:
    name: str
    seconds: float
    pbs_calls: int
    pbs_items: int
    pbs_items_padded: int

    @property
    def pbs_per_sec(self) -> float:
        return self.pbs_items / self.seconds if self.seconds > 0 else 0.0

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "seconds": round(self.seconds, 4),
            "pbs_calls": self.pbs_calls,
            "pbs_items": self.pbs_items,
            "pbs_items_padded": self.pbs_items_padded,
            "pbs_per_sec": round(self.pbs_per_sec, 1),
        }


GLOBAL = Counters()
RECORDS: list[MetricsRecord] = []

# Under jax.lax.scan the loop body is traced ONCE but executed `length`
# times; engine scans wrap the trace in scan_scope(length) so dispatch
# counts reflect actual executions.
_SCAN_MULT = 1


@contextlib.contextmanager
def scan_scope(length: int):
    """Multiply PBS tallies recorded inside by `length` (lax.scan bodies)."""
    global _SCAN_MULT
    prev = _SCAN_MULT
    _SCAN_MULT = prev * int(length)
    try:
        yield
    finally:
        _SCAN_MULT = prev


# Execution-time counting (see module docstring): when enabled, counts are
# committed by an ordered io_callback at device-execution time, so they stay
# correct under caller-side jit caching and need no scan multiplier.
_EXEC_MODE = False


@contextlib.contextmanager
def exec_count_scope():
    """Count PBS at EXECUTION time (io_callback) while tracing inside this
    scope. Use for measurement runs over caller-jitted methods; adds one
    ordered host callback per PBS dispatch, so keep it out of production
    serving paths."""
    global _EXEC_MODE
    prev = _EXEC_MODE
    _EXEC_MODE = True
    try:
        yield
    finally:
        _EXEC_MODE = prev


def _exec_commit(n_items, n_padded):
    GLOBAL.pbs_calls += 1
    GLOBAL.pbs_items += int(n_items)
    GLOBAL.pbs_items_padded += int(n_padded)


def record_pbs(n_items: int, n_padded: int) -> None:
    """Called by ShortintContext on every batched-PBS dispatch."""
    if _EXEC_MODE:
        import numpy as _np
        from jax.experimental import io_callback

        # ordered=True: a no-output callback would otherwise be dead-code
        # eliminated; ordering also keeps counts deterministic.
        io_callback(_exec_commit, None, _np.int64(n_items),
                    _np.int64(n_padded), ordered=True)
        return
    GLOBAL.pbs_calls += _SCAN_MULT
    GLOBAL.pbs_items += int(n_items) * _SCAN_MULT
    GLOBAL.pbs_items_padded += int(n_padded) * _SCAN_MULT


@contextlib.contextmanager
def measure(name: str, sync=None):
    """Measure wall time + PBS tallies of a code block.

    sync: optional callable run before stopping the clock (e.g. a device
    fetch that fences async execution).
    """
    before = GLOBAL.snapshot()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync is not None:
            sync()
        dt = time.perf_counter() - t0
        d = GLOBAL.delta(before)
        RECORDS.append(MetricsRecord(
            name, dt, d.pbs_calls, d.pbs_items, d.pbs_items_padded))


def last() -> MetricsRecord | None:
    return RECORDS[-1] if RECORDS else None


def report() -> dict:
    """Summary of all recorded measurements + global tallies."""
    return {
        "global": {
            "pbs_calls": GLOBAL.pbs_calls,
            "pbs_items": GLOBAL.pbs_items,
            "pbs_items_padded": GLOBAL.pbs_items_padded,
        },
        "records": [r.as_dict() for r in RECORDS],
    }


def reset() -> None:
    GLOBAL.pbs_calls = GLOBAL.pbs_items = GLOBAL.pbs_items_padded = 0
    RECORDS.clear()
