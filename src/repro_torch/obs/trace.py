"""Host-side span tracer: nested spans into a bounded ring buffer; port of
``repro.obs.trace``, a copy of its own.

The paper's thesis is that SCHEDULING decisions drive runtime, so the
interesting question about any run is *when* things happened (when a block
retired, when a re-arm wave fired, which ingest stalled a serve batch), not
just the end-of-run totals the ``Metrics`` classes carry. This module is the
host half of the observability layer:

  * :class:`TraceRecorder` — structured events (spans, instants, counter
    rows) appended to a ``deque`` ring buffer; overflow drops the OLDEST
    events and counts them (``dropped``), so a long-lived service can keep
    a recorder installed forever at bounded memory.
  * module-level ``install()`` / ``current()`` / ``recording()`` — the
    engines look the recorder up per call; with none installed,
    :func:`span` returns a shared no-op context whose cost is one global
    read, which keeps the instrumented hot paths free when tracing is off.
  * :func:`span` — nested-span context manager. The yielded handle carries
    ``t0``/``t1`` (seconds, relative to the recorder epoch) and
    ``set(**args)`` for results only known at exit (e.g. whether a
    repartition boundary actually fired).

The port keeps its own module state: a recorder installed here traces the
port's engines only, and one installed in ``repro.obs`` traces the JAX
package's only. Nothing in this module imports torch or touches device
state, so recording a span cannot perturb a trajectory. A span's clock
reads the host; the instrumented call sites end each span at a device read
that is already on their path (``engine.py``), so a span on the card
covers the device work it enqueued.

Timestamps are ``time.perf_counter()`` deltas (monotonic) against the
recorder's construction epoch; the Chrome-trace exporter
(:mod:`repro_torch.obs.export`) converts to microseconds.
"""
from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager

DEFAULT_CAPACITY = 65536  # events kept before the ring starts dropping


class SpanHandle:
    """Mutable view of an open span: ``set(**kw)`` attaches result args;
    ``t0``/``t1`` expose the measured window after the ``with`` exits
    (the engine interpolates per-superstep counter timestamps from
    them)."""

    __slots__ = ("name", "cat", "args", "t0", "t1")

    def __init__(self, name: str, cat: str, args: dict):
        self.name = name
        self.cat = cat
        self.args = args
        self.t0 = 0.0
        self.t1 = 0.0

    def set(self, **kw) -> None:
        self.args.update(kw)


class _NullSpan:
    """Shared do-nothing handle for the tracing-off path."""

    __slots__ = ()
    t0 = 0.0
    t1 = 0.0

    def set(self, **kw) -> None:
        pass


class _NullContext:
    """Reusable no-op context manager: one global read + one attribute
    call is the whole cost of an un-recorded span."""

    __slots__ = ()

    def __enter__(self):
        return _NULL_SPAN

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()
_NULL_CONTEXT = _NullContext()


class TraceRecorder:
    """Ring buffer of structured trace events.

    Event shapes (plain dicts, exporter-agnostic):
      ``{"type": "span", "name", "cat", "ts", "dur", "depth", "args"}``
      ``{"type": "instant", "name", "cat", "ts", "args"}``
      ``{"type": "counter", "name", "cat", "ts", "values"}``
    ``ts``/``dur`` are seconds relative to the recorder epoch.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self.events: deque = deque(maxlen=self.capacity)
        self.dropped = 0  # oldest events evicted by the ring
        self._epoch = time.perf_counter()
        self._depth = 0

    def now(self) -> float:
        return time.perf_counter() - self._epoch

    def _push(self, ev: dict) -> None:
        if len(self.events) == self.capacity:
            self.dropped += 1
        self.events.append(ev)

    @contextmanager
    def span(self, name: str, cat: str = "", **args):
        h = SpanHandle(name, cat, dict(args))
        h.t0 = self.now()
        self._depth += 1
        try:
            yield h
        finally:
            self._depth -= 1
            h.t1 = self.now()
            self._push({"type": "span", "name": name, "cat": cat,
                        "ts": h.t0, "dur": h.t1 - h.t0,
                        "depth": self._depth, "args": h.args})

    def instant(self, name: str, cat: str = "", **args) -> None:
        self._push({"type": "instant", "name": name, "cat": cat,
                    "ts": self.now(), "args": dict(args)})

    def counter_rows(self, name: str, rows: list, t0: float, t1: float,
                     cat: str = "engine") -> None:
        """Emit one counter event per row, timestamps interpolated
        UNIFORMLY across ``[t0, t1]``. This is how the fused engine's
        per-superstep timeline (exact counters, flushed once per chunk at
        the existing boundary sync) lands on the time axis: the counter
        VALUES are exact, their placement within the chunk's wall window
        is interpolated — the device does not timestamp supersteps."""
        k = len(rows)
        if k == 0:
            return
        step = (t1 - t0) / k
        for i, row in enumerate(rows):
            self._push({"type": "counter", "name": name, "cat": cat,
                        "ts": t0 + i * step,
                        "values": {k2: v for k2, v in row.items()
                                   if isinstance(v, (int, float))
                                   and not isinstance(v, bool)}})


# -- module-level installation ----------------------------------------------
_CURRENT: TraceRecorder | None = None


def install(recorder: TraceRecorder) -> TraceRecorder:
    """Make ``recorder`` the process-wide target of :func:`span` /
    :func:`instant`. Returns it (chaining convenience)."""
    global _CURRENT
    _CURRENT = recorder
    return recorder


def uninstall() -> None:
    global _CURRENT
    _CURRENT = None


def current() -> TraceRecorder | None:
    return _CURRENT


@contextmanager
def recording(capacity: int = DEFAULT_CAPACITY):
    """Install a fresh recorder for the duration of the block (restoring
    whatever was installed before): the test/bench-friendly entry point.

    >>> with recording() as rec:
    ...     engine.run()
    >>> export.write(rec, "results/trace_run.json")
    """
    global _CURRENT
    prev = _CURRENT
    rec = TraceRecorder(capacity)
    _CURRENT = rec
    try:
        yield rec
    finally:
        _CURRENT = prev


def span(name: str, cat: str = "", **args):
    """Span against the installed recorder; a shared no-op context when
    none is installed (the instrumented hot paths call this
    unconditionally)."""
    rec = _CURRENT
    if rec is None:
        return _NULL_CONTEXT
    return rec.span(name, cat, **args)


def instant(name: str, cat: str = "", **args) -> None:
    rec = _CURRENT
    if rec is not None:
        rec.instant(name, cat, **args)
