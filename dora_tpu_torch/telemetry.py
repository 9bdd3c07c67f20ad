"""Trace plane of the serving node: the port's copy of the part of
dora_tpu/telemetry.py that the node and ``serve()`` use.

A trace context rides in message metadata under ``open_telemetry_context``
as a ``k:v;`` string. ``TRACING`` (``DORA_TRACING=1``) gates every
trace-plane action behind one attribute load; ``FLIGHT`` is the
process-wide flight-recorder ring that holds span records until the node
ships them to its daemon; ``ServingTracer`` records the request-lifecycle
spans of the serving loop and the engine through that ring.

The reference's XLA compile listener has no counterpart here: the serving
metrics' ``compiles`` is the engine's ``graph_captures``.
"""

from __future__ import annotations

import os
import time

OTEL_CTX_KEY = "open_telemetry_context"


def _env_on(key: str) -> bool:
    return os.environ.get(key, "") not in ("", "0")


class TracingState:
    """Process-wide tracing switch (``DORA_TRACING=1``); nodes call
    :meth:`configure_from_env` at startup so a knob set after import counts."""

    __slots__ = ("active",)

    def __init__(self, active: bool = False):
        self.active = active

    def configure_from_env(self) -> None:
        self.active = _env_on("DORA_TRACING")


TRACING = TracingState(_env_on("DORA_TRACING"))

_U64 = (1 << 64) - 1
_U128 = (1 << 128) - 1


class _IdGen:
    """Per-process random bases plus a counter (reseeded after a fork)."""

    __slots__ = ("pid", "span_base", "trace_base", "count")

    def __init__(self):
        self.pid = -1
        self.span_base = 0
        self.trace_base = 0
        self.count = 0

    def next(self) -> int:
        if self.pid != os.getpid():
            self.pid = os.getpid()
            self.span_base = int.from_bytes(os.urandom(8), "big")
            self.trace_base = int.from_bytes(os.urandom(16), "big")
            self.count = 0
        self.count += 1
        return self.count


_IDS = _IdGen()


def next_span_id() -> str:
    """16-hex span id."""
    n = _IDS.next()
    return format((_IDS.span_base + n) & _U64, "016x")


def next_trace_id() -> str:
    """32-hex trace id; the counter lands in the high half."""
    n = _IDS.next()
    return format((_IDS.trace_base + (n << 64)) & _U128, "032x")


def parse_otel_context(raw: str) -> dict[str, str]:
    out: dict[str, str] = {}
    for part in raw.split(";"):
        if ":" in part:
            k, _, v = part.partition(":")
            out[k] = v
    return out


def child_context(parent_ctx: str = "") -> str:
    """A serialized child trace context: ``parent_ctx``'s trace id (a fresh
    one if absent or malformed), a new span id."""
    trace_id = None
    if parent_ctx:
        parent = parse_otel_context(parent_ctx).get("traceparent")
        if parent and parent.count("-") == 3:
            trace_id = parent.split("-")[1]
    if trace_id is None:
        trace_id = next_trace_id()
    return f"traceparent:00-{trace_id}-{next_span_id()}-01;"


class FlightRecorder:
    """Fixed-size ring of timestamped events, slots ``[monotonic_ns,
    wall_ns, kind, a, b, c]`` mutated in place. On with
    ``DORA_FLIGHT_RECORDER=1`` or ``DORA_TRACING=1`` (size
    ``DORA_FLIGHT_RECORDER_SIZE``, default 4096); off, :meth:`record` is one
    attribute check. ``dropped`` counts events that wrapped out before
    :meth:`events_since` shipped them."""

    __slots__ = ("enabled", "dropped", "_slots", "_size", "_idx")

    def __init__(self, size: int = 4096, enabled: bool = False):
        self._size = max(1, size)
        self._slots = [[0, 0, "", None, None, None] for _ in range(self._size)]
        self._idx = 0
        self.enabled = enabled
        self.dropped = 0

    def configure_from_env(self) -> None:
        """Re-read the knobs; an off -> on switch clears the ring."""
        enabled = _env_on("DORA_FLIGHT_RECORDER") or _env_on("DORA_TRACING")
        size = int(os.environ.get("DORA_FLIGHT_RECORDER_SIZE", "0") or "0")
        if size > 0 and size != self._size:
            self._size = size
            self._slots = [[0, 0, "", None, None, None] for _ in range(size)]
            self._idx = 0
        if enabled and not self.enabled:
            self.clear()
        self.enabled = enabled

    def record(self, kind: str, a=None, b=None, c=None) -> None:
        if not self.enabled:
            return
        slot = self._slots[self._idx % self._size]
        slot[0] = time.monotonic_ns()
        slot[1] = time.time_ns()
        slot[2] = kind
        slot[3] = a
        slot[4] = b
        slot[5] = c
        self._idx += 1

    def _snapshot(self, start: int) -> list[tuple]:
        """Slots [start, idx) oldest first, less any prefix a concurrent
        writer advanced over while they were copied."""
        idx = self._idx
        start = max(start, idx - self._size)
        out = [tuple(self._slots[i % self._size]) for i in range(start, idx)]
        overrun = (self._idx - self._size) - start
        if overrun > 0:
            out = out[overrun:] if overrun < len(out) else []
        return [e for e in out if e[2]]

    def events(self) -> list[tuple]:
        return self._snapshot(self._idx - min(self._idx, self._size))

    def events_since(self, cursor: int) -> tuple[list[tuple], int]:
        """Events recorded since ``cursor`` (0 to start) and the new cursor."""
        idx = self._idx
        floor = idx - min(idx, self._size)
        if cursor < floor:
            self.dropped += floor - cursor
        return self._snapshot(max(cursor, floor)), idx

    def clear(self) -> None:
        self._idx = 0
        self.dropped = 0
        for slot in self._slots:
            slot[:] = [0, 0, "", None, None, None]

    def dump(self, file=None) -> None:
        import sys

        file = file or sys.stderr
        events = self.events()
        print(f"--- flight recorder ({len(events)} events, {self._idx} recorded total, "
              f"{self.dropped} dropped)", file=file)
        for mono, _wall, kind, a, b, c in events:
            extra = " ".join(str(x) for x in (a, b, c) if x is not None)
            print(f"  {mono} {kind} {extra}".rstrip(), file=file)
        file.flush()


FLIGHT = FlightRecorder(
    size=int(os.environ.get("DORA_FLIGHT_RECORDER_SIZE", "4096") or "4096"),
    enabled=_env_on("DORA_FLIGHT_RECORDER") or _env_on("DORA_TRACING"),
)


class ServingTracer:
    """Per-request lifecycle spans of the serving loop and the engine
    (``engine.tracer``), recorded through the flight-recorder ring: slot
    ``a`` = request key (+ detail), ``b`` = the request's serialized trace
    context, ``c`` = span duration in ns. :meth:`begin` derives the request's
    context from the carrier message's, so engine spans share its trace id.
    Every method is one attribute check when tracing is off."""

    __slots__ = ("_flight", "_tracing", "_ctx")

    def __init__(self, flight: FlightRecorder | None = None,
                 tracing: TracingState | None = None):
        self._flight = flight if flight is not None else FLIGHT
        self._tracing = tracing if tracing is not None else TRACING
        self._ctx: dict[str, str] = {}

    @property
    def active(self) -> bool:
        return self._tracing.active

    def begin(self, key: str, parent_ctx: str = "") -> None:
        if not self._tracing.active:
            return
        self._ctx[key] = child_context(parent_ctx)

    def span(self, kind: str, key: str, detail: str | None = None, dur_ns: int = 0) -> None:
        """One completed span, recorded at its end."""
        if not self._tracing.active:
            return
        self._flight.record(kind, f"{key} {detail}" if detail else key,
                            self._ctx.get(key), int(dur_ns))

    def instant(self, kind: str, key: str, detail: str | None = None) -> None:
        if not self._tracing.active:
            return
        self._flight.record(kind, f"{key} {detail}" if detail else key,
                            self._ctx.get(key), None)

    def finish(self, key: str, reason: str = "stop") -> None:
        """Close a request: ``s_finish``, and its context released."""
        ctx = self._ctx.pop(key, None)
        if not self._tracing.active:
            return
        self._flight.record("s_finish", f"{key} {reason}", ctx, 0)

    def context(self, key: str) -> str:
        """The request's serialized trace context ("" with tracing off or
        for an unknown key): checkpoints and migration handoffs carry it,
        so a resumed stream keeps its trace id."""
        return self._ctx.get(key) or ""

    def release(self, key: str) -> None:
        """Drop a request's context without an ``s_finish``: a stream that
        migrates away rather than finishing here."""
        self._ctx.pop(key, None)


def install_flight_dump() -> None:
    """``kill -USR2 <pid>`` dumps the ring to stderr (chains any earlier
    handler; off with DORA_NO_STACK_DUMP, or off the main thread)."""
    if os.environ.get("DORA_NO_STACK_DUMP"):
        return
    import signal

    try:
        previous = signal.getsignal(signal.SIGUSR2)

        def _handler(signum, frame):
            FLIGHT.dump()
            if callable(previous) and previous not in (signal.SIG_IGN, signal.SIG_DFL):
                previous(signum, frame)

        signal.signal(signal.SIGUSR2, _handler)
    except (ValueError, AttributeError, OSError):
        pass  # not the main thread / no SIGUSR2 here


def install_stack_dump() -> None:
    """``kill -USR1 <pid>`` dumps every Python stack to stderr (off with
    DORA_NO_STACK_DUMP)."""
    if os.environ.get("DORA_NO_STACK_DUMP"):
        return
    try:
        import faulthandler
        import signal

        faulthandler.register(signal.SIGUSR1, chain=True)
    except (ValueError, AttributeError, OSError):
        pass
