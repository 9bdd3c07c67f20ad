"""Node-side events: the Event object and the thread that pumps the
daemon's blocking NextEvent loop (dora_tpu/node/events.py, without the
peer-to-peer edges).

``event["type"]`` is one of INPUT, INPUT_CLOSED, STOP, RELOAD, MIGRATE,
PROFILE and ERROR, and WAKE for the operator runtime
(:meth:`EventStream.wake`); an input's ``value`` is an Arrow array (read
without a copy, from shared memory when large) or, for raw payloads, bytes
or a view of the mapped region. A shared-memory payload is acknowledged to
its sender when the user drops the event."""

from __future__ import annotations

import queue as queue_mod
import threading
import weakref
from typing import Any

from dora_tpu_torch.message import daemon_to_node as d2n
from dora_tpu_torch.message import node_to_daemon as n2d
from dora_tpu_torch.message.common import ENCODING_ARROW_IPC, InlineData, SharedMemoryData
from dora_tpu_torch.native import ShmemRegion
from dora_tpu_torch.telemetry import FLIGHT, OTEL_CTX_KEY, TRACING

#: pump-internal marker: the daemon closed the stream (AllInputsClosed)
_END = object()


class Event:
    """One dataflow event, dict-like."""

    __slots__ = ("type", "id", "value", "metadata", "error", "operator_id", "_ack",
                 "__weakref__")

    def __init__(self, type: str, id: str | None = None, value: Any = None,
                 metadata: dict | None = None, error: str | None = None,
                 operator_id: str | None = None):
        self.type = type
        self.id = id
        self.value = value
        self.metadata = metadata or {}
        self.error = error
        self.operator_id = operator_id
        self._ack = None

    def __getitem__(self, key: str) -> Any:
        try:
            return getattr(self, key)
        except AttributeError:
            raise KeyError(key) from None

    def get(self, key: str, default: Any = None) -> Any:
        return getattr(self, key, default)

    def __contains__(self, key: str) -> bool:
        return hasattr(self, key) and getattr(self, key) is not None

    def __repr__(self) -> str:
        parts = [f"type={self.type!r}"]
        if self.id:
            parts.append(f"id={self.id!r}")
        if self.error:
            parts.append(f"error={self.error!r}")
        return f"Event({', '.join(parts)})"


class EventStream:
    """Background thread pumping the blocking NextEvent loop into a small
    local queue. ``on_ack(token)`` is called (from any thread, GC finalizers
    included) when user code drops an event whose payload lives in shared
    memory."""

    #: local buffer bound: small, so that while the consumer lags events back
    #: up in the daemon's per-input queues, where ``queue_size`` applies
    DEFAULT_MAX_QUEUE = 2

    def __init__(self, channel, on_ack=None, max_queue: int | None = None):
        self._channel = channel
        self._on_ack = on_ack
        self._queue: queue_mod.Queue = queue_mod.Queue(max_queue or self.DEFAULT_MAX_QUEUE)
        self._closed = threading.Event()
        #: set by the pump once no further real events can arrive
        self._eos = threading.Event()
        #: shmem_id -> mapped region, kept for the stream's life (senders
        #: never reuse a region name after unlinking it)
        self._regions: dict[str, ShmemRegion] = {}
        self._thread = threading.Thread(target=self._run, name="dora-event-stream",
                                        daemon=True)
        self._thread.start()

    @property
    def ended(self) -> bool:
        """True once the stream closed and no real event remains queued."""
        if self._closed.is_set() and self._queue.empty():
            return True
        if not self._eos.is_set():
            return False
        with self._queue.mutex:
            return all(item is None or item is self.WAKE for item in self._queue.queue)

    #: queued by :meth:`wake`; surfaces from :meth:`recv` as a WAKE event,
    #: which iteration skips (only the operator runtime's loop wakes itself)
    WAKE = Event(type="WAKE")

    def recv(self, timeout: float | None = None) -> Event | None:
        """Next event; None when the stream ended or ``timeout`` expired."""
        if self._closed.is_set() and self._queue.empty():
            return None
        try:
            item = self._queue.get(timeout=timeout)
        except queue_mod.Empty:
            return None
        if item is None:
            self._closed.set()
            return None
        return item

    def wake(self) -> None:
        """Unpark a ``recv(None)`` parked on an empty queue (the operator
        runtime's fetch-completion callback calls it from a worker thread).
        Lossy by design: with the queue full, recv is not parked."""
        try:
            self._queue.put_nowait(self.WAKE)
        except queue_mod.Full:
            pass

    def __iter__(self):
        while True:
            event = self.recv()
            if event is None:
                return
            if event is self.WAKE:
                continue
            yield event

    def close(self) -> None:
        self._closed.set()
        try:
            self._channel.interrupt()  # wake the pump if parked in recv
        except Exception:
            pass
        self._thread.join(timeout=2)
        try:
            self._channel.close()
        except Exception:
            pass
        for region in self._regions.values():
            try:
                # Never forced: user code may still hold arrays viewing the
                # region; such regions stay mapped until the process exits.
                region.close(unlink=False)
            except Exception:
                pass
        self._regions.clear()

    def _put(self, item) -> bool:
        """Blocking put that gives up once the stream closes."""
        while not self._closed.is_set():
            try:
                self._queue.put(item, timeout=0.2)
                return True
            except queue_mod.Full:
                continue
        return False

    def _run(self) -> None:
        try:
            while not self._closed.is_set():
                reply = self._channel.request(n2d.NextEvent(drop_tokens=[]))
                if not isinstance(reply, d2n.NextEvents) or not reply.events:
                    break
                ended = False
                for ts in reply.events:
                    event = self._convert(ts.inner)
                    if event is _END:
                        # Only the queued None sentinel may end the stream:
                        # setting _closed here would disarm the sentinel put
                        # below while the consumer is parked in get().
                        ended = True
                        break
                    if event is not None and not self._put(event):
                        return
                if ended:
                    break
        except Exception as e:
            if not self._closed.is_set():
                self._put(Event(type="ERROR", error=str(e)))
        finally:
            self._eos.set()
            while not self._closed.is_set():
                try:
                    self._queue.put(None, timeout=0.2)
                    break
                except queue_mod.Full:
                    continue

    def _convert(self, inner: Any) -> Event | None:
        if isinstance(inner, d2n.Input):
            value, token = self._reconstruct(inner)
            event = Event(type="INPUT", id=inner.id, value=value,
                          metadata=dict(inner.metadata.parameters))
            if TRACING.active:
                ctx = event.metadata.get(OTEL_CTX_KEY)
                if ctx:
                    FLIGHT.record("t_recv", inner.id, str(ctx), 0)
            if token is not None:
                # Acked when the user drops the event; the sender then
                # reuses the region.
                event._ack = weakref.finalize(event, self._queue_ack, token)
            return event
        if isinstance(inner, d2n.InputClosed):
            return Event(type="INPUT_CLOSED", id=inner.id)
        if isinstance(inner, d2n.AllInputsClosed):
            return _END
        if isinstance(inner, d2n.Stop):
            return Event(type="STOP")
        if isinstance(inner, d2n.Reload):
            return Event(type="RELOAD", operator_id=inner.operator_id)
        if isinstance(inner, d2n.Migrate):
            return Event(type="MIGRATE", metadata={"handoff_dir": inner.handoff_dir})
        if isinstance(inner, d2n.Profile):
            return Event(type="PROFILE",
                         metadata={"action": inner.action, "seconds": inner.seconds})
        return None

    def _queue_ack(self, token: str) -> None:
        if self._on_ack is not None:
            try:
                self._on_ack(token)
            except Exception:
                pass

    def _reconstruct(self, inner: d2n.Input) -> tuple[Any, str | None]:
        """The payload value, read in place for shared-memory data."""
        data = inner.data
        arrow = inner.metadata.type_info.encoding == ENCODING_ARROW_IPC
        if data is None:
            return None, None
        if isinstance(data, InlineData):
            if arrow:
                from dora_tpu_torch.node.arrow import ipc_deserialize

                return ipc_deserialize(data.data), None
            return data.data, None
        if not isinstance(data, SharedMemoryData):
            raise TypeError(f"unknown payload {type(data).__name__}")
        region = self._regions.get(data.shmem_id)
        if region is None:
            region = self._regions[data.shmem_id] = ShmemRegion.open(data.shmem_id)
        view = memoryview(region)[: data.len]
        if arrow:
            from dora_tpu_torch.node.arrow import ipc_deserialize

            # The array pins the region's export count until it is dropped.
            return ipc_deserialize(view), data.drop_token
        return view, data.drop_token
