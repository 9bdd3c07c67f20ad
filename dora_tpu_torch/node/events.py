"""Node-side events: the Event object and the thread that pumps the
daemon's blocking NextEvent loop (dora_tpu/node/events.py) into the store
that ``recv`` reads; the peer-to-peer edge threads (node/p2p.py) add theirs
to the same store.

``event["type"]`` is one of INPUT, INPUT_CLOSED, STOP, RELOAD, MIGRATE,
PROFILE and ERROR, and WAKE for the operator runtime
(:meth:`EventStream.wake`); an input's ``value`` is an Arrow array (read
without a copy, from shared memory when large) or, for raw payloads, bytes
or a view of the mapped region. A shared-memory payload is acknowledged to
its sender when the user drops the event."""

from __future__ import annotations

import collections
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
    """The node's events in arrival order, in one store that :meth:`recv`
    reads. A pump thread runs the daemon's blocking NextEvent loop into it,
    at most ``max_queue`` of its events at a time, so that while the consumer
    lags they wait in the daemon's per-input queues, where ``queue_size``
    applies; the peer-to-peer edge threads (node/p2p.py) add theirs with
    :meth:`put_direct`, which applies ``queue_size`` here. ``on_ack(token)``
    is called (from any thread, GC finalizers included) when user code drops
    an event whose payload lives in shared memory."""

    #: the daemon's events the store holds at most
    DEFAULT_MAX_QUEUE = 2

    def __init__(self, channel, on_ack=None, max_queue: int | None = None):
        self._channel = channel
        self._on_ack = on_ack
        self._max_daemon = max_queue or self.DEFAULT_MAX_QUEUE
        #: guards the store; notified on every add and take
        self._cond = threading.Condition()
        #: (input id of a peer-to-peer event, else None; event), oldest first
        self._items: collections.deque = collections.deque()
        #: the daemon's events in the store
        self._daemon_items = 0
        #: peer-to-peer input id -> its events in the store
        self._direct: dict[str, int] = {}
        self._wake_queued = False
        #: the pump ended the stream: recv returns None once the store is empty
        self._end = False
        self._closed = threading.Event()
        #: set by the pump once no further real events can arrive
        self._eos = threading.Event()
        #: ``barrier(input_id)`` is called before an INPUT_CLOSED is stored and
        #: ``barrier(None)`` before the end: the p2p endpoint returns once its
        #: edges' events are stored, so that the daemon's InputClosed /
        #: AllInputsClosed does not overtake direct events
        self.barrier = None
        #: shmem_id -> mapped region, kept for the stream's life (senders
        #: never reuse a region name after unlinking it); shared with the
        #: p2p edge threads
        self._regions: dict[str, ShmemRegion] = {}
        self._regions_guard = threading.Lock()
        self._thread = threading.Thread(target=self._run, name="dora-event-stream",
                                        daemon=True)
        self._thread.start()

    @property
    def ended(self) -> bool:
        """True once the stream closed and no real event remains stored."""
        with self._cond:
            if self._closed.is_set() and not self._items:
                return True
            if not self._eos.is_set():
                return False
            return all(event is self.WAKE for _origin, event in self._items)

    #: stored by :meth:`wake`; surfaces from :meth:`recv` as a WAKE event,
    #: which iteration skips (only the operator runtime's loop wakes itself)
    WAKE = Event(type="WAKE")

    def recv(self, timeout: float | None = None) -> Event | None:
        """Next event; None when the stream ended or ``timeout`` expired."""
        with self._cond:
            if not self._cond.wait_for(
                    lambda: self._items or self._end or self._closed.is_set(), timeout):
                return None
            if not self._items:
                self._closed.set()
                return None
            origin, event = self._items.popleft()
            if origin is not None:
                self._direct[origin] -= 1
            elif event is self.WAKE:
                self._wake_queued = False
            else:
                self._daemon_items -= 1
                self._cond.notify_all()  # room for the pump
            return event

    def wake(self) -> None:
        """Unpark a ``recv(None)`` parked on an empty store (the operator
        runtime's fetch-completion callback calls it from a worker thread).
        At most one WAKE waits in the store."""
        with self._cond:
            if not self._wake_queued:
                self._wake_queued = True
                self._items.append((None, self.WAKE))
                self._cond.notify_all()

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
        with self._cond:
            # the events never taken release their regions (their acks go
            # out as a consumed event's do)
            dropped, self._items = self._items, collections.deque()
            self._daemon_items = 0
            self._direct.clear()
            self._cond.notify_all()
        del dropped
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

    def put_direct(self, input_id: str, event: Event, queue_size: int) -> None:
        """Store a peer-to-peer event; past ``queue_size`` events of its input
        the oldest is dropped, as the daemon's queue drops it (its finalizer
        acks the region)."""
        dropped = None
        with self._cond:
            if self._closed.is_set():
                return
            self._items.append((input_id, event))
            count = self._direct.get(input_id, 0) + 1
            if count > queue_size:
                for i, (origin, _event) in enumerate(self._items):
                    if origin == input_id:
                        dropped = self._items[i]
                        del self._items[i]
                        count -= 1
                        break
            self._direct[input_id] = count
            self._cond.notify_all()
        del dropped

    def _put(self, event: Event) -> bool:
        """Store one of the daemon's events once there is room; gives up when
        the stream closes."""
        with self._cond:
            while self._daemon_items >= self._max_daemon and not self._closed.is_set():
                self._cond.wait(0.2)
            if self._closed.is_set():
                return False
            self._items.append((None, event))
            self._daemon_items += 1
            self._cond.notify_all()
            return True

    def _run(self) -> None:
        try:
            while not self._closed.is_set():
                reply = self._channel.request(n2d.NextEvent(drop_tokens=[]))
                if not isinstance(reply, d2n.NextEvents) or not reply.events:
                    break
                # The whole batch is read first: its shared-memory payloads
                # are mapped now, before the consumer frees room for them
                # (a closed sender's wait for its regions is bounded).
                ended, batch = False, []
                for ts in reply.events:
                    event = self._convert(ts.inner)
                    if event is _END:
                        ended = True
                        break
                    if event is not None:
                        batch.append(event)
                for event in batch:
                    if event.type == "INPUT_CLOSED" and self.barrier is not None:
                        self.barrier(event.id)
                    if not self._put(event):
                        return
                del batch, event
                if ended:
                    break
        except Exception as e:
            if not self._closed.is_set():
                self._put(Event(type="ERROR", error=str(e)))
        finally:
            if self.barrier is not None:
                try:
                    self.barrier(None)
                except Exception:
                    pass
            self._eos.set()
            with self._cond:
                self._end = True
                self._cond.notify_all()

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
        with self._regions_guard:
            region = self._regions.get(data.shmem_id)
            if region is None:
                region = self._regions[data.shmem_id] = ShmemRegion.open(data.shmem_id)
        view = memoryview(region)[: data.len]
        if arrow:
            from dora_tpu_torch.node.arrow import ipc_deserialize

            # The array pins the region's export count until it is dropped.
            return ipc_deserialize(view), data.drop_token
        return view, data.drop_token
