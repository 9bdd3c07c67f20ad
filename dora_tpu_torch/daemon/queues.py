"""Per-node event queues of the daemon with a bounded backlog per input
(dora_tpu/daemon/queues.py): each (node, input) holds at most its YAML
``queue_size`` (default 10) events; a push past it drops the input's
*oldest* queued event and releases that event's shared-memory drop token at
once, so the sender can reuse the region.
"""

from __future__ import annotations

import asyncio
import logging
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

from dora_tpu_torch.core.config import DEFAULT_QUEUE_SIZE
from dora_tpu_torch.message.serde import Timestamped
from dora_tpu_torch.telemetry import FLIGHT

logger = logging.getLogger(__name__)


@dataclass
class QueueEntry:
    #: decoded event, or None for fast-path entries that only ever exist
    #: as wire bytes (message/fastroute.py routes without object trees)
    event: Timestamped | None
    input_id: str | None = None  # set for Input events (drop-oldest scope)
    drop_token: str | None = None
    #: pre-encoded ``Timestamped(event)`` wire image; the events loop
    #: splices it into the NextEvents reply instead of re-encoding
    wire: bytes | None = None
    #: sender-side HLC physical ns (send→deliver latency histograms);
    #: 0 = unknown (close/stop events, which are never measured)
    send_ns: int = 0


@dataclass
class NodeEventQueue:
    """Events awaiting one node's next blocking NextEvent poll."""

    node_id: str
    queue_sizes: dict[str, int]  # input id -> bound
    on_token_unref: Callable[[str], None]  # release a dropped event's token
    entries: deque[QueueEntry] = field(default_factory=deque)
    input_counts: dict[str, int] = field(default_factory=dict)
    waiter: asyncio.Future | None = None
    closed: bool = False  # no more events will ever arrive
    #: DataflowMetrics hook; None = unmetered (tests)
    metrics: Any = None
    #: input id -> its "node/input" flight-recorder label, built once
    flight_labels: dict[str, str] = field(default_factory=dict)

    def _flight_label(self, input_id: str) -> str:
        label = self.flight_labels.get(input_id)
        if label is None:
            label = self.flight_labels[input_id] = f"{self.node_id}/{input_id}"
        return label

    def push(self, event: Timestamped | None, input_id: str | None = None,
             drop_token: str | None = None, wire: bytes | None = None,
             send_ns: int = 0) -> None:
        if self.closed:
            if drop_token is not None:
                self.on_token_unref(drop_token)
            return
        if input_id is not None:
            bound = self.queue_sizes.get(input_id, DEFAULT_QUEUE_SIZE)
            count = self.input_counts.get(input_id, 0)
            if count >= bound:
                self._drop_oldest(input_id)
            self.input_counts[input_id] = self.input_counts.get(input_id, 0) + 1
            if FLIGHT.enabled:
                FLIGHT.record("enqueue", self._flight_label(input_id),
                              self.input_counts[input_id])
        self.entries.append(QueueEntry(event, input_id, drop_token, wire,
                                       send_ns))
        self._wake()

    def _drop_oldest(self, input_id: str) -> None:
        for i, entry in enumerate(self.entries):
            if entry.input_id == input_id:
                del self.entries[i]
                self.input_counts[input_id] -= 1
                if entry.drop_token is not None:
                    self.on_token_unref(entry.drop_token)
                # Overflow shedding is the YAML's contract, not an error,
                # but never invisible: the metrics count it, debug logging
                # names the victim.
                logger.debug("queue overflow: dropped oldest event of %s/%s (depth %d)",
                             self.node_id, input_id, self.input_counts[input_id])
                if FLIGHT.enabled:
                    FLIGHT.record("drop_oldest", self._flight_label(input_id),
                                  self.input_counts[input_id])
                if self.metrics is not None:
                    self.metrics.count_drop(self.node_id, input_id)
                return

    def requeue_front(self, entries: list[QueueEntry]) -> None:
        """Put already-delivered entries back at the FRONT of the queue,
        in their original order — the replay path for a respawned node's
        un-acked in-flight inputs. Skips the per-input bound on purpose:
        these entries were inside the bound when first delivered, and
        dropping them here would turn a crash into silent input loss.
        A ``closed`` queue still accepts the replay: closed means the
        end-of-stream marker is queued, and pending entries drain before
        polls report end of stream — upstream finishing while the node
        was down must not eat the replay window."""
        for entry in reversed(entries):
            self.entries.appendleft(entry)
            if entry.input_id is not None:
                self.input_counts[entry.input_id] = (
                    self.input_counts.get(entry.input_id, 0) + 1
                )
        if entries:
            self._wake()

    def close(self) -> None:
        """Mark the stream closed: pending entries still drain, then polls
        return empty (= end of stream)."""
        self.closed = True
        self._wake()

    def release_all_tokens(self) -> None:
        """Stream abandoned (node died): ack every queued shmem token."""
        for entry in self.entries:
            if entry.drop_token is not None:
                self.on_token_unref(entry.drop_token)
        self.entries.clear()
        self.input_counts.clear()

    #: Events handed out per NextEvent poll — the frame-size/fairness
    #: ceiling on coalesced delivery, NOT the staleness bound. An event
    #: delivered to the node has left the drop-oldest domain, but the
    #: per-input exposure is already capped at push time: the queue never
    #: holds more than ``queue_size`` entries per input, so one batch
    #: cannot hand out more of an input than the YAML contract allows
    #: (a queue_size=1 camera input still yields at most 1 per poll).
    MAX_BATCH = 64

    async def next_batch(self) -> list[QueueEntry]:
        """Block until events are available (or the stream closes); hand
        out up to MAX_BATCH entries. Empty list = stream closed."""
        while not self.entries:
            if self.closed:
                return []
            if self.waiter is None or self.waiter.done():
                self.waiter = asyncio.get_running_loop().create_future()
            try:
                await self.waiter
            except asyncio.CancelledError:
                raise
        out = []
        while self.entries and len(out) < self.MAX_BATCH:
            entry = self.entries.popleft()
            if entry.input_id is not None:
                self.input_counts[entry.input_id] -= 1
            out.append(entry)
        return out

    def _wake(self) -> None:
        if self.waiter is not None and not self.waiter.done():
            self.waiter.set_result(None)


@dataclass
class DropQueue:
    """Released drop tokens awaiting the owning node's NextDropEvents poll."""

    tokens: list[str] = field(default_factory=list)
    waiter: asyncio.Future | None = None
    closed: bool = False

    def push(self, token: str) -> None:
        if self.closed:
            return
        self.tokens.append(token)
        self._wake()

    def close(self) -> None:
        self.closed = True
        self._wake()

    async def next_batch(self) -> list[str]:
        while not self.tokens:
            if self.closed:
                return []
            if self.waiter is None or self.waiter.done():
                self.waiter = asyncio.get_running_loop().create_future()
            await self.waiter
        out, self.tokens = self.tokens, []
        return out

    def _wake(self) -> None:
        if self.waiter is not None and not self.waiter.done():
            self.waiter.set_result(None)

