"""Peer-to-peer edges: the data plane of eligible local edges, straight
between two node processes (the port's copy of dora_tpu/node/p2p.py, the
same channel names, frames and acks, so a port node and a JAX node pair).

Through the daemon a message takes the sender's control channel, the
daemon's routing and the receiver's event channel. Here the daemon stays
the control plane only:

* A node creates one shared-memory channel (and its ack channel) per
  SENDER feeding it, grouping that sender's inputs so their relative order
  is the one the daemon's single per-receiver queue keeps, and announces
  the names (``P2PAnnounce``) BEFORE subscribing: by the time a sender can
  learn a name, the channel exists.
* At barrier release the daemon pairs the announced local endpoints per
  edge, stops routing those edges, and answers each sender's
  ``P2PEdgesRequest`` with its assignments.
* A send is one frame, the ``Timestamped(Input)`` the daemon would have
  delivered, encoded once for all the output's edges; payloads of the
  zero-copy threshold or more still travel as shared-memory regions, by
  name. The publishing thread writes the frame itself when the channel's
  previous frame was taken; else it waits in that channel's outbox, which
  a thread writes out, so the publishing loop waits for no receiver. The
  node writes every outbox out before it tells the daemon its outputs are
  done. Drop-token acks come back on the companion ack channel (the data
  channel's payload area is shared by its two directions), read by a
  thread a channel.
* The receiver's thread a sender reads every frame as it comes into the
  node's event store (node/events.py), which keeps the ``queue_size``
  contract per input with the oldest dropped (a dropped event releases its
  region as a consumed one does): a slow consumer never holds back the
  sender.

Timers, ``send_stdout_as`` outputs, C and C++ clients, dynamic nodes and
edges to other machines keep the daemon route; the daemon decides per
edge. ``DORA_P2P=0`` on either side turns it off.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
import uuid
from typing import Any

from dora_tpu_torch.message import daemon_to_node as d2n
from dora_tpu_torch.message import node_to_daemon as n2d
from dora_tpu_torch.message.common import SharedMemoryData
from dora_tpu_torch.message.serde import (
    decode_timestamped,
    encode_timestamped,
    encode_timestamped_inputs,
)
from dora_tpu_torch.native import Disconnected, ShmemChannel

logger = logging.getLogger(__name__)

#: capacity of an edge channel: metadata and region names, and inline
#: payloads below the zero-copy threshold
EDGE_CHANNEL_CAPACITY = 1 << 20

#: how long a sender retries opening an announced channel (the server
#: exists before the announcement; retries cover file-system visibility)
OPEN_RETRY_S = 5.0


def ack_name(channel_name: str) -> str:
    """The ack channel beside a data channel (receiver -> sender drop tokens)."""
    return channel_name + "-a"


class _EdgeServer:
    """Every inbound edge from ONE sender: a channel server and the thread
    that reads it into the node's event store. One channel a sender, not an
    input, so that sender's cross-input order survives."""

    def __init__(self, endpoint: "P2PEndpoint", sender: str, queue_sizes: dict[str, int],
                 channel: ShmemChannel, ack_channel: ShmemChannel):
        self.endpoint = endpoint
        self.sender = sender
        self.queue_sizes = {k: max(1, v) for k, v in queue_sizes.items()}
        self.channel = channel
        self.ack_channel = ack_channel
        #: the receive loop ended (its sender left, or the node closes);
        #: under the endpoint's ``settle`` condition, as ``last_idle`` is
        self.received_all = False
        #: the last time the channel was seen EMPTY (a recv timed out): the
        #: stream-end barrier reads it to know no frame is in flight
        self.last_idle = 0.0
        self._acks: list[str] = []
        self._acks_lock = threading.Lock()
        self.thread = threading.Thread(target=self._run, name=f"dora-p2p-{sender}",
                                       daemon=True)

    def settled(self, since: float) -> bool:
        """Every frame sent before ``since`` is in the event store: the
        receive loop ended, or saw the channel empty after ``since``."""
        return self.received_all or self.last_idle > since

    # -- acks (queued from GC finalizers, any thread) -------------------------

    def queue_ack(self, token: str) -> None:
        with self._acks_lock:
            self._acks.append(token)

    def push_final_acks(self, timeout: float = 0.5) -> None:
        """At close: push every ack to the sender before the ack channel goes
        (a frame sent before the disconnect is still read), so its regions
        come home now rather than at the end of its wait."""
        deadline = time.monotonic() + timeout
        while True:
            self._push_acks()
            with self._acks_lock:
                if not self._acks:
                    return
            if time.monotonic() >= deadline:
                return
            time.sleep(0.005)

    def _push_acks(self) -> None:
        """Push the acks gathered so far to the sender's ack reader; if the
        previous push is still unread, keep them for the next chance."""
        with self._acks_lock:
            if not self._acks:
                return
            acks = list(self._acks)
        frame = encode_timestamped(d2n.DropEvents(drop_tokens=acks), self.endpoint.node._clock)
        try:
            if self.ack_channel.try_send(frame):
                with self._acks_lock:
                    del self._acks[: len(acks)]
        except Exception:
            pass

    # -- the receive loop ---------------------------------------------------------

    def _run(self) -> None:
        endpoint = self.endpoint
        node, events, settle = endpoint.node, endpoint.events, endpoint.settle
        while not endpoint.closed.is_set():
            self._push_acks()
            try:
                frame = self.channel.recv(timeout=0.2)
            except Exception:
                break  # disconnected or closed
            if frame is None:
                with settle:
                    self.last_idle = time.monotonic()
                    settle.notify_all()
                continue
            try:
                inner = decode_timestamped(frame, node._clock).inner
                if isinstance(inner, d2n.Input):
                    data = inner.data
                    if isinstance(data, SharedMemoryData) and data.drop_token:
                        node._p2p_token_routes[data.drop_token] = self
                    event = events._convert(inner)
                    if event is not None:
                        events.put_direct(inner.id, event, self.queue_sizes.get(inner.id, 1))
                    del event
                # NextDropEvents frames only ask for the acks
            except Exception:
                logger.exception("p2p edges from %s: bad frame", self.sender)
        with settle:
            self.received_all = True
            settle.notify_all()


class _Outbox:
    """One receiver's channel on the sender's side: a frame is written by
    the publishing thread when the channel's previous frame was taken, else
    queued here, oldest first, for the writer thread (a blocking send);
    with the reader of the channel's acks."""

    def __init__(self, endpoint: "P2PEndpoint", edge):
        self.endpoint = endpoint
        self.receiver = f"{edge.receiver}/{edge.input_id}"
        self.channel = endpoint._open(edge.channel)
        self.ack_channel = endpoint._open(ack_name(edge.channel))
        #: (frame, drop token or None) not written yet
        self.frames: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._writing = False
        #: the receiver disconnected: nothing more can be written
        self.gone = False
        self._stopping = False
        self.writer = threading.Thread(target=self._write, name=f"dora-p2p-out-{edge.receiver}",
                                       daemon=True)
        self.reader = threading.Thread(target=endpoint._ack_reader, args=(self.ack_channel,),
                                       name=f"dora-p2p-acks-{edge.receiver}", daemon=True)
        self.writer.start()
        self.reader.start()

    def put(self, frame: bytes, token: str | None) -> None:
        with self._cond:
            if self.gone:
                raise Disconnected(f"p2p edge to {self.receiver} disconnected")
            if not self.frames and not self._writing:
                try:
                    if self.channel.try_send(frame):
                        return
                except Exception:
                    self._lose()
                    raise Disconnected(f"p2p edge to {self.receiver} disconnected") from None
            self.frames.append((frame, token))
            self._cond.notify_all()

    def _lose(self) -> list[str]:
        """The receiver is gone (under ``_cond``): the tokens of the frames
        never written, whose acks will not come."""
        self.gone = True
        lost = [t for _f, t in self.frames if t is not None]
        self.frames.clear()
        self._writing = False
        self._cond.notify_all()
        if not self._stopping:
            logger.warning("p2p edge to %s disconnected", self.receiver)
        return lost

    def _write(self) -> None:
        while True:
            with self._cond:
                while not self.frames:
                    if self._stopping or self.gone:
                        return
                    self._cond.wait()
                frame, token = self.frames.popleft()
                self._writing = True
            try:
                self.channel.send(frame)
            except Exception:
                with self._cond:
                    lost = self._lose() + ([token] if token is not None else [])
                self.endpoint.node._reclaim_regions(lost)
                return
            with self._cond:
                self._writing = False
                self._cond.notify_all()

    def drain(self, deadline: float) -> None:
        """Wait until every frame is written into the channel (or the
        receiver is gone, or ``deadline`` passed)."""
        with self._cond:
            while (self.frames or self._writing) and not self.gone:
                left = deadline - time.monotonic()
                if left <= 0:
                    return
                self._cond.wait(left)

    def stop(self) -> None:
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        for channel in (self.channel, self.ack_channel):
            try:
                channel.disconnect()
            except Exception:
                pass
        self.writer.join(timeout=2)
        self.reader.join(timeout=1)
        for channel in (self.channel, self.ack_channel):
            try:
                channel.close(unlink=False)
            except Exception:
                pass


class P2PEndpoint:
    """A node's peer-to-peer state: its inbound edge servers and its
    outbound assignments."""

    def __init__(self, node: Any):
        self.node = node
        self.events: Any = None  # the EventStream, attached after subscribing
        self.closed = threading.Event()
        #: notified when an edge sees its channel empty or its loop ends
        self.settle = threading.Condition()
        self.servers: dict[str, _EdgeServer] = {}
        #: input id -> channel name (inputs of one sender share a channel)
        self.listeners: dict[str, str] = {}
        #: output id -> d2n.P2POutput
        self.outbound: dict[str, Any] = {}
        #: channel name -> the outbox of that receiver's channel
        self._outboxes: dict[str, _Outbox] = {}
        self._out_lock = threading.Lock()
        for sender, inputs in self._inputs_by_sender(node).items():
            name = f"dtp-p2p-{uuid.uuid4().hex[:16]}"
            try:
                channel = ShmemChannel.create(name, EDGE_CHANNEL_CAPACITY)
                ack_channel = ShmemChannel.create(ack_name(name), 1 << 16)
            except Exception:
                logger.exception("p2p: channel create failed; edges from %s take the daemon "
                                 "route", sender)
                continue
            self.servers[sender] = _EdgeServer(self, sender, dict(inputs), channel, ack_channel)
            for input_id in inputs:
                self.listeners[input_id] = name

    @staticmethod
    def _inputs_by_sender(node) -> dict[str, dict[str, int]]:
        """{sender node id: {input id: queue size}} from the descriptor
        (timer inputs and fused sibling edges stay with the daemon)."""
        from dora_tpu_torch.core.config import UserMapping
        from dora_tpu_torch.core.descriptor import Descriptor

        try:
            me = Descriptor.parse(node._config.dataflow_descriptor).node(node._config.node_id)
            internal = me.fused_internal_inputs()
        except Exception:
            return {}
        out: dict[str, dict[str, int]] = {}
        for input_id, inp in me.inputs.items():
            if input_id in internal or not isinstance(inp.mapping, UserMapping):
                continue
            out.setdefault(str(inp.mapping.source), {})[str(input_id)] = inp.queue_size
        return out

    # -- lifecycle --------------------------------------------------------------

    def start(self, events) -> None:
        """Attach the event stream and start the edge threads (after the
        start barrier, before the first event is read)."""
        self.events = events
        events.barrier = self.barrier
        for server in self.servers.values():
            server.thread.start()

    def set_outbound(self, reply: d2n.P2PEdgesReply) -> None:
        self.outbound = dict(reply.outputs or {})

    def barrier(self, input_id: str | None = None) -> None:
        """Order of the stream's end: the daemon's AllInputsClosed (with
        ``input_id``, its InputClosed for that input) must not overtake the
        edge events in flight. A sender writes its outboxes out before its
        OutputsDone, so at most one frame an edge is still in the channel:
        wait until the edges (the one serving ``input_id``) have seen their
        channel EMPTY since the barrier began, or their receive loop ended;
        the node's close ends the wait."""
        servers = [s for s in self.servers.values()
                   if input_id is None or input_id in s.queue_sizes]
        start = time.monotonic()
        with self.settle:
            self.settle.wait_for(lambda: self.closed.is_set()
                                 or all(s.settled(start) for s in servers))

    # -- sender side ------------------------------------------------------------

    def publish(self, output_id: str, metadata, data) -> bool:
        """Publish on this output's edges. True when the daemon must still
        be sent the output (receivers off peer-to-peer)."""
        out = self.outbound.get(output_id)
        if out is None:
            return True
        token = data.drop_token if isinstance(data, SharedMemoryData) else None
        if token is not None:
            # one ack a direct receiver, and the daemon's if it routes too
            self.node._set_token_refs(token, len(out.edges) + (1 if out.daemon_route else 0))
        frames = encode_timestamped_inputs([edge.input_id for edge in out.edges], metadata,
                                           data, self.node._clock)
        for edge in out.edges:
            try:
                self._outbox(edge).put(frames[edge.input_id], token)
            except Disconnected:
                # the receiver is gone: count the ack that will not come
                if token is not None:
                    self.node._reclaim_regions([token])
        return out.daemon_route

    def _outbox(self, edge) -> _Outbox:
        with self._out_lock:
            outbox = self._outboxes.get(edge.channel)
            if outbox is None:
                outbox = self._outboxes[edge.channel] = _Outbox(self, edge)
            return outbox

    def drain_outboxes(self, timeout: float) -> None:
        """Write out every outbox (the node calls this before OutputsDone,
        so the daemon's InputClosed follows the last frame of each edge)."""
        deadline = time.monotonic() + timeout
        with self._out_lock:
            outboxes = list(self._outboxes.values())
        for outbox in outboxes:
            outbox.drain(deadline)

    def _ack_reader(self, channel: ShmemChannel) -> None:
        while not self.closed.is_set():
            try:
                frame = channel.recv(timeout=0.5)
            except Exception:
                return
            if frame is None:
                continue
            try:
                inner = decode_timestamped(frame, self.node._clock).inner
                if isinstance(inner, d2n.DropEvents) and inner.drop_tokens:
                    self.node._reclaim_regions(inner.drop_tokens)
            except Exception:
                continue

    @staticmethod
    def _open(name: str) -> ShmemChannel:
        deadline = time.monotonic() + OPEN_RETRY_S
        while True:
            try:
                return ShmemChannel.open(name)
            except Exception:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.01)

    def flush_acks(self) -> None:
        """Ping every outbound edge once, so receivers push their acks home
        (the close path's region wait)."""
        for out in self.outbound.values():
            for edge in out.edges:
                try:
                    self._outbox(edge).put(
                        encode_timestamped(n2d.NextDropEvents(), self.node._clock), None)
                except Exception:
                    continue

    def close(self) -> None:
        if self.closed.is_set():
            return
        self.closed.set()
        with self.settle:
            self.settle.notify_all()
        for server in self.servers.values():
            try:
                server.channel.disconnect()
            except Exception:
                pass
        for server in self.servers.values():
            if server.thread.ident is not None:
                server.thread.join(timeout=2)
            server.push_final_acks()
            try:
                server.ack_channel.disconnect()
                server.channel.close(unlink=True)
                server.ack_channel.close(unlink=True)
            except Exception:
                pass
        with self._out_lock:
            outboxes, self._outboxes = list(self._outboxes.values()), {}
        for outbox in outboxes:
            outbox.stop()
