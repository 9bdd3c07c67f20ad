"""The node API of the port: ``Node``, a dataflow node that the JAX package's
daemon spawns and runs unchanged (dora_tpu/node/__init__.py's wire, byte for
byte).

Construct it from the environment (a spawned node reads the base64 wire
``NodeConfig`` in ``DORA_NODE_CONFIG``) or by node id (a dynamic node asks
the daemon's local listen port); iterate events; publish with
``send_output``, in shared memory for payloads of ``ZERO_COPY_THRESHOLD``
bytes or more. The node announces no peer-to-peer listeners, so the daemon
routes every edge of it, as it does a dynamic node's.

msgpack (the wire codec) is imported when the node first talks to its
daemon; pyarrow only when a payload is Arrow::

    from dora_tpu_torch.node import Node

    with Node() as node:
        for event in node:
            if event["type"] == "INPUT":
                node.send_output("out", event["value"])
"""

from __future__ import annotations

import base64
import os
import socket
import threading
import time
import uuid
from typing import Any

from dora_tpu_torch.clock import HLC
from dora_tpu_torch.core.topics import (
    DORA_DAEMON_LOCAL_LISTEN_PORT_DEFAULT,
    ZERO_COPY_THRESHOLD,
)
from dora_tpu_torch.message import daemon_to_node as d2n
from dora_tpu_torch.message import node_to_daemon as n2d
from dora_tpu_torch.message.common import (
    ENCODING_ARROW_IPC,
    ENCODING_RAW,
    InlineData,
    Metadata,
    SharedMemoryData,
    TypeInfo,
    new_drop_token,
)
from dora_tpu_torch.message.serde import decode, decode_timestamped, encode_timestamped
from dora_tpu_torch.native import ShmemRegion
from dora_tpu_torch.node.channels import DaemonChannel, DaemonError
from dora_tpu_torch.node.events import Event, EventStream
from dora_tpu_torch.transport.framing import recv_frame, send_frame

#: the env var a spawning daemon puts the node's config in
NODE_CONFIG_ENV = "DORA_NODE_CONFIG"

#: reusable shared-memory regions a node keeps
SHMEM_CACHE_REGIONS = 20

#: on close, wait this long for receivers to release our regions
DROP_TOKEN_WAIT_S = 10.0


def decode_node_config(value: str) -> d2n.NodeConfig:
    """The NodeConfig in a ``DORA_NODE_CONFIG`` value (base64 of the wire
    encoding, as dora_tpu/daemon/spawn.py writes it)."""
    cfg = decode(base64.b64decode(value.encode("ascii")))
    if not isinstance(cfg, d2n.NodeConfig):
        raise ValueError("DORA_NODE_CONFIG does not contain a NodeConfig")
    return cfg


class _DropStream:
    """Background thread receiving released drop tokens (our regions that no
    receiver references any more)."""

    def __init__(self, channel: DaemonChannel, on_tokens):
        self._channel = channel
        self._on_tokens = on_tokens
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._run, name="dora-drop-stream",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            while not self._closed.is_set():
                reply = self._channel.request(n2d.NextDropEvents())
                if not isinstance(reply, d2n.DropEvents) or not reply.drop_tokens:
                    break
                self._on_tokens(reply.drop_tokens)
        except Exception:
            pass

    def close(self) -> None:
        self._closed.set()
        try:
            self._channel.interrupt()
        except Exception:
            pass
        self._thread.join(timeout=2)
        try:
            self._channel.close()
        except Exception:
            pass


class Node:
    """One dataflow node (spawned by the daemon, or dynamic)."""

    #: flusher linger after a wake (only with output coalescing on)
    FLUSH_LINGER_S = 0.0002
    #: with tracing on, the flusher ships ring growth at least this often
    TRACE_FLUSH_S = 1.0

    def __init__(self, node_id: str | None = None, daemon_addr: str | None = None):
        from dora_tpu_torch.telemetry import (
            FLIGHT,
            TRACING,
            install_flight_dump,
            install_stack_dump,
        )

        install_stack_dump()
        TRACING.configure_from_env()
        FLIGHT.configure_from_env()
        if FLIGHT.enabled:
            install_flight_dump()
        self._flight = FLIGHT
        self._tracing = TRACING
        self._trace_cursor = 0
        self._trace_dropped_sent = 0
        #: per-output published message / byte counts (node-local view)
        self._send_counts: dict[str, list] = {}
        self._closed = True  # until the channels are up
        config = self._load_config(node_id, daemon_addr)
        self._config = config
        self.dataflow_id = config.dataflow_id
        self.node_id = config.node_id
        self._clock = HLC()
        comm = config.daemon_communication

        self._control = DaemonChannel.connect(comm, n2d.CHANNEL_CONTROL, config.dataflow_id,
                                              config.node_id, self._clock)
        self._regions_lock = threading.Lock()
        self._regions_in_use: dict[str, ShmemRegion] = {}  # token -> region
        self._regions_free: list[ShmemRegion] = []

        drop_channel = DaemonChannel.connect(comm, n2d.CHANNEL_DROP, config.dataflow_id,
                                             config.node_id, self._clock)
        drop_channel.request_ok(n2d.SubscribeDrop())
        self._drop_stream = _DropStream(drop_channel, self._reclaim_regions)

        # DORA_SEND_COALESCE: buffer sub-threshold inline outputs and write
        # them as one once this many bytes wait (0 / unset: off).
        self._coalesce = int(os.environ.get("DORA_SEND_COALESCE", "0") or "0")
        # The flusher drains receiver-side drop-token acks (queued by GC
        # finalizers), coalesced outputs and trace reports in one write.
        self._ack_cond = threading.Condition()
        self._pending_acks: list[str] = []
        self._ack_closing = False
        self._ack_thread = threading.Thread(target=self._flush_loop, name="dora-flusher",
                                            daemon=True)
        self._ack_thread.start()

        events_channel = DaemonChannel.connect(comm, n2d.CHANNEL_EVENTS, config.dataflow_id,
                                               config.node_id, self._clock)
        # Blocks until every node of the dataflow subscribed (start barrier).
        events_channel.request_ok(n2d.Subscribe())
        self._events = EventStream(events_channel, on_ack=self._queue_ack)
        self._closed = False

    @staticmethod
    def _load_config(node_id: str | None, daemon_addr: str | None) -> d2n.NodeConfig:
        raw = os.environ.get(NODE_CONFIG_ENV)
        if raw and node_id is None:
            return decode_node_config(raw)
        if node_id is None:
            raise RuntimeError(f"Node() must be started by a daemon ({NODE_CONFIG_ENV} is not "
                               "set); pass node_id=... for a dynamic node")
        addr = daemon_addr or f"127.0.0.1:{DORA_DAEMON_LOCAL_LISTEN_PORT_DEFAULT}"
        host, _, port = addr.rpartition(":")
        clock = HLC()
        with socket.create_connection((host, int(port)), timeout=10) as sock:
            send_frame(sock, encode_timestamped(n2d.NodeConfigRequest(node_id=node_id), clock))
            reply = decode_timestamped(recv_frame(sock), clock).inner
        if not isinstance(reply, d2n.NodeConfigReply):
            raise RuntimeError(f"unexpected reply {type(reply).__name__}")
        if reply.error:
            raise RuntimeError(f"dynamic node init failed: {reply.error}")
        return reply.node_config

    # -- events ----------------------------------------------------------------

    def recv(self, timeout: float | None = None) -> Event | None:
        """Next event; None when the stream ended or ``timeout`` expired."""
        return self._events.recv(timeout)

    next = recv

    def wake(self) -> None:
        """Unpark a parked :meth:`recv` with a ``WAKE`` event (thread-safe;
        the operator runtime's pipelined loop calls it when a fetch ends)."""
        self._events.wake()

    @property
    def stream_ended(self) -> bool:
        return self._events.ended

    def __iter__(self):
        return iter(self._events)

    # -- outputs ---------------------------------------------------------------

    def send_output(self, output_id: str, data: Any = None, metadata: dict | None = None) -> None:
        """Publish one output. ``data`` may be an Arrow array, a numpy array,
        a list, bytes or None; lists and arrays travel as Arrow IPC,
        payloads of ZERO_COPY_THRESHOLD bytes or more in shared memory."""
        if output_id not in self._config.run_config.outputs:
            raise DaemonError(f"node {self.node_id!r} has no output {output_id!r} "
                              f"(declared: {self._config.run_config.outputs})")
        params = dict(metadata or {})
        if data is None:
            type_info = TypeInfo(encoding=ENCODING_RAW, len=0)
            message_data: Any = None
        elif isinstance(data, (bytes, bytearray, memoryview)):
            raw = bytes(data)
            type_info = TypeInfo(encoding=ENCODING_RAW, len=len(raw))
            if len(raw) >= ZERO_COPY_THRESHOLD:
                region, token = self._alloc_region(len(raw))
                memoryview(region)[: len(raw)] = raw
                message_data = SharedMemoryData(shmem_id=region.name, len=len(raw),
                                                drop_token=token)
            else:
                message_data = InlineData(data=raw)
        else:
            from dora_tpu_torch.node.arrow import (
                ipc_max_size,
                ipc_serialize,
                ipc_serialize_into,
                to_arrow,
            )

            arr = to_arrow(data)
            max_size = ipc_max_size(arr)
            if max_size >= ZERO_COPY_THRESHOLD:
                region, token = self._alloc_region(max_size)
                written = ipc_serialize_into(arr, memoryview(region))
                message_data = SharedMemoryData(shmem_id=region.name, len=written,
                                                drop_token=token)
                type_info = TypeInfo(encoding=ENCODING_ARROW_IPC, len=written)
            else:
                payload = ipc_serialize(arr)
                type_info = TypeInfo(encoding=ENCODING_ARROW_IPC, len=len(payload))
                message_data = InlineData(data=payload)
        self._publish(output_id, Metadata(type_info=type_info, parameters=params),
                      message_data)

    def _publish(self, output_id: str, metadata: Metadata, data: Any) -> None:
        """Route one output through the daemon. With tracing on, a child
        trace context goes into the metadata and the publish is recorded as
        a ``t_send`` span."""
        if not self._tracing.active:
            return self._publish_inner(output_id, metadata, data)
        from dora_tpu_torch.telemetry import OTEL_CTX_KEY, child_context

        params = metadata.parameters
        ctx = child_context(str(params.get(OTEL_CTX_KEY, "")))
        params[OTEL_CTX_KEY] = ctx
        t0 = time.monotonic_ns()
        try:
            return self._publish_inner(output_id, metadata, data)
        finally:
            self._flight.record("t_send", output_id, ctx, time.monotonic_ns() - t0)

    def _publish_inner(self, output_id: str, metadata: Metadata, data: Any) -> None:
        counts = self._send_counts.setdefault(output_id, [0, 0])
        counts[0] += 1
        counts[1] += metadata.type_info.len
        if self._flight.enabled:
            self._flight.record("send", output_id, metadata.type_info.len)
        msg = n2d.SendMessage(output_id=output_id, metadata=metadata, data=data)
        if self._coalesce and (data is None or isinstance(data, InlineData)):
            # Inline outputs only: a shared-memory payload's drop token must
            # not wait in a sender-side buffer.
            if self._control.queue(msg) >= self._coalesce:
                self._control.flush()
            else:
                with self._ack_cond:
                    self._ack_cond.notify()
            return
        self._control.request(msg)

    def flush(self) -> None:
        """Flush coalesced outputs now (DORA_SEND_COALESCE)."""
        self._control.flush()

    def _report(self, msg) -> None:
        self._control.queue(msg)
        self._control.flush()

    def report_serving(self, snapshot: dict) -> None:
        """Ship a ServingMetrics snapshot to the daemon, fire-and-forget."""
        self._report(n2d.ReportServing(snapshot=dict(snapshot)))

    def report_engine_state(self, digest) -> None:
        """Ship a fleet digest (EngineStateDigest), fire-and-forget."""
        self._report(n2d.ReportEngineState(digest=digest))

    def report_profile(self, artifact: str, error: str | None = None) -> None:
        """Report a finished deep capture's artifact path (or failure)."""
        self._report(n2d.ReportProfile(artifact=artifact, error=error))

    def allocate_sample(self, size: int) -> "DataSample":
        """A writable sample, backed by a shared-memory region from
        ZERO_COPY_THRESHOLD bytes on: fill ``sample.view[:n]`` and publish
        with :meth:`send_sample`, with no producer-side copy."""
        if size < ZERO_COPY_THRESHOLD:
            return DataSample(self, None, None, bytearray(size))
        region, token = self._alloc_region(size)
        return DataSample(self, region, token, None)

    def send_sample(self, output_id: str, sample: "DataSample", length: int,
                    metadata: dict | None = None, encoding: str = ENCODING_RAW) -> None:
        """Publish a filled sample (shared-memory samples without a copy)."""
        if output_id not in self._config.run_config.outputs:
            raise DaemonError(f"node {self.node_id!r} has no output {output_id!r}")
        if sample._sent:
            raise DaemonError("sample was already sent")
        sample._sent = True
        if sample._region is not None:
            message_data: Any = SharedMemoryData(shmem_id=sample._region.name, len=length,
                                                 drop_token=sample._token)
        else:
            message_data = InlineData(data=bytes(sample._inline[:length]))
        self._publish(output_id,
                      Metadata(type_info=TypeInfo(encoding=encoding, len=length),
                               parameters=dict(metadata or {})),
                      message_data)

    # -- shared-memory regions ---------------------------------------------------

    def _alloc_region(self, size: int) -> tuple[ShmemRegion, str]:
        token = new_drop_token()
        with self._regions_lock:
            for i, region in enumerate(self._regions_free):
                if region.size >= size:
                    del self._regions_free[i]
                    self._regions_in_use[token] = region
                    return region, token
        # Powers of two: fewer distinct sizes across varying payloads.
        region = ShmemRegion.create(f"dtp-{uuid.uuid4().hex[:16]}",
                                    max(4096, 1 << (size - 1).bit_length()))
        with self._regions_lock:
            self._regions_in_use[token] = region
        return region, token

    def _queue_ack(self, token: str) -> None:
        with self._ack_cond:
            self._pending_acks.append(token)
            self._ack_cond.notify()

    def _queue_trace_report(self) -> None:
        """Queue the ring's growth since the last report as a ReportTrace; a
        wrap loss ships as a ``trace_truncated`` event (count in slot a)."""
        events, self._trace_cursor = self._flight.events_since(self._trace_cursor)
        dropped = self._flight.dropped
        if dropped > self._trace_dropped_sent:
            lost = dropped - self._trace_dropped_sent
            self._trace_dropped_sent = dropped
            events = [(time.monotonic_ns(), time.time_ns(), "trace_truncated", lost, None,
                       None)] + list(events)
        if events:
            self._control.queue(n2d.ReportTrace(events=[list(e) for e in events]))

    def _flush_loop(self) -> None:
        while True:
            with self._ack_cond:
                while (not self._pending_acks and self._control.buffered_bytes == 0
                       and not self._ack_closing):
                    if self._tracing.active:
                        if not self._ack_cond.wait(self.TRACE_FLUSH_S):
                            break  # idle tick: ship ring growth
                    else:
                        self._ack_cond.wait()
                if (self._ack_closing and not self._pending_acks
                        and self._control.buffered_bytes == 0):
                    return
            if self._coalesce and not self._ack_closing:
                time.sleep(self.FLUSH_LINGER_S)
            with self._ack_cond:
                tokens, self._pending_acks = self._pending_acks, []
            try:
                if tokens:
                    self._control.queue(n2d.ReportDropTokens(drop_tokens=tokens))
                if self._tracing.active:
                    self._queue_trace_report()
                self._control.flush()
            except Exception:
                return

    def _reclaim_regions(self, tokens: list[str]) -> None:
        with self._regions_lock:
            for token in tokens:
                region = self._regions_in_use.pop(token, None)
                if region is None:
                    continue
                if len(self._regions_free) < SHMEM_CACHE_REGIONS:
                    self._regions_free.append(region)
                else:
                    try:
                        region.close(unlink=True, force=True)
                    except Exception:
                        pass

    # -- misc ------------------------------------------------------------------

    def dataflow_descriptor(self) -> dict:
        return self._config.dataflow_descriptor

    @property
    def config(self) -> d2n.NodeConfig:
        return self._config

    def close(self) -> None:
        """Report outputs done, wait (at most DROP_TOKEN_WAIT_S) for receivers
        to release our regions, close the channels and unlink the regions."""
        if self._closed:
            return
        self._closed = True
        # Surface straggler events so their finalizers queue acks, then let
        # the flusher drain before reporting done.
        self._events.close()
        with self._ack_cond:
            self._ack_closing = True
            self._ack_cond.notify()
        self._ack_thread.join(timeout=2)
        try:
            if self._tracing.active:
                self._queue_trace_report()
            self._control.request_ok(n2d.OutputsDone())
        except Exception:
            pass
        deadline = time.monotonic() + DROP_TOKEN_WAIT_S
        while time.monotonic() < deadline:
            with self._regions_lock:
                if not self._regions_in_use:
                    break
            time.sleep(0.05)
        self._drop_stream.close()
        try:
            self._control.close()
        except Exception:
            pass
        with self._regions_lock:
            for region in list(self._regions_in_use.values()) + self._regions_free:
                try:
                    region.close(unlink=True, force=True)
                except Exception:
                    pass
            self._regions_in_use.clear()
            self._regions_free.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class DataSample:
    """A writable payload buffer, in shared memory from ZERO_COPY_THRESHOLD
    bytes on."""

    __slots__ = ("_node", "_region", "_token", "_inline", "_sent")

    def __init__(self, node, region, token, inline):
        self._node = node
        self._region = region
        self._token = token
        self._inline = inline
        self._sent = False

    @property
    def view(self) -> memoryview:
        """The writable bytes (hold no slice of it past the send)."""
        if self._region is not None:
            return memoryview(self._region)
        return memoryview(self._inline)

    def __len__(self) -> int:
        return self._region.size if self._region is not None else len(self._inline)


__all__ = ["Node", "Event", "DataSample", "DaemonError", "NODE_CONFIG_ENV",
           "decode_node_config"]
