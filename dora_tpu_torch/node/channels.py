"""The node's request-reply channels to its daemon (dora_tpu/node/
channels.py): over TCP, a Unix socket or the shared-memory channel, each
opened with a Register exchange."""

from __future__ import annotations

import socket
import threading
from typing import Any

from dora_tpu_torch import PROTOCOL_VERSION
from dora_tpu_torch.message import daemon_to_node as d2n
from dora_tpu_torch.message import node_to_daemon as n2d
from dora_tpu_torch.message.serde import decode_timestamped, encode_timestamped
from dora_tpu_torch.native import Disconnected, ShmemChannel
from dora_tpu_torch.telemetry import FLIGHT
from dora_tpu_torch.transport.framing import recv_frame, send_frame, send_frames


class DaemonError(RuntimeError):
    """The daemon rejected a request."""


class _SocketTransport:
    def __init__(self, sock: socket.socket):
        self.sock = sock

    def send(self, payload: bytes) -> None:
        send_frame(self.sock, payload)

    def send_many(self, payloads: list[bytes]) -> None:
        send_frames(self.sock, payloads)

    def recv(self) -> bytes:
        return recv_frame(self.sock)

    def interrupt(self) -> None:
        """Wake a thread blocked in recv."""
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass

    def close(self) -> None:
        self.interrupt()
        self.sock.close()


class _ShmemTransport:
    def __init__(self, channel: ShmemChannel):
        self.channel = channel

    def send(self, payload: bytes) -> None:
        self.channel.send(payload)

    def send_many(self, payloads: list[bytes]) -> None:
        # One slot per message: frames cannot be joined.
        for payload in payloads:
            self.channel.send(payload)

    def recv(self) -> bytes:
        data = self.channel.recv(timeout=None)
        if data is None:
            raise Disconnected("shmem channel closed")
        return data

    def interrupt(self) -> None:
        """Set the disconnect flag: wakes a blocked recv without freeing the
        native handle under it."""
        self.channel.disconnect()

    def close(self) -> None:
        self.channel.disconnect()
        self.channel.close()


class DaemonChannel:
    """One registered request-reply channel to the daemon. Fire-and-forget
    messages may be buffered with :meth:`queue` and flushed as one write;
    :meth:`request` flushes the buffer first, so the daemon sees the order
    they were sent in."""

    def __init__(self, transport, clock):
        self._transport = transport
        self._clock = clock
        # Held across send AND recv: request() is the channel's
        # serialization point.
        self._lock = threading.Lock()
        self._pending: list[bytes] = []
        self._pending_bytes = 0
        self.closed = False

    @classmethod
    def connect(cls, comm: Any, channel_kind: str, dataflow_id: str, node_id: str,
                clock) -> "DaemonChannel":
        if isinstance(comm, d2n.TcpCommunication):
            host, _, port = comm.socket_addr.rpartition(":")
            sock = socket.create_connection((host, int(port)))
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            transport: Any = _SocketTransport(sock)
        elif isinstance(comm, d2n.UnixDomainCommunication):
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.connect(comm.socket_file)
            transport = _SocketTransport(sock)
        elif isinstance(comm, d2n.ShmemCommunication):
            region = {
                n2d.CHANNEL_CONTROL: comm.control_region_id,
                n2d.CHANNEL_EVENTS: comm.events_region_id,
                n2d.CHANNEL_DROP: comm.drop_region_id,
            }[channel_kind]
            transport = _ShmemTransport(ShmemChannel.open(region))
        else:
            raise ValueError(f"unknown daemon communication {comm!r}")
        channel = cls(transport, clock)
        reply = channel.request(n2d.Register(dataflow_id=dataflow_id, node_id=node_id,
                                             protocol_version=PROTOCOL_VERSION,
                                             channel=channel_kind))
        if isinstance(reply, d2n.ReplyResult) and reply.error:
            channel.close()
            raise DaemonError(f"register failed: {reply.error}")
        return channel

    def _flush_locked(self) -> None:
        if self._pending:
            pending, self._pending = self._pending, []
            nbytes, self._pending_bytes = self._pending_bytes, 0
            if FLIGHT.enabled:
                FLIGHT.record("coalesce_flush", len(pending), nbytes)
            self._transport.send_many(pending)

    def request(self, msg: Any) -> Any:
        """Send one request and, if its kind expects one, wait for the reply."""
        with self._lock:
            self._flush_locked()
            self._transport.send(encode_timestamped(msg, self._clock))
            if not n2d.expects_reply(msg):
                return None
            frame = self._transport.recv()
        return decode_timestamped(frame, self._clock).inner

    def queue(self, msg: Any) -> int:
        """Buffer a fire-and-forget message; returns the bytes buffered."""
        if n2d.expects_reply(msg):
            raise ValueError(f"{type(msg).__name__} expects a reply and cannot be queued")
        frame = encode_timestamped(msg, self._clock)
        with self._lock:
            self._pending.append(frame)
            self._pending_bytes += len(frame)
            return self._pending_bytes

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    @property
    def buffered_bytes(self) -> int:
        return self._pending_bytes

    def request_ok(self, msg: Any) -> None:
        reply = self.request(msg)
        if isinstance(reply, d2n.ReplyResult) and reply.error:
            raise DaemonError(reply.error)

    def interrupt(self) -> None:
        """Shutdown, phase 1: unblock a thread parked in recv."""
        self._transport.interrupt()

    def close(self) -> None:
        """Shutdown, phase 2: free the transport (after the blocked thread
        left recv)."""
        if not self.closed:
            self.closed = True
            try:
                self.flush()  # do not strand buffered outputs
            except Exception:
                pass
            self._transport.close()
