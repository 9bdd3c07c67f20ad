"""Daemon-side node-channel connections over TCP, UDS and shared memory
(dora_tpu/daemon/connection.py).

A ``NodeConnection`` is one request-reply channel to one node (control,
events, or drop). TCP/UDS connections ride one asyncio accept loop; the
node identifies itself (and the channel kind) with its first Register
message. Shmem channels block in native code, so each is pumped by an
executor thread that re-enters the asyncio loop per request.
"""

from __future__ import annotations

import asyncio
import threading
import time
from typing import Awaitable, Callable

from dora_tpu_torch.native import Disconnected, ShmemChannel
from dora_tpu_torch.transport.framing import (
    ConnectionClosed,
    recv_frame_async,
    send_frame_async,
)


class NodeConnection:
    """One request-reply channel; recv() returns raw frames (None = closed)."""

    async def recv(self) -> bytes | None:
        raise NotImplementedError

    async def send(self, payload: bytes) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class StreamConnection(NodeConnection):
    """TCP or UDS connection (asyncio streams)."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer

    async def recv(self) -> bytes | None:
        try:
            return await recv_frame_async(self.reader)
        except (ConnectionClosed, ConnectionError):
            return None

    async def send(self, payload: bytes) -> None:
        await send_frame_async(self.writer, payload)

    def close(self) -> None:
        try:
            self.writer.close()
        except Exception:
            pass


class ShmemConnection(NodeConnection):
    """Server side of one native shmem request-reply channel.

    The blocking native recv runs on a dedicated pump thread (one per
    channel) that re-enters the asyncio loop per request — executor slots
    stay free for short-lived work.
    """

    RECV_TICK_S = 0.5
    #: how long a send waits before it tries an occupied reply slot again
    SEND_RETRY_S = 0.0002

    def __init__(self, channel: ShmemChannel):
        self.channel = channel
        self._closing = False
        self._close_lock = threading.Lock()
        self._channel_closed = False
        self._loop = asyncio.get_running_loop()
        self._incoming: asyncio.Queue[bytes | None] = asyncio.Queue()
        self._thread = threading.Thread(
            target=self._pump, name=f"shmem-pump-{channel.name}", daemon=True
        )
        self._thread.start()

    def _pump(self) -> None:
        try:
            while not self._closing:
                try:
                    data = self.channel.recv(self.RECV_TICK_S)
                except (Disconnected, Exception):
                    break
                if data is not None:
                    self._loop.call_soon_threadsafe(self._incoming.put_nowait, data)
            self._loop.call_soon_threadsafe(self._incoming.put_nowait, None)
        except RuntimeError:
            pass  # event loop closed during teardown

    async def recv(self) -> bytes | None:
        return await self._incoming.get()

    async def send(self, payload: bytes) -> None:
        # Fast path: under request-reply discipline the requester is parked
        # in recv, so the reply slot is free — send inline (memcpy + futex
        # wake, a few µs) instead of paying an executor-thread hop. Fall
        # back to retrying off-loop only if the slot is occupied
        # (pipelined fire-and-forget peer or stuck client).
        try:
            if self._try_send(payload):
                return
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(None, self._send_retrying, payload)
        except Disconnected:
            raise ConnectionClosed("shmem peer disconnected") from None

    def _try_send(self, payload: bytes) -> bool:
        """One non-blocking send under the close lock: an event batch can
        come due after close() (a queue's wait ends as the node goes), and
        its send must not touch the native handle while the deferred
        helper frees it."""
        with self._close_lock:
            if self._closing or self._channel_closed:
                raise ConnectionClosed("shmem channel closed")
            return self.channel.try_send(payload)

    def _send_retrying(self, payload: bytes) -> None:
        while not self._try_send(payload):
            time.sleep(self.SEND_RETRY_S)

    def close(self) -> None:
        """Disconnect and free the channel. The native handle is freed only
        after the pump thread exits (freeing under a blocked recv would be a
        use-after-free); a send checks, under the same lock, that the
        channel is not closing, so no send can race the free either."""
        if self._closing:
            return
        self._closing = True
        self._disconnect_once()

        def _finish(thread=self._thread):
            thread.join(timeout=5)
            self._close_channel_once()

        threading.Thread(target=_finish, daemon=True).start()

    def _disconnect_once(self) -> None:
        """Disconnect under the close lock: close() (deferred helper) and
        close_sync() (daemon teardown) can overlap, and a disconnect
        racing the native free would touch a handle mid-free."""
        with self._close_lock:
            if self._channel_closed:
                return
            try:
                self.channel.disconnect()
            except Exception:
                pass

    def _close_channel_once(self) -> None:
        """Free + unlink the native channel exactly once (the deferred
        close() helper and the synchronous teardown path can both reach
        here; a double native close would be a double munmap). The lock
        is held across the native close so a concurrent
        ``_disconnect_once`` can never observe the handle mid-free."""
        with self._close_lock:
            if self._channel_closed:
                return
            self._channel_closed = True
            try:
                self.channel.close()
            except Exception:
                pass

    def close_sync(self, timeout: float = 2.0) -> None:
        """Close and unlink before returning — the daemon-teardown path.
        The deferred close() is right for per-connection teardown during a
        live run (never block the loop), but at process exit the helper
        thread would be killed before shm_unlink runs, leaking segments.
        Disconnect wakes the pump's blocked recv immediately, so the join
        is bounded by one recv tick in practice. Safe after close():
        whichever path reaches the native free first wins."""
        self._closing = True
        self._disconnect_once()
        self._thread.join(timeout=timeout)
        self._close_channel_once()


async def serve_stream(
    host_listener: Callable[[NodeConnection], Awaitable[None]],
    *,
    tcp_host: str | None = None,
    uds_path: str | None = None,
) -> tuple[asyncio.AbstractServer, str]:
    """Start one accept loop; every accepted connection is handed to
    ``host_listener`` as a StreamConnection. Returns (server, address)."""

    async def on_client(reader, writer):
        await host_listener(StreamConnection(reader, writer))

    if uds_path is not None:
        server = await asyncio.start_unix_server(on_client, path=uds_path)
        return server, uds_path
    server = await asyncio.start_server(on_client, host=tcp_host or "127.0.0.1", port=0)
    addr = server.sockets[0].getsockname()
    return server, f"{addr[0]}:{addr[1]}"
