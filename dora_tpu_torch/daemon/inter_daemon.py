"""The links between daemons of one dataflow on several machines
(dora_tpu/daemon/inter_daemon.py).

Each attached daemon listens for the events other machines' daemons send
it: an output for its receivers (``InterDaemonOutput``, its payload inline:
shared memory never crosses machines) and the inputs whose producers closed
(``InterDaemonInputsClosed``). A daemon sends over one lazy persistent TCP
connection a peer, length-prefixed frames of the node wire's codec.
"""

from __future__ import annotations

import asyncio
import logging
from typing import TYPE_CHECKING

from dora_tpu_torch.message import coordinator as cm
from dora_tpu_torch.message.serde import decode_timestamped, encode_timestamped
from dora_tpu_torch.transport.framing import (
    ConnectionClosed,
    recv_frame_async,
    send_frame_async,
)

if TYPE_CHECKING:
    from dora_tpu_torch.daemon.core import Daemon

logger = logging.getLogger(__name__)


async def start_server(daemon: "Daemon", port: int = 0) -> tuple[asyncio.AbstractServer, int]:
    """Listen for the events of other machines' daemons; returns the server
    and its port."""

    async def on_peer(reader, writer):
        try:
            while True:
                frame = await recv_frame_async(reader)
                event = decode_timestamped(frame, daemon.clock).inner
                df = daemon.dataflows.get(getattr(event, "dataflow_id", None))
                if df is None:
                    continue
                if isinstance(event, cm.InterDaemonOutput):
                    daemon.deliver_remote_output(df, event.output_id, event.metadata, event.data)
                elif isinstance(event, cm.InterDaemonInputsClosed):
                    daemon.close_remote_inputs(df, event.inputs)
        except (ConnectionClosed, ConnectionError):
            pass
        except Exception:
            logger.exception("inter-daemon connection failed")
        finally:
            try:
                writer.close()
            except Exception:
                pass

    server = await asyncio.start_server(on_peer, host="0.0.0.0", port=port)
    return server, server.sockets[0].getsockname()[1]


class InterDaemonClient:
    """Lazy persistent connections to peer daemons, by address."""

    def __init__(self, clock):
        self._clock = clock
        self._writers: dict[str, asyncio.StreamWriter] = {}
        self._locks: dict[str, asyncio.Lock] = {}

    async def send(self, addr: str, event) -> None:
        """Send one event; a broken connection is reopened once."""
        lock = self._locks.setdefault(addr, asyncio.Lock())
        async with lock:
            writer = self._writers.get(addr)
            payload = encode_timestamped(event, self._clock)
            for attempt in (1, 2):
                if writer is None:
                    host, _, port = addr.rpartition(":")
                    _, writer = await asyncio.open_connection(host, int(port))
                    self._writers[addr] = writer
                try:
                    await send_frame_async(writer, payload)
                    return
                except (ConnectionError, ConnectionClosed):
                    self._writers.pop(addr, None)
                    writer = None
                    if attempt == 2:
                        raise

    def close(self) -> None:
        for writer in self._writers.values():
            try:
                writer.close()
            except Exception:
                pass
        self._writers.clear()
