"""The CLI's synchronous client of the coordinator's control port
(dora_tpu/cli/control.py): one request, one reply, in the node wire's
framing and codec; after ``LogSubscribe`` the connection is a stream of
pushed log lines."""

from __future__ import annotations

import socket
from typing import Any

from dora_tpu_torch.clock import HLC
from dora_tpu_torch.core.topics import DORA_COORDINATOR_PORT_CONTROL_DEFAULT
from dora_tpu_torch.message import coordinator as cm
from dora_tpu_torch.message.serde import decode_timestamped, encode_timestamped
from dora_tpu_torch.transport.framing import recv_frame, send_frame


class ControlConnection:
    def __init__(self, addr: str | None = None, timeout: float = 60.0):
        addr = addr or f"127.0.0.1:{DORA_COORDINATOR_PORT_CONTROL_DEFAULT}"
        host, _, port = addr.rpartition(":")
        self._clock = HLC()
        self.sock = socket.create_connection((host, int(port)), timeout=5)
        self.sock.settimeout(timeout)

    def request(self, msg: Any) -> Any:
        """Send one request and return its reply; an ``Error`` reply raises
        RuntimeError with its message."""
        send_frame(self.sock, encode_timestamped(msg, self._clock))
        reply = decode_timestamped(recv_frame(self.sock), self._clock).inner
        if isinstance(reply, cm.Error):
            raise RuntimeError(reply.message)
        return reply

    def stream(self):
        """After a LogSubscribe request: yield the pushed messages."""
        while True:
            yield decode_timestamped(recv_frame(self.sock), self._clock).inner

    def send_only(self, msg: Any) -> None:
        send_frame(self.sock, encode_timestamped(msg, self._clock))

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def connect(addr: str | None = None) -> ControlConnection:
    try:
        return ControlConnection(addr)
    except OSError as e:
        raise SystemExit(
            f"cannot connect to coordinator at {addr or 'localhost'}: {e}\n"
            f"hint: run `python -m dora_tpu_torch.cli up` first") from e
