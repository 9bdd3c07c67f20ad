"""Length-prefixed framing over sockets, the synchronous half of
dora_tpu/transport/framing.py (nodes are synchronous).

Frame = 4-byte little-endian length + payload."""

from __future__ import annotations

import socket
import struct

_LEN = struct.Struct("<I")
MAX_FRAME = 1 << 30


class ConnectionClosed(ConnectionError):
    pass


def send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_LEN.pack(len(payload)) + payload)


def send_frames(sock: socket.socket, payloads: list[bytes]) -> None:
    """Every frame in one sendall; the receiver's framed recv splits them."""
    if len(payloads) == 1:
        send_frame(sock, payloads[0])
        return
    buf = bytearray()
    for payload in payloads:
        buf += _LEN.pack(len(payload))
        buf += payload
    sock.sendall(buf)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionClosed("peer closed connection")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def recv_frame(sock: socket.socket) -> bytes:
    (length,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if length > MAX_FRAME:
        raise ValueError(f"frame of {length} B exceeds limit")
    return _recv_exact(sock, length) if length else b""
