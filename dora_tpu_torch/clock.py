"""Hybrid logical clock (HLC), the port's copy of dora_tpu/clock.py.

Every message on the node wire carries an HLC timestamp and every receipt
feeds the remote timestamp back into the local clock. A timestamp packs
physical nanoseconds in its high bits and a 16-bit logical counter in the
low ones; on the wire it travels split as (physical_ns, logical, id), the
layout dora_tpu's daemon reads.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import NamedTuple

_LOGICAL_BITS = 16
_LOGICAL_MASK = (1 << _LOGICAL_BITS) - 1


class Timestamp(NamedTuple):
    """A totally ordered HLC timestamp: (time, id). ``time`` packs physical
    ns and the logical counter; ``id`` is the hex id of the originating
    clock and only breaks ties."""

    time: int
    id: str

    @property
    def physical_ns(self) -> int:
        return self.time >> _LOGICAL_BITS

    @property
    def logical(self) -> int:
        return self.time & _LOGICAL_MASK

    def to_wire(self) -> tuple[int, int, str]:
        # Split so each component fits a 64-bit msgpack int.
        return (self.physical_ns, self.logical, self.id)

    @classmethod
    def from_wire(cls, wire) -> "Timestamp":
        phys, logical, i = wire
        return cls((int(phys) << _LOGICAL_BITS) | int(logical), str(i))

    def __str__(self) -> str:
        return f"{self.physical_ns}.{self.logical}@{self.id[:8]}"


class HLC:
    """Thread-safe hybrid logical clock."""

    def __init__(self, id: str | None = None):
        self.id = id or uuid.uuid4().hex
        self._lock = threading.Lock()
        self._last = time.time_ns() << _LOGICAL_BITS

    def new_timestamp(self) -> Timestamp:
        now = time.time_ns() << _LOGICAL_BITS
        with self._lock:
            if now > self._last:
                self._last = now
            else:
                self._last += 1
            return Timestamp(self._last, self.id)

    def update_with_timestamp(self, remote: Timestamp) -> None:
        """Advance the local clock past a remote timestamp (message receipt)."""
        now = time.time_ns() << _LOGICAL_BITS
        with self._lock:
            m = max(now, remote.time, self._last)
            if m == self._last and m != now and m != remote.time:
                self._last += 1
            elif m == remote.time or m == self._last:
                self._last = m + 1
            else:
                self._last = m
