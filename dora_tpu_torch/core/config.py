"""Input mappings of a dataflow descriptor (dora_tpu/core/config.py's
``TimerMapping``, ``UserMapping``, ``parse_input_mapping`` and ``Input``):
"node/output" or "dora/timer/<unit>/<n>" strings, each input with its
bounded-queue size. Ids are plain strings here."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Union

#: the pseudo-node that owns timer streams ("dora/timer/millis/100")
DORA_NODE_ID = "dora"

_TIMER_UNITS_NS = {
    "nanos": 1,
    "micros": 1_000,
    "millis": 1_000_000,
    "secs": 1_000_000_000,
}

DEFAULT_QUEUE_SIZE = 10


@dataclass(frozen=True)
class TimerMapping:
    """Input fed by a daemon-owned periodic timer."""

    interval_ns: int

    def __str__(self) -> str:
        for unit in ("secs", "millis", "micros", "nanos"):
            div = _TIMER_UNITS_NS[unit]
            if self.interval_ns % div == 0:
                return f"dora/timer/{unit}/{self.interval_ns // div}"
        raise AssertionError("unreachable")


@dataclass(frozen=True)
class UserMapping:
    """Input fed by another node's output (``output`` may hold '/': a
    runtime node's streams are namespaced "<operator>/<output>")."""

    source: str
    output: str

    def __str__(self) -> str:
        return f"{self.source}/{self.output}"


InputMapping = Union[TimerMapping, UserMapping]


def parse_input_mapping(s: str) -> InputMapping:
    """Parse "source/output" or "dora/timer/<unit>/<n>"."""
    parts = s.split("/")
    if parts[0] == DORA_NODE_ID:
        if len(parts) == 4 and parts[1] == "timer" and parts[2] in _TIMER_UNITS_NS:
            try:
                n = int(parts[3])
            except ValueError:
                raise ValueError(f"invalid timer interval in {s!r}") from None
            if n <= 0:
                raise ValueError(f"timer interval must be positive: {s!r}")
            return TimerMapping(interval_ns=n * _TIMER_UNITS_NS[parts[2]])
        raise ValueError(
            f"unknown dora input {s!r} (expected dora/timer/<unit>/<n> with "
            f"unit in {sorted(_TIMER_UNITS_NS)})")
    if len(parts) >= 2 and all(parts):
        return UserMapping(source=parts[0], output="/".join(parts[1:]))
    raise ValueError(f"expected '<node>/<output>' or dora timer, got {s!r}")


@dataclass(frozen=True)
class Input:
    """One input slot: where it comes from and its queue size (the daemon
    drops the oldest event of a full queue)."""

    mapping: InputMapping
    queue_size: int = DEFAULT_QUEUE_SIZE

    @classmethod
    def parse(cls, value: Any) -> "Input":
        if isinstance(value, str):
            return cls(mapping=parse_input_mapping(value))
        if isinstance(value, Mapping):
            extra = set(value) - {"source", "queue_size"}
            if extra:
                raise ValueError(f"unknown input keys: {sorted(extra)}")
            if "source" not in value:
                raise ValueError(f"input mapping missing 'source': {value!r}")
            qs = value.get("queue_size", DEFAULT_QUEUE_SIZE)
            if not isinstance(qs, int) or qs < 1:
                raise ValueError(f"queue_size must be a positive int, got {qs!r}")
            return cls(mapping=parse_input_mapping(value["source"]), queue_size=qs)
        raise ValueError(f"invalid input spec: {value!r}")
