"""Input and communication configuration of a dataflow descriptor
(dora_tpu/core/config.py): input mappings parsed from "node/output" or
"dora/timer/<unit>/<n>" strings, each input with its bounded-queue size, the
``communication:`` block, and ``$VAR`` expansion."""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Any, Mapping, Union

from dora_tpu_torch.ids import DataId, NodeId, OutputId

# ---------------------------------------------------------------------------
# Input mappings
# ---------------------------------------------------------------------------

#: The pseudo-node that owns timer streams ("dora/timer/millis/100").
DORA_NODE_ID = NodeId("dora")

_TIMER_UNITS_NS = {
    "nanos": 1,
    "micros": 1_000,
    "millis": 1_000_000,
    "secs": 1_000_000_000,
}


@dataclass(frozen=True)
class TimerMapping:
    """Input fed by a daemon-owned periodic timer."""

    interval_ns: int

    @property
    def data_id(self) -> DataId:
        # Canonical form uses the coarsest exact unit.
        for unit in ("secs", "millis", "micros", "nanos"):
            div = _TIMER_UNITS_NS[unit]
            if self.interval_ns % div == 0:
                return DataId(f"timer-{unit}-{self.interval_ns // div}")
        raise AssertionError("unreachable")

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

    source: NodeId
    output: DataId

    @property
    def output_id(self) -> OutputId:
        return OutputId(self.source, self.output)

    def __str__(self) -> str:
        return f"{self.source}/{self.output}"


InputMapping = Union[TimerMapping, UserMapping]


def parse_input_mapping(s: str) -> InputMapping:
    """Parse "source/output" or "dora/timer/<unit>/<n>"."""
    parts = s.split("/")
    if parts[0] == str(DORA_NODE_ID):
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
            f"unit in {sorted(_TIMER_UNITS_NS)})"
        )
    # "<node>/<output>" where output may itself contain '/' (runtime-node
    # streams are namespaced "<operator>/<output>").
    if len(parts) >= 2 and all(parts):
        return UserMapping(source=NodeId(parts[0]), output=DataId("/".join(parts[1:])))
    raise ValueError(f"expected '<node>/<output>' or dora timer, got {s!r}")


DEFAULT_QUEUE_SIZE = 10


@dataclass(frozen=True)
class Input:
    """One input slot: where it comes from plus its bounded-queue size.

    Overflowing queues drop the *oldest* event (reference:
    binaries/daemon/src/node_communication/mod.rs:320-359).
    """

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

    def to_dict(self) -> Any:
        if self.queue_size == DEFAULT_QUEUE_SIZE:
            return str(self.mapping)
        return {"source": str(self.mapping), "queue_size": self.queue_size}


# ---------------------------------------------------------------------------
# Communication config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LocalCommunicationConfig:
    """node<->daemon transport on one machine: tcp | shmem | uds."""

    kind: str = "tcp"

    _KINDS = ("tcp", "shmem", "uds")

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError(
                f"unknown local communication {self.kind!r}; expected one of {self._KINDS}"
            )


@dataclass(frozen=True)
class CommunicationConfig:
    local: LocalCommunicationConfig = field(default_factory=LocalCommunicationConfig)
    remote: str = "tcp"

    @classmethod
    def parse(cls, value: Mapping[str, Any] | None) -> "CommunicationConfig":
        if not value:
            return cls()
        local = value.get("local", value.get("_unstable_local", "tcp"))
        if isinstance(local, Mapping):
            local = local.get("kind", "tcp")
        # Reference spellings (dataflow_socket.yml uses "UnixDomain").
        local = {
            "UnixDomain": "uds",
            "Tcp": "tcp",
            "Shmem": "shmem",
            "SharedMemory": "shmem",
        }.get(str(local), str(local).lower())
        remote = value.get("remote", value.get("_unstable_remote", "tcp"))
        if isinstance(remote, Mapping):
            remote = remote.get("kind", "tcp")
        if remote != "tcp":
            raise ValueError(f"unknown remote communication {remote!r}; only 'tcp'")
        return cls(local=LocalCommunicationConfig(str(local)), remote=str(remote))


# ---------------------------------------------------------------------------
# Env expansion
# ---------------------------------------------------------------------------

_ENV_RE = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_]*)\}|\$([A-Za-z_][A-Za-z0-9_]*)")


def expand_env(value: Any, env: Mapping[str, str] | None = None) -> Any:
    """Expand $VAR / ${VAR} inside string values (reference:
    libraries/core/src/descriptor/mod.rs:541-550)."""
    if env is None:
        env = os.environ
    if isinstance(value, str):

        def sub(m: re.Match) -> str:
            name = m.group(1) or m.group(2)
            return env.get(name, m.group(0))

        return _ENV_RE.sub(sub, value)
    return value
