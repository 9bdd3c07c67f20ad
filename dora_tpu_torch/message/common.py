"""Wire types shared by the node and daemon message directions: payload
typing and metadata, inline and shared-memory payloads, drop tokens, node
and dataflow results, and the fleet plane's engine digest. The port's copy
of the part of dora_tpu/message/common.py its node and its local daemon
use.

Payloads travel in Arrow IPC stream format, inline or in a shared-memory
region; receivers acknowledge a region through its drop token."""

from __future__ import annotations

import os
import time
import uuid
from typing import Any

from dora_tpu_torch.message.serde import message

#: encodings of the payload of an Input event / SendMessage
ENCODING_ARROW_IPC = "arrow-ipc"  # Arrow IPC stream
ENCODING_RAW = "raw"  # untyped bytes


@message
class TypeInfo:
    """How to interpret the payload bytes."""

    encoding: str  # ENCODING_*
    len: int


@message
class Metadata:
    """Per-message metadata: payload typing plus user and framework
    parameters (``open_telemetry_context`` carries trace propagation)."""

    type_info: TypeInfo
    parameters: dict[str, Any]


def new_drop_token() -> str:
    """Time-ordered unique token tracking a shared-memory buffer's lifetime
    (a UUIDv7)."""
    ms = time.time_ns() // 1_000_000
    b = bytearray(ms.to_bytes(6, "big") + os.urandom(10))
    b[6] = (b[6] & 0x0F) | 0x70
    b[8] = (b[8] & 0x3F) | 0x80
    return str(uuid.UUID(bytes=bytes(b)))


@message
class InlineData:
    """Payload small enough to travel inline through the daemon channel."""

    data: bytes


@message
class SharedMemoryData:
    """Payload living in a shared-memory region; receivers map it and
    acknowledge via ``drop_token`` so the sender can reuse the region."""

    shmem_id: str
    len: int
    drop_token: str


@message
class EngineStateDigest:
    """A serving replica's shippable state summary (fleet plane), published
    on the ``DORA_FLEET_DIGEST_S`` cadence: the top-N cached radix prefixes
    as ``[chain, token_len, pages]``, page and HBM occupancy, the
    ``fits()``-derived free-stream capacity, the resident adapters and a
    fingerprint of the config axes that make two replicas interchangeable."""

    model_id: str
    fingerprint: str
    page_size: int
    window: int           # fused decode window K
    spec_k: int
    kv_dtype: str
    weight_bits: int
    max_slots: int
    free_streams: int
    used_pages: int
    free_pages: int
    total_pages: int
    prefix_pages: int
    hbm_used_bytes: int
    hbm_limit_bytes: int
    adapters: list[str]
    prefixes: list[list[Any]]  # [chain: str, token_len: int, pages: int]
    seq: int
    unix_ts: float


@message
class NodeExitStatus:
    """How a node process ended: success, exit code, or signal."""

    success: bool
    code: int | None = None
    signal: int | None = None
    error: str | None = None


@message
class NodeErrorCause:
    """Classification of a node failure.

    kind: "grace_duration" (killed after the stop grace period) |
          "cascading" (failed because ``caused_by_node`` failed first) |
          "other" (its own failure; ``stderr`` holds the last lines).
    """

    kind: str
    caused_by_node: str | None = None
    stderr: str | None = None


@message
class NodeError:
    exit_status: NodeExitStatus
    cause: NodeErrorCause

    def __str__(self) -> str:
        s = self.exit_status
        how = (
            "was killed after the stop grace period"
            if self.cause.kind == "grace_duration"
            else f"failed because node {self.cause.caused_by_node!r} failed"
            if self.cause.kind == "cascading"
            else f"exited with code {s.code}"
            if s.code is not None
            else f"was killed by signal {s.signal}"
            if s.signal is not None
            else f"failed: {s.error}"
        )
        msg = f"node {how}"
        if self.cause.stderr:
            msg += "\n  last stderr:\n    " + "\n    ".join(self.cause.stderr.splitlines())
        return msg


@message
class NodeResult:
    """Success or failure of one node of a finished dataflow."""

    error: NodeError | None = None


@message
class DataflowResult:
    uuid: str
    node_results: dict[str, NodeResult]  # node_id -> result

    def is_ok(self) -> bool:
        return all(r.error is None for r in self.node_results.values())

    def errors(self) -> list[tuple[str, NodeError]]:
        return [(nid, r.error) for nid, r in sorted(self.node_results.items()) if r.error]


LOG_LEVELS = ("trace", "debug", "info", "warn", "error")


@message
class LogMessage:
    """A log line travelling daemon -> coordinator -> CLI subscribers."""

    dataflow_id: str
    level: str
    message: str
    node_id: str | None = None
    target: str | None = None
    machine_id: str | None = None


def log_level_at_least(level: str, minimum: str) -> bool:
    try:
        return LOG_LEVELS.index(level) >= LOG_LEVELS.index(minimum)
    except ValueError:
        return True


#: level words parse_level_prefix accepts -> the canonical level
_LEVEL_WORDS = {
    "trace": "trace",
    "debug": "debug",
    "info": "info",
    "warn": "warn",
    "warning": "warn",
    "error": "error",
    "err": "error",
    "critical": "error",
    "fatal": "error",
}


def parse_level_prefix(text: str) -> str | None:
    """A log line's severity from its first tokens (``ERROR: boom``,
    ``[warn] slow``, ``2026-01-01 00:00:00,123 WARNING retrying``), or None
    when none is recognisable (callers keep their stream's default)."""
    for token in text.split(None, 3)[:3]:
        word = token.strip("[]()<>:,-|").lower()
        if len(word) < 3:
            continue
        level = _LEVEL_WORDS.get(word)
        if level is not None:
            return level
    return None
