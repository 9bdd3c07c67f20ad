"""Wire types shared by the node's two message directions: payload typing
and metadata, inline and shared-memory payloads, drop tokens, and the
fleet plane's engine digest. The port's copy of the part of
dora_tpu/message/common.py a node sends or receives.

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
