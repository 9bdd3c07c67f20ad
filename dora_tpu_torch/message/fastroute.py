"""The daemon's wire-level fast path (dora_tpu/message/fastroute.py): an
inline-payload ``Timestamped(SendMessage)`` frame is routed without building
its metadata and data as objects.

* :func:`parse_send_message` shallow-parses the frame with
  ``msgpack.Unpacker``: the envelope, the output id and the sender's
  timestamp, and the byte span of the ``metadata`` and ``data`` fields
  (skipped, never decoded; with tracing on, the metadata's trace context is
  read out of it).
* :func:`build_input_event` splices that span into a ``Timestamped(Input)``
  wire image (msgpack is context-free, so the embedded value is byte-equal
  to a standalone one).
* :func:`build_next_events_frame` joins per-event wire images into the
  ``NextEvents`` reply.

Each either produces the bytes ``serde.encode`` gives for the equivalent
object tree, or returns None and the daemon takes the decoding path
(shared-memory payloads, a foreign field order).
"""

from __future__ import annotations

import msgpack

from dora_tpu_torch.clock import Timestamp
from dora_tpu_torch.telemetry import OTEL_CTX_KEY, TRACING

#: process-wide tally of fallbacks by reason (the per-dataflow hit and
#: fallback counts are in the daemon's metrics)
FALLBACKS: dict[str, int] = {}


def _fallback(reason: str) -> None:
    FALLBACKS[reason] = FALLBACKS.get(reason, 0) + 1
    return None


def _frag(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


_MAP1 = b"\x81"
_MAP2 = b"\x82"
_MAP3 = b"\x83"
_T_KEY = _frag("t")
_F_KEY = _frag("f")

#: ``{"t": "Timestamped", "f": {"inner":`` … (envelope up to the inner value)
_ENVELOPE_PREFIX = _MAP2 + _T_KEY + _frag("Timestamped") + _F_KEY + _MAP2 + _frag("inner")
_TIMESTAMP_KEY = _frag("timestamp")
#: ``{"t": "Input", "f": {"id":`` … (event up to the input-id value)
_INPUT_PREFIX = _MAP2 + _T_KEY + _frag("Input") + _F_KEY + _MAP3 + _frag("id")
#: ``{"t": "NextEvents", "f": {"events":`` … (reply up to the event array)
_NEXT_EVENTS_PREFIX = _MAP2 + _T_KEY + _frag("NextEvents") + _F_KEY + _MAP1 + _frag("events")


def _timestamp_frag(ts: Timestamp) -> bytes:
    # Matches serde._encode_timestamp: {"t": "@ts", "f": [phys, logical, id]}.
    return _frag({"t": "@ts", "f": list(ts.to_wire())})


def _array_header(n: int) -> bytes:
    if n < 16:
        return bytes((0x90 | n,))
    if n < 1 << 16:
        return b"\xdc" + n.to_bytes(2, "big")
    return b"\xdd" + n.to_bytes(4, "big")


class FastSend:
    """A shallow-parsed ``Timestamped(SendMessage)`` frame."""

    __slots__ = ("output_id", "body", "timestamp", "payload_len", "ctx")

    def __init__(self, output_id: str, body: bytes, timestamp: Timestamp,
                 payload_len: int = 0, ctx: str = ""):
        self.output_id = output_id
        #: wire bytes spanning ``"metadata": <...>, "data": <...>`` —
        #: exactly the tail an Input event's field map needs
        self.body = body
        self.timestamp = timestamp
        #: inline payload bytes (metrics: routed bytes per link)
        self.payload_len = payload_len
        #: serialized trace context from metadata (tracing on only) —
        #: the body bytes still splice through verbatim
        self.ctx = ctx


def parse_send_message(frame) -> FastSend | None:
    """Shallow-parse ``Timestamped(SendMessage)`` wire bytes.

    Returns None — caller must take the reflective path — for any other
    message type, a shared-memory payload (its drop token needs the full
    bookkeeping), or any layout surprise (e.g. a foreign writer emitting
    fields in a different order).
    """
    try:
        u = msgpack.Unpacker(raw=False, strict_map_key=False)
        u.feed(frame)
        if u.read_map_header() != 2 or u.unpack() != "t":
            return _fallback("envelope")
        if u.unpack() != "Timestamped" or u.unpack() != "f":
            return _fallback("envelope")
        if u.read_map_header() != 2 or u.unpack() != "inner":
            return _fallback("envelope")
        if u.read_map_header() != 2 or u.unpack() != "t":
            return _fallback("envelope")
        if u.unpack() != "SendMessage" or u.unpack() != "f":
            return _fallback("not-send-message")
        if u.read_map_header() != 3 or u.unpack() != "output_id":
            return _fallback("field-order")
        output_id = u.unpack()
        body_start = u.tell()
        if u.unpack() != "metadata":
            return _fallback("field-order")
        ctx = ""
        if TRACING.active:
            # Trace plane: lift the context out of metadata. The consumed
            # byte span is the one skip() would consume, so the body still
            # splices through verbatim.
            meta = u.unpack()
            try:
                ctx = meta["f"]["parameters"].get(OTEL_CTX_KEY) or ""
            except (TypeError, KeyError, AttributeError):
                ctx = ""
        else:
            u.skip()  # metadata subtree: bytes reused verbatim, never built
        if u.unpack() != "data":
            return _fallback("field-order")
        # The data value must be built (cheap: nil, or one C-level bin
        # copy) to learn its tag — only inline/empty payloads are
        # routable without token bookkeeping.
        data = u.unpack()
        if data is not None and (
            not isinstance(data, dict) or data.get("t") != "InlineData"
        ):
            return _fallback("shmem-data")
        body_end = u.tell()
        if u.unpack() != "timestamp":
            return _fallback("field-order")
        ts = u.unpack()
        if not isinstance(ts, dict) or ts.get("t") != "@ts":
            return _fallback("field-order")
        timestamp = Timestamp.from_wire(ts["f"])
        payload_len = 0
        if data is not None:
            inline = data.get("f")
            if isinstance(inline, dict):
                payload = inline.get("data")
                if payload is not None:
                    payload_len = len(payload)
    except Exception:
        return _fallback("parse-error")
    return FastSend(
        str(output_id), bytes(frame[body_start:body_end]), timestamp,
        payload_len, str(ctx),
    )


def build_input_event(input_id: str, body: bytes, ts: Timestamp) -> bytes:
    """Wire image of ``Timestamped(Input(id, <body>), ts)`` — byte-equal
    to ``serde.encode`` of the equivalent object tree."""
    return b"".join((
        _ENVELOPE_PREFIX,
        _INPUT_PREFIX, _frag(input_id), body,
        _TIMESTAMP_KEY, _timestamp_frag(ts),
    ))


def build_next_events_frame(event_wires: list[bytes], ts: Timestamp) -> bytes:
    """Wire image of ``Timestamped(NextEvents(events=[...]), ts)`` from
    per-event wire images (an empty list is the end-of-stream reply)."""
    return b"".join((
        _ENVELOPE_PREFIX,
        _NEXT_EVENTS_PREFIX, _array_header(len(event_wires)),
        *event_wires,
        _TIMESTAMP_KEY, _timestamp_frag(ts),
    ))
