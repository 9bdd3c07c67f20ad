"""Dataclass <-> msgpack tagged-union codec of the node wire.

The port's copy of dora_tpu/message/serde.py; its bytes are the JAX
codec's. Every protocol message is a frozen dataclass registered under its
class name with ``@message``; on the wire a message is ``{"t": <class
name>, "f": {<field>: <value>, ...}}``, recursively for nested messages,
packed with msgpack (bytes pass through). Registration compiles a
pack/unpack closure pair per class; values the tables do not know
(subclasses of builtin types) go through a reflective walk.

msgpack is imported by :func:`encode` and :func:`decode` only, so the
message classes load without it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Type, TypeVar

from dora_tpu_torch.clock import Timestamp

_REGISTRY: dict[str, type] = {}

T = TypeVar("T")

_MISSING = object()


def _encode_value(value: Any) -> Any:
    enc = _PACK.get(value.__class__)
    if enc is not None:
        return enc(value)
    return _to_wire(value)


def _identity(value: Any) -> Any:
    return value


def _encode_seq(value: Any) -> list:
    return [_encode_value(v) for v in value]


def _encode_dict(value: dict) -> dict:
    if "t" in value:
        # Escape user dicts that would collide with the tagged-union
        # envelope (e.g. Metadata.parameters containing a "t" key).
        return {"t": "@map", "f": [[str(k), _encode_value(v)] for k, v in value.items()]}
    return {str(k): _encode_value(v) for k, v in value.items()}


def _encode_timestamp(value: Timestamp) -> dict:
    return {"t": "@ts", "f": list(value.to_wire())}


#: exact type -> wire encoder; ``@message`` registration adds one per class
_PACK: dict[type, Callable[[Any], Any]] = {
    type(None): _identity,
    bool: _identity,
    int: _identity,
    float: _identity,
    str: _identity,
    bytes: _identity,
    bytearray: _identity,
    memoryview: bytes,
    list: _encode_seq,
    tuple: _encode_seq,
    set: _encode_seq,
    frozenset: _encode_seq,
    dict: _encode_dict,
    Timestamp: _encode_timestamp,
}

#: wire tag -> compiled field decoder ("@ts" and "@map" are special-cased)
_UNPACK: dict[str, Callable[[dict], Any]] = {}


def _decode_value(value: Any) -> Any:
    cls = value.__class__
    if cls is dict:
        tag = value.get("t")
        if tag is not None:
            up = _UNPACK.get(tag)
            if up is not None:
                fields = value.get("f", _MISSING)
                if fields is not _MISSING:
                    return up(fields)
            elif tag == "@ts":
                return Timestamp.from_wire(value["f"])
            elif tag == "@map":
                return {k: _decode_value(v) for k, v in value["f"]}
        return {k: _decode_value(v) for k, v in value.items()}
    if cls is list:
        return [_decode_value(v) for v in value]
    return value


def _compile_codec(cls: type) -> None:
    name = cls.__name__
    names = tuple(f.name for f in dataclasses.fields(cls))

    def pack(value, _name=name, _names=names, _enc=_encode_value):
        return {"t": _name, "f": {n: _enc(getattr(value, n)) for n in _names}}

    known = frozenset(names)

    def unpack(fields, _cls=cls, _known=known, _dec=_decode_value):
        # Forward compatibility: ignore unknown fields.
        return _cls(**{k: _dec(v) for k, v in fields.items() if k in _known})

    _PACK[cls] = pack
    _UNPACK[name] = unpack


def message(cls: Type[T]) -> Type[T]:
    """Class decorator: freeze as dataclass, register for the wire, and
    compile the class's pack/unpack codec pair."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    name = cls.__name__
    if name in _REGISTRY and _REGISTRY[name] is not cls:
        raise RuntimeError(f"duplicate message type name: {name}")
    _REGISTRY[name] = cls
    _compile_codec(cls)
    return cls


def _to_wire(value: Any) -> Any:
    """The reflective encoder, for values the compiled tables do not know
    (a subclass of a builtin type); raises on what cannot travel."""
    if value is None or isinstance(value, (bool, int, float, str, bytes, bytearray)):
        return value
    if isinstance(value, memoryview):
        return bytes(value)
    if isinstance(value, Timestamp):
        return {"t": "@ts", "f": list(value.to_wire())}
    if dataclasses.is_dataclass(value) and type(value).__name__ in _REGISTRY:
        return {
            "t": type(value).__name__,
            "f": {f.name: _to_wire(getattr(value, f.name)) for f in dataclasses.fields(value)},
        }
    if isinstance(value, (list, tuple, set, frozenset)):
        return [_to_wire(v) for v in value]
    if isinstance(value, dict):
        if "t" in value:
            return {"t": "@map", "f": [[str(k), _to_wire(v)] for k, v in value.items()]}
        return {str(k): _to_wire(v) for k, v in value.items()}
    raise TypeError(f"cannot serialize {type(value).__name__}: {value!r}")


def encode(msg: Any) -> bytes:
    import msgpack

    return msgpack.packb(_encode_value(msg), use_bin_type=True)


def decode(data: bytes | memoryview) -> Any:
    import msgpack

    return _decode_value(msgpack.unpackb(data, raw=False, strict_map_key=False))


@message
class Timestamped:
    """HLC envelope: every top-level protocol message travels inside one."""

    inner: Any
    timestamp: Timestamp


def encode_timestamped(msg: Any, clock) -> bytes:
    return encode(Timestamped(inner=msg, timestamp=clock.new_timestamp()))


def encode_timestamped_inputs(input_ids, metadata: Any, data: Any, clock) -> dict[str, bytes]:
    """``encode_timestamped(Input(id, metadata, data), clock)`` for each id
    of ``input_ids``, under one timestamp: the metadata and the payload go
    through the encoder once, and only the id differs between the frames."""
    import msgpack

    from dora_tpu_torch.message.daemon_to_node import Input

    wire = _encode_value(Timestamped(inner=Input(id="", metadata=metadata, data=data),
                                     timestamp=clock.new_timestamp()))
    fields = wire["f"]["inner"]["f"]
    frames = {}
    for input_id in input_ids:
        if input_id not in frames:
            fields["id"] = str(input_id)
            frames[input_id] = msgpack.packb(wire, use_bin_type=True)
    return frames


def decode_timestamped(data: bytes | memoryview, clock=None) -> Timestamped:
    msg = decode(data)
    if not isinstance(msg, Timestamped):
        raise ValueError(f"expected Timestamped envelope, got {type(msg).__name__}")
    if clock is not None:
        clock.update_with_timestamp(msg.timestamp)
    return msg
