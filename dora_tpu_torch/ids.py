"""Typed identifiers of the dataflow graph (dora_tpu/ids.py): ``str``
subclasses that travel as plain strings on the wire and in YAML, and the
composite (node, output) / (node, input) ids as NamedTuples."""

from __future__ import annotations

import re
from typing import NamedTuple

_ID_RE = re.compile(r"[a-zA-Z0-9_.\-]+")


class _Id(str):
    __slots__ = ()

    def __new__(cls, value: str):
        if not value:
            raise ValueError(f"{cls.__name__} must be non-empty")
        if not _ID_RE.fullmatch(value):
            raise ValueError(
                f"invalid {cls.__name__} {value!r}: only [a-zA-Z0-9_.-] allowed"
            )
        return super().__new__(cls, value)

    def __repr__(self) -> str:  # NodeId('camera')
        return f"{type(self).__name__}({str.__repr__(self)})"


class NodeId(_Id):
    """Identifier of one node in a dataflow."""


class OperatorId(_Id):
    """Identifier of one operator hosted inside a runtime node."""


class DataId(str):
    """Identifier of one output (or input slot) of a node.

    Unlike NodeId/OperatorId this may contain ``/``: runtime nodes namespace
    their operators' streams as ``<operator>/<output>``.
    """

    __slots__ = ()

    def __new__(cls, value: str):
        if not value:
            raise ValueError("DataId must be non-empty")
        segments = value.split("/")
        if not all(_ID_RE.fullmatch(s) for s in segments):
            raise ValueError(
                f"invalid DataId {value!r}: '/'-separated segments of "
                f"[a-zA-Z0-9_.-] required"
            )
        return super().__new__(cls, value)

    def __repr__(self) -> str:
        return f"DataId({str.__repr__(self)})"


class DataflowId(str):
    """UUID of one running dataflow instance."""

    __slots__ = ()


class OutputId(NamedTuple):
    """(node, output) — the global name of a produced stream."""

    node: NodeId
    output: DataId

    def __str__(self) -> str:
        return f"{self.node}/{self.output}"

    @classmethod
    def parse(cls, s: str) -> "OutputId":
        node, sep, output = s.partition("/")
        if not sep or not node or not output:
            raise ValueError(f"expected '<node>/<output>', got {s!r}")
        return cls(NodeId(node), DataId(output))  # output may itself contain '/'


class InputId(NamedTuple):
    """(node, input) — the global name of a consumed slot."""

    node: NodeId
    input: DataId

    def __str__(self) -> str:
        return f"{self.node}/{self.input}"


def validate_id(value: str, what: str = "id") -> str:
    if not _ID_RE.fullmatch(value):
        raise ValueError(
            f"invalid {what} {value!r}: only [a-zA-Z0-9_.-] allowed"
        )
    return value
