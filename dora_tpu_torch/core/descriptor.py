"""The slice of dataflow descriptor parsing that the port's operator runtime
needs (dora_tpu/core/descriptor.py): every node's id, inputs and outputs,
runtime nodes' streams namespaced ``<operator>/<name>`` as
``ResolvedNode.inputs`` / ``outputs`` name them, and a custom node's source
and arguments. The runtime reads the whole descriptor from its NodeConfig
to find which of its outputs something outside it consumes."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping

from dora_tpu_torch.core.config import Input

#: the id of the one operator of the ``operator:`` shorthand
DEFAULT_OPERATOR_ID = "op"

_NODE_KIND_KEYS = ("path", "custom", "operators", "operator")


def _parse_inputs(value: Any) -> dict[str, Input]:
    if value is None:
        return {}
    if not isinstance(value, Mapping):
        raise ValueError(f"'inputs' must be a mapping, got {type(value).__name__}")
    return {str(k): Input.parse(v) for k, v in value.items()}


def _parse_outputs(value: Any) -> frozenset[str]:
    if value is None:
        return frozenset()
    if not isinstance(value, (list, tuple)):
        raise ValueError(f"'outputs' must be a list, got {type(value).__name__}")
    return frozenset(str(v) for v in value)


@dataclass(frozen=True)
class NodeSpec:
    """One node of a dataflow. ``inputs`` / ``outputs`` are the node's
    stream ids, ``<op>/<name>`` for a runtime node's operators; ``source``
    and ``args`` are a custom node's (None for a runtime node)."""

    id: str
    inputs: dict[str, Input] = field(default_factory=dict)
    outputs: frozenset[str] = frozenset()
    source: str | None = None
    args: str | None = None

    @classmethod
    def parse(cls, value: Mapping[str, Any]) -> "NodeSpec":
        if "id" not in value:
            raise ValueError(f"node missing 'id': {value!r}")
        node_id = str(value["id"])
        kinds = [k for k in _NODE_KIND_KEYS if k in value]
        if len(kinds) != 1:
            raise ValueError(
                f"node {node_id!r} must have exactly one of {_NODE_KIND_KEYS}, got {kinds}")
        kind = kinds[0]
        if kind in ("path", "custom"):
            c = value if kind == "path" else value["custom"]
            return cls(id=node_id, inputs=_parse_inputs(c.get("inputs")),
                       outputs=_parse_outputs(c.get("outputs")),
                       source=str(c["path" if kind == "path" else "source"]),
                       args=c.get("args"))
        ops = value["operators"] if kind == "operators" else [value["operator"]]
        inputs: dict[str, Input] = {}
        outputs: set[str] = set()
        for op in ops:
            op_id = str(op.get("id", DEFAULT_OPERATOR_ID if kind == "operator" else ""))
            if not op_id:
                raise ValueError(f"operator missing 'id': {op!r}")
            for input_id, inp in _parse_inputs(op.get("inputs")).items():
                inputs[f"{op_id}/{input_id}"] = inp
            outputs |= {f"{op_id}/{o}" for o in _parse_outputs(op.get("outputs"))}
        return cls(id=node_id, inputs=inputs, outputs=frozenset(outputs))


@dataclass(frozen=True)
class Descriptor:
    nodes: tuple[NodeSpec, ...]

    @classmethod
    def parse(cls, raw: Mapping[str, Any]) -> "Descriptor":
        nodes = raw.get("nodes")
        if not isinstance(nodes, list) or not nodes:
            raise ValueError("descriptor has no 'nodes' list")
        parsed = tuple(NodeSpec.parse(n) for n in nodes)
        ids = [n.id for n in parsed]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate node ids in {ids}")
        return cls(nodes=parsed)

    def node(self, node_id: str) -> NodeSpec:
        for n in self.nodes:
            if n.id == str(node_id):
                return n
        raise KeyError(f"no node {node_id!r} in the dataflow")
