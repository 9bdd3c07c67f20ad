"""The YAML dataflow descriptor (dora_tpu/core/descriptor.py): parse,
resolve, check.

Four node kinds, resolved into one ``ResolvedNode`` list: ``path:`` and
``custom:`` nodes (an executable, a ``.py`` file, ``module:<name>``,
``shell`` or ``dynamic``), ``operators:`` and the ``operator:`` shorthand
(a runtime node hosting operators, their streams namespaced
``<operator>/<name>``, run by ``python -m dora_tpu_torch.runtime``).
Operator sources: ``python``, ``shared-library`` and ``wasm`` as the JAX
package parses them, and ``torch: <module>:<factory>``, the port's name for
the JAX package's ``jax:`` source (operators fused into the runtime's
step). A ``jax:`` source is parsed, and :meth:`Descriptor.check` refuses it
naming ``torch:``.

PyYAML is imported only by :meth:`Descriptor.read`; :meth:`Descriptor.parse`
takes the parsed mapping.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Mapping

from dora_tpu_torch.core.config import CommunicationConfig, Input, expand_env
from dora_tpu_torch.ids import DataId, NodeId, OperatorId, OutputId

# Special `path:` markers.
SHELL_SOURCE = "shell"
DYNAMIC_SOURCE = "dynamic"

DEFAULT_OPERATOR_ID = "op"


# ---------------------------------------------------------------------------
# Operator model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PythonSource:
    """A Python operator: a .py file defining ``class Operator`` with
    ``on_event(event, send_output) -> DoraStatus``."""

    source: str
    conda_env: str | None = None


@dataclass(frozen=True)
class SharedLibrarySource:
    """A native operator: shared library exporting the C operator ABI
    (dora_init_operator / dora_on_event / dora_drop_operator)."""

    source: str


@dataclass(frozen=True)
class WasmSource:
    """A WASM operator module (declared, run by no runtime)."""

    source: str


@dataclass(frozen=True)
class TorchSource:
    """A torch operator of the port's runtime, fused into its step:
    ``module.path:factory`` or ``file.py:factory`` (the factory takes
    ``device=`` and returns a ``tpu.api.TorchOperator``). ``device``, the
    mapping form ``{source: ..., device: cpu}``, is the operator form's
    counterpart of the custom runtime node's ``--device``: tests set it to
    put the step on the CPU; None (the string form) is cuda."""

    source: str
    device: str | None = None

    def split(self) -> tuple[str, str]:
        mod, sep, fn = self.source.partition(":")
        return (mod, fn if sep else "make_operator")


@dataclass(frozen=True)
class JaxSource:
    """A JAX operator of the JAX package's runtime (``jax:``); the port's
    check refuses it, naming ``torch:``."""

    source: str


OperatorSource = PythonSource | SharedLibrarySource | TorchSource | JaxSource | WasmSource

#: operator source keys, in the order of their checks
OPERATOR_KINDS = ("python", "shared-library", "torch", "jax", "wasm")


@dataclass(frozen=True)
class OperatorDefinition:
    id: OperatorId
    source: OperatorSource
    inputs: dict[DataId, Input] = field(default_factory=dict)
    outputs: frozenset[DataId] = frozenset()
    name: str | None = None
    description: str | None = None
    build: str | None = None
    send_stdout_as: str | None = None

    @classmethod
    def parse(cls, value: Mapping[str, Any], default_id: str | None = None) -> "OperatorDefinition":
        op_id = value.get("id", default_id)
        if op_id is None:
            raise ValueError(f"operator missing 'id': {value!r}")
        sources = [k for k in OPERATOR_KINDS if k in value]
        if len(sources) != 1:
            raise ValueError(
                f"operator {op_id!r} must have exactly one of "
                f"{'/'.join(OPERATOR_KINDS)}, got {sources}"
            )
        kind = sources[0]
        raw = value[kind]
        if kind == "python":
            if isinstance(raw, Mapping):
                source: OperatorSource = PythonSource(
                    source=str(raw["source"]), conda_env=raw.get("conda_env")
                )
            else:
                source = PythonSource(source=str(raw))
        elif kind == "shared-library":
            source = SharedLibrarySource(source=str(raw))
        elif kind == "wasm":
            source = WasmSource(source=str(raw))
        elif kind == "torch":
            if isinstance(raw, Mapping):
                source = TorchSource(source=str(raw["source"]), device=raw.get("device"))
            else:
                source = TorchSource(source=str(raw))
        else:
            source = JaxSource(source=str(raw))
        return cls(
            id=OperatorId(str(op_id)),
            source=source,
            inputs=_parse_inputs(value.get("inputs")),
            outputs=_parse_outputs(value.get("outputs")),
            name=value.get("name"),
            description=value.get("description"),
            build=value.get("build"),
            send_stdout_as=value.get("send_stdout_as"),
        )


# ---------------------------------------------------------------------------
# Node model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Deploy:
    machine: str | None = None

    @classmethod
    def parse(cls, value: Mapping[str, Any] | None) -> "Deploy":
        if not value:
            return cls()
        return cls(machine=value.get("machine"))


@dataclass(frozen=True)
class RestartPolicy:
    """Per-node elastic-recovery policy (``restart:`` in the descriptor).

    A node that fails post-barrier (nonzero exit, signal, spawn error)
    is respawned by its daemon up to ``max_attempts`` times with
    exponential backoff (``backoff_base_s * 2**attempt`` capped at
    ``backoff_max_s``, plus jitter), and its un-acked in-flight inputs
    are replayed from the daemon-side replay buffer. Grace kills,
    cascading failures, and pre-barrier failures never respawn.
    """

    max_attempts: int = 0
    backoff_base_s: float = 0.5
    backoff_max_s: float = 15.0

    @classmethod
    def parse(cls, value: Any) -> "RestartPolicy | None":
        if value is None or value is False:
            return None
        if value is True:
            return cls(max_attempts=1)
        if isinstance(value, int):
            return cls(max_attempts=value) if value > 0 else None
        if not isinstance(value, Mapping):
            raise ValueError(
                f"'restart' must be a mapping, int, or bool, got {type(value).__name__}"
            )
        unknown = set(value) - {"max_attempts", "backoff_base_s", "backoff_max_s"}
        if unknown:
            raise ValueError(f"unknown restart keys: {sorted(unknown)}")
        policy = cls(
            max_attempts=int(value.get("max_attempts", 1)),
            backoff_base_s=float(value.get("backoff_base_s", 0.5)),
            backoff_max_s=float(value.get("backoff_max_s", 15.0)),
        )
        if policy.max_attempts < 0 or policy.backoff_base_s < 0:
            raise ValueError("restart: max_attempts/backoff_base_s must be >= 0")
        return policy if policy.max_attempts > 0 else None


@dataclass(frozen=True)
class SloPolicy:
    """Per-node service-level objectives (``slo:`` in the descriptor).

    The daemon passes the targets to the node as ``DORA_SLO_*`` (a serving
    node checks itself against them). All targets are optional; an empty
    mapping is rejected (an ``slo:`` block that checks nothing is a
    descriptor bug).
    """

    ttft_p99_ms: float | None = None
    tokens_per_s_min: float | None = None
    queue_depth_max: int | None = None

    @classmethod
    def parse(cls, value: Any) -> "SloPolicy | None":
        if value is None:
            return None
        if not isinstance(value, Mapping):
            raise ValueError(
                f"'slo' must be a mapping, got {type(value).__name__}"
            )
        unknown = set(value) - {
            "ttft_p99_ms", "tokens_per_s_min", "queue_depth_max"
        }
        if unknown:
            raise ValueError(f"unknown slo keys: {sorted(unknown)}")
        if not value:
            raise ValueError("'slo' must set at least one objective")
        for key in ("ttft_p99_ms", "tokens_per_s_min", "queue_depth_max"):
            raw = value.get(key)
            if raw is not None and not isinstance(raw, (int, float)):
                raise ValueError(f"slo {key} must be a number")
        policy = cls(
            ttft_p99_ms=(
                float(value["ttft_p99_ms"])
                if value.get("ttft_p99_ms") is not None
                else None
            ),
            tokens_per_s_min=(
                float(value["tokens_per_s_min"])
                if value.get("tokens_per_s_min") is not None
                else None
            ),
            queue_depth_max=(
                int(value["queue_depth_max"])
                if value.get("queue_depth_max") is not None
                else None
            ),
        )
        for key, target in policy.as_targets().items():
            if target < 0:
                raise ValueError(f"slo {key} must be >= 0")
        return policy

    def as_targets(self) -> dict[str, float]:
        """Non-None objectives as a plain dict (the node's DORA_SLO_* env
        values)."""
        out = {}
        if self.ttft_p99_ms is not None:
            out["ttft_p99_ms"] = self.ttft_p99_ms
        if self.tokens_per_s_min is not None:
            out["tokens_per_s_min"] = self.tokens_per_s_min
        if self.queue_depth_max is not None:
            out["queue_depth_max"] = self.queue_depth_max
        return out


QOS_CLASSES = ("interactive", "standard", "batch")


@dataclass(frozen=True)
class QosPolicy:
    """Traffic shaping for a serving node (``qos:`` in the descriptor).

    Requests carry a priority class (``interactive`` / ``standard`` /
    ``batch``); the admission queue drains classes by weight with aging
    so ``batch`` never starves forever. Per-class depth bounds and the
    queue-wait deadline turn overload into fast retriable
    ``overloaded`` chunks instead of unbounded backlog, and
    ``preempt`` lets an inadmissible higher-class request evict a
    lower-class decode (recompute-on-resume, token-identical).
    """

    default_class: str = "standard"
    depth_interactive: int | None = None
    depth_standard: int | None = None
    depth_batch: int | None = None
    shed_wait_ms: float | None = None
    aging_s: float | None = None
    preempt: bool | None = None

    _KEYS = (
        "default_class",
        "depth_interactive",
        "depth_standard",
        "depth_batch",
        "shed_wait_ms",
        "aging_s",
        "preempt",
    )

    @classmethod
    def parse(cls, value: Any) -> "QosPolicy | None":
        if value is None:
            return None
        if not isinstance(value, Mapping):
            raise ValueError(
                f"'qos' must be a mapping, got {type(value).__name__}"
            )
        unknown = set(value) - set(cls._KEYS)
        if unknown:
            raise ValueError(f"unknown qos keys: {sorted(unknown)}")
        if not value:
            raise ValueError("'qos' must set at least one knob")
        default_class = value.get("default_class", "standard")
        if default_class not in QOS_CLASSES:
            raise ValueError(
                f"qos default_class must be one of {QOS_CLASSES}, "
                f"got {default_class!r}"
            )
        for key in ("depth_interactive", "depth_standard", "depth_batch"):
            raw = value.get(key)
            if raw is not None and (not isinstance(raw, int) or raw < 1):
                raise ValueError(f"qos {key} must be an int >= 1")
        for key in ("shed_wait_ms", "aging_s"):
            raw = value.get(key)
            if raw is not None and (
                not isinstance(raw, (int, float)) or raw < 0
            ):
                raise ValueError(f"qos {key} must be a number >= 0")
        preempt = value.get("preempt")
        if preempt is not None and not isinstance(preempt, bool):
            raise ValueError("qos preempt must be a bool")
        return cls(
            default_class=str(default_class),
            depth_interactive=value.get("depth_interactive"),
            depth_standard=value.get("depth_standard"),
            depth_batch=value.get("depth_batch"),
            shed_wait_ms=(
                float(value["shed_wait_ms"])
                if value.get("shed_wait_ms") is not None
                else None
            ),
            aging_s=(
                float(value["aging_s"])
                if value.get("aging_s") is not None
                else None
            ),
            preempt=preempt,
        )

    def as_env(self) -> dict[str, str]:
        """Set knobs as ``DORA_QOS_*`` suffix -> value strings (the
        daemon injects these before the node's own env, so descriptor
        ``env:`` entries can still override)."""
        out = {"DEFAULT_CLASS": self.default_class}
        if self.depth_interactive is not None:
            out["DEPTH_INTERACTIVE"] = str(self.depth_interactive)
        if self.depth_standard is not None:
            out["DEPTH_STANDARD"] = str(self.depth_standard)
        if self.depth_batch is not None:
            out["DEPTH_BATCH"] = str(self.depth_batch)
        if self.shed_wait_ms is not None:
            out["SHED_WAIT_MS"] = str(self.shed_wait_ms)
        if self.aging_s is not None:
            out["AGING_S"] = str(self.aging_s)
        if self.preempt is not None:
            out["PREEMPT"] = "1" if self.preempt else "0"
        return out


@dataclass(frozen=True)
class CustomNode:
    """A node that is its own executable (or a dynamic/externally-attached
    process)."""

    source: str
    args: str | None = None
    build: str | None = None
    send_stdout_as: str | None = None
    inputs: dict[DataId, Input] = field(default_factory=dict)
    outputs: frozenset[DataId] = frozenset()

    @property
    def is_dynamic(self) -> bool:
        return self.source == DYNAMIC_SOURCE


@dataclass(frozen=True)
class RuntimeNode:
    """A node hosting operators inside the operator runtime."""

    operators: tuple[OperatorDefinition, ...]


@dataclass(frozen=True)
class ResolvedNode:
    id: NodeId
    name: str | None
    description: str | None
    env: dict[str, Any]
    deploy: Deploy
    kind: CustomNode | RuntimeNode
    restart: RestartPolicy | None = None
    slo: SloPolicy | None = None
    qos: QosPolicy | None = None
    #: Explicit serving-engine declaration (``serving: true`` in YAML).
    #: ``slo:``/``qos:`` validation trusts this over the source-name
    #: heuristic, so custom serving nodes under any source name pass.
    #: None = undeclared (heuristic applies); False = declared non-serving.
    serving: bool | None = None

    @property
    def inputs(self) -> dict[DataId, Input]:
        """All inputs, namespaced ``<op>/<input>`` for runtime nodes."""
        if isinstance(self.kind, CustomNode):
            return dict(self.kind.inputs)
        out: dict[DataId, Input] = {}
        for op in self.kind.operators:
            for input_id, inp in op.inputs.items():
                out[DataId(f"{op.id}/{input_id}")] = inp
        return out

    @property
    def outputs(self) -> frozenset[DataId]:
        """All outputs, namespaced ``<op>/<output>`` for runtime nodes."""
        if isinstance(self.kind, CustomNode):
            return self.kind.outputs
        return frozenset(
            DataId(f"{op.id}/{o}") for op in self.kind.operators for o in op.outputs
        )

    def fused_internal_inputs(self) -> frozenset[DataId]:
        """Inputs of a runtime node fed inside it by its fused torch step
        (both ends torch operators of this node): tensors on the device,
        never routed by the daemon, the source output never published."""
        if not isinstance(self.kind, RuntimeNode):
            return frozenset()
        torch_ops = {str(op.id) for op in self.kind.operators
                     if isinstance(op.source, TorchSource)}
        internal = set()
        for op in self.kind.operators:
            if str(op.id) not in torch_ops:
                continue
            for input_id, inp in op.inputs.items():
                m = inp.mapping
                if (getattr(m, "source", None) == str(self.id)
                        and str(m.output).partition("/")[0] in torch_ops):
                    internal.add(DataId(f"{op.id}/{input_id}"))
        return frozenset(internal)

    @property
    def source(self) -> str | None:
        """A custom node's source (None for a runtime node)."""
        return self.kind.source if isinstance(self.kind, CustomNode) else None

    @property
    def args(self) -> str | None:
        """A custom node's arguments (None for a runtime node)."""
        return self.kind.args if isinstance(self.kind, CustomNode) else None

    @property
    def send_stdout_as(self) -> str | None:
        if isinstance(self.kind, CustomNode):
            return self.kind.send_stdout_as
        for op in self.kind.operators:
            if op.send_stdout_as:
                return f"{op.id}/{op.send_stdout_as}"
        return None


# ---------------------------------------------------------------------------
# Parsing helpers
# ---------------------------------------------------------------------------


def _parse_inputs(value: Any) -> dict[DataId, Input]:
    if value is None:
        return {}
    if not isinstance(value, Mapping):
        raise ValueError(f"'inputs' must be a mapping, got {type(value).__name__}")
    return {DataId(str(k)): Input.parse(v) for k, v in value.items()}


def _parse_outputs(value: Any) -> frozenset[DataId]:
    if value is None:
        return frozenset()
    if not isinstance(value, (list, tuple)):
        raise ValueError(f"'outputs' must be a list, got {type(value).__name__}")
    return frozenset(DataId(str(v)) for v in value)


_NODE_KIND_KEYS = ("path", "custom", "operators", "operator")


# ---------------------------------------------------------------------------
# Descriptor
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Descriptor:
    """A parsed dataflow YAML."""

    nodes: tuple[ResolvedNode, ...]
    communication: CommunicationConfig = field(default_factory=CommunicationConfig)
    alerts: "AlertsPolicy | None" = None
    raw: dict[str, Any] = field(default_factory=dict, compare=False)

    # -- constructors -------------------------------------------------------

    @classmethod
    def read(cls, path: str | Path) -> "Descriptor":
        import yaml

        return cls.parse(yaml.safe_load(Path(path).read_text()))

    @classmethod
    def parse(cls, raw: Mapping[str, Any]) -> "Descriptor":
        if not isinstance(raw, Mapping):
            raise ValueError("dataflow descriptor must be a YAML mapping")
        known = {"nodes", "communication", "deploy", "_unstable_deploy", "env", "alerts"}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(f"unknown top-level keys: {sorted(unknown)}")
        nodes_raw = raw.get("nodes")
        if not nodes_raw:
            raise ValueError("dataflow has no nodes")
        global_env = raw.get("env") or {}
        # Top-level deploy provides per-node defaults (e.g. default machine).
        default_deploy = Deploy.parse(raw.get("deploy") or raw.get("_unstable_deploy"))
        nodes = tuple(
            cls._parse_node(n, global_env, default_deploy) for n in nodes_raw
        )
        ids = [n.id for n in nodes]
        dupes = {i for i in ids if ids.count(i) > 1}
        if dupes:
            raise ValueError(f"duplicate node ids: {sorted(dupes)}")
        # alerts.py pulls in the metrics and history modules, which a
        # descriptor without an ``alerts:`` block does not need.
        alerts = None
        if raw.get("alerts") is not None:
            from dora_tpu_torch.alerts import AlertsPolicy

            alerts = AlertsPolicy.parse(raw.get("alerts"))
        return cls(
            nodes=nodes,
            communication=CommunicationConfig.parse(raw.get("communication")),
            alerts=alerts,
            raw=dict(raw),
        )

    @classmethod
    def _parse_node(
        cls,
        value: Mapping[str, Any],
        global_env: Mapping[str, Any],
        default_deploy: "Deploy | None" = None,
    ) -> ResolvedNode:
        if "id" not in value:
            raise ValueError(f"node missing 'id': {value!r}")
        node_id = NodeId(str(value["id"]))
        kinds = [k for k in _NODE_KIND_KEYS if k in value]
        if len(kinds) != 1:
            raise ValueError(
                f"node {node_id!r} must have exactly one of {_NODE_KIND_KEYS}, got {kinds}"
            )
        env = {**global_env, **(value.get("env") or {})}
        env = {str(k): expand_env(v) for k, v in env.items()}
        kind_key = kinds[0]

        if kind_key == "path":
            kind: CustomNode | RuntimeNode = CustomNode(
                source=expand_env(str(value["path"])),
                args=value.get("args"),
                build=value.get("build"),
                send_stdout_as=value.get("send_stdout_as"),
                inputs=_parse_inputs(value.get("inputs")),
                outputs=_parse_outputs(value.get("outputs")),
            )
        elif kind_key == "custom":
            c = value["custom"]
            kind = CustomNode(
                source=expand_env(str(c["source"])),
                args=c.get("args"),
                build=c.get("build"),
                send_stdout_as=c.get("send_stdout_as"),
                inputs=_parse_inputs(c.get("inputs")),
                outputs=_parse_outputs(c.get("outputs")),
            )
            env = {**env, **{str(k): expand_env(v) for k, v in (c.get("envs") or {}).items()}}
        elif kind_key == "operators":
            ops = tuple(OperatorDefinition.parse(o) for o in value["operators"])
            if not ops:
                raise ValueError(f"node {node_id!r} has an empty 'operators' list")
            op_ids = [o.id for o in ops]
            if len(set(op_ids)) != len(op_ids):
                raise ValueError(f"node {node_id!r} has duplicate operator ids")
            kind = RuntimeNode(operators=ops)
        else:  # single "operator" shorthand -> runtime node with one operator
            op = OperatorDefinition.parse(value["operator"], default_id=DEFAULT_OPERATOR_ID)
            kind = RuntimeNode(operators=(op,))

        deploy = Deploy.parse(value.get("deploy") or value.get("_unstable_deploy"))
        if deploy.machine is None and default_deploy is not None:
            deploy = default_deploy
        serving = value.get("serving")
        if serving is not None and not isinstance(serving, bool):
            raise ValueError(
                f"node {node_id!r}: 'serving' must be a boolean, got "
                f"{serving!r}"
            )
        return ResolvedNode(
            id=node_id,
            name=value.get("name"),
            description=value.get("description"),
            env=env,
            deploy=deploy,
            kind=kind,
            restart=RestartPolicy.parse(value.get("restart")),
            slo=SloPolicy.parse(value.get("slo")),
            qos=QosPolicy.parse(value.get("qos")),
            serving=serving,
        )

    # -- queries ------------------------------------------------------------

    def node(self, node_id: NodeId | str) -> ResolvedNode:
        for n in self.nodes:
            if n.id == node_id:
                return n
        raise KeyError(f"no node {node_id!r} in dataflow")

    def output_ids(self) -> set[OutputId]:
        out: set[OutputId] = set()
        for n in self.nodes:
            for o in n.outputs:
                out.add(OutputId(n.id, o))
        return out

    def machines(self) -> set[str]:
        return {n.deploy.machine or "" for n in self.nodes}

    def check(self, working_dir: str | Path | None = None) -> None:
        from dora_tpu_torch.core.validate import check_dataflow

        check_dataflow(self, working_dir)


def new_dataflow_uuid() -> str:
    """UUIDv7-style (time-ordered) dataflow id, as the reference uses."""
    # uuid.uuid7 landed in 3.14; compose one: 48-bit unix-ms + random.
    import os
    import time

    ms = time.time_ns() // 1_000_000
    rand = os.urandom(10)
    b = ms.to_bytes(6, "big") + rand
    b = bytearray(b)
    b[6] = (b[6] & 0x0F) | 0x70  # version 7
    b[8] = (b[8] & 0x3F) | 0x80  # variant
    return str(uuid.UUID(bytes=bytes(b)))
