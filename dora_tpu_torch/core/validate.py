"""Dataflow validation (dora_tpu/core/validate.py): every custom node's
source resolves, every input names an existing node and one of its declared
outputs. Operator nodes are refused by name: the port's runtime is a custom
node (``module:dora_tpu_torch.runtime --operator <id>=<factory>``), and it
hosts no Python, shared-library, JAX or WASM operator."""

from __future__ import annotations

import shutil
from pathlib import Path

from dora_tpu_torch.core.config import TimerMapping, UserMapping
from dora_tpu_torch.core.descriptor import (
    DYNAMIC_SOURCE,
    SHELL_SOURCE,
    CustomNode,
    Descriptor,
    JaxSource,
    PythonSource,
    RuntimeNode,
    SharedLibrarySource,
)


class ValidationError(ValueError):
    pass


def check_dataflow(descriptor: Descriptor, working_dir: str | Path | None = None) -> None:
    """Raise ValidationError on the first problem found."""
    working_dir = Path(working_dir) if working_dir else None

    declared_outputs = descriptor.output_ids()
    node_ids = {n.id for n in descriptor.nodes}

    for node in descriptor.nodes:
        # 1. sources resolvable
        if isinstance(node.kind, CustomNode):
            _check_custom_source(node.id, node.kind, working_dir)
        else:
            assert isinstance(node.kind, RuntimeNode)
            for op in node.kind.operators:
                _refuse_operator(node.id, op.id, op.source)

        # 2. every input refers to an existing node + declared output
        for input_id, inp in node.inputs.items():
            m = inp.mapping
            if isinstance(m, TimerMapping):
                continue
            assert isinstance(m, UserMapping)
            if m.source not in node_ids:
                raise ValidationError(
                    f"input {node.id}/{input_id}: source node {m.source!r} does not exist"
                )
            if m.output_id not in declared_outputs:
                raise ValidationError(
                    f"input {node.id}/{input_id}: node {m.source!r} has no "
                    f"output {m.output!r}"
                )


def _check_custom_source(node_id, kind: CustomNode, working_dir: Path | None) -> None:
    source = kind.source
    if source in (DYNAMIC_SOURCE, SHELL_SOURCE):
        return
    if "://" in source:
        raise ValidationError(
            f"node {node_id!r}: source {source!r} is a URL, and the port's daemon "
            "downloads nothing")
    if source.startswith("module:"):  # an installed Python module
        return
    path = Path(source)
    if working_dir and not path.is_absolute():
        path = working_dir / path
    if path.exists():
        return
    # Not a file: anything on PATH (e.g. "python").
    if shutil.which(source):
        return
    raise ValidationError(f"node {node_id!r}: source {source!r} not found")


def _refuse_operator(node_id, op_id, source) -> None:
    if isinstance(source, (PythonSource, SharedLibrarySource)):
        kind = "python" if isinstance(source, PythonSource) else "shared-library"
        raise ValidationError(
            f"operator {node_id}/{op_id}: the port's runtime hosts no {kind} operators "
            "(callback operators are not ported)")
    if isinstance(source, JaxSource):
        raise ValidationError(
            f"operator {node_id}/{op_id}: a jax operator belongs to the JAX package's "
            "runtime; the port's runtime is the custom node "
            "'module:dora_tpu_torch.runtime --operator <id>=<module:factory>'")
    raise ValidationError(
        f"operator {node_id}/{op_id}: WASM operators are not supported")
