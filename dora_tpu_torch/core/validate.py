"""Dataflow validation (dora_tpu/core/validate.py): every custom node's and
operator's source resolves, every input names an existing node and one of
its declared outputs. The port's runtime hosts ``python``,
``shared-library`` and ``torch`` operators; a ``jax:`` operator is refused
naming ``torch:``, its counterpart, and a ``wasm:`` one as unsupported."""

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
    TorchSource,
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
                _check_operator_source(node.id, op.id, op.source, working_dir)

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


def adjust_shared_library_path(path: Path) -> Path:
    """'op' -> 'libop.so' / 'op.so' when the bare name does not exist."""
    if path.exists():
        return path
    for candidate in (path.with_name(f"lib{path.name}.so"), path.with_name(f"{path.name}.so")):
        if candidate.exists():
            return candidate
    return path


def _check_operator_source(node_id, op_id, source, working_dir: Path | None) -> None:
    if isinstance(source, (PythonSource, SharedLibrarySource)):
        src = source.source
        if "://" in src:
            raise ValidationError(
                f"operator {node_id}/{op_id}: source {src!r} is a URL, and the port's daemon "
                "downloads nothing")
        path = Path(src)
        if working_dir and not path.is_absolute():
            path = working_dir / path
        if isinstance(source, SharedLibrarySource):
            path = adjust_shared_library_path(path)
        if not path.exists():
            raise ValidationError(f"operator {node_id}/{op_id}: source {src!r} not found")
        if isinstance(source, PythonSource) and path.suffix != ".py":
            raise ValidationError(
                f"operator {node_id}/{op_id}: python source must be a .py file")
    elif isinstance(source, TorchSource):
        mod, _fn = source.split()
        if mod.endswith(".py"):
            path = Path(mod)
            if working_dir and not path.is_absolute():
                path = working_dir / path
            if not path.exists():
                raise ValidationError(
                    f"operator {node_id}/{op_id}: torch source file {mod!r} not found")
        # a module path resolves when the runtime imports it
    elif isinstance(source, JaxSource):
        raise ValidationError(
            f"operator {node_id}/{op_id}: 'jax: {source.source}' is the JAX package's "
            "operator; the port's runtime fuses torch operators: write "
            f"'torch: <module>:<factory>' (e.g. torch: dora_tpu_torch.nodehub.ops:make_vlm)")
    else:
        raise ValidationError(f"operator {node_id}/{op_id}: WASM operators are not supported")
