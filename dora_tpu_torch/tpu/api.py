"""The operator ABI of the port's runtime (dora_tpu/tpu/api.py): the status
codes of a callback operator and ``TorchOperator``, the counterpart of
``JaxOperator``, with ``load_torch_operator`` resolving a factory."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Callable


class DoraStatus(enum.IntEnum):
    """Return value of a callback operator's on_event."""

    CONTINUE = 0
    STOP = 1
    STOP_ALL = 2


@dataclass
class TorchOperator:
    """An operator of the port's runtime: ``step(state, inputs) ->
    (new_state, outputs)``, where ``inputs`` / ``outputs`` are dicts keyed
    by the operator's input / output names and the values are tensors on
    the operator's device. The runtime runs the node's operators in
    dataflow order on one stream; a sibling's output reaches the next
    operator as the tensor itself. ``init_state`` (weights and carried
    state, already on the device) is threaded from tick to tick. An output
    must be a tensor that no later step writes in place: with pipelining
    its copy to the host is taken after the next ticks have been issued.

    ``input_shapes`` and ``sharding`` keep the fields of the JAX contract:
    the JAX package pins shapes for a compile and places state on a mesh;
    the port compiles nothing at tick time and runs a node on one card
    (``DORA_MESH`` is refused), so neither is read. ``host=True`` marks an operator that
    must run outside the pipelined path (data-dependent shapes); as in
    the JAX package, one host operator makes its whole node synchronous."""

    step: Callable[[Any, dict[str, Any]], tuple[Any, dict[str, Any]]]
    init_state: Any = ()
    input_shapes: dict[str, tuple] = field(default_factory=dict)
    sharding: Any = None
    host: bool = False


def load_torch_operator(source: str, working_dir=None, device=None) -> TorchOperator:
    """Resolve an operator source, ``module.path:factory`` or
    ``file.py:factory`` (the factory defaults to ``make_operator``), and
    call the factory with ``device=`` (None: cuda)."""
    import importlib
    import importlib.util
    from pathlib import Path

    mod_path, sep, factory_name = source.partition(":")
    factory_name = factory_name if sep else "make_operator"
    if mod_path.endswith(".py"):
        path = Path(mod_path)
        if working_dir is not None and not path.is_absolute():
            path = Path(working_dir) / path
        spec = importlib.util.spec_from_file_location(f"dora_tpu_torch_op_{path.stem}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(mod_path)
    operator = getattr(module, factory_name)(device=device)
    if not isinstance(operator, TorchOperator):
        raise TypeError(f"{source}: factory returned {type(operator).__name__}, "
                        "expected TorchOperator")
    return operator
