"""The port's operator runtime: one dataflow node hosting operators
(dora_tpu/runtime/__init__.py): torch operators fused into one step per
tick, and callback operators (Python and shared-library) beside them, in
one loop.

The port's daemon runs an operator node of the descriptor with it
(``python -m dora_tpu_torch.runtime``)::

    - id: vlm
      operator:
        torch: dora_tpu_torch.nodehub.ops:make_vlm   # or {source: ..., device: cpu}
        inputs:
          image: camera/image
        outputs: [tokens]

    - id: counter
      operators:
        - id: py
          python: op.py            # class Operator: on_event(event, send_output)
          inputs: {in: source/data}
          outputs: [out]
        - id: c
          shared-library: c_counter  # the C ABI of native/dora_operator_api.h
          inputs: {in: source/data}
          outputs: [status]

A Python operator's file defines ``class Operator`` whose ``on_event(event,
send_output)`` returns a ``tpu.api.DoraStatus``; RELOAD re-imports the file
and keeps the instance's ``__dict__``. The node ends when its input stream
ends, on STOP, when an operator returns STOP_ALL, or when every callback
operator has stopped and there is no torch operator. A ``wasm:`` operator
raises when the runtime starts, as the JAX runtime's does.

A daemon (the port's or the JAX package's) also spawns it as a custom node::

    - id: speech
      path: module:dora_tpu_torch.runtime
      args: --operator vad=dora_tpu_torch.nodehub.ops:make_vad
            --operator asr=dora_tpu_torch.nodehub.ops:make_asr
      inputs:
        vad/audio: microphone/audio
        asr/audio: microphone/audio
      outputs: [vad/prob, asr/tokens]

Its streams are named ``<op>/<name>``, as a runtime node's are, so
consumers map ``speech/asr/tokens``. An input mapped to the node's own
output (``asr/speech: speech/vad/prob``) is a sibling edge: resolved on the
device inside the step, and the output is published only if something
outside the node consumes it. ``--device`` (default cuda) places every
operator.

The torch operators load before the node subscribes, so the start barrier
holds upstream producers until the weights are in place.

Each output's metadata carries, beside the tensor's ``shape`` and
``dtype``, the parameters of the events its tick read (the trigger's
first, then each input's latest, the first value of a key winning) and
``tick_ns``, the wall time the tick was dispatched: a consumer knows which
frame a caption answers and how long the answer took.
"""

from __future__ import annotations

import importlib.util
import logging
import os
import time
from collections import deque
from pathlib import Path
from typing import Any

from dora_tpu_torch.telemetry import OTEL_CTX_KEY, TRACING, child_context
from dora_tpu_torch.tpu.api import DoraStatus

logger = logging.getLogger(__name__)

#: metadata keys of an input that do not pass through to the outputs
#: (tpu.bridge's SHAPE_KEY and DTYPE_KEY, and the trace context)
_OWN_KEYS = ("shape", "dtype", OTEL_CTX_KEY)


def _tick_params(trigger: str, latest: dict, tick_ns: int) -> dict:
    """The parameters a tick's outputs carry: ``tick_ns``, then the
    trigger's and each input's latest metadata (the first value wins)."""
    params = {"tick_ns": tick_ns}
    for event_id in [trigger] + sorted(latest):
        for key, value in latest[event_id].items():
            if key not in _OWN_KEYS:
                params.setdefault(key, value)
    return params


class PythonOperatorHost:
    """One Python operator: the instance of its file's ``class Operator``,
    given the dataflow's descriptor (as a mapping) as an attribute. ``node``
    (set before the first event) publishes its outputs."""

    def __init__(self, definition, descriptor: dict, working_dir: Path, node=None):
        self.definition = definition
        self.descriptor = descriptor
        self.node = node
        self.working_dir = working_dir
        self.stopped = False
        self.instance = self._instantiate()

    def _instantiate(self):
        path = Path(self.definition.source.source)
        if not path.is_absolute():
            path = self.working_dir / path
        spec = importlib.util.spec_from_file_location(f"dora_tpu_torch_pyop_{self.definition.id}",
                                                      path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        instance = module.Operator()
        instance.dataflow_descriptor = self.descriptor
        return instance

    def reload(self) -> None:
        """Re-import the file, keeping the operator's state (``__dict__``);
        on failure the old code stays."""
        old_dict = dict(self.instance.__dict__)
        try:
            self.instance = self._instantiate()
            self.instance.__dict__.update(old_dict)
            logger.info("operator %s reloaded", self.definition.id)
        except Exception:
            logger.exception("hot reload of %s failed; keeping the old code", self.definition.id)

    def on_event(self, event: dict) -> DoraStatus:
        if self.stopped:
            return DoraStatus.STOP
        # with tracing on, the operator's span parents its outputs' t_send
        ctx = str((event.get("metadata") or {}).get(OTEL_CTX_KEY, ""))
        if TRACING.active:
            ctx = child_context(ctx)

        def send_output(output_id: str, data=None, metadata=None):
            metadata = dict(metadata or {})
            if ctx:
                metadata.setdefault(OTEL_CTX_KEY, ctx)
            self.node.send_output(f"{self.definition.id}/{output_id}", data, metadata)

        status = self.instance.on_event(event, send_output)
        if status is None:
            return DoraStatus.CONTINUE
        status = DoraStatus(int(status))
        if status == DoraStatus.STOP:
            self.stopped = True
        return status


def serve(node, executor=None, hosts: dict[str, Any] | None = None) -> int:
    """The event loop over ``node`` (``recv``, ``send_output``,
    ``stream_ended``, and ``wake`` when pipelined): an input of a callback
    operator in ``hosts`` (operator id -> host) goes to its ``on_event``,
    any other to the fused torch ``executor``; RELOAD reloads the Python
    operators it names. Finished pipelined ticks are emitted on every
    iteration, WAKE only unparks ``recv``; at the end of the stream the
    ticks in flight are flushed in order, the executor closes and each
    callback operator still running gets STOP. With sibling edges of the
    custom-node form, the daemon keeps the node's own input open while the
    node runs, so a node of torch operators alone also ends once every
    external input has closed (a node with timers ends on STOP)."""
    hosts = hosts or {}
    graph = executor.graph if executor is not None else None
    pipelined = executor is not None and executor.pipeline_depth > 0
    if pipelined:
        executor.on_fetch_done = node.wake
    open_external = set(graph.external_inputs) if graph is not None else set()
    #: each event id's latest metadata, and the params of each tick not yet
    #: emitted, oldest first
    latest: dict[str, dict] = {}
    params: deque[dict] = deque()

    def emit(batches) -> None:
        for outputs in batches:
            tick = params.popleft()
            for out_id, (arr, meta) in outputs.items():
                node.send_output(out_id, arr, {**tick, **meta})

    stop_all = False
    try:
        while True:
            event = node.recv()
            # every iteration, not only on WAKE: a wake dropped against a
            # full event queue must not strand a finished tick
            if pipelined and executor.has_in_flight:
                emit(executor.harvest())
            if event is None:
                if node.stream_ended:
                    break
                continue
            kind = event["type"]
            if kind == "INPUT":
                op_id, _, input_id = event["id"].partition("/")
                host = hosts.get(op_id)
                if host is not None:
                    status = host.on_event({"type": "INPUT", "id": input_id,
                                            "value": event["value"],
                                            "metadata": event["metadata"]})
                    stop_all = stop_all or status == DoraStatus.STOP_ALL
                elif executor is not None:
                    latest[event["id"]] = event["metadata"] or {}
                    ticks, tick_ns = executor.ticks, time.time_ns()
                    if pipelined:
                        executor.on_event_async(event["id"], event["value"],
                                                event["metadata"])
                        if executor.ticks != ticks:
                            params.append(_tick_params(event["id"], latest, tick_ns))
                        emit(executor.harvest())
                    else:
                        outputs = executor.on_event(event["id"], event["value"],
                                                    event["metadata"])
                        if executor.ticks != ticks:
                            params.append(_tick_params(event["id"], latest, tick_ns))
                        if outputs is not None:
                            emit([outputs])
            elif kind == "RELOAD":
                target = event["operator_id"]
                for op_id, host in hosts.items():
                    if target in (None, op_id) and hasattr(host, "reload"):
                        host.reload()  # shared-library operators do not reload
            elif kind == "INPUT_CLOSED":
                open_external.discard(event["id"])
                if (graph is not None and not hosts and graph.external_inputs
                        and not open_external and not graph.timer_inputs):
                    break
            elif kind == "STOP":
                break
            elif kind == "ERROR":  # the stream ends after it, as in the JAX runtime
                logger.error("event stream error: %s", event["error"])
            if stop_all or (hosts and executor is None
                            and all(h.stopped for h in hosts.values())):
                break
        if pipelined:
            try:
                emit(executor.harvest(block=True))
            except Exception:
                logger.exception("pipelined flush failed")
    finally:
        if executor is not None:
            executor.close()
        for host in hosts.values():
            if not host.stopped:
                try:
                    host.on_event({"type": "STOP", "id": None, "value": None, "metadata": {}})
                except Exception:
                    pass
            close = getattr(host, "close", None)
            if close is not None:
                close()
    return 0


def _refuse_unhosted(node) -> None:
    """The JAX package's runtime raises at start on a WASM operator; a
    ``jax:`` operator is the JAX runtime's, whose port is ``torch:``."""
    from dora_tpu_torch.core.descriptor import JaxSource, WasmSource

    for op in node.kind.operators:
        if isinstance(op.source, WasmSource):
            raise RuntimeError(f"operator {str(op.id)!r}: WASM operators are not supported yet")
        if isinstance(op.source, JaxSource):
            raise RuntimeError(f"operator {str(op.id)!r}: 'jax: {op.source.source}' is the JAX "
                               "package's operator; the port's runtime fuses 'torch:' ones")


def run(argv: list[str] | None = None) -> int:
    """The node's main (spawned with ``DORA_NODE_CONFIG`` set): an operator
    node of the descriptor, or the custom node's ``--operator`` arguments.
    Every operator loads before the node subscribes, so the start barrier
    holds upstream producers until they are in place."""
    from dora_tpu_torch.core.descriptor import (
        Descriptor,
        PythonSource,
        RuntimeNode,
        SharedLibrarySource,
        TorchSource,
    )
    from dora_tpu_torch.node import NODE_CONFIG_ENV, Node, decode_node_config

    raw = os.environ.get(NODE_CONFIG_ENV)
    if not raw:
        raise RuntimeError(f"the runtime must be spawned by a daemon ({NODE_CONFIG_ENV} is "
                           "not set)")
    config = decode_node_config(raw)
    descriptor = Descriptor.parse(config.dataflow_descriptor)
    me = descriptor.node(config.node_id)
    working_dir = Path.cwd()
    operator_node = isinstance(me.kind, RuntimeNode)
    if operator_node:
        _refuse_unhosted(me)
    executor = None
    if not operator_node or any(isinstance(op.source, TorchSource) for op in me.kind.operators):
        from dora_tpu_torch.tpu.fuse import FusedExecutor, FusedGraph, parse_runtime_args

        if operator_node:
            graph = FusedGraph.build(me, descriptor, working_dir)
        else:
            sources, device = parse_runtime_args(argv)
            graph = FusedGraph.build(me, descriptor, working_dir, sources=sources,
                                     device=device)
        executor = FusedExecutor(graph)
        logger.info("fused %d operators (topo %s) on %s; external in=%s out=%s",
                    len(graph.operators), graph.topo, graph.device,
                    sorted(graph.external_inputs | graph.timer_inputs),
                    sorted(graph.external_outputs))
    hosts: dict[str, Any] = {}
    for op in me.kind.operators if operator_node else ():
        if isinstance(op.source, PythonSource):
            hosts[str(op.id)] = PythonOperatorHost(op, config.dataflow_descriptor, working_dir)
        elif isinstance(op.source, SharedLibrarySource):
            from dora_tpu_torch.runtime.shared_lib import SharedLibOperatorHost

            hosts[str(op.id)] = SharedLibOperatorHost(op, working_dir)
    node = Node()  # subscribes: joins the start barrier only now
    for host in hosts.values():
        host.node = node
    try:
        return serve(node, executor, hosts)
    finally:
        node.close()
