"""The port's operator runtime: one dataflow node hosting torch operators
fused into one step per tick (dora_tpu/runtime/__init__.py's loop, for
torch operators).

A daemon (the port's or the JAX package's) spawns it as a custom node::

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
operator. Python and shared-library operators are not hosted.

The operators load before the node subscribes, so the start barrier holds
upstream producers until the weights are in place.

Each output's metadata carries, beside the tensor's ``shape`` and
``dtype``, the parameters of the events its tick read (the trigger's
first, then each input's latest, the first value of a key winning) and
``tick_ns``, the wall time the tick was dispatched: a consumer knows which
frame a caption answers and how long the answer took.
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque
from pathlib import Path

from dora_tpu_torch.telemetry import OTEL_CTX_KEY
from dora_tpu_torch.tpu.bridge import DTYPE_KEY, SHAPE_KEY
from dora_tpu_torch.tpu.fuse import FusedExecutor, FusedGraph, parse_runtime_args

logger = logging.getLogger(__name__)

#: metadata keys of an input that do not pass through to the outputs
_OWN_KEYS = (SHAPE_KEY, DTYPE_KEY, OTEL_CTX_KEY)


def _tick_params(trigger: str, latest: dict, tick_ns: int) -> dict:
    """The parameters a tick's outputs carry: ``tick_ns``, then the
    trigger's and each input's latest metadata (the first value wins)."""
    params = {"tick_ns": tick_ns}
    for event_id in [trigger] + sorted(latest):
        for key, value in latest[event_id].items():
            if key not in _OWN_KEYS:
                params.setdefault(key, value)
    return params


def serve(node, executor: FusedExecutor) -> int:
    """The event loop over ``node`` (``recv``, ``send_output``,
    ``stream_ended``, and ``wake`` when pipelined): finished pipelined ticks
    are emitted on every iteration, WAKE only unparks ``recv``; at the end
    of the stream the ticks in flight are flushed in order, then the
    executor closes. With sibling edges the daemon keeps the node's own
    input open while the node runs, so the loop also ends once every
    external input has closed (a node with timers ends on STOP)."""
    graph = executor.graph
    pipelined = executor.pipeline_depth > 0
    if pipelined:
        executor.on_fetch_done = node.wake
    open_external = set(graph.external_inputs)
    #: each event id's latest metadata, and the params of each tick not yet
    #: emitted, oldest first
    latest: dict[str, dict] = {}
    params: deque[dict] = deque()

    def emit(batches) -> None:
        for outputs in batches:
            tick = params.popleft()
            for out_id, (arr, meta) in outputs.items():
                node.send_output(out_id, arr, {**tick, **meta})

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
                latest[event["id"]] = event["metadata"] or {}
                ticks, tick_ns = executor.ticks, time.time_ns()
                if pipelined:
                    executor.on_event_async(event["id"], event["value"], event["metadata"])
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
            elif kind == "INPUT_CLOSED":
                open_external.discard(event["id"])
                if graph.external_inputs and not open_external and not graph.timer_inputs:
                    break
            elif kind == "STOP":
                break
            elif kind == "ERROR":  # the stream ends after it, as in the JAX runtime
                logger.error("event stream error: %s", event["error"])
        if pipelined:
            try:
                emit(executor.harvest(block=True))
            except Exception:
                logger.exception("pipelined flush failed")
    finally:
        executor.close()
    return 0


def run(argv: list[str] | None = None) -> int:
    """The node's main (spawned with ``DORA_NODE_CONFIG`` set)."""
    from dora_tpu_torch.core.descriptor import Descriptor
    from dora_tpu_torch.node import NODE_CONFIG_ENV, Node, decode_node_config

    raw = os.environ.get(NODE_CONFIG_ENV)
    if not raw:
        raise RuntimeError(f"the runtime must be spawned by a daemon ({NODE_CONFIG_ENV} is "
                           "not set)")
    sources, device = parse_runtime_args(argv)
    config = decode_node_config(raw)
    descriptor = Descriptor.parse(config.dataflow_descriptor)
    graph = FusedGraph.build(descriptor.node(config.node_id), descriptor, Path.cwd(),
                             sources=sources, device=device)
    executor = FusedExecutor(graph)
    logger.info("fused %d operators (topo %s) on %s; external in=%s out=%s",
                len(graph.operators), graph.topo, graph.device,
                sorted(graph.external_inputs | graph.timer_inputs),
                sorted(graph.external_outputs))
    node = Node()  # subscribes: joins the start barrier only now
    try:
        return serve(node, executor)
    finally:
        node.close()
