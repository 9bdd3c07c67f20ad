"""The fused graph of one runtime node and its executor (dora_tpu/tpu/fuse.py).

Every operator of the node runs in dataflow order in one step per tick, on
one device and one stream: a sibling edge (an input mapped to
``<self>/<op>/<output>``) is the producing operator's tensor itself, never
an Arrow message, and an output is published only when something outside
the fused graph consumes it. Operator state threads from tick to tick on
the device. The JAX package jits the step with the state donated; here the
step runs eagerly (an operator's own decode loop is a host loop), with no
CUDA graph.

Tick semantics, the JAX package's: timer inputs are the tick triggers when
present, else every external data input triggers; non-trigger inputs are
sampled latest-wins, and no tick runs before every data input has
produced (warm-up). With a pipeline depth above 0 a tick is issued
without waiting for it: each one records a CUDA event, and a fetch worker
copies its outputs into pinned host memory once the event is done, in
tick order; with ``DORA_FETCH_EVERY`` N > 1 the outputs of N ticks are
stacked on the device and fetched as one copy.
"""

from __future__ import annotations

import logging
import os
import shlex
import threading
import time
from dataclasses import dataclass
from typing import Any

import torch

from dora_tpu_torch.core.config import Input, TimerMapping, UserMapping
from dora_tpu_torch.core.descriptor import Descriptor, NodeSpec
from dora_tpu_torch.tpu.api import TorchOperator, load_torch_operator

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class OperatorDefinition:
    """One operator of the port's runtime node: its factory source (from
    the node's ``--operator <id>=<source>`` argument) and the node's
    ``<id>/<name>`` inputs and outputs, without the prefix."""

    id: str
    source: str
    inputs: dict[str, Input]
    outputs: frozenset[str]


def parse_runtime_args(args) -> tuple[dict[str, str], str | None]:
    """({operator id: factory source}, device or None) from the runtime
    node's arguments (a string, as a descriptor holds them, or a list):
    ``--operator <id>=<module:factory | file.py:factory>`` (repeated,
    in order) and ``--device <cuda | cpu>``."""
    import argparse

    argv = shlex.split(args) if isinstance(args, str) else list(args or [])
    ap = argparse.ArgumentParser(prog="dora_tpu_torch.runtime")
    ap.add_argument("--operator", action="append", default=[], metavar="ID=SOURCE")
    ap.add_argument("--device", default=None)
    ns = ap.parse_args(argv)
    sources: dict[str, str] = {}
    for spec in ns.operator:
        op_id, sep, source = spec.partition("=")
        if not sep or not op_id or not source or "/" in op_id:
            raise ValueError(f"--operator {spec!r}: expected <id>=<module:factory>")
        if op_id in sources:
            raise ValueError(f"--operator {op_id!r} given twice")
        sources[op_id] = source
    if not sources:
        raise ValueError("the runtime node needs at least one --operator <id>=<source>")
    return sources, ns.device


def operator_definitions(node: NodeSpec, sources: dict[str, str]) -> dict[str, OperatorDefinition]:
    """The operators of ``node``: each stream id must be ``<op>/<name>`` of
    an operator that ``sources`` names."""
    inputs: dict[str, dict[str, Input]] = {op: {} for op in sources}
    outputs: dict[str, set[str]] = {op: set() for op in sources}
    for kind, ids, into in (("input", node.inputs, inputs), ("output", node.outputs, outputs)):
        for sid in ids:
            op_id, sep, name = str(sid).partition("/")
            if not sep or op_id not in sources:
                raise ValueError(
                    f"node {node.id!r}: {kind} {sid!r} is not <operator>/<name> of an operator "
                    f"given by --operator ({sorted(sources)})")
            if kind == "input":
                into[op_id][name] = node.inputs[sid]
            else:
                into[op_id].add(name)
    return {op: OperatorDefinition(op, src, inputs[op], frozenset(outputs[op]))
            for op, src in sources.items()}


@dataclass
class FusedGraph:
    """The static structure of one node's fused operator graph."""

    node_id: str
    operators: dict[str, TorchOperator]  # op id -> operator
    definitions: dict[str, OperatorDefinition]
    topo: list[str]  # op ids in dataflow order
    #: (op, input) -> (src op, src output): sibling edges, tensors on the device
    intra_edges: dict[tuple[str, str], tuple[str, str]]
    #: event ids ("<op>/<input>") carrying data from outside the node
    external_inputs: set[str]
    #: event ids fed by daemon timers (trigger, no payload)
    timer_inputs: set[str]
    #: output ids ("<op>/<output>") consumed outside the node
    external_outputs: set[str]
    #: the device every operator's state and every input lives on
    device: torch.device

    @property
    def trigger_inputs(self) -> set[str]:
        return self.timer_inputs or self.external_inputs

    @classmethod
    def build(cls, node: NodeSpec, descriptor: Descriptor | None = None, working_dir=None,
              sources: dict[str, str] | None = None, device=None) -> "FusedGraph":
        """The graph of the port's runtime node ``node``. ``sources`` and
        ``device`` default to what the node's own ``args`` give; ``device``
        None is cuda. Without ``descriptor`` every output is external."""
        from dora_tpu_torch._device import resolve_device

        if sources is None:
            sources, arg_device = parse_runtime_args(node.args)
            device = device if device is not None else arg_device
        dev = resolve_device(device)
        defs = operator_definitions(node, sources)

        intra: dict[tuple[str, str], tuple[str, str]] = {}
        external_inputs: set[str] = set()
        timer_inputs: set[str] = set()
        for op_id, op in defs.items():
            for input_id, inp in op.inputs.items():
                if isinstance(inp.mapping, TimerMapping):
                    timer_inputs.add(f"{op_id}/{input_id}")
                    continue
                mapping: UserMapping = inp.mapping
                if mapping.source == node.id:
                    # sibling edge "<self>/<src_op>/<src_out>"
                    src_op, _, src_out = mapping.output.partition("/")
                    if src_op in defs:
                        intra[(op_id, input_id)] = (src_op, src_out)
                        continue
                external_inputs.add(f"{op_id}/{input_id}")

        topo = _topo_sort(list(defs), intra)
        operators = {op_id: load_torch_operator(defs[op_id].source, working_dir, device=dev)
                     for op_id in topo}

        # Outputs with consumers outside the fused graph; without a
        # descriptor, conservatively every output.
        external_outputs: set[str] = set()
        if descriptor is not None:
            for consumer in descriptor.nodes:
                for input_id, inp in consumer.inputs.items():
                    m = inp.mapping
                    if isinstance(m, TimerMapping) or m.source != node.id:
                        continue
                    if m.output.partition("/")[0] not in defs:
                        continue
                    in_op, _, in_name = input_id.partition("/")
                    internal = consumer.id == node.id and (in_op, in_name) in intra
                    if not internal:
                        external_outputs.add(m.output)
        else:
            for op_id, op in defs.items():
                external_outputs |= {f"{op_id}/{o}" for o in op.outputs}

        return cls(node_id=node.id, operators=operators, definitions=defs, topo=topo,
                   intra_edges=intra, external_inputs=external_inputs,
                   timer_inputs=timer_inputs, external_outputs=external_outputs, device=dev)

    def step_fn(self, states: dict, ext_inputs: dict) -> tuple[dict, dict]:
        """One fused step: every operator in dataflow order, sibling edges
        as the producers' tensors. Returns (new states, the external
        outputs by output id)."""
        produced: dict[str, dict[str, Any]] = {}
        new_states: dict[str, Any] = {}
        for op_id in self.topo:
            inputs: dict[str, Any] = {}
            for input_id in self.definitions[op_id].inputs:
                edge = self.intra_edges.get((op_id, input_id))
                if edge is not None:
                    inputs[input_id] = produced[edge[0]][edge[1]]
                elif f"{op_id}/{input_id}" in ext_inputs:
                    inputs[input_id] = ext_inputs[f"{op_id}/{input_id}"]
            new_states[op_id], produced[op_id] = self.operators[op_id].step(states[op_id],
                                                                            inputs)
        external = {}
        for out_id in sorted(self.external_outputs):
            op_id, _, name = out_id.partition("/")
            if name in produced.get(op_id, {}):
                external[out_id] = produced[op_id][name]
        return new_states, external


def _topo_sort(op_ids: list[str], intra: dict[tuple[str, str], tuple[str, str]]) -> list[str]:
    deps: dict[str, set[str]] = {op: set() for op in op_ids}
    for (dst, _), (src, _) in intra.items():
        deps[dst].add(src)
    order: list[str] = []
    ready = sorted(op for op, d in deps.items() if not d)
    while ready:
        op = ready.pop(0)
        order.append(op)
        for other, d in deps.items():
            if op in d:
                d.discard(op)
                if not d and other not in order and other not in ready:
                    ready.append(other)
                    ready.sort()
    if len(order) != len(op_ids):
        cyclic = sorted(set(op_ids) - set(order))
        raise ValueError(f"cycle among fused operators: {cyclic}")
    return order


def mesh_from_env():
    """The JAX package runs a node's fused step over the device mesh that
    ``DORA_MESH`` names; the port has no mesh yet, so a set ``DORA_MESH``
    raises rather than being ignored. Returns None when it is unset."""
    spec = os.environ.get("DORA_MESH", "").strip()
    if spec:
        raise RuntimeError(
            f"DORA_MESH={spec!r}: the port's operator runtime has no device mesh "
            "(tensor parallelism is not ported); unset DORA_MESH to run on one card")
    return None


def _fetch(value: torch.Tensor) -> torch.Tensor:
    """The one device-to-host copy point of the pipelined executor (a
    module hook, so tests can add latency): a CUDA tensor lands in pinned
    host memory, a CPU tensor is copied (an operator may reuse its
    buffers)."""
    if value.device.type == "cuda":
        host = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
        return host.copy_(value)
    return value.clone()


def fetch_every_from_env() -> int:
    """Ticks a device-to-host fetch carries (``DORA_FETCH_EVERY``, default
    1). With N > 1 the outputs of N ticks stack on the device and move in
    one copy; they arrive in bursts of N (up to N - 1 ticks of added
    latency), and a partial group is fetched after
    ``DORA_FETCH_LINGER_MS`` (default 100)."""
    return max(1, int(os.environ.get("DORA_FETCH_EVERY", "1")))


def pipeline_depth_from_env(device) -> int:
    """Ticks in flight (``DORA_PIPELINE_DEPTH``); default 4 on the card,
    where a tick's kernels are issued without waiting and the copy of its
    outputs overlaps the next ticks, and 0 (synchronous) on the CPU."""
    value = os.environ.get("DORA_PIPELINE_DEPTH")
    if value is not None:
        return max(0, int(value))
    return 4 if torch.device(device).type == "cuda" else 0


class FusedExecutor:
    """Runs one fused graph: latest-wins sampling, tick triggering, state
    threaded on the device, and with ``pipeline_depth`` > 0 ticks issued
    without waiting, their outputs harvested in tick order.

    Outputs are ``{output id: (flat numpy array, tensor metadata)}``, the
    node writes them as Arrow."""

    def __init__(self, graph: FusedGraph, pipeline_depth=None, fetch_every=None):
        mesh_from_env()
        self.graph = graph
        self.device = graph.device
        #: one host operator makes the whole node synchronous, as in JAX
        self.eager = any(op.host for op in graph.operators.values())
        #: zero-argument callback fired from a fetch worker when a
        #: pipelined tick's copy ends (the runtime points it at node.wake)
        self.on_fetch_done = None
        self.pipeline_depth = (pipeline_depth_from_env(self.device) if pipeline_depth is None
                               else pipeline_depth)
        self.fetch_every = fetch_every_from_env() if fetch_every is None else fetch_every
        if self.eager:
            self.pipeline_depth = 0
            self.fetch_every = 1
        self.states = {op_id: op.init_state for op_id, op in graph.operators.items()}
        #: latest device value per external data input (latest-wins sampling)
        self.latest: dict[str, Any] = {}
        #: in-flight (future, n_ticks) pairs, oldest first; each future
        #: resolves to a list of tick-output dicts
        self._in_flight: list[tuple[Any, int]] = []
        #: tick outputs (and the event each one recorded) staged for the next fetch
        self._staged: list[tuple[dict, Any]] = []
        self._linger_s = float(os.environ.get("DORA_FETCH_LINGER_MS", "100")) / 1000.0
        self._linger_timer = None
        # the linger timer submits from its own thread
        self._stage_lock = threading.Lock()
        self._fetch_pool = None
        if self.pipeline_depth > 0:
            from concurrent.futures import ThreadPoolExecutor

            # depth + 1 workers: the backpressure check runs after a
            # dispatch, so depth + 1 ticks can briefly be in flight
            self._fetch_pool = ThreadPoolExecutor(
                max_workers=self.pipeline_depth + 1,
                thread_name_prefix=f"dora-fetch-{graph.node_id}")
        self._first_tick = True
        self._required = graph.external_inputs - graph.timer_inputs

    def observe(self, event_id: str, value, metadata: dict | None) -> None:
        """Record an input's latest value without ticking."""
        from dora_tpu_torch.tpu.bridge import arrow_to_device

        if event_id in self._required and value is not None:
            self.latest[event_id] = arrow_to_device(value, metadata, self.device)

    def _ready(self) -> bool:
        return all(k in self.latest for k in self._required)

    def _step(self) -> dict:
        t0 = time.perf_counter()
        with torch.no_grad():
            self.states, outputs = self.graph.step_fn(self.states, dict(self.latest))
        if self._first_tick:
            self._first_tick = False
            logger.info("fused step first tick: %.1fs", time.perf_counter() - t0)
        return outputs

    def tick_if_ready(self):
        """Run one tick when every required input has produced."""
        if not self._ready():
            return None
        return self.tick()

    def on_event(self, event_id: str, value, metadata: dict | None):
        """Feed one event; returns the outputs when it triggered a tick,
        else None."""
        self.observe(event_id, value, metadata)
        if event_id not in self.graph.trigger_inputs:
            return None
        return self.tick_if_ready()

    def tick(self) -> dict:
        from dora_tpu_torch.tpu.bridge import device_to_host

        outputs = self._step()
        return {out_id: device_to_host(_fetch(v)) for out_id, v in outputs.items()}

    # -- pipelined dispatch (pipeline_depth > 0) ----------------------------

    def on_event_async(self, event_id: str, value, metadata: dict | None) -> None:
        """Pipelined on_event: issue the tick without waiting for it; its
        outputs come out of :meth:`harvest`."""
        self.observe(event_id, value, metadata)
        if event_id not in self.graph.trigger_inputs or not self._ready():
            return
        outputs = self._step()
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        with self._stage_lock:
            self._staged.append((outputs, event))
            if len(self._staged) >= self.fetch_every:
                self._submit_group_locked()
            elif self._linger_timer is None:
                # a partial group is fetched even if no further tick comes
                self._linger_timer = threading.Timer(self._linger_s, self._linger_flush)
                self._linger_timer.daemon = True
                self._linger_timer.start()
        # Backpressure: at most pipeline_depth unfetched ticks beyond the
        # staging group; the waited result stays queued for the harvest.
        limit = self.pipeline_depth + self.fetch_every - 1
        while self._unfetched_ticks() > limit:
            with self._stage_lock:
                oldest = next((f for f, _ in self._in_flight if not f.done()), None)
            if oldest is None:
                break
            oldest.result()

    def _unfetched_ticks(self) -> int:
        with self._stage_lock:
            return sum(n for f, n in self._in_flight if not f.done()) + len(self._staged)

    def _submit_group_locked(self) -> None:
        """Move the staged ticks into one fetch job: one stacked tensor per
        output (issued on the device) and one copy of it."""
        if not self._staged:
            return
        timer, self._linger_timer = self._linger_timer, None
        if timer is not None:
            timer.cancel()
        staged, self._staged = self._staged, []
        if len(staged) == 1:
            payload, event = staged[0]
        else:
            payload = {key: torch.stack([tick[key] for tick, _ in staged])
                       for key in staged[0][0]}
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
        future = self._fetch_pool.submit(self._emit, payload, len(staged), event)
        self._in_flight.append((future, len(staged)))
        if self.on_fetch_done is not None:
            future.add_done_callback(lambda _f: self.on_fetch_done())

    def _submit_group(self) -> None:
        with self._stage_lock:
            self._submit_group_locked()

    def _linger_flush(self) -> None:
        with self._stage_lock:
            self._linger_timer = None
            self._submit_group_locked()

    def _emit(self, outputs: dict, n_ticks: int, event) -> list[dict]:
        from dora_tpu_torch.tpu.bridge import device_to_host

        if event is not None:
            event.synchronize()
        host = {out_id: _fetch(v) for out_id, v in outputs.items()}
        if n_ticks == 1:
            return [{out_id: device_to_host(v) for out_id, v in host.items()}]
        return [{out_id: device_to_host(v[i]) for out_id, v in host.items()}
                for i in range(n_ticks)]

    @property
    def has_in_flight(self) -> bool:
        with self._stage_lock:
            return bool(self._in_flight) or bool(self._staged)

    def harvest(self, block: bool = False) -> list[dict]:
        """Finished tick outputs in dispatch order; ``block`` waits for
        every tick, a partly filled fetch group included (stream end)."""
        if block:
            self._submit_group()
        done: list[dict] = []
        while True:
            with self._stage_lock:
                if not self._in_flight:
                    break
                future, _ = self._in_flight[0]
                if not (block or future.done()):
                    break
                self._in_flight.pop(0)
            done.extend(future.result())
        return done

    def close(self) -> None:
        """Release the fetch workers, after draining what is in flight.
        Call after the stream-end flush (``harvest(block=True)``)."""
        with self._stage_lock:
            timer, self._linger_timer = self._linger_timer, None
            in_flight, self._in_flight = self._in_flight, []
        if timer is not None:
            timer.cancel()
        if self._fetch_pool is not None:
            for future, _ in in_flight:
                try:
                    future.result()
                except Exception:
                    logger.exception("a fetch failed while closing")
            self._fetch_pool.shutdown(wait=True)
            self._fetch_pool = None
