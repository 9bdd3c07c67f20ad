"""The port's operator tier against dora_tpu's, on the CPU (no daemon).

The dataflows of tests/test_tpu_fuse.py, each in the JAX package's form (a
runtime node with ``jax:`` operators) and in the port's (a custom node
``module:dora_tpu_torch.runtime`` with ``--operator`` arguments and
``<op>/<name>`` streams), with the same toy operators written once in each
package:

* ``FusedGraph.build``: the same topological order, sibling edges,
  external inputs and outputs, timer and trigger inputs, and the cycle
  error;
* ``FusedExecutor``: tick and state, latest-wins sampling, timer warm-up,
  pipelined order, backpressure and flush, the fetch ring and its linger:
  every emitted value and its metadata equal the JAX executor's (these
  toy values are exact in f32);
* the bridge: Arrow in (numbers with shape / dtype metadata, strings, a
  bf16 tensor's f32 wire form) gives the JAX bridge's values and metadata;
* the runtime loop over a scripted node: WAKE, the pipelined flush at the
  stream's end, and the end once every external input closed (a sibling
  edge keeps the node's own input open);
* ``DORA_MESH`` and ``DORA_CHECKPOINT`` are refused by name.
"""

from __future__ import annotations

import queue
import shlex
import threading
import time

import numpy as np
import pyarrow as pa
import pytest
import torch
import yaml

from dora_tpu.core.descriptor import Descriptor as JDescriptor
from dora_tpu.tpu import bridge as jbridge
from dora_tpu.tpu import fuse as jfuse
from dora_tpu_torch.core.descriptor import Descriptor
from dora_tpu_torch.tpu import bridge, fuse
from dora_tpu_torch.tpu.api import TorchOperator, load_torch_operator

JAX_OPS = """
import jax.numpy as jnp

from dora_tpu.tpu.api import JaxOperator


def make_double():
    return JaxOperator(step=lambda state, inputs: (state, {"y": inputs["x"] * 2.0}))


def make_plus():
    def step(state, inputs):
        count = state + 1
        return count, {"y": inputs["x"] + 1.0, "count": count}
    return JaxOperator(step=step, init_state=0)


def make_model():
    def step(state, inputs):
        return state + 1, {"out": inputs["frame"] * state}
    return JaxOperator(step=step, init_state=1)


def make_op():
    return JaxOperator(step=lambda s, i: (s, {"y": i["x"]}))
"""

PORT_OPS = """
import torch

from dora_tpu_torch.tpu.api import TorchOperator


def make_double(device=None):
    return TorchOperator(step=lambda state, inputs: (state, {"y": inputs["x"] * 2.0}))


def make_plus(device=None):
    def step(state, inputs):
        count = state + 1
        return count, {"y": inputs["x"] + 1.0, "count": count}
    return TorchOperator(step=step, init_state=torch.zeros((), dtype=torch.int32, device=device))


def make_model(device=None):
    def step(state, inputs):
        return state + 1, {"out": inputs["frame"] * state}
    return TorchOperator(step=step, init_state=torch.ones((), dtype=torch.int32, device=device))


def make_op(device=None):
    return TorchOperator(step=lambda s, i: (s, {"y": i["x"]}))


def make_wrong(device=None):
    return object()
"""


def _both(tmp_path, nodes: list[dict]) -> tuple:
    """(JAX descriptor, port descriptor) of one dataflow: each node with
    ``operators`` becomes a JAX runtime node and a port runtime node."""
    (tmp_path / "jops.py").write_text(JAX_OPS)
    (tmp_path / "tops.py").write_text(PORT_OPS)
    jnodes, tnodes = [], []
    for node in nodes:
        if "operators" not in node:
            jnodes.append(node)
            tnodes.append(node)
            continue
        jnodes.append({"id": node["id"], "operators": [
            {"id": op["id"], "jax": f"{tmp_path}/jops.py:{op['factory']}",
             "inputs": op.get("inputs", {}), "outputs": op["outputs"]}
            for op in node["operators"]]})
        args = " ".join(
            "--operator " + shlex.quote(f"{op['id']}={tmp_path}/tops.py:{op['factory']}")
            for op in node["operators"])
        tnodes.append({
            "id": node["id"], "path": "module:dora_tpu_torch.runtime",
            "args": args + " --device cpu",
            "inputs": {f"{op['id']}/{k}": v for op in node["operators"]
                       for k, v in op.get("inputs", {}).items()},
            "outputs": [f"{op['id']}/{o}" for op in node["operators"] for o in op["outputs"]],
        })
    return JDescriptor.parse({"nodes": jnodes}), Descriptor.parse({"nodes": tnodes})


SOURCE = {"id": "source", "path": "module:dora_tpu.nodehub.pyarrow_sender",
          "outputs": ["data"]}


def _pipeline(tmp_path):
    return _both(tmp_path, [
        SOURCE,
        {"id": "pipeline", "operators": [
            {"id": "double", "factory": "make_double", "inputs": {"x": "source/data"},
             "outputs": ["y"]},
            {"id": "plus", "factory": "make_plus", "inputs": {"x": "pipeline/double/y"},
             "outputs": ["y", "count"]}]},
        {"id": "sink", "path": "module:dora_tpu.nodehub.echo",
         "inputs": {"in": "pipeline/plus/y"}, "outputs": ["echo"]},
    ])


def _timer(tmp_path):
    return _both(tmp_path, [
        {"id": "cam", "path": "module:dora_tpu.nodehub.pyarrow_sender", "outputs": ["frame"]},
        {"id": "model", "operators": [
            {"id": "m", "factory": "make_model",
             "inputs": {"frame": {"source": "cam/frame", "queue_size": 1},
                        "tick": "dora/timer/millis/100"},
             "outputs": ["out"]}]},
        {"id": "sink", "path": "module:dora_tpu.nodehub.echo",
         "inputs": {"in": "model/m/out", "other": "model/m/out"}, "outputs": ["echo"]},
    ])


def _graphs(jd, td, node_id):
    return (jfuse.FusedGraph.build(jd.node(node_id), jd),
            fuse.FusedGraph.build(td.node(node_id), td))


def _structure(g):
    return (g.topo, g.intra_edges, g.external_inputs, g.timer_inputs, g.external_outputs,
            g.trigger_inputs)


def _values(outputs):
    """{output id: (numpy values, metadata)} of one tick, from either
    package (Arrow arrays or flat numpy arrays)."""
    out = {}
    for key, (arr, meta) in outputs.items():
        values = arr.to_numpy() if isinstance(arr, pa.Array) else np.asarray(arr)
        out[key] = (values.tolist(), values.dtype.name, dict(meta))
    return out


def test_graph_structure_matches(tmp_path):
    for make, node_id in ((_pipeline, "pipeline"), (_timer, "model")):
        jg, tg = _graphs(*make(tmp_path), node_id)
        assert _structure(tg) == _structure(jg)
    jg, tg = _graphs(*_pipeline(tmp_path), "pipeline")
    assert tg.external_outputs == {"plus/y"} and tg.device == torch.device("cpu")
    # without a descriptor every output is external, as in JAX
    jd, td = _pipeline(tmp_path)
    assert (fuse.FusedGraph.build(td.node("pipeline")).external_outputs
            == jfuse.FusedGraph.build(jd.node("pipeline")).external_outputs)


def test_cycle_detected_in_both(tmp_path):
    jd, td = _both(tmp_path, [{"id": "loop", "operators": [
        {"id": "a", "factory": "make_op", "inputs": {"x": "loop/b/y"}, "outputs": ["y"]},
        {"id": "b", "factory": "make_op", "inputs": {"x": "loop/a/y"}, "outputs": ["y"]}]}])
    for build, d in ((jfuse.FusedGraph.build, jd), (fuse.FusedGraph.build, td)):
        with pytest.raises(ValueError, match="cycle"):
            build(d.node("loop"), d)


def test_runtime_args_and_loader(tmp_path):
    _pipeline(tmp_path)
    sources, device = fuse.parse_runtime_args(
        f"--operator a={tmp_path}/tops.py:make_op --device cpu --operator b=m:f")
    assert sources == {"a": f"{tmp_path}/tops.py:make_op", "b": "m:f"} and device == "cpu"
    for bad in ("", "--operator a", "--operator a=x --operator a=y", "--operator a/b=x"):
        with pytest.raises(ValueError):
            fuse.parse_runtime_args(bad)
    op = load_torch_operator(f"{tmp_path}/tops.py:make_op", device="cpu")
    assert isinstance(op, TorchOperator)
    with pytest.raises(TypeError, match="expected TorchOperator"):
        load_torch_operator("tops.py:make_wrong", working_dir=tmp_path, device="cpu")
    node = Descriptor.parse({"nodes": [{"id": "n", "path": "module:dora_tpu_torch.runtime",
                                        "inputs": {"zz/x": "a/b"}}]}).node("n")
    with pytest.raises(ValueError, match="not <operator>/<name>"):
        fuse.operator_definitions(node, {"a": "m:f"})


def _feed(executor, events, pipelined: bool):
    out = []
    for event_id, value in events:
        if pipelined:
            executor.on_event_async(event_id, value, {})
            out += executor.harvest()
        else:
            res = executor.on_event(event_id, value, {})
            if res is not None:
                out.append(res)
    if pipelined:
        out += executor.harvest(block=True)
    return [_values(o) for o in out]


def test_tick_state_and_sync_outputs_match(tmp_path):
    jg, tg = _graphs(*_pipeline(tmp_path), "pipeline")
    events = [("double/x", pa.array([1.0, 2.0])), ("double/other", pa.array([9.0])),
              ("double/x", pa.array([0.0, 0.5]))]
    je, te = jfuse.FusedExecutor(jg), fuse.FusedExecutor(tg)
    assert te.pipeline_depth == 0
    want, got = _feed(je, events, False), _feed(te, events, False)
    assert got == want and len(got) == 2
    assert got[0]["plus/y"] == ([3.0, 5.0], "float32", {"shape": [2], "dtype": "float32"})
    assert int(te.states["plus"]) == int(np.asarray(je.states["plus"])) == 2


def test_timer_warmup_and_latest_wins_match(tmp_path):
    jg, tg = _graphs(*_timer(tmp_path), "model")
    events = [("m/tick", None), ("m/frame", pa.array([2.0])), ("m/tick", None),
              ("m/frame", pa.array([4.0])), ("m/frame", pa.array([5.0])), ("m/tick", None),
              ("m/tick", None)]
    want = _feed(jfuse.FusedExecutor(jg), events, False)
    got = _feed(fuse.FusedExecutor(tg), events, False)
    assert got == want
    assert [o["m/out"][0] for o in got] == [[2.0], [10.0], [15.0]]


@pytest.mark.parametrize("depth,fetch_every,n", [(2, 1, 5), (2, 4, 6), (1, 3, 7), (4, 1, 9)])
def test_pipelined_order_and_flush_match(tmp_path, depth, fetch_every, n):
    jg, tg = _graphs(*_pipeline(tmp_path), "pipeline")
    events = [("double/x", pa.array([float(i), -float(i)])) for i in range(n)]
    je = jfuse.FusedExecutor(jg, pipeline_depth=depth, fetch_every=fetch_every)
    te = fuse.FusedExecutor(tg, pipeline_depth=depth, fetch_every=fetch_every)
    want, got = _feed(je, events, True), _feed(te, events, True)
    je.close()
    assert not te._in_flight and not te._staged
    te.close()
    assert got == want and len(got) == n
    assert [o["plus/y"][0][0] for o in got] == [2 * i + 1 for i in range(n)]
    assert int(te.states["plus"]) == n


def test_pipelined_warmup_and_backpressure(tmp_path, monkeypatch):
    jg, tg = _graphs(*_pipeline(tmp_path), "pipeline")
    te = fuse.FusedExecutor(tg, pipeline_depth=2)
    te.on_event_async("double/other", pa.array([1.0]), {})
    assert not te.has_in_flight
    # slow fetches: in-flight ticks never exceed the depth (+ the staging group)
    gate = threading.Event()
    real = fuse._fetch
    seen = []

    def slow_fetch(value):
        gate.wait(5)
        return real(value)

    monkeypatch.setattr(fuse, "_fetch", slow_fetch)
    releaser = threading.Timer(0.3, gate.set)
    releaser.start()
    for i in range(5):
        te.on_event_async("double/x", pa.array([float(i)]), {})
        seen.append(te._unfetched_ticks())
    out = te.harvest(block=True)
    releaser.join()
    te.close()
    assert max(seen) <= 2 and len(out) == 5
    assert [float(o["plus/y"][0][0]) for o in out] == [2 * i + 1 for i in range(5)]


def test_fetch_ring_linger_flushes_partial_group(tmp_path):
    jg, tg = _graphs(*_pipeline(tmp_path), "pipeline")
    te = fuse.FusedExecutor(tg, pipeline_depth=2, fetch_every=8)
    te._linger_s = 0.05
    woke = threading.Event()
    te.on_fetch_done = woke.set
    te.on_event_async("double/x", pa.array([3.0]), {})
    assert te.harvest() == []  # staged, not yet fetched
    assert woke.wait(5)
    deadline = time.monotonic() + 5
    results = []
    while not results and time.monotonic() < deadline:
        time.sleep(0.01)
        results = te.harvest()
    te.close()
    assert [_values(r)["plus/y"][0] for r in results] == [[7.0]]


def test_pipeline_and_fetch_knobs(monkeypatch):
    monkeypatch.delenv("DORA_PIPELINE_DEPTH", raising=False)
    assert fuse.pipeline_depth_from_env("cuda") == 4 and fuse.pipeline_depth_from_env("cpu") == 0
    assert jfuse.pipeline_depth_from_env() == fuse.pipeline_depth_from_env("cpu")
    monkeypatch.setenv("DORA_PIPELINE_DEPTH", "3")
    assert fuse.pipeline_depth_from_env("cpu") == fuse.pipeline_depth_from_env("cuda") == 3
    monkeypatch.setenv("DORA_FETCH_EVERY", "0")
    assert fuse.fetch_every_from_env() == jfuse.fetch_every_from_env() == 1
    monkeypatch.setenv("DORA_FETCH_EVERY", "6")
    assert fuse.fetch_every_from_env() == 6


def test_host_operator_makes_the_node_synchronous(tmp_path):
    _, tg = _graphs(*_pipeline(tmp_path), "pipeline")
    tg.operators["double"].host = True
    te = fuse.FusedExecutor(tg, pipeline_depth=3, fetch_every=4)
    assert te.eager and te.pipeline_depth == 0 and te.fetch_every == 1


def test_mesh_and_checkpoint_knobs_are_refused(tmp_path, monkeypatch):
    _, tg = _graphs(*_pipeline(tmp_path), "pipeline")
    monkeypatch.setenv("DORA_MESH", "tp=4")
    with pytest.raises(RuntimeError, match="DORA_MESH"):
        fuse.FusedExecutor(tg)
    from dora_tpu_torch.nodehub import ops

    with pytest.raises(RuntimeError, match="DORA_MESH"):
        ops.make_vlm(device="cpu")
    monkeypatch.delenv("DORA_MESH")
    assert fuse.mesh_from_env() is None
    monkeypatch.setenv("DORA_CHECKPOINT", str(tmp_path))
    for make in (ops.make_vlm, ops.make_asr, ops.make_vad):
        with pytest.raises(RuntimeError, match="DORA_CHECKPOINT"):
            make(device="cpu")


def test_bridge_matches_jax():
    cases = [
        (pa.array([1.5, -2.0, 3.25, 4.0, 5.0, 6.0], pa.float32()),
         {"shape": [2, 3], "dtype": "float32"}),
        (pa.array([1, 2, 3, 4], pa.int64()), {"shape": [2, 2], "dtype": "int32"}),
        (pa.array([7, 8, 9], pa.uint8()), None),
        (pa.array(["hello", None, "wörld"]), None),
        (pa.array([0.5, -1.25, 3.0, 1e-3], pa.float32()), {"shape": [4], "dtype": "bfloat16"}),
    ]
    for value, meta in cases:
        want = jbridge.arrow_to_host(value, meta)
        got = bridge.arrow_to_host(value, meta)
        if meta and meta["dtype"] == "bfloat16":
            # numpy has no bf16 here: the port keeps the f32 wire values on
            # the host, and its device tensor holds the JAX bf16 values
            np.testing.assert_array_equal(got, value.to_numpy())
            dev = bridge.arrow_to_device(value, meta, "cpu")
            assert dev.dtype == torch.bfloat16
            np.testing.assert_array_equal(dev.float().numpy(), np.asarray(want, np.float32))
            continue
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert bridge.arrow_to_device(value, meta, "cpu").numpy().tolist() == want.tolist()
    for value in (np.arange(6, dtype=np.float32).reshape(2, 3),
                  np.asarray([[1, 2]], np.int32), np.float32(2.5)):
        jarr, jmeta = jbridge.device_to_arrow(value)
        tarr, tmeta = bridge.device_to_arrow(torch.from_numpy(np.asarray(value)))
        assert tmeta == jmeta and tarr.equals(jarr)
    bf = torch.tensor([[0.5, -1.25], [3.0, 7.0]], dtype=torch.bfloat16)
    jarr, jmeta = jbridge.device_to_arrow(np.asarray(bf.float()).astype(jbridge.np.dtype(
        "bfloat16")))
    tarr, tmeta = bridge.device_to_arrow(bf)
    assert tmeta == jmeta == {"shape": [2, 2], "dtype": "bfloat16"} and tarr.equals(jarr)
    assert bridge.is_tensor_metadata({"shape": [1]}) and not bridge.is_tensor_metadata({})


class _ScriptNode:
    """A node that replays events and records what is sent; ``wake`` queues
    a WAKE as the real node does."""

    def __init__(self, events):
        self.events = queue.Queue()
        for event in events:
            self.events.put(event)
        self.events.put(None)
        self.sent = []
        self.stream_ended = False
        self.wakes = 0
        self._lock = threading.Lock()

    def recv(self, timeout=None):
        event = self.events.get(timeout=10)
        if event is None:
            self.stream_ended = True
        return event

    def wake(self):  # from the fetch workers
        with self._lock:
            self.wakes += 1

    def send_output(self, out_id, data, metadata=None):
        self.sent.append((out_id, np.asarray(data).tolist(), dict(metadata or {})))


def _input(event_id, value):
    return {"type": "INPUT", "id": event_id, "value": value, "metadata": {}}


@pytest.mark.parametrize("depth", [0, 2])
def test_runtime_loop_flushes_and_ends(tmp_path, depth):
    from dora_tpu_torch.runtime import serve

    _, tg = _graphs(*_pipeline(tmp_path), "pipeline")
    events = [_input("double/x", np.asarray([float(i)], np.float32)) for i in range(4)]
    node = _ScriptNode(events + [{"type": "WAKE"}])
    assert serve(node, fuse.FusedExecutor(tg, pipeline_depth=depth)) == 0
    assert [s[1] for s in node.sent] == [[1.0], [3.0], [5.0], [7.0]]
    assert {s[0] for s in node.sent} == {"plus/y"}
    assert depth == 0 or node.wakes == 4  # one per finished fetch

    # a sibling edge from outside the fused graph's view: once every
    # external input closed the loop ends without waiting for the daemon
    _, td = _both(tmp_path, [SOURCE, {"id": "p", "operators": [
        {"id": "double", "factory": "make_double", "inputs": {"x": "source/data"},
         "outputs": ["y"]},
        {"id": "plus", "factory": "make_plus",
         "inputs": {"x": "p/double/y", "y": "source/data"}, "outputs": ["y"]}]},
        {"id": "sink", "path": "x.py", "inputs": {"a": "p/plus/y", "b": "p/double/y"}}])
    graph = fuse.FusedGraph.build(td.node("p"), td)
    assert graph.external_outputs == {"double/y", "plus/y"}
    node = _ScriptNode([_input("double/x", np.asarray([1.0], np.float32)),
                        _input("plus/y", np.asarray([0.0], np.float32)),
                        {"type": "INPUT_CLOSED", "id": "double/x"},
                        {"type": "INPUT_CLOSED", "id": "plus/y"},
                        _input("double/x", np.asarray([5.0], np.float32))])
    serve(node, fuse.FusedExecutor(graph, pipeline_depth=depth))
    assert sorted((s[0], s[1]) for s in node.sent) == [("double/y", [2.0]), ("plus/y", [3.0])]
    assert not node.stream_ended  # ended on the closes, not on the stream's end


def test_event_stream_wake():
    from dora_tpu_torch.node.events import EventStream

    class Channel:
        def __init__(self):
            self.stop = threading.Event()

        def request(self, msg):
            self.stop.wait(10)
            return None

        def interrupt(self):
            self.stop.set()

        def close(self):
            pass

    stream = EventStream(Channel())
    try:
        stream.wake()
        event = stream.recv(timeout=5)
        assert event is EventStream.WAKE and event["type"] == "WAKE"
        assert stream.recv(timeout=0.05) is None and not stream.ended
    finally:
        stream.close()


@pytest.mark.parametrize("name,node,jax_example", [
    ("speech-to-text.yml", "speech", "examples/speech-to-text/dataflow.yml"),
    ("vlm.yml", "vlm", "examples/vlm/dataflow.yml"),
    ("yolo.yml", "detector", "examples/yolo/dataflow.yml"),
    ("translation.yml", "translator", "examples/translation/dataflow.yml"),
    ("translation.yml", "tts", "examples/translation/dataflow.yml")])
def test_example_dataflows_mirror_the_jax_ones(name, node, jax_example):
    """The port's example dataflows pass the JAX package's check, and their
    runtime node has the JAX runtime node's operators and streams."""
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    path = repo / "dora_tpu_torch" / "examples" / name
    jd = JDescriptor.read(path)
    jd.check(repo)
    td = Descriptor.parse(yaml.safe_load(path.read_text()))
    me = td.node(node)
    sources, device = fuse.parse_runtime_args(me.args)
    defs = fuse.operator_definitions(me, sources)
    ref = JDescriptor.read(repo / jax_example).node(node)
    assert device is None and set(defs) == {str(op.id) for op in ref.kind.operators}
    assert {k: str(v.mapping) for k, v in me.inputs.items()} == {
        str(k): str(v.mapping) for k, v in ref.inputs.items()}
    assert me.outputs == {str(o) for o in ref.outputs}
    assert all(s.startswith("dora_tpu_torch.nodehub.ops:make_") for s in sources.values())
