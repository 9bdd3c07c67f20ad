"""Operator nodes under the port's daemon (``operator:`` / ``operators:``,
run by ``python -m dora_tpu_torch.runtime``) against the JAX runtime under
the JAX daemon, on the CPU.

* A Python operator (tests/test_runtime_e2e.py's doubling operator) and,
  compiled with g++, a C++ operator of the C ABI and one of the C++ wrapper
  (tests/test_shared_lib_operator.py's): the sink's records equal the JAX
  runtime's.
* ``examples/c-dataflow``, unchanged, copied with ``native/`` into a
  scratch directory: the port CLI's ``build`` and ``run``, and the JAX
  daemon's run of its own copy, give the C sink the same lines.
* Hot reload: ``start --attach --hot-reload`` on the port's coordinator
  and daemon sees an edited Python operator file, the daemon sends RELOAD,
  and the outputs change while the instance's state carries on.
* A ``torch:`` operator node of the tiny VLM (the JAX package's seeded
  weights) beside the custom-node form in one dataflow, and the JAX
  runtime's ``jax: make_vlm``: every frame's tokens equal JAX
  ``vlm.generate`` on that frame in all three.
* ``check`` refuses ``jax:`` naming ``torch:``, and ``wasm:``; the runtime
  raises on a ``wasm:`` operator when it starts.

Each dataflow has a time limit of its own; no timing is asserted.
"""

from __future__ import annotations

import asyncio
import json
import os
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from dora_tpu.core.descriptor import Descriptor as JDescriptor
from dora_tpu.daemon import run_dataflow as jax_run
from dora_tpu_torch.cli.main import _connected_machines
from dora_tpu_torch.core.descriptor import Descriptor
from dora_tpu_torch.core.validate import ValidationError
from dora_tpu_torch.daemon import run_dataflow as port_run

REPO = Path(__file__).resolve().parents[1]
NATIVE = REPO / "native"
LIMIT_S = 120


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_daemon_routes(monkeypatch):
    """The JAX runs take the daemon route: JAX's receivers keep a closed
    sender waiting for acks; the port's runs pair their edges."""
    monkeypatch.setenv("DORA_P2P", "0")


def _run(daemon: str, work: Path, spec: dict, timeout_s: float = LIMIT_S):
    if daemon == "port":
        return port_run(Descriptor.parse(spec), working_dir=work, timeout_s=timeout_s)
    return jax_run(JDescriptor.parse(spec), working_dir=work, timeout_s=timeout_s)


SINK = """
import json
import sys

from {pkg}.node import Node

records = []
with Node() as node:
    for event in node:
        if event["type"] == "INPUT":
            value = event["value"]
            value = value.to_pylist() if hasattr(value, "to_pylist") else list(bytes(value))
            records.append([event["id"], value])
json.dump(records, open(sys.argv[1], "w"))
"""

PY_OPERATOR = """
import pyarrow as pa

from {pkg}.tpu.api import DoraStatus


class Operator:
    def __init__(self):
        self.count = 0

    def on_event(self, event, send_output):
        if event["type"] == "INPUT":
            self.count += 1
            doubled = pa.array([v.as_py() * 2 for v in event["value"]] + [self.count])
            send_output("out", doubled, event["metadata"])
        return DoraStatus.CONTINUE
"""

C_OPERATOR = """
#include <cstdint>
#include "dora_operator_api.h"

struct State { int inputs = 0; };

extern "C" void* dora_init_operator(void) { return new State(); }
extern "C" void dora_drop_operator(void* state) { delete static_cast<State*>(state); }
extern "C" int dora_on_event(void* raw, const DoraOperatorEvent* event,
                             const DoraOperatorSendOutput* send_output) {
  auto* state = static_cast<State*>(raw);
  if (event->type != DORA_OP_EVENT_INPUT) return DORA_OP_CONTINUE;
  state->inputs++;
  uint32_t reply[2] = {(uint32_t)state->inputs, (uint32_t)event->data_len};
  send_output->send(send_output->context, "stats", (const unsigned char*)reply,
                    sizeof(reply), "raw");
  return state->inputs >= 3 ? DORA_OP_STOP : DORA_OP_CONTINUE;
}
"""

CPP_WRAPPER_OPERATOR = """
#include <string>
#include "dora_operator_api.hpp"

class Shouter : public dora::Operator {
  int seen_ = 0;
  dora::Status on_input(std::string_view id, dora::Bytes data,
                        dora::OutputSender& out) override {
    ++seen_;
    out.send("reply", std::string(id) + "#" + std::to_string(seen_) + ":" +
                      std::to_string(data.len));
    return dora::Status::Continue;
  }
};

DORA_REGISTER_OPERATOR(Shouter)
"""


def _compile(work: Path, name: str, source: str) -> None:
    src = work / f"{name}.cpp"
    src.write_text(textwrap.dedent(source))
    proc = subprocess.run(["g++", "-O1", "-shared", "-fPIC", "-std=c++17", "-I", str(NATIVE),
                           str(src), "-o", str(work / f"lib{name}.so")],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def _callback_spec(work: Path, pkg: str) -> dict:
    (work / "op.py").write_text(textwrap.dedent(PY_OPERATOR.format(pkg=pkg)))
    (work / "sink.py").write_text(textwrap.dedent(SINK.format(pkg=pkg)))
    _compile(work, "counter", C_OPERATOR)
    _compile(work, "shouter", CPP_WRAPPER_OPERATOR)
    return {"nodes": [
        {"id": "source", "path": f"module:{pkg}.nodehub.pyarrow_sender", "outputs": ["data"],
         "env": {"DATA": "[2, 4]", "COUNT": "4", "DELAY": "0.05"}},
        {"id": "transform", "operator": {"python": "op.py", "inputs": {"in": "source/data"},
                                         "outputs": ["out"]}},
        {"id": "native", "operators": [
            {"id": "counter", "shared-library": "counter", "inputs": {"in": "source/data"},
             "outputs": ["stats"]},
            {"id": "shouter", "shared-library": "shouter", "inputs": {"in": "source/data"},
             "outputs": ["reply"]}]},
        {"id": "sink", "path": "sink.py", "args": "records.json",
         "inputs": {"doubled": {"source": "transform/op/out", "queue_size": 64},
                    "stats": {"source": "native/counter/stats", "queue_size": 64},
                    "reply": {"source": "native/shouter/reply", "queue_size": 64}}},
    ]}


def test_python_and_shared_library_operators_equal_the_jax_runtime(tmp_path):
    out = {}
    for daemon, pkg in (("port", "dora_tpu_torch"), ("jax", "dora_tpu")):
        work = tmp_path / daemon
        work.mkdir()
        result = _run(daemon, work, _callback_spec(work, pkg))
        assert result.is_ok(), (daemon, result.errors())
        records = json.loads((work / "records.json").read_text())
        out[daemon] = {k: [v for i, v in records if i == k] for k in ("doubled", "stats",
                                                                     "reply")}
    assert out["port"] == out["jax"]
    assert out["port"]["doubled"] == [[4, 8, n] for n in range(1, 5)]
    # the C operator stops itself after three inputs
    assert [bytes(v)[:4] for v in out["port"]["stats"]] == [bytes([n, 0, 0, 0])
                                                          for n in (1, 2, 3)]
    assert len(out["port"]["reply"]) == 4


def _copy_c_dataflow(root: Path) -> Path:
    """examples/c-dataflow and native/ under ``root``, in the repo's layout
    (the build commands name ../../native)."""
    example = root / "examples" / "c-dataflow"
    shutil.copytree(REPO / "examples" / "c-dataflow", example,
                    ignore=shutil.ignore_patterns("out", "*.o", "*.so", "c_node", "c_sink"))
    shutil.copytree(NATIVE, root / "native", ignore=shutil.ignore_patterns("build*", "*.so"))
    return example


def _sink_lines(example: Path) -> list[str]:
    """The C sink's lines of the newest run of ``example``."""
    logs = sorted((example / "out").glob("*/log_c_sink.txt"), key=lambda p: p.stat().st_mtime)
    return [line for line in logs[-1].read_text().splitlines() if line.startswith("c sink: ")]


def _c_node_sums() -> list[str]:
    """What the C sink prints when the operator saw every value: the running
    sums of the C node's values (glibc's srand(42), rand() % 100)."""
    import ctypes

    libc = ctypes.CDLL(None)
    libc.srand(42)
    total, out = 0, []
    for i in range(1, 21):
        total += libc.rand() % 100
        out.append(f"c sink: sum={total} after {i}")
    return out


#: runs of a daemon's c-dataflow: the example's 50 ms timer feeds the
#: operator's default queue of 10, so a runtime starved of the CPU for half
#: a second drops the oldest values, by the queue's contract; such a run (its
#: sink's count short of 20) is repeated
C_FLOW_RUNS = 5


def test_c_dataflow_example_builds_and_runs_under_both_daemons(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out, short = {}, {"port": [], "jax": []}  # the sink's counts of the short runs
    for daemon in ("port", "jax"):
        example = _copy_c_dataflow(tmp_path / daemon)
        res = subprocess.run([sys.executable, "-m", "dora_tpu_torch.cli", "build",
                              str(example / "dataflow.yml")], cwd=example, env=env,
                             capture_output=True, text=True, timeout=180)
        assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-2000:])
        for _ in range(C_FLOW_RUNS):
            if daemon == "port":
                res = subprocess.run([sys.executable, "-m", "dora_tpu_torch.cli", "run",
                                      str(example / "dataflow.yml"), "--timeout", "90"],
                                     cwd=example, env=env, capture_output=True, text=True,
                                     timeout=180)
                assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-2000:])
            else:
                result = jax_run(JDescriptor.read(example / "dataflow.yml"),
                                 working_dir=example, timeout_s=90)
                assert result.is_ok(), result.errors()
            out[daemon] = _sink_lines(example)
            if len(out[daemon]) == 20:
                break
            short[daemon].append(len(out[daemon]))
    assert out["port"] == out["jax"] == _c_node_sums(), {k: (len(v), short[k])
                                                        for k, v in out.items()}


RELOAD_SOURCE = """
import time
import pyarrow as pa
from dora_tpu_torch.node import Node

with Node() as node:
    for i in range(40):
        node.send_output("data", pa.array([i]))
        time.sleep(0.1)
"""

RELOAD_OPERATOR = """
import pathlib

import pyarrow as pa


class Operator:
    def __init__(self):
        self.count = 0

    def on_event(self, event, send_output):
        if event["type"] == "INPUT":
            self.count += 1
            pathlib.Path("running").touch()
            send_output("out", pa.array(["{version}:%d" % self.count]))
"""


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_start_attach_hot_reload_of_an_edited_python_operator(tmp_path, monkeypatch):
    """``start --attach --hot-reload`` on the port's coordinator and daemon:
    the CLI sees the edited operator file and asks for a reload, the
    daemon's RELOAD reaches the runtime, and the new code runs on the old
    instance's ``count``."""
    monkeypatch.setenv("DORA_P2P", "1")
    monkeypatch.setenv("DORA_TPU_STATE_DIR", str(tmp_path / "state"))
    (tmp_path / "source.py").write_text(textwrap.dedent(RELOAD_SOURCE))
    op = tmp_path / "op.py"
    op.write_text(textwrap.dedent(RELOAD_OPERATOR.format(version="v1")))
    (tmp_path / "sink.py").write_text(textwrap.dedent(SINK.format(pkg="dora_tpu_torch")))
    (tmp_path / "flow.yml").write_text(yaml.safe_dump({"nodes": [
        {"id": "source", "path": "source.py", "outputs": ["data"]},
        {"id": "transform", "operator": {"python": "op.py", "inputs": {"in": "source/data"},
                                         "outputs": ["out"]}},
        {"id": "sink", "path": "sink.py", "args": "records.json",
         "inputs": {"text": {"source": "transform/op/out", "queue_size": 64}}},
    ]}))
    daemon_port, control_port = _free_port(), _free_port()
    ctl = f"127.0.0.1:{control_port}"
    cli = [sys.executable, "-m", "dora_tpu_torch.cli"]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    logs = open(tmp_path / "cluster.log", "wb")
    procs = [subprocess.Popen(cli + ["coordinator", "--port", str(daemon_port),
                                     "--control-port", str(control_port), "--quiet"],
                              stdout=logs, stderr=logs, env=env)]
    try:
        procs.append(subprocess.Popen(cli + ["daemon", "--coordinator-addr",
                                             f"127.0.0.1:{daemon_port}"],
                                      stdout=logs, stderr=logs, env=env))
        deadline = time.monotonic() + LIMIT_S
        while not _connected_machines(ctl):
            assert time.monotonic() < deadline, (tmp_path / "cluster.log").read_text()[-3000:]
            time.sleep(0.1)
        attach = subprocess.Popen(cli + ["start", "flow.yml", "--attach", "--hot-reload",
                                         "--coordinator-addr", ctl],
                                  cwd=tmp_path, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
        procs.append(attach)
        deadline = time.monotonic() + LIMIT_S
        while not (tmp_path / "running").exists():
            assert time.monotonic() < deadline and attach.poll() is None, \
                (tmp_path / "cluster.log").read_text()[-3000:]
            time.sleep(0.05)
        op.write_text(textwrap.dedent(RELOAD_OPERATOR.format(version="v2")))
        stamp = time.time() + 2
        os.utime(op, (stamp, stamp))
        out, _ = attach.communicate(timeout=LIMIT_S)
        assert attach.returncode == 0 and "reloading transform/op" in out, out
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
                proc.wait(timeout=20)
        logs.close()
    texts = [v[0] for _i, v in json.loads((tmp_path / "records.json").read_text())]
    versions = [t.split(":")[0] for t in texts]
    k = versions.index("v2")
    assert 0 < k and versions == ["v1"] * k + ["v2"] * (40 - k), versions
    assert [int(t.split(":")[1]) for t in texts] == list(range(1, 41))  # state kept


VLM_OPS = """
import numpy as np

from dora_tpu_torch.models import vlm
from dora_tpu_torch.nodehub import ops

_W = np.load(__file__.replace("vlm_ops.py", "weights.npz"))


def make(device=None):
    tree = {}
    for key in _W.files:
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = _W[key]
    return ops.vlm_operator(vlm.VLMConfig.tiny(), vlm.params_from_jax(tree, device=device))
"""

MAX_NEW = 4


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for key, value in tree.items():
            _flatten(value, f"{prefix}/{key}" if prefix else key, out)
    else:
        out[prefix] = np.asarray(tree)


def _vlm_spec(daemon: str, size: int) -> dict:
    camera = {"id": "camera", "path": "module:dora_tpu_torch.nodehub.camera",
              "inputs": {"tick": "dora/timer/millis/100"}, "outputs": ["image"],
              "env": {"IMAGE_WIDTH": str(size), "IMAGE_HEIGHT": str(size), "SEED": "5",
                      "MAX_FRAMES": "3"}}
    env = {"DORA_MAX_NEW_TOKENS": str(MAX_NEW), "OMP_NUM_THREADS": "1",
           "DORA_MODEL_SIZE": "tiny"}
    image = {"source": "camera/image", "queue_size": 8}
    if daemon == "port":
        vlms = [
            {"id": "vlm", "env": env, "operator": {
                "torch": {"source": "vlm_ops.py:make", "device": "cpu"},
                "inputs": {"image": image}, "outputs": ["tokens"]}},
            {"id": "custom", "path": "module:dora_tpu_torch.runtime", "env": env,
             "args": "--operator op=vlm_ops.py:make --device cpu",
             "inputs": {"op/image": image}, "outputs": ["op/tokens"]},
        ]
        inputs = {"tokens": "vlm/op/tokens", "custom": "custom/op/tokens"}
    else:
        vlms = [{"id": "vlm", "env": env, "operator": {
            "jax": "dora_tpu.nodehub.ops:make_vlm", "inputs": {"image": image},
            "outputs": ["tokens"]}}]
        inputs = {"tokens": "vlm/op/tokens"}
    recorder = {"id": "recorder", "path": "module:dora_tpu_torch.nodehub.record",
                "inputs": inputs, "env": {"RECORD_DIR": "record"}}
    return {"nodes": [camera, *vlms, recorder]}


def test_torch_vlm_operator_node_equals_custom_form_and_jax_runtime(tmp_path):
    import jax
    import pyarrow.parquet as pq

    from dora_tpu.models import tokenizer as jtok
    from dora_tpu.models import vlm as jvlm
    from dora_tpu_torch.nodehub.camera import seeded_frame

    cfg = jvlm.VLMConfig.tiny()
    jparams = jvlm.init_params(jax.random.PRNGKey(0), cfg)
    flat: dict = {}
    _flatten(jparams, "", flat)
    prompt = np.array([[t % cfg.vocab for t in jtok.encode("describe")]], np.int32)
    want = {f: np.asarray(jvlm.generate(
        jparams, cfg, (seeded_frame(cfg.image_size, cfg.image_size, 5, f) / 255.0)[None]
        .astype(np.float32), prompt, MAX_NEW))[0].tolist() for f in range(3)}
    for daemon, streams in (("port", ("tokens", "custom")), ("jax", ("tokens",))):
        work = tmp_path / daemon
        work.mkdir()
        np.savez(work / "weights.npz", **flat)
        (work / "vlm_ops.py").write_text(VLM_OPS)
        result = _run(daemon, work, _vlm_spec(daemon, cfg.image_size))
        assert result.is_ok(), (daemon, result.errors())
        for stream in streams:
            rows = pq.read_table(work / "record" / f"{stream}.parquet").to_pylist()
            # the JAX runtime's outputs carry no input parameters: its
            # three ticks are the three frames, in order (queue_size 8)
            got = {json.loads(r["metadata"]).get("frame", i): r["value"]
                   for i, r in enumerate(rows)}
            assert got == want, (daemon, stream)


@pytest.mark.parametrize("kind,source,reason", [
    ("jax", "dora_tpu.nodehub.ops:make_vlm", "torch: <module>:<factory>"),
    ("wasm", "op.wasm", "WASM operators are not supported"),
])
def test_check_refuses_jax_and_wasm_operators(tmp_path, kind, source, reason):
    (tmp_path / "op.wasm").write_bytes(b"\0asm")
    desc = Descriptor.parse({"nodes": [
        {"id": "cam", "path": "module:dora_tpu_torch.nodehub.camera", "outputs": ["image"]},
        {"id": "vlm", "operator": {kind: source, "inputs": {"image": "cam/image"},
                                   "outputs": ["tokens"]}},
    ]})
    with pytest.raises(ValidationError, match=f"^operator vlm/op: .*{reason}"):
        desc.check(tmp_path)


def test_runtime_raises_on_a_wasm_operator_when_it_starts(tmp_path):
    (tmp_path / "op.wasm").write_bytes(b"\0asm")
    spec = {"nodes": [
        {"id": "source", "path": "module:dora_tpu_torch.nodehub.pyarrow_sender",
         "outputs": ["data"]},
        {"id": "w", "operator": {"wasm": "op.wasm", "inputs": {"in": "source/data"},
                                 "outputs": ["out"]}},
    ]}
    from dora_tpu_torch.daemon import Daemon

    async def run():  # past check, which refuses it first
        daemon = Daemon()
        await daemon.start()
        try:
            df = await daemon.spawn_dataflow(Descriptor.parse(spec), working_dir=tmp_path)
            return await asyncio.wait_for(asyncio.shield(df.done), 60)
        finally:
            await daemon.close()

    result = asyncio.run(run())
    errors = dict(result.errors())
    assert "w" in errors  # (the start barrier it leaves may fail its upstream node too)
    (log,) = (tmp_path / "out").glob("*/log_w.txt")
    assert "operator 'op': WASM operators are not supported yet" in log.read_text()
