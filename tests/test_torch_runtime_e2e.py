"""The port's operator runtime as a dataflow node under the JAX package's
daemon, on the CPU, against the JAX runtime node in the same dataflow.

A source sends four seeded audio chunks, each first on its ``vad`` output,
then on its ``asr`` output. The ``speech`` node hosts the tiny VAD and ASR
(``DORA_MODEL_SIZE`` tiny), and the ASR also takes the VAD's probability
over a sibling edge (``asr/speech: speech/vad/prob``). A sink records what
``speech/vad/prob`` and ``speech/asr/tokens`` deliver. The dataflow runs
twice: with ``module:dora_tpu_torch.runtime --device cpu`` (whose factories
take the JAX operators' parameters, carried over from an npz written by
the test: the port seeds its own weights otherwise), and with the JAX
runtime node. The records must be the same: every tick in the same order,
tokens equal, probabilities within 1e-5 of the largest, shape and dtype
metadata equal. The port's run has a limit of 45 s, the JAX run (which
compiles) 70 s: the test stays under two minutes.

Both runs take the daemon's routes (``DORA_P2P=0``; the port's node
announces no peer-to-peer listener) and inline payloads, so the JAX node
layer's two limits on a receiver that falls behind on loaded cores stay
out of the comparison: a payload in shared memory lives at most 10 s after
its sender exits, and a peer-to-peer edge whose sender exits early loses
its last frames (both seen with six copies of this test at once).
"""

from __future__ import annotations

import json

import jax
import numpy as np
import yaml

from dora_tpu.daemon import run_dataflow
from dora_tpu.nodehub import ops as jops

PORT_LIMIT_S = 45
JAX_LIMIT_S = 70

SOURCE = """
import time

import numpy as np
import pyarrow as pa

from dora_tpu.node import Node

rng = np.random.default_rng(7)
with Node() as node:
    time.sleep(0.3)
    for i in range(4):
        # inline payloads: their Arrow streams stay under 4096 bytes
        chunk = (rng.normal(size=400 + 80 * i) * (0.1 + i)).astype(np.float32)
        node.send_output("vad", pa.array(chunk))
        node.send_output("asr", pa.array(chunk))
        time.sleep(0.15)
"""

SINK = """
import json
import sys

from dora_tpu.node import Node

records = []
with Node() as node:
    for event in node:
        if event["type"] == "INPUT":
            meta = event["metadata"]
            records.append([event["id"], event["value"].to_numpy().tolist(),
                            meta.get("shape"), meta.get("dtype")])
with open(sys.argv[1], "w") as f:
    json.dump(records, f)
"""

PORT_OPS = """
import numpy as np

from dora_tpu_torch.models.hf.qwen2 import params_from_jax
from dora_tpu_torch.nodehub import ops

_WEIGHTS = np.load(__file__.replace("port_ops.py", "weights.npz"))


def _tree(prefix):
    tree = {}
    for key in _WEIGHTS.files:
        if key.startswith(prefix + "/"):
            node = tree
            *path, leaf = key[len(prefix) + 1:].split("/")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = _WEIGHTS[key]
    return tree


def make_vad(device=None):
    op = ops.make_vad(device=device)
    op.init_state = params_from_jax((_tree("vad/params"), _WEIGHTS["vad/h0"]), device=device)
    return op


def make_asr(device=None):
    op = ops.make_asr(device=device)
    op.init_state = params_from_jax(_tree("asr"), device=device)
    return op
"""


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for key, value in tree.items():
            _flatten(value, f"{prefix}/{key}", out)
    else:
        out[prefix] = np.asarray(tree)


def _run(tmp_path, name: str, speech: dict, limit_s: float) -> list:
    work = tmp_path / name
    work.mkdir()
    (work / "source.py").write_text(SOURCE)
    (work / "sink.py").write_text(SINK)
    records = work / "records.json"
    spec = {"nodes": [
        {"id": "source", "path": "source.py", "outputs": ["vad", "asr"]},
        {"id": "speech", **speech},
        {"id": "sink", "path": "sink.py", "args": str(records),
         "inputs": {"prob": "speech/vad/prob", "tokens": "speech/asr/tokens"}},
    ]}
    for node in spec["nodes"]:
        # one thread a node (the run shares its cores), and every edge
        # through the daemon, as the port's node takes them
        node["env"] = {"OMP_NUM_THREADS": "1", "DORA_P2P": "0"}
    df = work / "dataflow.yml"
    df.write_text(yaml.safe_dump(spec))
    result = run_dataflow(df, timeout_s=limit_s)
    logs = {p.name: p.read_text()[-3000:] for p in next((work / "out").iterdir()).iterdir()}
    assert result.is_ok(), (result.errors(), logs)
    return json.loads(records.read_text())


def test_port_runtime_node_matches_the_jax_runtime_node(tmp_path):
    weights: dict = {}
    vad_params, h0 = jops.make_vad().init_state
    _flatten(jax.device_get(vad_params), "vad/params", weights)
    weights["vad/h0"] = np.asarray(h0)
    _flatten(jax.device_get(jops.make_asr().init_state), "asr", weights)
    np.savez(tmp_path / "weights.npz", **weights)
    (tmp_path / "port_ops.py").write_text(PORT_OPS)

    inputs = {"vad/audio": "source/vad", "asr/audio": "source/asr",
              "asr/speech": "speech/vad/prob"}
    port = _run(tmp_path, "port", {
        "path": "module:dora_tpu_torch.runtime",
        "args": (f"--operator vad={tmp_path}/port_ops.py:make_vad "
                 f"--operator asr={tmp_path}/port_ops.py:make_asr --device cpu"),
        "inputs": inputs, "outputs": ["vad/prob", "asr/tokens"]}, PORT_LIMIT_S)
    ref = _run(tmp_path, "jax", {"operators": [
        {"id": "vad", "jax": "dora_tpu.nodehub.ops:make_vad",
         "inputs": {"audio": "source/vad"}, "outputs": ["prob"]},
        {"id": "asr", "jax": "dora_tpu.nodehub.ops:make_asr",
         "inputs": {"audio": "source/asr", "speech": "speech/vad/prob"},
         "outputs": ["tokens"]}]}, JAX_LIMIT_S)

    # 8 events, the first only warms up: 7 ticks, each a prob and tokens
    assert len(ref) == 14 and [r[0] for r in ref].count("tokens") == 7
    for name in ("prob", "tokens"):
        got = [r for r in port if r[0] == name]
        want = [r for r in ref if r[0] == name]
        assert [r[2:] for r in got] == [r[2:] for r in want], name
        values = np.asarray([r[1] for r in got], np.float64)
        expect = np.asarray([r[1] for r in want], np.float64)
        if name == "tokens":
            np.testing.assert_array_equal(values, expect)
        else:
            np.testing.assert_allclose(values, expect, rtol=0,
                                       atol=1e-5 * np.abs(expect).max())
