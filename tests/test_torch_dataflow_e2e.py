"""The port's dataflows end to end under the port's own daemon, on the CPU.

* ``dora_tpu_torch/examples/vlm.yml`` at the tiny size (``--device cpu``,
  the JAX package's seeded tiny VLM carried over from an npz, four new
  tokens, three seeded camera frames): every caption the recorder wrote, under
  the port's daemon and under the JAX daemon, equals JAX ``vlm.generate`` on
  the frame its metadata names, and the two runs' captions of a frame are
  equal.
* The serving node (``nodehub.llm_server``, the stub engine) behind the
  port's daemon gives the chunks the JAX stub node gives behind the JAX
  daemon.
* ``bench_vlm e2e`` on the CPU: its FPS line and the VLM node's launch line.

Each dataflow has a time limit of its own; no timing is asserted.
"""

from __future__ import annotations

import asyncio
import json
import textwrap

import jax
import numpy as np
import pyarrow.parquet as pq
import yaml

from dora_tpu.core.descriptor import Descriptor as JDescriptor
from dora_tpu.daemon import run_dataflow as jax_run
from dora_tpu.daemon.core import Daemon as JDaemon
from dora_tpu.models import tokenizer as jtok
from dora_tpu.models import vlm as jvlm
from dora_tpu_torch.core.descriptor import Descriptor
from dora_tpu_torch.daemon import Daemon, run_dataflow
from dora_tpu_torch.nodehub.camera import seeded_frame

LIMIT_S = 90
#: seconds each VLM dataflow runs on after its first caption
VLM_AFTER_S = 1.0
MAX_NEW = 4
CFG = jvlm.VLMConfig.tiny()

#: the runtime's factory: ``make_vlm``'s operator over the JAX weights
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


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for key, value in tree.items():
            _flatten(value, f"{prefix}/{key}" if prefix else key, out)
    else:
        out[prefix] = np.asarray(tree)


def _vlm_spec() -> dict:
    """vlm.yml with the tiny model on the CPU, three seeded frames, the
    runtime's factory over the JAX weights and the recorder into ./record."""
    raw = yaml.safe_load(open("dora_tpu_torch/examples/vlm.yml").read())
    nodes = {n["id"]: n for n in raw["nodes"]}
    size = str(CFG.image_size)
    nodes["camera"]["env"].update(IMAGE_WIDTH=size, IMAGE_HEIGHT=size, SEED="5",
                                  MAX_FRAMES="3")
    nodes["vlm"]["args"] = "--operator op=vlm_ops.py:make --device cpu"
    nodes["vlm"]["env"] = {"DORA_MAX_NEW_TOKENS": str(MAX_NEW), "OMP_NUM_THREADS": "1"}
    nodes["recorder"]["env"] = {"RECORD_DIR": "record"}
    return raw


async def _run_until_captions(daemon, desc, work, **kw):
    """Spawn, wait for the recorder's first caption (the file appears with
    its first row) and a little more, then stop: a loaded machine may take
    seconds to the first caption, so no fixed run length."""
    await daemon.start()
    try:
        df = await daemon.spawn_dataflow(desc, working_dir=work, **kw)
        await asyncio.wait_for(df.started.wait(), LIMIT_S)

        async def first_caption():
            while not (work / "record" / "tokens.parquet").exists() and not df.done.done():
                await asyncio.sleep(0.05)

        await asyncio.wait_for(first_caption(), LIMIT_S)
        await asyncio.sleep(VLM_AFTER_S)
        daemon.stop_dataflow(df)
        return await asyncio.wait_for(asyncio.shield(df.done), LIMIT_S)
    finally:
        await daemon.close()


def test_vlm_dataflow_tokens_equal_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(__file__.rsplit("/tests/", 1)[0])
    jparams = jvlm.init_params(jax.random.PRNGKey(0), CFG)
    flat: dict = {}
    _flatten(jparams, "", flat)
    prompt = np.array([[t % CFG.vocab for t in jtok.encode("describe")]], np.int32)
    captions = {}
    for daemon in ("port", "jax"):
        work = tmp_path / daemon
        work.mkdir()
        np.savez(work / "weights.npz", **flat)
        (work / "vlm_ops.py").write_text(VLM_OPS)
        spec = _vlm_spec()
        if daemon == "port":
            result = asyncio.run(_run_until_captions(Daemon(), Descriptor.parse(spec), work))
        else:
            result = asyncio.run(_run_until_captions(
                JDaemon(), JDescriptor.parse(spec), work,
                local_nodes={n["id"] for n in spec["nodes"]}))
        assert result.is_ok(), (daemon, result.errors())
        rows = pq.read_table(work / "record" / "tokens.parquet").to_pylist()
        assert rows, daemon
        captions[daemon] = {}
        for row in rows:
            meta = json.loads(row["metadata"])
            assert meta["shape"] == [MAX_NEW] and "tick_ns" in meta
            captions[daemon].setdefault(meta["frame"], set()).add(tuple(row["value"]))
    for daemon, by_frame in captions.items():
        for frame, seen in by_frame.items():
            image = seeded_frame(CFG.image_size, CFG.image_size, 5, frame)
            want = np.asarray(jvlm.generate(jparams, CFG, (image / 255.0)[None].astype(np.float32),
                                            prompt, MAX_NEW))[0]
            assert seen == {tuple(want.tolist())}, (daemon, frame)
    common = set(captions["port"]) & set(captions["jax"])
    assert common and all(captions["port"][f] == captions["jax"][f] for f in common)


PROMPTS = """
import time

import pyarrow as pa

from {pkg}.node import Node

with Node() as node:
    for i, text in enumerate(["hello there", "a longer prompt about dataflows", "x"]):
        node.send_output("prompt", pa.array([text]), {{"request_id": f"r{{i}}",
                                                       "max_new_tokens": 6}})
"""

CHUNKS = """
import json
import sys

from {pkg}.node import Node

chunks = []
with Node() as node:
    for event in node:
        if event["type"] == "INPUT":
            m = event["metadata"]
            chunks.append([m["request_id"], m["seq"], m["done"], m.get("finish"),
                           event["value"].to_pylist()[0]])
json.dump(sorted(chunks), open(sys.argv[1], "w"))
"""


def test_llm_server_stub_behind_the_port_daemon(tmp_path, monkeypatch):
    """The port's serving node (stub engine) behind the port's daemon gives
    the JAX stub node's chunks behind the JAX daemon."""
    monkeypatch.setenv("DORA_P2P", "0")
    out = {}
    for daemon, pkg in (("port", "dora_tpu_torch"), ("jax", "dora_tpu")):
        work = tmp_path / daemon
        work.mkdir()
        (work / "prompts.py").write_text(textwrap.dedent(PROMPTS.format(pkg=pkg)))
        (work / "chunks.py").write_text(textwrap.dedent(CHUNKS.format(pkg=pkg)))
        llm = {"id": "llm", "path": f"module:{pkg}.nodehub.llm_server",
               "inputs": {"text": "prompts/prompt"}, "outputs": ["response"],
               "env": {"DORA_STUB_ENGINE": "1", "DORA_MAX_NEW_TOKENS": "6"}}
        if pkg == "dora_tpu_torch":
            llm["args"] = "--device cpu"
        spec = {"nodes": [
            {"id": "prompts", "path": "prompts.py", "outputs": ["prompt"]},
            llm,
            {"id": "sink", "path": "chunks.py", "args": "chunks.json",
             "inputs": {"response": {"source": "llm/response", "queue_size": 100}}},
        ]}
        if daemon == "port":
            result = run_dataflow(Descriptor.parse(spec), working_dir=work, timeout_s=LIMIT_S)
        else:
            result = jax_run(JDescriptor.parse(spec), working_dir=work, timeout_s=LIMIT_S)
        assert result.is_ok(), (daemon, result.errors())
        out[daemon] = json.loads((work / "chunks.json").read_text())
    assert out["port"] == out["jax"]
    done = [c for c in out["port"] if c[2]]
    assert len(done) == 3 and {c[3] for c in done} == {"length"}
    assert sum(1 for c in out["port"] if c[4]) == 3 * 6


def test_bench_vlm_e2e_on_the_cpu(tmp_path, monkeypatch, capsys):
    from dora_tpu_torch.tools import bench_vlm

    monkeypatch.setenv("BENCH_FRAMES", "30")
    monkeypatch.setenv("BENCH_MAX_NEW", "2")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert bench_vlm.main(["e2e", "--device", "cpu", "--size", "tiny"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    fps, launch = lines
    assert fps["unit"] == "fps" and fps["value"] > 0 and fps["outputs"] >= 2
    assert fps["device"] == launch["device"] == "cpu"
    # on the CPU no kernel launches
    assert launch["unit"] == "launches" and launch["launches"] == {} and launch["value"] == 0
