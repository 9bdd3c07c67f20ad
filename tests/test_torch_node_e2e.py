"""The port's serving node in a dataflow that the JAX package's daemon runs,
on the CPU.

``path: module:dora_tpu_torch.nodehub.llm_server`` with ``args: --device
cpu`` behind the OpenAI gateway (concurrent mode), three parallel
streaming clients: every stream equals JAX ``qwen2.generate``'s tokens for
its prompt on the tiny random Qwen2 (the counterpart of
tests/test_openai_concurrent.py's end-to-end test), and with
``DORA_STUB_ENGINE=1`` the JAX stub engine's stream. A relay node written
on ``dora_tpu_torch.node`` passes inline and shared-memory payloads between
JAX nodes over each daemon transport with ``DORA_P2P=0`` in its env, and
the daemon pairs no peer-to-peer edge with it (tests/test_torch_p2p.py
pairs the port's nodes). No timing is asserted; each run has its own
limit.
"""

from __future__ import annotations

import asyncio
import textwrap

import pytest
import torch
import yaml

from dora_tpu.daemon import run_dataflow


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    from transformers import Qwen2Config, Qwen2ForCausalLM

    config = Qwen2Config(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rope_theta=10000.0,
        rms_norm_eps=1e-6, tie_word_embeddings=False,
        attn_implementation="eager",
    )
    torch.manual_seed(0)
    model = Qwen2ForCausalLM(config).eval()
    path = tmp_path_factory.mktemp("qwen2-torch-node")
    model.save_pretrained(path, safe_serialization=True)
    return path


#: the driver: three concurrent streaming clients, each stream held to
#: REFERENCE(text) (a function the test defines above this text)
CLIENTS = """
import json
import threading
import time
import urllib.request

from dora_tpu.node import Node

refs = {p: reference(p) for p in PROMPTS}
node = Node()
time.sleep(0.5)
results = {}


def ask(word):
    body = json.dumps({
        "stream": True,
        "max_tokens": MAX_NEW,
        "messages": [{"role": "user", "content": word}],
    }).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{PORT}/v1/chat/completions",
        data=body, headers={"Content-Type": "application/json"},
    )
    raw = ""
    for attempt in range(240):
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                raw = r.read().decode()
            break
        except Exception:
            time.sleep(0.5)
    deltas = [
        json.loads(line[6:])["choices"][0]["delta"]
        for line in raw.splitlines()
        if line.startswith("data: ") and line != "data: [DONE]"
    ]
    results[word] = "".join(d.get("content", "") for d in deltas)


threads = [threading.Thread(target=ask, args=(p,)) for p in PROMPTS]
for t in threads:
    t.start()
for t in threads:
    t.join()
for p in PROMPTS:
    assert results[p] == refs[p], (p, results[p], refs[p])
print("port node e2e ok")
node.close()
"""


def _serve_dataflow(tmp_path, port: int, llm_env: dict, reference: str) -> None:
    driver = tmp_path / "driver.py"
    driver.write_text(textwrap.dedent(reference) + f"\nPORT = {port}\n" + CLIENTS)
    spec = {
        "nodes": [
            {
                "id": "api",
                "path": "module:dora_tpu.nodehub.openai_server",
                "outputs": ["text"],
                # every chunk must reach the gateway: the daemon's default
                # input queue (10 events) drops the oldest under a burst, and
                # the stub engine emits a stream's tokens within microseconds
                "inputs": {"response": {"source": "llm/response", "queue_size": 256}},
                "env": {"PORT": str(port), "MAX_REQUESTS": "3",
                        "DORA_OPENAI_CONCURRENT": "1", "RESPONSE_TIMEOUT": "120"},
            },
            {
                "id": "llm",
                "path": "module:dora_tpu_torch.nodehub.llm_server",
                "args": "--device cpu",
                "inputs": {"text": "api/text"},
                "outputs": ["response"],
                "env": llm_env,
            },
            {"id": "driver", "path": "driver.py"},
        ]
    }
    df = tmp_path / "dataflow.yml"
    df.write_text(yaml.safe_dump(spec))
    result = run_dataflow(df, timeout_s=300)
    log_dir = next((tmp_path / "out").iterdir())
    logs = {p.name: p.read_text() for p in log_dir.iterdir()}
    assert result.is_ok(), (result.errors(), logs.get("log_llm.txt", "")[-3000:])
    assert "port node e2e ok" in logs["log_driver.txt"]


def test_port_node_serves_the_gateway_as_jax_generate(tmp_path, tiny_checkpoint):
    reference = f"""
        import os

        import jax.numpy as jnp

        from dora_tpu.models import tokenizer as bytecodec
        from dora_tpu.models.hf import qwen2

        os.environ["DORA_INT8_DECODE"] = "1"
        cfg, params = qwen2.load({str(tiny_checkpoint)!r}, max_seq=64)
        qparams = qwen2.quantize_decode(params, cfg)
        MAX_NEW = 6
        PROMPTS = ["hello", "robot", "dora!"]


        def reference(text):
            ids = [t % cfg.vocab for t in bytecodec.encode(text)]
            out = qwen2.generate(qparams, cfg, jnp.asarray([ids], jnp.int32), MAX_NEW)
            return "".join(bytecodec.decode([int(t)]) for t in out[0])
    """
    _serve_dataflow(tmp_path, 8141, {"DORA_HF_CHECKPOINT": str(tiny_checkpoint),
                                     "DORA_MAX_SEQ": "64", "DORA_MAX_NEW_TOKENS": "6",
                                     "DORA_BATCH_SLOTS": "3"}, reference)


def test_port_stub_node_serves_the_gateway_as_the_jax_stub(tmp_path):
    reference = """
        from dora_tpu.models.batch_engine import make_stub_paged_engine

        MAX_NEW = 8
        PROMPTS = ["alpha", "beta gamma", "delta"]


        def reference(text):
            engine = make_stub_paged_engine(max_slots=4, window=4, prefix_cache=True)
            engine.submit("r", [ord(ch) % 97 for ch in text], MAX_NEW)
            out = []
            while engine.active:
                out += [tok for _r, tok, _d in engine.step()]
            return "".join(f" t{tok}" for tok in out)
    """
    _serve_dataflow(tmp_path, 8143, {"DORA_STUB_ENGINE": "1"}, reference)


SENDER = """
import numpy as np
import pyarrow as pa

from dora_tpu.node import Node

with Node() as node:
    for i in range(4):
        node.send_output("data", pa.array([f"text {i}"]), {"i": i, "kind": "text"})
        node.send_output("data", bytes([i]) * 6000, {"i": i, "kind": "raw"})
        node.send_output("data", pa.array(np.arange(3000, dtype=np.float32) + i),
                         {"i": i, "kind": "floats"})
"""

RELAY = """
from dora_tpu_torch.node import Node

with Node() as node:
    for event in node:
        if event["type"] != "INPUT":
            continue
        value = event["value"]
        if hasattr(value, "to_pylist"):
            node.send_output("out", value, dict(event["metadata"], relayed=True))
        else:
            node.send_output("out", bytes(value), dict(event["metadata"], relayed=True))
        del value, event
"""

SINK = """
import numpy as np

from dora_tpu.node import Node

got = {"relayed": [], "direct": []}
with Node() as node:
    for event in node:
        if event["type"] != "INPUT":
            continue
        md = event["metadata"]
        value = event["value"]
        if md["kind"] == "text":
            payload = value.to_pylist()
        elif md["kind"] == "raw":
            payload = bytes(value)
        else:
            payload = value.to_numpy().tolist()
        got[event["id"]].append((md["i"], md["kind"], md.get("relayed", False), payload))
        del value, event
want = []
for i in range(4):
    want += [(i, "text", [f"text {i}"]), (i, "raw", bytes([i]) * 6000),
             (i, "floats", (np.arange(3000, dtype=np.float32) + i).tolist())]
assert [(i, k, p) for i, k, r, p in got["relayed"]] == want, got["relayed"][:2]
assert all(r for _i, _k, r, _p in got["relayed"])
assert [(i, k, p) for i, k, r, p in got["direct"]] == want
print("relay ok")
"""


@pytest.mark.parametrize("comm", ["tcp", "uds", "shmem"])
def test_port_relay_node_over_every_transport_takes_the_daemon_route(tmp_path, comm):
    from dora_tpu.core.descriptor import Descriptor
    from dora_tpu.daemon.core import Daemon

    for name, body in (("sender.py", SENDER), ("relay.py", RELAY), ("sink.py", SINK)):
        (tmp_path / name).write_text(body)
    spec = {
        "nodes": [
            {"id": "sender", "path": "sender.py", "outputs": ["data"]},
            # queues long enough that drop-oldest never fires
            # the daemon route for the relay: peer-to-peer off on its side
            {"id": "relay", "path": "relay.py", "env": {"DORA_P2P": "0"},
             "inputs": {"in": {"source": "sender/data", "queue_size": 64}},
             "outputs": ["out"]},
            {"id": "sink", "path": "sink.py",
             "inputs": {"relayed": {"source": "relay/out", "queue_size": 64},
                        "direct": {"source": "sender/data", "queue_size": 64}}},
        ]
    }
    path = tmp_path / "dataflow.yml"
    path.write_text(yaml.safe_dump(spec))

    async def run():
        desc = Descriptor.read(path)
        desc.check(tmp_path)
        daemon = Daemon(local_comm=comm)
        await daemon.start()
        try:
            df = await daemon.spawn_dataflow(desc, working_dir=tmp_path,
                                             local_nodes={str(n.id) for n in desc.nodes})
            await asyncio.wait_for(df.started.wait(), 120)
            listeners = dict(df.p2p_listeners)
            result = await asyncio.wait_for(asyncio.shield(df.done), 120)
            return result, listeners, set(df.p2p_edges)
        finally:
            await daemon.close()

    result, listeners, edges = asyncio.run(run())
    log_dir = next((tmp_path / "out").iterdir())
    assert result.is_ok(), (result.errors(), (log_dir / "log_relay.txt").read_text()[-3000:])
    assert "relay ok" in (log_dir / "log_sink.txt").read_text()
    assert "relay" not in listeners
    assert not any("relay" in edge for edge in edges), edges
    # the JAX nodes themselves do pair their direct edge
    assert ("sender", "data", "sink", "direct") in edges
