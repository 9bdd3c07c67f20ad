"""The port's OpenAI gateway (dora_tpu_torch.nodehub.openai_server) against
the JAX package's, on the CPU, on the dataflows of
tests/test_pubsub_openai.py and tests/test_openai_concurrent.py.

* Both gateways in one dataflow under the port's daemon, each in serial and
  in concurrent mode, behind the same responders: a serial JSON body, a
  serial SSE stream of several deltas, concurrent streams routed by
  ``request_id``, a concurrent JSON body and a shed request (429 with
  ``Retry-After``) give equal bodies and SSE events, but for ids and
  timestamps.
* The tiny Qwen2 (a seeded safetensors checkpoint) served by the port's
  ``llm_server`` on machine B behind the port's gateway on machine A, under
  the port's coordinator: three concurrent streamed completions, every token
  crossing the daemons' link, each equal to JAX ``qwen2.generate``.
* ``openai-server.yml`` (the port's runtime with the tiny translator, the
  port's ``text_decode``) under the port's daemon beside the JAX example under
  the JAX daemon, the translator's weights the JAX one's: equal completions.

No timing is asserted; each run has its own limit.
"""

from __future__ import annotations

import asyncio
import json
import os
import socket
import time

import numpy as np
import yaml

from dora_tpu.daemon.core import run_dataflow_async as jax_run_async
from dora_tpu_torch.coordinator import Coordinator
from dora_tpu_torch.daemon.core import Daemon
from dora_tpu_torch.daemon.core import run_dataflow_async as port_run_async
from dora_tpu_torch.message import coordinator as cm

LIMIT_S = 180
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: one torch thread a node process: the runs share the machine's cores
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def _free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


#: the HTTP helpers every client node below uses (a node that keeps the dataflow
#: running while it asks)
HTTP = """
import json
import time
import urllib.error
import urllib.request


def wait_up(port):
    for _ in range(1200):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/v1/models", timeout=5):
                return
        except Exception:
            time.sleep(0.1)
    raise TimeoutError(f"gateway {port} never came up")


def post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers.get("Content-Type"), r.headers.get("Retry-After"), \\
                r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.headers.get("Retry-After"), \\
            e.read().decode()


def events(raw):
    return [json.loads(line[6:]) for line in raw.splitlines()
            if line.startswith("data: ") and line != "data: [DONE]"]


def content(raw):
    return "".join(e["choices"][0]["delta"].get("content", "") for e in events(raw))
"""


# ---------------------------------------------------------------------------
# both gateways behind the same responders
# ---------------------------------------------------------------------------

SERIAL_RESPONDER = """
import pyarrow as pa

from dora_tpu_torch.node import Node

with Node() as node:
    for event in node:
        if event["type"] == "INPUT":
            for word in event["value"][0].as_py().split():
                node.send_output(event["id"].replace("text", "reply"), pa.array([word.upper()]))
"""

CONCURRENT_RESPONDER = """
import pyarrow as pa

from dora_tpu_torch.node import Node

with Node() as node:
    for event in node:
        if event["type"] != "INPUT":
            continue
        out = event["id"].replace("text", "reply")
        rid = event["metadata"]["request_id"]
        text = event["value"][0].as_py()
        if text == "shed":
            node.send_output(out, pa.array([""]), {"request_id": rid, "done": True,
                                                   "finish": "overloaded",
                                                   "retry_after_ms": 2500})
            continue
        words = text.split()
        for i, word in enumerate(words):
            meta = {"request_id": rid, "done": i == len(words) - 1}
            if meta["done"]:
                meta["finish"] = "length"
            node.send_output(out, pa.array([word.upper()]), meta)
"""

BOTH_CLIENT = HTTP + """
import sys
import threading

from dora_tpu_torch.node import Node

PORTS = json.loads(sys.argv[1])
node = Node()
got = {}
for stack, (serial, concurrent) in PORTS.items():
    wait_up(serial)
    wait_up(concurrent)
    r = {}
    r["json"] = post(serial, {"model": "m1", "messages": [
        {"role": "system", "content": "be brief"}, {"role": "user", "content": "hello"}]})
    r["sse"] = post(serial, {"model": "m1", "stream": True,
                             "messages": [{"role": "user", "content": "hello big world"}]})
    streams = {}

    def ask(i, text):
        streams[i] = post(concurrent, {"stream": True, "max_tokens": 9,
                                       "messages": [{"role": "user", "content": text}]})

    texts = ["alpha beta", "gamma delta epsilon", "zeta"]
    threads = [threading.Thread(target=ask, args=(i, t)) for i, t in enumerate(texts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    r["concurrent"] = [streams[i] for i in range(len(texts))]
    r["concurrent_json"] = post(concurrent, {"messages": [{"role": "user", "content": "eta theta"}]})
    r["shed"] = post(concurrent, {"messages": [{"role": "user", "content": "shed"}]})
    got[stack] = r
json.dump(got, open(sys.argv[2], "w"))
node.close()
"""


def _scrub(obj):
    """A body without its ids and timestamps."""
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items() if k not in ("id", "created")}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    return obj


def _sse(raw: str) -> list:
    assert raw.rstrip().endswith("data: [DONE]"), raw
    return [_scrub(json.loads(line[6:])) for line in raw.splitlines()
            if line.startswith("data: ") and line != "data: [DONE]"]


def test_gateway_bodies_and_streams_equal_jax(tmp_path):
    ports = dict(zip(("jax", "port"), np.array(_free_ports(4)).reshape(2, 2).tolist()))
    (tmp_path / "serial_responder.py").write_text(SERIAL_RESPONDER)
    (tmp_path / "concurrent_responder.py").write_text(CONCURRENT_RESPONDER)
    (tmp_path / "client.py").write_text(BOTH_CLIENT)
    nodes = []
    for stack, pkg in (("jax", "dora_tpu"), ("port", "dora_tpu_torch")):
        serial, concurrent = ports[stack]
        nodes += [
            {"id": f"{stack}-serial", "path": f"module:{pkg}.nodehub.openai_server",
             "outputs": ["text"], "inputs": {"response": f"serial/reply_{stack}"},
             "env": {"PORT": str(serial), "MAX_REQUESTS": "2", "STREAM_QUIET_MS": "1500"}},
            {"id": f"{stack}-concurrent", "path": f"module:{pkg}.nodehub.openai_server",
             "outputs": ["text"],
             "inputs": {"response": {"source": f"concurrent/reply_{stack}", "queue_size": 256}},
             "env": {"PORT": str(concurrent), "MAX_REQUESTS": "5", "DORA_OPENAI_CONCURRENT": "1",
                     "RESPONSE_TIMEOUT": "60"}},
        ]
    nodes += [
        {"id": "serial", "path": "serial_responder.py", "outputs": ["reply_jax", "reply_port"],
         "inputs": {"text_jax": "jax-serial/text", "text_port": "port-serial/text"}},
        {"id": "concurrent", "path": "concurrent_responder.py", "outputs": ["reply_jax", "reply_port"],
         "inputs": {"text_jax": "jax-concurrent/text", "text_port": "port-concurrent/text"}},
        {"id": "client", "path": "client.py",
         "args": f"'{json.dumps(ports)}' {tmp_path / 'got.json'}"},
    ]
    (tmp_path / "dataflow.yml").write_text(yaml.safe_dump({"nodes": nodes}))
    result = asyncio.run(port_run_async(tmp_path / "dataflow.yml", timeout_s=LIMIT_S))
    assert result.is_ok(), result.errors()
    got = json.loads((tmp_path / "got.json").read_text())
    jax, port = got["jax"], got["port"]

    status, ctype, _, body = port["json"]
    assert (status, ctype) == (200, "application/json")
    assert json.loads(body)["choices"][0]["message"]["content"] == "HELLO"
    assert _scrub(json.loads(body)) == _scrub(json.loads(jax["json"][3]))
    assert port["sse"][:2] == jax["sse"][:2] == [200, "text/event-stream"]
    assert _sse(port["sse"][3]) == _sse(jax["sse"][3])
    deltas = [e["choices"][0]["delta"] for e in _sse(port["sse"][3])]
    assert deltas == [{"role": "assistant"}, {"content": "HELLO"}, {"content": "BIG"},
                      {"content": "WORLD"}, {}]
    for i, want in enumerate(["ALPHABETA", "GAMMADELTAEPSILON", "ZETA"]):
        events = _sse(port["concurrent"][i][3])
        assert events == _sse(jax["concurrent"][i][3])
        assert "".join(e["choices"][0]["delta"].get("content", "") for e in events) == want
        assert events[-1]["choices"][0]["finish_reason"] == "length"
    assert _scrub(json.loads(port["concurrent_json"][3])) == \
        _scrub(json.loads(jax["concurrent_json"][3]))
    assert port["shed"][:3] == jax["shed"][:3] == [429, "application/json", "2"]
    assert json.loads(port["shed"][3]) == json.loads(jax["shed"][3])


# ---------------------------------------------------------------------------
# the tiny Qwen2 behind the port's gateway, on two machines
# ---------------------------------------------------------------------------

QWEN2_DIMS = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2)

LLM_CLIENT = HTTP + """
import sys
import threading

from dora_tpu_torch.node import Node

PORT, PROMPTS, MAX_NEW = int(sys.argv[1]), json.loads(sys.argv[2]), int(sys.argv[3])
node = Node()
wait_up(PORT)
got = {}


def ask(text):
    status, ctype, _, raw = post(PORT, {"stream": True, "max_tokens": MAX_NEW,
                                        "messages": [{"role": "user", "content": text}]})
    got[text] = [status, ctype, content(raw), events(raw)[-1]["choices"][0]["finish_reason"]]


threads = [threading.Thread(target=ask, args=(p,)) for p in PROMPTS]
for t in threads:
    t.start()
for t in threads:
    t.join()
json.dump(got, open(sys.argv[4], "w"))
node.close()
"""


def _tiny_qwen2(path) -> None:
    """A seeded Qwen2 checkpoint at QWEN2_DIMS: config.json and
    model.safetensors, without a tokenizer (requests use the byte codec)."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(0)
    d, ffn = QWEN2_DIMS["hidden_size"], QWEN2_DIMS["intermediate_size"]
    hd = d // QWEN2_DIMS["num_attention_heads"]
    kv = QWEN2_DIMS["num_key_value_heads"] * hd

    def w(*shape):
        return (rng.standard_normal(shape) * 0.08).astype(np.float32)

    tensors = {"model.embed_tokens.weight": w(QWEN2_DIMS["vocab_size"], d),
               "model.norm.weight": np.ones(d, np.float32),
               "lm_head.weight": w(QWEN2_DIMS["vocab_size"], d)}
    for i in range(QWEN2_DIMS["num_hidden_layers"]):
        p = f"model.layers.{i}."
        tensors.update({
            p + "input_layernorm.weight": np.ones(d, np.float32),
            p + "post_attention_layernorm.weight": np.ones(d, np.float32),
            p + "self_attn.q_proj.weight": w(d, d), p + "self_attn.q_proj.bias": w(d),
            p + "self_attn.k_proj.weight": w(kv, d), p + "self_attn.k_proj.bias": w(kv),
            p + "self_attn.v_proj.weight": w(kv, d), p + "self_attn.v_proj.bias": w(kv),
            p + "self_attn.o_proj.weight": w(d, d),
            p + "mlp.gate_proj.weight": w(ffn, d), p + "mlp.up_proj.weight": w(ffn, d),
            p + "mlp.down_proj.weight": w(d, ffn),
        })
    path.mkdir()
    save_file(tensors, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps({
        "model_type": "qwen2", **QWEN2_DIMS, "max_position_embeddings": 128,
        "rope_theta": 10000.0, "rms_norm_eps": 1e-6, "tie_word_embeddings": False}))


def _jax_completion(ckpt, text: str, max_new: int) -> str:
    import jax.numpy as jnp

    from dora_tpu.models import tokenizer as bytecodec
    from dora_tpu.models.hf import qwen2

    os.environ["DORA_INT8_DECODE"] = "1"
    try:
        cfg, params = qwen2.load(str(ckpt), max_seq=64)
        qparams = qwen2.quantize_decode(params, cfg)
    finally:
        os.environ.pop("DORA_INT8_DECODE", None)
    ids = [t % cfg.vocab for t in bytecodec.encode(text)]
    out = qwen2.generate(qparams, cfg, jnp.asarray([ids], jnp.int32), max_new)
    return "".join(bytecodec.decode([int(t)]) for t in out[0])


def test_tiny_qwen2_behind_the_port_gateway_on_two_machines_equals_jax_generate(tmp_path):
    ckpt = tmp_path / "qwen2"
    _tiny_qwen2(ckpt)
    (tmp_path / "client.py").write_text(LLM_CLIENT)
    port = _free_ports(1)[0]
    prompts, max_new = ["hello", "robot", "dora!"], 6
    spec = yaml.safe_load(open(os.path.join(REPO, "dora_tpu_torch/examples/llm-server.yml")))
    nodes = {n["id"]: n for n in spec["nodes"]}
    nodes["api"]["env"].update(PORT=str(port), MAX_REQUESTS=str(len(prompts)))
    nodes["llm"]["args"] = "--device cpu"
    nodes["llm"]["env"] = {"DORA_HF_CHECKPOINT": str(ckpt), "DORA_MAX_SEQ": "64",
                           "DORA_MAX_NEW_TOKENS": str(max_new), "DORA_BATCH_SLOTS": "3",
                           **ONE_THREAD}
    spec["nodes"].append({"id": "client", "path": "client.py", "deploy": {"machine": "A"},
                          "args": f"{port} '{json.dumps(prompts)}' {max_new} "
                                  f"{tmp_path / 'got.json'}"})

    async def main():
        coord = Coordinator()
        await coord.start()
        addr = f"127.0.0.1:{coord.daemon_port}"
        tasks = [asyncio.create_task(Daemon().run(addr, m)) for m in ("A", "B")]
        try:
            deadline = time.monotonic() + 20
            while set((await coord.handle_control_request(cm.ConnectedMachines())).machines) \
                    < {"A", "B"}:
                assert time.monotonic() < deadline
                await asyncio.sleep(0.05)
            start = await coord.handle_control_request(
                cm.Start(dataflow=spec, name="serve", local_working_dir=str(tmp_path)))
            assert isinstance(start, cm.DataflowStarted), start
            deadline = time.monotonic() + LIMIT_S
            while not isinstance(reply := await coord.handle_control_request(
                    cm.Check(dataflow_uuid=start.uuid)), cm.DataflowStopped):
                assert time.monotonic() < deadline, "the serving dataflow never finished"
                await asyncio.sleep(0.2)
            metrics = await coord.handle_control_request(cm.QueryMetrics(name="serve"))
            await coord.handle_control_request(cm.Destroy())
            await asyncio.wait_for(asyncio.gather(*tasks), 20)
        finally:
            for t in tasks:
                t.cancel()
            await coord.close()
        return reply.result, metrics.metrics

    result, metrics = asyncio.run(main())
    log_dir = next((tmp_path / "out").iterdir())
    assert result.is_ok(), (result.errors(), (log_dir / "log_llm.txt").read_text()[-3000:])
    got = json.loads((tmp_path / "got.json").read_text())
    for text in prompts:
        status, ctype, completion, finish = got[text]
        assert (status, ctype, finish) == (200, "text/event-stream", "length")
        assert completion == _jax_completion(ckpt, text, max_new), text
    # each token a message across the link: counted on B as sent, on A as arrived
    assert metrics["links"]["llm/response"]["msgs"] >= 2 * len(prompts) * max_new


# ---------------------------------------------------------------------------
# openai-server.yml against the JAX example
# ---------------------------------------------------------------------------

TRANSLATOR_OPS = """
import numpy as np

from dora_tpu_torch.models import translation
from dora_tpu_torch.nodehub import ops

_W = np.load(__file__.replace("translator_ops.py", "translator.npz"))


def make(device=None):
    tree = {}
    for key in _W.files:
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = _W[key]
    op = ops.make_translator(device=device)
    op.init_state = translation.params_from_jax(tree, device=device)
    return op
"""

#: the translator's token ids as they leave it, one list a request
TOKEN_TAP = """
import json
import sys

from {pkg}.node import Node

seen = []
with Node() as node:
    for event in node:
        if event["type"] == "INPUT":
            seen.append(event["value"].to_pylist())
json.dump(seen, open(sys.argv[1], "w"))
"""

TRANSLATE_CLIENT = HTTP + """
import sys

from {pkg}.node import Node

PORT, PROMPTS = int(sys.argv[1]), json.loads(sys.argv[2])
node = Node()
wait_up(PORT)
got = []
for text in PROMPTS:
    status, _, _, body = post(PORT, {"messages": [{"role": "user", "content": text}]})
    got.append([status, json.loads(body)["choices"][0]["message"]["content"]])
json.dump(got, open(sys.argv[3], "w"))
node.close()
"""


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for key, value in tree.items():
            _flatten(value, f"{prefix}/{key}" if prefix else key, out)
    else:
        out[prefix] = np.asarray(tree)


def test_openai_server_example_equals_the_jax_example(tmp_path):
    import jax

    from dora_tpu.models import translation as jtranslation

    prompts = ["hello world", "dora runs dataflows"]
    jport, pport = _free_ports(2)
    runs = {}
    for stack, pkg, src in (("jax", "dora_tpu", "examples/openai-server/dataflow.yml"),
                            ("port", "dora_tpu_torch",
                             "dora_tpu_torch/examples/openai-server.yml")):
        work = tmp_path / stack
        work.mkdir()
        spec = yaml.safe_load(open(os.path.join(REPO, src)))
        nodes = {n["id"]: n for n in spec["nodes"]}
        port = jport if stack == "jax" else pport
        nodes["api"]["env"].update(PORT=str(port), MAX_REQUESTS=str(len(prompts)),
                                   RESPONSE_TIMEOUT="120")
        nodes["llm"]["env"] = {"DORA_MODEL_SIZE": "tiny", **ONE_THREAD}
        if stack == "port":
            cfg = jtranslation.TranslatorConfig.tiny()
            flat: dict = {}
            _flatten(jtranslation.init_params(jax.random.PRNGKey(0), cfg), "", flat)
            np.savez(work / "translator.npz", **flat)
            (work / "translator_ops.py").write_text(TRANSLATOR_OPS)
            nodes["llm"]["args"] = f"--operator op={work / 'translator_ops.py'}:make --device cpu"
        (work / "client.py").write_text(TRANSLATE_CLIENT.replace("{pkg}", pkg))
        (work / "tap.py").write_text(TOKEN_TAP.replace("{pkg}", pkg))
        spec["nodes"] += [
            {"id": "client", "path": "client.py",
             "args": f"{port} '{json.dumps(prompts)}' {work / 'got.json'}"},
            {"id": "tap", "path": "tap.py", "args": str(work / "tokens.json"),
             "inputs": {"tokens": "llm/op/tokens"}},
        ]
        (work / "dataflow.yml").write_text(yaml.safe_dump(spec))
        runs[stack] = work

    async def both():
        return await asyncio.gather(
            jax_run_async(runs["jax"] / "dataflow.yml", timeout_s=LIMIT_S),
            port_run_async(runs["port"] / "dataflow.yml", timeout_s=LIMIT_S))

    for stack, result in zip(("jax", "port"), asyncio.run(both())):
        log_dir = next((runs[stack] / "out").iterdir())
        assert result.is_ok(), (stack, result.errors(),
                                (log_dir / "log_llm.txt").read_text()[-3000:])
    jax_got = json.loads((runs["jax"] / "got.json").read_text())
    port_got = json.loads((runs["port"] / "got.json").read_text())
    assert [s for s, _ in port_got] == [200] * len(prompts)
    assert port_got == jax_got
    tokens = json.loads((runs["port"] / "tokens.json").read_text())
    assert tokens == json.loads((runs["jax"] / "tokens.json").read_text())
    assert len(tokens) == len(prompts) and all(len(t) == 16 for t in tokens), tokens
