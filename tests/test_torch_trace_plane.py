"""The port's trace and profile planes, and every observability plane end to
end, on the CPU.

* ``tracing.merge_trace_snapshots`` and ``to_chrome_trace`` on the same
  seeded per-machine snapshots (two machines whose clocks are skewed, each
  with its daemon's ring and its nodes' shipped events: message spans,
  engine lifecycle and ``dev_*`` spans, instants, a truncated buffer) give
  the JAX package's merged timeline and Chrome trace, equal; both
  validators and self-checks agree; the wire fast path lifts a frame's trace
  context as JAX's does.
* End to end: a coordinator and two port daemons (machines A and B), in this
  process, with ``DORA_TRACING=1``, ``DORA_METRICS_HISTORY_S=0.2`` and the
  JSONL alert sink; the port's gateway on A and the tiny Qwen2 (a seeded
  checkpoint) in the port's serving node on B, three streamed requests. On
  the port's coordinator, through the port's CLI (``top --once --json``,
  ``alerts --json``, ``trace --out``, ``profile``), and on a JAX
  coordinator, through control requests: the history, alerts, trace and
  profile planes answer with the JAX reply types; the history and the trace
  have the machines, series keys and span names of the same run on the
  JAX package's coordinator, daemons and nodes; a profile is a directory
  holding the CPU ``torch.profiler`` trace.
* ``profiling.Capture``: the profiler on a thread of its own records the
  asking thread's ops.

No timing is asserted; each run has its own limit.
"""

from __future__ import annotations

import asyncio
import contextlib
import copy
import json
import os
import socket
import time

import numpy as np
import pytest
import yaml

from dora_tpu import tracing as jtracing
from dora_tpu.coordinator import Coordinator as JCoordinator
from dora_tpu.daemon.core import Daemon as JDaemon
from dora_tpu.message import coordinator as jcm
from dora_tpu_torch import tracing as ptracing
from dora_tpu_torch.cli import main as cli
from dora_tpu_torch.coordinator import Coordinator as PCoordinator
from dora_tpu_torch.daemon.core import Daemon as PDaemon
from dora_tpu_torch.message import coordinator as pcm

T0_NS = 1_760_000_000_000_000_000
SKEW_NS = 370_000_000
LIMIT_S = 180
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPANS = ("s_queued", "s_admitted", "s_prefill_chunk", "s_decode_window", "s_finish")


def _ctx(rng) -> str:
    return (f"traceparent:00-{rng.bytes(16).hex()}-{rng.bytes(8).hex()}-01;")


def trace_parts(seed: int) -> list[dict]:
    """Two machines' trace snapshots (``Daemon.trace_snapshot``'s shape),
    made from a seed: A's wall clock on the cluster's, B's SKEW_NS behind."""
    rng = np.random.default_rng(seed)
    parts = []
    for k, (machine, node) in enumerate((("A", "api"), ("B", "llm"))):
        skew = SKEW_NS * k
        wall = T0_NS - skew
        mono = 10_000 + k
        daemon, proc = [], []

        def ev(events, kind, a=None, b=None, c=None):
            nonlocal wall, mono
            wall += int(rng.integers(10_000, 3_000_000))
            mono += 1
            events.append([mono, wall, kind, a, b, c])

        for i in range(12):
            ctx = _ctx(rng)
            ev(proc, "t_send", "text" if k == 0 else "response", ctx, int(rng.integers(1, 90_000)))
            ev(daemon, "enqueue", f"{node}/in", int(rng.integers(1, 9)))
            ev(daemon, "t_route", f"{node}/out", ctx, int(rng.integers(1, 400_000)))
            ev(daemon, "route", f"{node}/out", int(rng.integers(8, 900)))
            ev(daemon, "t_deliver", f"{node}/in", None, int(rng.integers(1, 900_000)))
            ev(proc, "t_recv", "in", ctx, 0)
            if k == 1:
                key = f"r{i}"
                for kind in SPANS[:3]:
                    ev(proc, kind, f"{key} slot={i % 4}", ctx, int(rng.integers(1, 4e6)))
                for j in range(int(rng.integers(1, 4))):
                    ev(proc, "s_decode_window", f"{key} k=8", ctx, int(rng.integers(1, 3e7)))
                    for part in ("s_dev_dispatch", "s_dev_compute", "s_dev_fetch"):
                        ev(proc, part, "window", None, int(rng.integers(1, 2e7)))
                ev(proc, "s_finish", f"{key} length", ctx, 0)
                if i % 5 == 0:
                    ev(proc, "s_page_wait", key, ctx, None)
            if i % 4 == 3:
                ev(daemon, "drop_oldest", f"{node}/in", 3)
                ev(daemon, "alert_firing", "busy:srv:llm:decode_tokens", "value=12 threshold=10")
                ev(daemon, "fastroute_hit", f"{node}/out", 64)
        ev(proc, "trace_truncated", 5)
        ev(proc, "profile_start", "(engine)", "/tmp/x")
        part = {"machine": machine, "wall_ns": wall, "hlc_ns": wall + skew,
                "processes": {"(daemon)": daemon, node: proc}}
        if k == 1:
            part["dropped_events"] = {node: 17}
        parts.append(part)
    return parts


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trace_merge_and_chrome_export_equal_jax(seed):
    parts = trace_parts(seed)
    merged = ptracing.merge_trace_snapshots(copy.deepcopy(parts) + [None, {}])
    want = jtracing.merge_trace_snapshots(copy.deepcopy(parts) + [None, {}])
    assert merged == want
    assert [(p["machine"], p["process"]) for p in merged["processes"]] == [
        ("A", "(daemon)"), ("A", "api"), ("B", "(daemon)"), ("B", "llm")]
    # B's events shifted onto the cluster axis by its offset
    raw_b = parts[1]["processes"]["llm"][0][1]
    assert merged["processes"][3]["events"][0][1] == raw_b + SKEW_NS
    trace = ptracing.to_chrome_trace(merged)
    assert trace == jtracing.to_chrome_trace(want)
    assert ptracing.validate_chrome_trace(trace) == [] == jtracing.validate_chrome_trace(trace)
    names = {e["name"].split(" ")[0] for e in trace["traceEvents"] if e["ph"] == "X"}
    assert {"send", "route", "deliver", "recv", "queued", "admitted", "prefill_chunk",
            "decode_window", "finish", "dev_compute"} <= names
    assert any(e["name"].startswith("trace truncated (17") for e in trace["traceEvents"])
    broken = copy.deepcopy(trace)
    broken["traceEvents"][3]["ph"] = "Z"
    broken["traceEvents"][5].pop("ts", None)
    assert ptracing.validate_chrome_trace(broken) == jtracing.validate_chrome_trace(broken) != []


def test_self_checks_and_id_helpers_equal_jax():
    from dora_tpu import telemetry as jtel
    from dora_tpu_torch import telemetry as ptel

    assert ptracing.self_check() == [] == jtracing.self_check()
    for ctx in ("", "traceparent:00-abc-def-01;", "x:y;",
                "traceparent:00-000102030405060708090a0b0c0d0e0f-0001020304050607-01;"):
        assert ptel.trace_id_of(ctx) == jtel.trace_id_of(ctx)
    assert (ptracing.SPAN_KINDS, ptracing.SERVING_SPAN_KINDS, ptracing.INSTANT_NAMES) == (
        jtracing.SPAN_KINDS, jtracing.SERVING_SPAN_KINDS, jtracing.INSTANT_NAMES)


@contextlib.contextmanager
def _tracing_restored():
    """The process-wide switches that daemons re-read from the environment,
    put back afterwards."""
    from dora_tpu import telemetry as jtel
    from dora_tpu_torch import telemetry as ptel

    saved = [(m.TRACING, m.TRACING.active, m.FLIGHT, m.FLIGHT.enabled) for m in (jtel, ptel)]
    try:
        yield
    finally:
        for tracing, active, flight, enabled in saved:
            tracing.active = active
            flight.enabled = enabled
            flight.clear()


@pytest.fixture
def tracing_state():
    with _tracing_restored():
        yield


def test_fast_path_lifts_the_trace_context_as_jax(tracing_state):
    from dora_tpu import telemetry as jtel
    from dora_tpu.clock import HLC as JHLC
    from dora_tpu.message import fastroute as jfast
    from dora_tpu.message import serde as jserde
    from dora_tpu.message.common import InlineData, Metadata, TypeInfo
    from dora_tpu.message.node_to_daemon import SendMessage
    from dora_tpu_torch import telemetry as ptel
    from dora_tpu_torch.message import fastroute as pfast

    ctx = "traceparent:00-000102030405060708090a0b0c0d0e0f-0001020304050607-01;"
    msg = SendMessage(output_id="out", metadata=Metadata(
        type_info=TypeInfo(encoding="raw", len=3),
        parameters={jtel.OTEL_CTX_KEY: ctx, "i": 1}), data=InlineData(data=b"abc"))
    frame = jserde.encode_timestamped(msg, JHLC())
    for active in (False, True):
        jtel.TRACING.active = ptel.TRACING.active = active
        got, want = pfast.parse_send_message(frame), jfast.parse_send_message(frame)
        assert (got.output_id, got.body, got.payload_len, got.ctx) == (
            want.output_id, want.body, want.payload_len, want.ctx)
        assert got.ctx == (ctx if active else "")


def test_capture_thread_records_the_callers_ops(tmp_path):
    """``profiling.Capture`` runs torch.profiler on a thread of its own (the
    serving node's captures): the ops of the thread that asked are in the
    trace, and the capture's start, stop and export seconds beside it."""
    import threading

    import torch

    from dora_tpu_torch import profiling

    out = str(tmp_path / "capture")
    capture = profiling.Capture(out)
    assert capture.started.wait(LIMIT_S) and not capture.done.is_set()
    x = torch.ones(8, 8)
    for _ in range(4):
        x = torch.mm(x, x) / 8
    assert capture.wait() == out
    with open(os.path.join(out, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert threading.get_native_id() in {e.get("tid") for e in events
                                         if e.get("name") == "aten::mm"}
    with open(os.path.join(out, profiling.CAPTURE_TIMINGS)) as f:
        steps = json.load(f)
    assert set(steps) == {"start_s", "stop_s", "export_s", "started_unix", "stopped_unix",
                          "options"}
    assert "profile_all_threads" in steps["options"]
    assert steps["started_unix"] <= steps["stopped_unix"]
    assert not os.path.exists(os.path.join(out, "profile_synthetic.json"))


# ---------------------------------------------------------------------------
# end to end: the tiny Qwen2 behind the gateway, on two machines
# ---------------------------------------------------------------------------

QWEN2_DIMS = dict(vocab_size=256, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2)
PROMPTS, MAX_NEW = ["hello", "robot", "dora!"], 6
#: one torch thread a node process: the runs share the machine's cores
ONE_THREAD = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
#: the rule the runs must see fire: any decoding at all
BUSY_RULE = {"name": "busy", "kind": "rate", "selector": "srv:*:decode_tokens", "op": ">",
             "threshold": 0, "window_s": 1}

CLIENT = """
import json
import sys
import threading
import time
import urllib.request

from {pkg}.node import Node

PORT, PROMPTS, MAX_NEW = int(sys.argv[1]), json.loads(sys.argv[2]), int(sys.argv[3])
node = Node()
for _ in range(1200):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{{PORT}}/v1/models", timeout=5):
            break
    except Exception:
        time.sleep(0.1)
got = {{}}


def ask(text):
    body = json.dumps({{"stream": True, "max_tokens": MAX_NEW,
                       "messages": [{{"role": "user", "content": text}}]}}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{{PORT}}/v1/chat/completions", data=body,
                                 headers={{"Content-Type": "application/json"}})
    with urllib.request.urlopen(req, timeout=120) as r:
        got[text] = [r.status, r.read().decode().count("data: ")]


threads = [threading.Thread(target=ask, args=(p,)) for p in PROMPTS]
for t in threads:
    t.start()
for t in threads:
    t.join()
json.dump(got, open(sys.argv[4], "w"))
node.close()
"""


def _tiny_qwen2(path) -> None:
    """A seeded Qwen2 checkpoint at QWEN2_DIMS (config.json and
    model.safetensors; requests use the byte codec)."""
    from safetensors.numpy import save_file

    rng = np.random.default_rng(0)
    d, ffn = QWEN2_DIMS["hidden_size"], QWEN2_DIMS["intermediate_size"]
    kv = QWEN2_DIMS["num_key_value_heads"] * d // QWEN2_DIMS["num_attention_heads"]

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


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("observe") / "qwen2"
    _tiny_qwen2(path)
    return path


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spec(pkg: str, ckpt, work) -> dict:
    """The llm-server example of ``pkg`` at the tiny model: the gateway and a
    client on A, the serving node on B."""
    port = _free_port()
    (work / "client.py").write_text(CLIENT.format(pkg=pkg))
    device = ["--device cpu"] if pkg == "dora_tpu_torch" else []
    return {"alerts": {"rules": [BUSY_RULE]}, "nodes": [
        {"id": "api", "path": f"module:{pkg}.nodehub.openai_server", "outputs": ["text"],
         "inputs": {"response": {"source": "llm/response", "queue_size": 4096}},
         "env": {"PORT": str(port), "DORA_OPENAI_CONCURRENT": "1", "RESPONSE_TIMEOUT": "120"},
         "deploy": {"machine": "A"}},
        {"id": "llm", "path": f"module:{pkg}.nodehub.llm_server", "args": " ".join(device),
         "inputs": {"text": {"source": "api/text", "queue_size": 64}},
         "outputs": ["response"],
         "env": {"DORA_HF_CHECKPOINT": str(ckpt), "DORA_MAX_SEQ": "64",
                 "DORA_MAX_NEW_TOKENS": str(MAX_NEW), "DORA_BATCH_SLOTS": "3", **ONE_THREAD},
         "deploy": {"machine": "B"}},
        {"id": "client", "path": "client.py", "deploy": {"machine": "A"},
         "args": f"{port} '{json.dumps(PROMPTS)}' {MAX_NEW} {work / 'got.json'}"},
    ]}


def _observe(cluster: str, ckpt, work, monkeypatch) -> dict:
    """Serve the three requests on ``cluster`` ("port", "jax-coordinator" or
    "jax"), query every plane while the node runs and after the stop, and
    return what the comparisons read."""
    for key, value in {"DORA_TRACING": "1", "DORA_METRICS_HISTORY_S": "0.2",
                       "DORA_ALERT_SINK": "jsonl", "DORA_P2P": "0",
                       "DORA_ALERT_SINK_FILE": str(work / "alerts.jsonl"),
                       "DORA_PROFILE_DIR": str(work / "profiles")}.items():
        monkeypatch.setenv(key, value)
    pkg = "dora_tpu" if cluster == "jax" else "dora_tpu_torch"
    Coordinator, cm = (PCoordinator, pcm) if cluster == "port" else (JCoordinator, jcm)
    Daemon = JDaemon if cluster == "jax" else PDaemon
    spec = _spec(pkg, ckpt, work)

    async def ask(coord, request):
        return await asyncio.wait_for(coord.handle_control_request(request), 30)

    async def main():
        coord = Coordinator()
        await coord.start()
        addr = f"127.0.0.1:{coord.daemon_port}"
        ctl = f"127.0.0.1:{coord.control_port}"
        tasks = [asyncio.create_task(Daemon().run(addr, m)) for m in ("A", "B")]
        out: dict = {}
        try:
            deadline = time.monotonic() + 20
            while set((await ask(coord, cm.ConnectedMachines())).machines) < {"A", "B"}:
                assert time.monotonic() < deadline
                await asyncio.sleep(0.05)
            start = await ask(coord, cm.Start(dataflow=spec, name="serve",
                                              local_working_dir=str(work)))
            assert isinstance(start, cm.DataflowStarted), start
            deadline = time.monotonic() + LIMIT_S
            while not (work / "got.json").exists():
                assert time.monotonic() < deadline, "the requests never finished"
                check = await ask(coord, cm.Check(dataflow_uuid=start.uuid))
                assert not isinstance(check, (cm.Error, cm.DataflowStopped)), check
                await asyncio.sleep(0.2)
            out["got"] = json.loads((work / "got.json").read_text())
            await asyncio.sleep(1.5)  # the node's next report, a few samples
            if cluster == "port":
                out.update(await asyncio.to_thread(_cli_views, ctl, work))
            elif cluster == "jax-coordinator":
                out["profile"] = await ask(coord, cm.StartProfile(
                    dataflow_uuid=None, node_id="llm", seconds=0.3, name="serve"))
                out["stop_profile"] = await ask(coord, cm.StopProfile(
                    dataflow_uuid=None, node_id="llm", name="serve"))
            out["live_history"] = await ask(coord, cm.QueryMetricsHistory(name="serve"))
            stopped = await ask(coord, cm.StopByName(name="serve", grace_duration_s=10))
            assert isinstance(stopped, cm.DataflowStopped) and stopped.result.is_ok(), \
                stopped.result.errors()
            for name, request in (("history", cm.QueryMetricsHistory),
                                  ("alerts", cm.QueryAlerts), ("trace", cm.QueryTrace)):
                out[name] = await ask(coord, request(name="serve"))
            await ask(coord, cm.Destroy())
            await asyncio.wait_for(asyncio.gather(*tasks), 20)
        finally:
            for t in tasks:
                t.cancel()
            await coord.close()
        return out

    with _tracing_restored():
        out = asyncio.run(main())
    sink = work / "alerts.jsonl"
    out["sink"] = [json.loads(line) for line in sink.read_text().splitlines()] \
        if sink.exists() else []
    return out


def _cli_views(ctl: str, work) -> dict:
    """The port's CLI against the live cluster, as a user runs it."""
    import io

    out = {}
    for name, argv in (("top_cli", ["top", "--once", "--json"]),
                       ("alerts_cli", ["alerts", "--json"]),
                       ("table_cli", ["metrics", "--name", "serve"]),
                       ("trace_cli", ["trace", "--out", str(work / "trace.json")]),
                       ("profile_cli", ["profile", "llm", "--seconds", "0.3"]),
                       ("stop_profile_cli", ["profile", "llm", "--stop"])):
        buf, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = cli.main(argv + ["--coordinator-addr", ctl])
        out[name] = (rc, buf.getvalue(), err.getvalue())
    return out


def _shape(out: dict) -> dict:
    """What two runs must share: the machines and series keys of the history,
    the span names (their first word) and tracks of the trace."""
    history = out["history"].history
    keys = {"counters": set(), "gauges": set(), "hist": set()}
    for s in history["samples"]:
        for kind in keys:
            keys[kind] |= set(s[kind])
    trace = jtracing.to_chrome_trace(out["trace"].trace)
    names = {}
    tracks = {e["pid"]: e["args"]["name"] for e in trace["traceEvents"] if e["ph"] == "M"
              and e["name"] == "process_name"}
    for e in trace["traceEvents"]:
        if e["ph"] == "X":
            names.setdefault(tracks[e["pid"]], set()).add(e["name"].split(" ")[0])
    return {"machines": history["machines"], "keys": keys, "spans": names}


@pytest.fixture(scope="module")
def jax_run(checkpoint, tmp_path_factory):
    """The same run on the JAX package's coordinator, daemons and nodes."""
    mp = pytest.MonkeyPatch()
    try:
        return _observe("jax", checkpoint, tmp_path_factory.mktemp("jax-observe"), mp)
    finally:
        mp.undo()


def _hold_to_jax(got: dict, want: dict) -> None:
    assert got["got"] == want["got"] and all(v[0] == 200 for v in got["got"].values())
    shape, want_shape = _shape(got), _shape(want)
    assert shape["machines"] == want_shape["machines"] == ["A", "B"]
    # the port's node reports the JAX node's series; Kineto's own lines of
    # the node's profile capture go to the capture's kineto.log, not to the
    # node's log, so its error and warning counters stay as JAX's
    assert shape["keys"]["counters"] == want_shape["keys"]["counters"]
    assert shape["keys"]["hist"] == want_shape["keys"]["hist"]
    assert shape["keys"]["gauges"] >= {k for k in want_shape["keys"]["gauges"]
                                       if not k.startswith("srv:llm:hbm_")}
    assert shape["spans"] == want_shape["spans"]
    for machine in ("A", "B"):
        spans = set().union(*(v for k, v in shape["spans"].items() if k.startswith(machine)))
        assert {"send", "route", "deliver", "recv"} <= spans, (machine, shape["spans"])
    assert {"queued", "admitted", "prefill_chunk", "decode_window", "finish",
            "dev_compute"} <= shape["spans"]["B/llm"]
    for name in ("history", "alerts", "trace"):
        assert type(got[name]).__name__ == type(want[name]).__name__
    # the rule fired while the node decoded, and resolved once it stopped
    fired = [e for e in got["sink"] if e["rule"] == "busy"]
    assert [e["phase"] for e in fired][:3] == ["pending", "firing", "resolved"], got["sink"]
    status = got["alerts"].alerts
    assert status["firing_total"].get("busy", 0) >= 1 and status["firing"] == 0
    assert not [e for e in got["sink"] if e["rule"] != "busy" and e["phase"] == "firing"]


def _is_profile_dir(artifact: str) -> bool:
    return os.path.isdir(artifact) and "traceEvents" in json.loads(
        open(os.path.join(artifact, "trace.json")).read())


def test_port_cluster_observed_through_the_cli_as_jax(checkpoint, tmp_path, monkeypatch,
                                                       jax_run):
    got = _observe("port", checkpoint, tmp_path, monkeypatch)
    _hold_to_jax(got, jax_run)
    rc, text, err = got["top_cli"]
    assert rc == 0, err
    top = json.loads(text)
    assert top["machines"] == ["A", "B"] and top["samples"] and "rates" in top
    assert "tokens_per_s" in top["rates"] and "fleet" in top
    rc, text, err = got["alerts_cli"]
    assert rc == 0 and "busy" in json.loads(text)["rules"], err
    rc, text, err = got["table_cli"]
    assert rc == 0 and "SERVING" in text, err
    rc, text, err = got["trace_cli"]
    assert rc == 0 and not err, err
    assert ptracing.validate_chrome_trace(json.loads((tmp_path / "trace.json").read_text())) == []
    rc, text, err = got["profile_cli"]
    assert rc == 0, err
    assert _is_profile_dir(text.strip()), text
    rc, text, err = got["stop_profile_cli"]
    assert rc == 1 and "no capture active" in err
    live = got["live_history"].history
    assert live["samples"] and live["machines"] == ["A", "B"]


def test_port_daemons_observed_by_a_jax_coordinator_as_jax(checkpoint, tmp_path, monkeypatch,
                                                           jax_run):
    got = _observe("jax-coordinator", checkpoint, tmp_path, monkeypatch)
    _hold_to_jax(got, jax_run)
    assert isinstance(got["profile"], jcm.ProfileReply) and got["profile"].error is None
    assert _is_profile_dir(got["profile"].artifact), got["profile"]
    assert isinstance(got["stop_profile"], jcm.ProfileReply)
    assert got["stop_profile"].error == "no capture active"
