"""The port's local daemon (dora_tpu_torch.daemon) against the JAX package's
(dora_tpu.daemon), on the CPU.

Each case is one of tests/test_daemon_e2e.py's shapes: the same dataflow
runs under the port's daemon with the port's nodes (dora_tpu_torch.node) and
under the JAX daemon with the JAX nodes, and the sinks' records must be
equal: a roundtrip over tcp, uds and shmem, a payload in shared memory, an
echo chain, timer ticks, a zero-copy sample, a failing node and its report,
``send_stdout_as``, and a restart with the un-acked input replayed. The
cross-checks run the JAX nodes under the port's daemon and the port's nodes
under the JAX one. The queue-size case holds the port's daemon to what
drop-oldest guarantees (the newest value arrives, no more is queued than
``queue_size``), not to a timing.

Both sides take the daemon route (``DORA_P2P=0``), so every edge of both
runs goes through a daemon; tests/test_torch_p2p.py holds the
peer-to-peer edges. Each dataflow has a time limit of its own; no case asserts a time.
"""

from __future__ import annotations

import asyncio
import json
import textwrap

import pytest

from dora_tpu.core.descriptor import Descriptor as JDescriptor
from dora_tpu.daemon import run_dataflow as jax_run
from dora_tpu_torch.core.descriptor import Descriptor
from dora_tpu_torch.daemon import run_dataflow as port_run

LIMIT_S = 60

#: (daemon, node package) of the two sides every case compares
PORT = ("port", "dora_tpu_torch")
JAX = ("jax", "dora_tpu")

SENDER = """
import pyarrow as pa
from {pkg}.node import Node

with Node() as node:
    for i, data in enumerate({data}):
        node.send_output("data", pa.array(data), {{"i": i}})
"""

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
            meta = {{k: v for k, v in event["metadata"].items() if k in ("i", "timer")}}
            records.append([event["type"], event["id"], value, meta])
        else:
            records.append([event["type"], event.get("id")])
with open(sys.argv[1], "w") as f:
    json.dump(records, f)
"""

ECHO = """
from {pkg}.node import Node

with Node() as node:
    for event in node:
        if event["type"] == "INPUT":
            node.send_output("echo", event["value"], event["metadata"])
"""

TICKER = """
import json
import sys

from {pkg}.node import Node

node = Node()
ticks = []
for event in node:
    if event["type"] == "INPUT":
        ticks.append([event["id"], event["metadata"]["timer"]])
        if len(ticks) == 3:
            break
node.close()
with open(sys.argv[1], "w") as f:
    json.dump(ticks, f)
"""

SAMPLER = """
from {pkg}.node import Node

with Node() as node:
    for n in (64, 6000, 9000):
        sample = node.allocate_sample(n)
        sample.view[:n] = bytes(i % 251 for i in range(n))
        node.send_sample("data", sample, n, {{"i": n}})
"""

FAILING = """
import sys

print("about to fail", file=sys.stderr, flush=True)
sys.exit(3)
"""

PRINTER = """
from {pkg}.node import Node

with Node() as node:
    for line in ("alpha", "beta 2", "gamma three"):
        print(line, flush=True)
"""

#: a restartable node that dies on its second input the first time round (the
#: marker file remembers the death). Delivery is at least once: the replayed
#: window may hold inputs the dead incarnation already forwarded, so the node
#: skips those, as a consumer dedups by request id.
CRASHER = """
import os
import sys

from {pkg}.node import Node

marker, done_file = sys.argv[1], "forwarded.txt"
done = set(open(done_file).read().split()) if os.path.exists(done_file) else set()
with Node() as node:
    for event in node:
        if event["type"] != "INPUT":
            continue
        i = event["metadata"]["i"]
        if i == 1 and not os.path.exists(marker):
            open(marker, "w").close()
            os._exit(1)
        if str(i) in done:
            continue
        node.send_output("out", event["value"], event["metadata"])
        with open(done_file, "a") as f:
            f.write(f"{{i}} ")
"""


def _write(tmp_path, name: str, template: str, pkg: str, **kw) -> str:
    (tmp_path / name).write_text(textwrap.dedent(template.format(pkg=pkg, **kw)))
    return name


def _run(side, tmp_path, spec: dict, comm: str | None = None):
    """Run ``spec`` under ``side``'s daemon from ``tmp_path``."""
    daemon = side[0]
    if daemon == "port":
        return port_run(Descriptor.parse(spec), working_dir=tmp_path, local_comm=comm,
                        timeout_s=LIMIT_S)
    return jax_run(JDescriptor.parse(spec), working_dir=tmp_path, local_comm=comm,
                   timeout_s=LIMIT_S)


def _records(tmp_path, name="records.json"):
    return json.loads((tmp_path / name).read_text())


@pytest.fixture(autouse=True)
def _daemon_routes(monkeypatch):
    monkeypatch.setenv("DORA_P2P", "0")


def _pair_spec(tmp_path, pkg: str, data: str, sink_pkg: str | None = None) -> dict:
    return {"nodes": [
        {"id": "sender", "path": _write(tmp_path, "sender.py", SENDER, pkg, data=data),
         "outputs": ["data"]},
        {"id": "sink", "path": _write(tmp_path, "sink.py", SINK, sink_pkg or pkg),
         "args": "records.json", "inputs": {"in": "sender/data"}},
    ]}


def _both(tmp_path, build, comm=None, sides=(PORT, JAX)):
    """Run ``build(dir, pkg)`` on each side in a directory of its own; the
    results and the sinks' records."""
    out = []
    for side in sides:
        d = tmp_path / side[0]
        d.mkdir()
        result = _run(side, d, build(d, side[1]), comm)
        assert result.is_ok(), (side, result.errors())
        out.append(_records(d))
    return out


@pytest.mark.parametrize("comm", ["tcp", "uds", "shmem"])
def test_roundtrip_equals_jax_daemon(tmp_path, comm):
    port, jax = _both(tmp_path, lambda d, pkg: _pair_spec(d, pkg, "[[1, 2, 3], [4], []]"),
                      comm)
    assert port == jax
    assert [r[2] for r in port if r[0] == "INPUT"] == [[1, 2, 3], [4], []]
    assert port[-1] == ["INPUT_CLOSED", "in"]


def test_large_shmem_payload_equals_jax_daemon(tmp_path):
    """Payloads of 5000 int64 travel in shared-memory regions."""
    data = "[list(range(5000)), list(range(5000, 10000)), list(range(3))]"
    port, jax = _both(tmp_path, lambda d, pkg: _pair_spec(d, pkg, data), "shmem")
    assert port == jax and port[1][2][-1] == 9999 and len(port[0][2]) == 5000


def test_echo_chain_equals_jax_daemon(tmp_path):
    def build(d, pkg):
        return {"nodes": [
            {"id": "sender", "path": _write(d, "sender.py", SENDER, pkg, data="[[7, 8], [9]]"),
             "outputs": ["data"]},
            {"id": "relay", "path": _write(d, "echo.py", ECHO, pkg), "inputs": {"in": "sender/data"},
             "outputs": ["echo"]},
            {"id": "sink", "path": _write(d, "sink.py", SINK, pkg), "args": "records.json",
             "inputs": {"in": "relay/echo"}},
        ]}

    port, jax = _both(tmp_path, build)
    assert port == jax and [r[2] for r in port if r[0] == "INPUT"] == [[7, 8], [9]]


def test_timer_ticks_equal_jax_daemon(tmp_path):
    def build(d, pkg):
        return {"nodes": [{"id": "ticker", "path": _write(d, "ticker.py", TICKER, pkg),
                           "args": "records.json", "inputs": {"tick": "dora/timer/millis/50"}}]}

    port, jax = _both(tmp_path, build)
    assert port == jax == [["tick", "timer-millis-50"]] * 3


def test_zero_copy_sample_equals_jax_daemon(tmp_path):
    def build(d, pkg):
        return {"nodes": [
            {"id": "sender", "path": _write(d, "sampler.py", SAMPLER, pkg), "outputs": ["data"]},
            {"id": "sink", "path": _write(d, "sink.py", SINK, pkg), "args": "records.json",
             "inputs": {"in": "sender/data"}},
        ]}

    port, jax = _both(tmp_path, build, "shmem")
    assert port == jax
    assert [len(r[2]) for r in port if r[0] == "INPUT"] == [64, 6000, 9000]
    assert port[1][2][:3] == [0, 1, 2] and port[2][2][-1] == 8999 % 251


def test_failing_node_reported_as_jax_daemon(tmp_path):
    """The failing node's own failure (exit code, last stderr line) and its
    receiver's end, as the JAX daemon reports them."""
    reports = []
    for side in (PORT, JAX):
        d = tmp_path / side[0]
        d.mkdir()
        spec = {"nodes": [
            {"id": "bad", "path": _write(d, "bad.py", FAILING, side[1]), "outputs": ["data"]},
            {"id": "sink", "path": _write(d, "sink.py", SINK, side[1]), "args": "records.json",
             "inputs": {"in": "bad/data"}},
        ]}
        result = _run(side, d, spec)
        assert not result.is_ok()
        errors = dict(result.errors())
        reports.append((sorted(errors), str(errors["bad"]), errors["bad"].cause.kind,
                        errors["bad"].exit_status.code))
    assert reports[0] == reports[1]
    assert reports[0][2:] == ("other", 3) and "about to fail" in reports[0][1]


def test_send_stdout_as_equals_jax_daemon(tmp_path):
    def build(d, pkg):
        return {"nodes": [
            {"id": "talker", "path": _write(d, "printer.py", PRINTER, pkg),
             "outputs": ["stdout"], "send_stdout_as": "stdout"},
            {"id": "sink", "path": _write(d, "sink.py", SINK, pkg), "args": "records.json",
             "inputs": {"lines": "talker/stdout"}},
        ]}

    port, jax = _both(tmp_path, build)
    assert port == jax
    assert [r[2] for r in port if r[0] == "INPUT"] == [["alpha"], ["beta 2"], ["gamma three"]]


def test_restart_replays_the_unacked_input_as_jax_daemon(tmp_path):
    """The node dies on input 1; the daemon respawns it and hands it the
    un-acked inputs again (input 1 among them), so the sink sees every input.

    The JAX daemon forgets a batch on the node's next poll, and a node's
    event stream polls as soon as it queued a batch, before it consumed it:
    the JAX run can lose inputs the dead node had queued (its own
    tests/test_elastic_recovery.py sees that under load). So its records
    must be the port's with at most such inputs missing, in order; the
    port's daemon keeps the batches a node may not have consumed, and its
    sink sees all four."""
    def build(d, pkg):
        return {"nodes": [
            {"id": "sender", "path": _write(d, "sender.py", SENDER, pkg,
                                            data="[[0], [1], [2], [3]]"),
             "outputs": ["data"]},
            {"id": "worker", "path": _write(d, "crasher.py", CRASHER, pkg), "args": "died",
             "inputs": {"in": "sender/data"}, "outputs": ["out"],
             "restart": {"max_attempts": 2, "backoff_base_s": 0.05}},
            {"id": "sink", "path": _write(d, "sink.py", SINK, pkg), "args": "records.json",
             "inputs": {"in": "worker/out"}},
        ]}

    port, jax = _both(tmp_path, build)
    assert [r[3]["i"] for r in port if r[0] == "INPUT"] == [0, 1, 2, 3]
    assert port[-1] == jax[-1] == ["INPUT_CLOSED", "in"]
    it = iter(port)
    assert jax[0] == port[0] and all(r in it for r in jax)
    assert (tmp_path / "port" / "died").exists() and (tmp_path / "jax" / "died").exists()


@pytest.mark.parametrize("daemon,nodes", [("port", "dora_tpu"), ("jax", "dora_tpu_torch")])
def test_nodes_of_either_package_under_either_daemon(tmp_path, monkeypatch, daemon, nodes):
    """JAX nodes under the port's daemon, and the port's nodes under the JAX
    one, give the records of each package's nodes under its own daemon
    (a sender of one package to a sink of the other, over shmem). Under the
    port's daemon the nodes announce peer-to-peer listeners and their edge
    is paired."""
    if daemon == "port":
        monkeypatch.setenv("DORA_P2P", "1")
    data = "[[1, 2], list(range(3000)), [5]]"
    other = "dora_tpu" if nodes == "dora_tpu_torch" else "dora_tpu_torch"
    (ref,) = _both(tmp_path, lambda d, pkg: _pair_spec(d, pkg, data), "shmem", sides=(PORT,))
    d = tmp_path / "cross"
    d.mkdir()
    result = _run((daemon, nodes), d, _pair_spec(d, nodes, data, sink_pkg=other), "shmem")
    assert result.is_ok(), result.errors()
    assert _records(d) == ref


RECEIVER_SLOW = """
import json
import sys
import time

from dora_tpu_torch.node import Node

node = Node()
time.sleep(1.0)  # the burst arrives while nothing consumes
values = [event["value"][0].as_py() for event in node if event["type"] == "INPUT"]
node.close()
with open(sys.argv[1], "w") as f:
    json.dump(values, f)
"""


def test_queue_size_keeps_the_newest(tmp_path):
    """queue_size 2 under a burst of 20 into a receiver that sleeps: the newest
    value arrives, and the receiver gets at most what the daemon's queue
    (2), its own local buffer and one batch in flight held."""
    from dora_tpu_torch.node.events import EventStream

    spec = {"nodes": [
        {"id": "sender", "path": _write(tmp_path, "sender.py", SENDER, "dora_tpu_torch",
                                        data="[[i] for i in range(20)]"),
         "outputs": ["data"]},
        {"id": "sink", "path": "slow.py", "args": "records.json",
         "inputs": {"in": {"source": "sender/data", "queue_size": 2}}},
    ]}
    (tmp_path / "slow.py").write_text(RECEIVER_SLOW)
    result = _run(PORT, tmp_path, spec)
    assert result.is_ok(), result.errors()
    values = _records(tmp_path)
    assert values[-1] == 19
    assert len(values) <= 2 + EventStream.DEFAULT_MAX_QUEUE + 1, values
    assert values == sorted(values)


def test_event_queue_drops_the_oldest_and_releases_its_token():
    """NodeEventQueue: a push past an input's bound drops that input's oldest
    event (its drop token released), other inputs untouched."""
    from dora_tpu_torch.daemon.queues import NodeEventQueue

    released = []
    q = NodeEventQueue(node_id="n", queue_sizes={"a": 2, "b": 5}, on_token_unref=released.append)
    for i in range(6):
        q.push(None, input_id="a", drop_token=f"t{i}", wire=bytes([i]))
    q.push(None, input_id="b", wire=b"b")
    assert q.input_counts == {"a": 2, "b": 1} and released == ["t0", "t1", "t2", "t3"]
    batch = asyncio.run(q.next_batch())
    assert [e.wire for e in batch] == [bytes([4]), bytes([5]), b"b"]
    q.close()
    assert asyncio.run(q.next_batch()) == []


def test_shmem_send_after_close_is_a_closed_connection():
    """A send on a shmem connection that was closed (an event batch that
    comes due as its node goes) raises ConnectionClosed, as a disconnected
    peer does, and checks the closing under the lock that guards the
    channel's free."""
    import os
    import uuid

    from dora_tpu_torch.daemon.connection import ShmemConnection
    from dora_tpu_torch.native import ShmemChannel
    from dora_tpu_torch.transport.framing import ConnectionClosed

    async def run():
        name = f"dtp-closed-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        conn = ShmemConnection(ShmemChannel.create(name, 4096))
        await conn.send(b"reply")  # the slot is free: sent inline
        conn.close_sync()
        with pytest.raises(ConnectionClosed):
            await conn.send(b"late")

    asyncio.run(run())


RELOADED = """
import json
import sys

from dora_tpu_torch.node import Node

events = []
with Node() as node:
    for event in node:
        events.append([event["type"], event.get("operator_id")])
        if event["type"] == "RELOAD":
            break
with open(sys.argv[1], "w") as f:
    json.dump(events, f)
"""


def test_reload_and_the_routing_counters(tmp_path):
    """Daemon.reload_node queues RELOAD for one node (its timer keeps its
    stream open until then), and metrics_snapshot counts what was routed:
    messages and bytes on the link, one latency sample a delivery, every
    inline frame on the wire fast path."""
    from dora_tpu_torch.daemon import Daemon

    (tmp_path / "worker.py").write_text(RELOADED)
    spec = {"nodes": [
        {"id": "sender", "path": _write(tmp_path, "sender.py", SENDER, "dora_tpu_torch",
                                        data="[[1], [2, 3], [4]]"),
         "outputs": ["data"]},
        {"id": "worker", "path": "worker.py", "args": "records.json",
         "inputs": {"in": "sender/data", "tick": "dora/timer/secs/3600"}},
    ]}

    async def run():
        daemon = Daemon()
        await daemon.start()
        try:
            df = await daemon.spawn_dataflow(Descriptor.parse(spec), working_dir=tmp_path)
            await asyncio.wait_for(df.started.wait(), LIMIT_S)

            async def routed():  # the sender's three messages go first
                while daemon.metrics_snapshot(df)["links"].get("sender/data", {}).get(
                        "msgs", 0) < 3:
                    await asyncio.sleep(0.02)

            await asyncio.wait_for(routed(), LIMIT_S)
            daemon.reload_node(df, "worker", "op")
            return await asyncio.wait_for(asyncio.shield(df.done), LIMIT_S), \
                daemon.metrics_snapshot(df)
        finally:
            await daemon.close()

    result, snap = asyncio.run(run())
    assert result.is_ok(), result.errors()
    events = _records(tmp_path)
    assert events[-1] == ["RELOAD", "op"]
    assert [e for e in events if e[0] == "INPUT"] == [["INPUT", None]] * 3
    assert snap["links"]["sender/data"]["msgs"] == 3
    assert snap["latency_us"]["worker/in"]["count"] == 3
    assert snap["fastroute"]["hits"] == 3 and snap["drops"] == {}


def test_cli_check_and_run_with_stop_after(tmp_path):
    """``python -m dora_tpu_torch.cli``: ``check`` accepts a dataflow and
    names what it refuses; ``run --stop-after`` ends a dataflow that a timer
    keeps alive (its node sees STOP and exits cleanly)."""
    import os
    import subprocess
    import sys

    import yaml

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo)
    (tmp_path / "forever.py").write_text(textwrap.dedent("""
        from dora_tpu_torch.node import Node

        with Node() as node:
            for event in node:
                if event["type"] == "STOP":
                    print("stopped", flush=True)
                    break
    """))
    good = tmp_path / "good.yml"
    good.write_text(yaml.safe_dump({"nodes": [
        {"id": "t", "path": "forever.py", "inputs": {"tick": "dora/timer/millis/50"}}]}))
    bad = tmp_path / "bad.yml"
    bad.write_text(yaml.safe_dump({"nodes": [
        {"id": "v", "operator": {"jax": "m:f", "outputs": ["o"]}}]}))

    def cli(*args):
        return subprocess.run([sys.executable, "-m", "dora_tpu_torch.cli", *args], cwd=tmp_path,
                              env=env, capture_output=True, text=True, timeout=LIMIT_S)

    res = cli("check", str(good))
    assert res.returncode == 0 and "OK (1 nodes)" in res.stdout, res.stderr
    res = cli("check", str(bad))
    assert res.returncode == 1 and "operator v/op: 'jax: m:f'" in res.stderr
    assert "torch: <module>:<factory>" in res.stderr
    res = cli("run", str(good), "--stop-after", "0.5")
    assert res.returncode == 0 and "finished successfully" in res.stdout, res.stderr
    (log,) = (tmp_path / "out").glob("*/log_t.txt")
    assert log.read_text().strip() == "stopped"


def test_replay_buffer_keeps_the_batches_a_node_may_not_have_consumed():
    """A poll acks only the batches older than ACK_LAG before the newest:
    the node's stream queues up to three events ahead of what it consumed."""
    from dora_tpu_torch.daemon.queues import QueueEntry
    from dora_tpu_torch.daemon.replay_buffer import ACK_LAG, ReplayBuffer

    buf = ReplayBuffer("n")
    for k in range(6):
        if k:
            buf.ack()  # the poll that asks for batch k
        buf.remember([QueueEntry(None, input_id="in", wire=bytes([k])),
                      QueueEntry(None)])  # a marker: never replayed
    assert len(buf) == ACK_LAG + 1
    assert [e.wire for e in buf.drain()] == [bytes([k]) for k in range(6 - ACK_LAG - 1, 6)]
    assert len(buf) == 0
