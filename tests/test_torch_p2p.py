"""Peer-to-peer edges of the port (dora_tpu_torch/node/p2p.py and the
pairing in dora_tpu_torch/daemon/core.py) against the JAX package's, on the
CPU.

tests/test_p2p.py's five cases run under the port's daemon with the port's
nodes: full speed with no loss, the assignment with the daemon's route off,
the order across two inputs of one sender, drop-oldest on ``queue_size``,
and ``DORA_P2P=0``. A port node and a JAX node then exchange shared-memory
payloads over a peer-to-peer edge in both directions under each daemon
(the acks cross the packages too). Last, the port's daemon pairs the edges
the JAX daemon pairs for the same descriptor, with its exclusions: a
receiver with a ``restart`` policy, a ``send_stdout_as`` output, a dynamic
node and a node with ``DORA_P2P=0`` keep the daemon's route.
"""

from __future__ import annotations

import asyncio
import json
import textwrap
import time

import pytest
import torch
import yaml

from dora_tpu.core.descriptor import Descriptor as JDescriptor
from dora_tpu.daemon import run_dataflow as jax_run
from dora_tpu_torch.core.descriptor import Descriptor
from dora_tpu_torch.daemon import run_dataflow as port_run

LIMIT_S = 90


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _p2p_on(monkeypatch):
    monkeypatch.setenv("DORA_P2P", "1")


def _run(tmp_path, nodes, daemon="port", timeout_s=LIMIT_S):
    spec = {"nodes": nodes, "communication": {"local": "shmem"}}
    (tmp_path / "flow.yml").write_text(yaml.safe_dump(spec))
    if daemon == "port":
        result = port_run(Descriptor.parse(spec), working_dir=tmp_path, local_comm="shmem",
                          timeout_s=timeout_s)
    else:
        result = jax_run(JDescriptor.parse(spec), working_dir=tmp_path, local_comm="shmem",
                         timeout_s=timeout_s)
    assert result.is_ok(), result.errors()
    return result


def _write(tmp_path, name: str, body: str, pkg: str = "dora_tpu_torch") -> str:
    (tmp_path / name).write_text(textwrap.dedent(body).replace("{pkg}", pkg))
    return name


def _read(tmp_path, name: str):
    return json.loads((tmp_path / name).read_text())


SENDER_BURST = """
    import json
    from {pkg}.node import Node
    with Node() as node:
        out = {k: {"edges": len(v.edges), "daemon_route": v.daemon_route}
               for k, v in node._p2p.outbound.items()}
        open("outbound.json", "w").write(json.dumps(out))
        for i in range(30):
            sample = node.allocate_sample(8192)
            sample.view[:8192] = bytes([i % 256]) * 8192
            node.send_sample("data", sample, 8192, metadata={"seq": i})
"""

RECEIVER_SEQS = """
    import json
    from {pkg}.node import Node
    seqs = []
    node = Node()
    assert node._p2p is not None
    for event in node:
        if event["type"] == "INPUT":
            assert bytes(event["value"][:3]) == bytes([event["metadata"]["seq"] % 256]) * 3
            seqs.append(event["metadata"]["seq"])
    node.close()
    open("seqs.json", "w").write(json.dumps(seqs))
"""


def test_p2p_full_speed_no_loss(tmp_path):
    """30 zero-copy messages at full speed all arrive, in order."""
    _run(tmp_path, [
        {"id": "s", "path": _write(tmp_path, "s.py", SENDER_BURST), "outputs": ["data"]},
        {"id": "r", "path": _write(tmp_path, "r.py", RECEIVER_SEQS),
         "inputs": {"data": {"source": "s/data", "queue_size": 100}}},
    ])
    assert _read(tmp_path, "seqs.json") == list(range(30))
    assert _read(tmp_path, "outbound.json") == {"data": {"edges": 1, "daemon_route": False}}


def test_p2p_assignment_and_daemon_skip(tmp_path):
    """The sender learns its edge; with every receiver direct the daemon's
    route is off (the exact count proves no double delivery), and the
    daemon's routing counters see none of the messages."""
    (tmp_path / "s.py").write_text(textwrap.dedent("""
        import json
        from dora_tpu_torch.node import Node
        with Node() as node:
            out = {k: {"edges": len(v.edges), "daemon_route": v.daemon_route}
                   for k, v in node._p2p.outbound.items()}
            open("outbound.json", "w").write(json.dumps(out))
            for i in range(5):
                node.send_output("data", b"x" * 100, {"seq": i})
    """))
    (tmp_path / "r.py").write_text(textwrap.dedent("""
        import json
        from dora_tpu_torch.node import Node
        n = 0
        node = Node()
        for event in node:
            if event["type"] == "INPUT":
                n += 1
        node.close()
        open("count.json", "w").write(json.dumps(n))
    """))
    _run(tmp_path, [
        {"id": "s", "path": "s.py", "outputs": ["data"]},
        {"id": "r", "path": "r.py", "inputs": {"data": {"source": "s/data", "queue_size": 100}}},
    ])
    assert _read(tmp_path, "outbound.json") == {"data": {"edges": 1, "daemon_route": False}}
    assert _read(tmp_path, "count.json") == 5


def test_p2p_cross_input_ordering(tmp_path):
    """Two inputs fed by one sender share a channel: a marker sent after 15
    data messages arrives after all of them."""
    (tmp_path / "s.py").write_text(textwrap.dedent("""
        from dora_tpu_torch.node import Node
        with Node() as node:
            for i in range(15):
                node.send_output("data", b"d" * 6000, {"seq": i})
            node.send_output("marker", b"m", {})
    """))
    (tmp_path / "r.py").write_text(textwrap.dedent("""
        import json
        from dora_tpu_torch.node import Node
        order = []
        node = Node()
        for event in node:
            if event["type"] == "INPUT":
                order.append(event["id"])
        node.close()
        open("order.json", "w").write(json.dumps(order))
    """))
    _run(tmp_path, [
        {"id": "s", "path": "s.py", "outputs": ["data", "marker"]},
        {"id": "r", "path": "r.py", "inputs": {
            "data": {"source": "s/data", "queue_size": 100},
            "marker": {"source": "s/marker", "queue_size": 10}}},
    ])
    assert _read(tmp_path, "order.json") == ["data"] * 15 + ["marker"]


def test_p2p_queue_size_drop_oldest(tmp_path):
    """A consumer ten times slower than its producer behind queue_size 2
    sees the freshest events, in order, never the whole backlog."""
    (tmp_path / "s.py").write_text(textwrap.dedent("""
        import time
        from dora_tpu_torch.node import Node
        with Node() as node:
            for i in range(40):
                node.send_output("data", b"d" * 5000, {"seq": i})
                time.sleep(0.005)
    """))
    (tmp_path / "r.py").write_text(textwrap.dedent("""
        import json, time
        from dora_tpu_torch.node import Node
        seqs = []
        node = Node()
        for event in node:
            if event["type"] == "INPUT":
                seqs.append(event["metadata"]["seq"])
                time.sleep(0.05)
        node.close()
        open("seqs.json", "w").write(json.dumps(seqs))
    """))
    _run(tmp_path, [
        {"id": "s", "path": "s.py", "outputs": ["data"]},
        {"id": "r", "path": "r.py", "inputs": {"data": {"source": "s/data", "queue_size": 2}}},
    ], timeout_s=120)
    seqs = _read(tmp_path, "seqs.json")
    assert len(seqs) < 40, "drop-oldest never engaged"
    assert seqs == sorted(seqs)
    assert seqs[-1] > 30, "the freshest events must win"


def test_p2p_kill_switch(tmp_path, monkeypatch):
    """DORA_P2P=0: every edge through the daemon, the same messages."""
    monkeypatch.setenv("DORA_P2P", "0")
    (tmp_path / "s.py").write_text(textwrap.dedent("""
        from dora_tpu_torch.node import Node
        with Node() as node:
            assert node._p2p is None
            for i in range(5):
                node.send_output("data", b"x", {"seq": i})
    """))
    (tmp_path / "r.py").write_text(textwrap.dedent("""
        import json
        from dora_tpu_torch.node import Node
        seqs = []
        node = Node()
        assert node._p2p is None
        for event in node:
            if event["type"] == "INPUT":
                seqs.append(event["metadata"]["seq"])
        node.close()
        open("seqs.json", "w").write(json.dumps(seqs))
    """))
    _run(tmp_path, [
        {"id": "s", "path": "s.py", "outputs": ["data"]},
        {"id": "r", "path": "r.py", "inputs": {"data": "s/data"}},
    ])
    assert _read(tmp_path, "seqs.json") == list(range(5))


@pytest.mark.parametrize("daemon", ["port", "jax"])
@pytest.mark.parametrize("sender,receiver", [("dora_tpu_torch", "dora_tpu"),
                                             ("dora_tpu", "dora_tpu_torch")])
def test_port_and_jax_nodes_pair_under_either_daemon(tmp_path, daemon, sender, receiver):
    """A sender of one package and a receiver of the other pair their edge
    and move 30 shared-memory payloads over it in order; the receiver's
    acks free the sender's regions across the packages."""
    _run(tmp_path, [
        {"id": "s", "path": _write(tmp_path, "s.py", SENDER_BURST, sender), "outputs": ["data"]},
        {"id": "r", "path": _write(tmp_path, "r.py", RECEIVER_SEQS, receiver),
         "inputs": {"data": {"source": "s/data", "queue_size": 100}}},
    ], daemon=daemon)
    assert _read(tmp_path, "seqs.json") == list(range(30))
    assert _read(tmp_path, "outbound.json") == {"data": {"edges": 1, "daemon_route": False}}


EDGE_SENDER = """
    from {pkg}.node import Node
    with Node() as node:
        print("hello", flush=True)
        for i in range(3):
            node.send_output("data", b"x" * 5000, {"seq": i})
"""

EDGE_SINK = """
    from {pkg}.node import Node
    with Node() as node:
        for event in node:
            pass
"""


def _edge_spec(tmp_path, pkg: str) -> dict:
    sender = _write(tmp_path, "s.py", EDGE_SENDER, pkg)
    sink = _write(tmp_path, "k.py", EDGE_SINK, pkg)
    return {"nodes": [
        {"id": "s", "path": sender, "outputs": ["data", "log"], "send_stdout_as": "log"},
        {"id": "direct", "path": sink, "inputs": {"data": "s/data", "log": "s/log"}},
        {"id": "restartable", "path": sink, "inputs": {"data": "s/data"},
         "restart": {"max_attempts": 1}},
        {"id": "off", "path": sink, "inputs": {"data": "s/data"}, "env": {"DORA_P2P": "0"}},
        {"id": "dyn", "path": "dynamic", "inputs": {"data": "s/data"}},
        {"id": "relay", "path": sink, "inputs": {"data": "s/data"}, "outputs": ["out"]},
        {"id": "after", "path": sink, "inputs": {"data": "relay/out"}},
    ]}


def _edges(daemon: str, tmp_path) -> set:
    """The peer-to-peer edges ``daemon``'s daemon pairs for the edge
    descriptor with its own package's nodes."""
    pkg = "dora_tpu_torch" if daemon == "port" else "dora_tpu"
    spec = _edge_spec(tmp_path, pkg)
    if daemon == "port":
        from dora_tpu_torch.daemon.core import Daemon

        desc = Descriptor.parse(spec)
    else:
        from dora_tpu.daemon.core import Daemon

        desc = JDescriptor.parse(spec)

    async def run():
        d = Daemon(local_comm="shmem")
        await d.start()
        try:
            df = await d.spawn_dataflow(desc, working_dir=tmp_path,
                                        local_nodes={str(n.id) for n in desc.nodes})
            await asyncio.wait_for(df.started.wait(), LIMIT_S)
            edges = set(df.p2p_edges)
            result = await asyncio.wait_for(asyncio.shield(df.done), LIMIT_S)
            assert result.is_ok(), result.errors()
            return edges
        finally:
            await d.close()

    return asyncio.run(run())


def test_port_daemon_pairs_the_edges_the_jax_daemon_pairs(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port = _edges("port", tmp_path / "port")
    jax = _edges("jax", tmp_path / "jax")
    assert port == jax == {("s", "data", "direct", "data"), ("s", "data", "relay", "data"),
                           ("relay", "out", "after", "data")}


def test_p2p_receiver_that_does_not_read_holds_back_no_sender(tmp_path):
    """A sender feeding two receivers, one reading and one that reads
    nothing for a while (as the serving dataflow's prompt node once its
    requests are out): the reading receiver gets all 2000 messages before
    the other starts reading, and the other then gets them all too."""
    (tmp_path / "s.py").write_text(textwrap.dedent("""
        from dora_tpu_torch.node import Node
        with Node() as node:
            for i in range(2000):
                node.send_output("data", b"x" * 64, {"seq": i})
    """))
    reader = """
        import json, sys, time
        from dora_tpu_torch.node import Node
        node = Node()
        time.sleep(float(sys.argv[2]))
        start = time.time()
        seqs = [event["metadata"]["seq"] for event in node if event["type"] == "INPUT"]
        node.close()
        json.dump({"start": start, "last": time.time(), "seqs": seqs}, open(sys.argv[1], "w"))
    """
    (tmp_path / "r.py").write_text(textwrap.dedent(reader))
    _run(tmp_path, [
        {"id": "s", "path": "s.py", "outputs": ["data"]},
        {"id": "fast", "path": "r.py", "args": "fast.json 0",
         "inputs": {"data": {"source": "s/data", "queue_size": 4096}}},
        {"id": "idle", "path": "r.py", "args": "idle.json 6",
         "inputs": {"data": {"source": "s/data", "queue_size": 4096}}},
    ])
    fast, idle = _read(tmp_path, "fast.json"), _read(tmp_path, "idle.json")
    assert fast["seqs"] == idle["seqs"] == list(range(2000))
    assert fast["last"] < idle["start"], "the idle receiver held the sender back"


def test_p2p_input_closed_follows_the_last_input(tmp_path):
    """The daemon's InputClosed reaches a slow receiver after every message
    of that input sent peer-to-peer, as it does through the daemon's queue."""
    (tmp_path / "s.py").write_text(textwrap.dedent("""
        from dora_tpu_torch.node import Node
        with Node() as node:
            for i in range(20):
                node.send_output("data", b"d" * 5000, {"seq": i})
    """))
    (tmp_path / "r.py").write_text(textwrap.dedent("""
        import json, time
        from dora_tpu_torch.node import Node
        got = []
        node = Node()
        for event in node:
            got.append([event["type"], event["metadata"].get("seq") if event["metadata"] else None])
            time.sleep(0.05)
        node.close()
        open("got.json", "w").write(json.dumps(got))
    """))
    _run(tmp_path, [
        {"id": "s", "path": "s.py", "outputs": ["data"]},
        {"id": "r", "path": "r.py", "inputs": {"data": {"source": "s/data", "queue_size": 100}}},
    ])
    assert _read(tmp_path, "got.json") == [["INPUT", i] for i in range(20)] + [
        ["INPUT_CLOSED", None]]


def test_event_store_keeps_arrival_order_and_drops_oldest_per_input():
    """The node's one event store: the daemon's events and the peer-to-peer
    ones in arrival order, ``queue_size`` applied to each peer-to-peer input
    alone (the oldest dropped, its region acked as a consumed event's is),
    at most ``max_queue`` of the daemon's events at a time, and the end
    after everything stored."""
    import threading

    from dora_tpu_torch.message import daemon_to_node as d2n
    from dora_tpu_torch.node.events import Event, EventStream

    class Channel:
        """The daemon's side: three inputs, then the end."""

        def __init__(self):
            self.replies = [d2n.NextEvents(events=[_stamped(d2n.Input(
                id="tick", metadata=_meta(), data=None))]) for _ in range(3)]
            self.replies.append(d2n.NextEvents(events=[_stamped(d2n.AllInputsClosed())]))
            self.release = threading.Event()
            self.stop = threading.Event()

        def request(self, msg):
            if len(self.replies) == 1:
                self.release.wait(10)  # the end waits until the test allows it
            return self.replies.pop(0) if self.replies else self.stop.wait(10)

        def interrupt(self):
            self.stop.set()

        def close(self):
            pass

    acked = []
    channel = Channel()
    stream = EventStream(channel, on_ack=acked.append)
    try:
        import weakref

        deadline = time.monotonic() + 10
        while stream._daemon_items < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert stream._daemon_items == 2, "the pump stores two of the daemon's events"
        for seq in range(5):
            event = Event(type="INPUT", id="data", metadata={"seq": seq})
            event._ack = weakref.finalize(event, acked.append, f"token{seq}")
            stream.put_direct("data", event, 3)
            del event
        assert acked == ["token0", "token1"]
        got = [(e.id, e.metadata.get("seq")) for e in (stream.recv(5) for _ in range(6))]
        channel.release.set()
        rest = [e.id for e in stream]
    finally:
        stream.close()
    assert got == [("tick", None), ("tick", None), ("data", 2), ("data", 3), ("data", 4),
                   ("tick", None)]
    assert rest == [] and stream.ended
    assert sorted(acked) == ["token0", "token1", "token2", "token3", "token4"]


def _meta():
    from dora_tpu_torch.message.common import ENCODING_RAW, Metadata, TypeInfo

    return Metadata(type_info=TypeInfo(encoding=ENCODING_RAW, len=0), parameters={})


def _stamped(inner):
    from dora_tpu_torch.clock import HLC
    from dora_tpu_torch.message.serde import Timestamped

    return Timestamped(inner=inner, timestamp=HLC().new_timestamp())
