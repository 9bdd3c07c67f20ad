"""The port's node wire against dora_tpu's, byte for byte, on the CPU.

For every message class the port's node sends or receives, the port's
codec (dora_tpu_torch/message) gives the bytes dora_tpu.message.serde
gives, and each side decodes the other's; the Arrow IPC payload of
``[text]`` is JAX ``ipc_serialize(pa.array([text]))``; a NodeConfig that
dora_tpu.daemon.spawn encodes decodes in the port; a shared-memory region
and channel written by one side's native binding read back in the other's.
"""

from __future__ import annotations

import base64
import dataclasses
import uuid

import pytest

from dora_tpu.clock import Timestamp as JaxTimestamp
from dora_tpu.message import common as jc
from dora_tpu.message import daemon_to_node as jd2n
from dora_tpu.message import node_to_daemon as jn2d
from dora_tpu.message import serde as jserde
from dora_tpu_torch.clock import Timestamp
from dora_tpu_torch.message import common as tc
from dora_tpu_torch.message import daemon_to_node as td2n
from dora_tpu_torch.message import node_to_daemon as tn2d
from dora_tpu_torch.message import serde as tserde

TS = (1_700_000_000_123_456_789 << 16) | 7


def _samples(common, d2n, n2d, serde, ts_cls):
    """One instance of every message class the node speaks, built from the
    given package's modules with the same field values."""
    meta = common.Metadata(type_info=common.TypeInfo(encoding="arrow-ipc", len=42),
                           parameters={"request_id": "r-1", "done": False, "seq": 3,
                                       "t": "collides with the envelope tag",
                                       "nested": {"a": [1, 2.5, None, True]}})
    inline = common.InlineData(data=b"\x00\x01payload")
    shm = common.SharedMemoryData(shmem_id="dtp-0123456789abcdef", len=8192,
                                  drop_token="0190a0a0-0000-7000-8000-000000000000")
    digest = common.EngineStateDigest(
        model_id="qwen2", fingerprint="00ff", page_size=16, window=8, spec_k=0, kv_dtype="fp",
        weight_bits=8, max_slots=16, free_streams=3, used_pages=40, free_pages=470,
        total_pages=510, prefix_pages=12, hbm_used_bytes=1 << 33, hbm_limit_bytes=1 << 36,
        adapters=["t0"], prefixes=[["c0ffee", 32, 2]], seq=5, unix_ts=1.7e9)
    run = d2n.RunConfig(inputs={"text": 10}, outputs=["response"])
    ts = ts_cls(TS, "a" * 32)
    status = common.NodeExitStatus(success=False, code=3)
    cause = common.NodeErrorCause(kind="other", stderr="boom")
    error = common.NodeError(exit_status=status, cause=cause)
    return {
        "TypeInfo": meta.type_info,
        "Metadata": meta,
        "InlineData": inline,
        "SharedMemoryData": shm,
        "EngineStateDigest": digest,
        "ReplyResult": d2n.ReplyResult(error="refused"),
        "NextEvents": d2n.NextEvents(events=[
            serde.Timestamped(inner=d2n.Input(id="text", metadata=meta, data=inline),
                              timestamp=ts),
            serde.Timestamped(inner=d2n.Input(id="text", metadata=meta, data=shm),
                              timestamp=ts)]),
        "NodeConfigReply": d2n.NodeConfigReply(error=None, node_config=d2n.NodeConfig(
            dataflow_id="df", node_id="llm", run_config=run,
            daemon_communication=d2n.TcpCommunication(socket_addr="127.0.0.1:5"),
            dataflow_descriptor={"nodes": []}, dynamic=True)),
        "DropEvents": d2n.DropEvents(drop_tokens=["tok-1", "tok-2"]),
        "Stop": d2n.Stop(),
        "Reload": d2n.Reload(operator_id="op"),
        "Migrate": d2n.Migrate(handoff_dir="/tmp/h"),
        "Profile": d2n.Profile(action="start", seconds=2.5),
        "Input": d2n.Input(id="text", metadata=meta, data=None),
        "InputClosed": d2n.InputClosed(id="text"),
        "AllInputsClosed": d2n.AllInputsClosed(),
        "TcpCommunication": d2n.TcpCommunication(socket_addr="127.0.0.1:53291"),
        "UnixDomainCommunication": d2n.UnixDomainCommunication(socket_file="/tmp/d.sock"),
        "ShmemCommunication": d2n.ShmemCommunication(control_region_id="c", events_region_id="e",
                                                     drop_region_id="d"),
        "RunConfig": run,
        "NodeConfig": d2n.NodeConfig(
            dataflow_id="df", node_id="llm", run_config=run,
            daemon_communication=d2n.ShmemCommunication(control_region_id="c",
                                                        events_region_id="e",
                                                        drop_region_id="d"),
            dataflow_descriptor={"nodes": [{"id": "llm", "env": {"K": 8}}]}),
        "Register": n2d.Register(dataflow_id="df", node_id="llm", protocol_version="0.1.0",
                                 channel=n2d.CHANNEL_EVENTS),
        "Subscribe": n2d.Subscribe(),
        "SubscribeDrop": n2d.SubscribeDrop(),
        "SendMessage": n2d.SendMessage(output_id="response", metadata=meta, data=shm),
        "OutputsDone": n2d.OutputsDone(),
        "NextEvent": n2d.NextEvent(drop_tokens=["tok-3"]),
        "ReportDropTokens": n2d.ReportDropTokens(drop_tokens=["tok-4"]),
        "ReportTrace": n2d.ReportTrace(events=[[1, 2, "s_admitted", "req-1 slot=0", "ctx", 50]]),
        "ReportServing": n2d.ReportServing(snapshot={"engine": "paged", "ttft_us": {
            "counts": [0, 1], "p50_us": 2.0}, "qos_depth": {"batch": 1}}),
        "ReportEngineState": n2d.ReportEngineState(digest=digest),
        "ReportProfile": n2d.ReportProfile(artifact="/tmp/p", error=None),
        "NextDropEvents": n2d.NextDropEvents(),
        "NodeConfigRequest": n2d.NodeConfigRequest(node_id="llm"),
        "Timestamped": serde.Timestamped(inner=n2d.Subscribe(), timestamp=ts),
        # what the port's daemon also receives and reports
        "CloseOutputs": n2d.CloseOutputs(outputs=["response"]),
        "EventStreamDropped": n2d.EventStreamDropped(),
        "P2PAnnounce": n2d.P2PAnnounce(listeners={"text": "dtp-p2p-0"}),
        "P2PEdgesRequest": n2d.P2PEdgesRequest(),
        "P2PEdge": d2n.P2PEdge(channel="dtp-p2p-0", input_id="text", receiver="llm"),
        "P2POutput": d2n.P2POutput(edges=[d2n.P2PEdge(channel="dtp-p2p-0", input_id="text",
                                                      receiver="llm")], daemon_route=True),
        "P2PEdgesReply": d2n.P2PEdgesReply(outputs={"response": d2n.P2POutput(
            edges=[d2n.P2PEdge(channel="dtp-p2p-1", input_id="in", receiver="sink")],
            daemon_route=False)}),
        "NodeExitStatus": status,
        "NodeErrorCause": cause,
        "NodeError": error,
        "NodeResult": common.NodeResult(error=error),
        "DataflowResult": common.DataflowResult(uuid="df", node_results={
            "llm": common.NodeResult(error=error), "sink": common.NodeResult()}),
        "LogMessage": common.LogMessage(dataflow_id="df", level="warn", message="slow",
                                        node_id="llm", machine_id="B"),
    }


JAX = _samples(jc, jd2n, jn2d, jserde, JaxTimestamp)
PORT = _samples(tc, td2n, tn2d, tserde, Timestamp)


def test_every_node_message_class_is_covered():
    """The samples name every @message class of the port's node wire (and of
    what its daemon receives and reports); the control plane's classes
    (message/coordinator.py) are tests/test_torch_cluster.py's."""
    port_classes = {name for name, cls in tserde._REGISTRY.items()
                    if cls.__module__ != "dora_tpu_torch.message.coordinator"}
    assert port_classes == set(PORT), port_classes ^ set(PORT)


@pytest.mark.parametrize("name", sorted(PORT))
def test_message_bytes_equal_jax(name):
    ours, theirs = PORT[name], JAX[name]
    assert type(ours).__name__ == type(theirs).__name__ == name
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(theirs)]
    data = tserde.encode(ours)
    assert data == jserde.encode(theirs)
    # each side decodes the other's bytes back to its own equal message
    assert tserde.decode(jserde.encode(theirs)) == ours
    assert jserde.decode(data) == theirs


def test_timestamped_envelope_and_expects_reply_match_jax():
    from dora_tpu.clock import HLC as JaxHLC
    from dora_tpu_torch.clock import HLC

    for name in PORT:
        assert tn2d.expects_reply(PORT[name]) == jn2d.expects_reply(JAX[name]), name
    clock, jclock = HLC(), JaxHLC()
    framed = tserde.encode_timestamped(PORT["SendMessage"], clock)
    env = jserde.decode_timestamped(framed, jclock)
    assert env.inner == JAX["SendMessage"]
    back = tserde.decode_timestamped(jserde.encode_timestamped(JAX["NextEvent"], jclock), clock)
    assert back.inner == PORT["NextEvent"]
    # the receiving clock moved past the sender's timestamp
    assert clock.new_timestamp().time > back.timestamp.time


@pytest.mark.parametrize("data", ["inline", "shmem", "none"])
def test_input_frames_encoded_once_equal_jax_frames_per_edge(data):
    """A peer-to-peer publish encodes its metadata and payload once for all
    of an output's edges: each frame equals the JAX package's
    Timestamped(Input) for that edge's input id, byte for byte."""
    from dora_tpu_torch.clock import HLC

    class Clock:
        def __init__(self, ts):
            self.ts = ts

        def new_timestamp(self):
            return self.ts

    meta = tc.Metadata(type_info=tc.TypeInfo(encoding=tc.ENCODING_RAW, len=3),
                       parameters={"seq": 4, "t": "escaped", "done": False})
    jmeta = jc.Metadata(type_info=jc.TypeInfo(encoding=jc.ENCODING_RAW, len=3),
                        parameters={"seq": 4, "t": "escaped", "done": False})
    payload, jpayload = {
        "inline": (tc.InlineData(data=b"abc"), jc.InlineData(data=b"abc")),
        "shmem": (tc.SharedMemoryData(shmem_id="dtp-x", len=3, drop_token="tok"),
                  jc.SharedMemoryData(shmem_id="dtp-x", len=3, drop_token="tok")),
        "none": (None, None)}[data]
    ts = HLC().new_timestamp()
    jts = JaxTimestamp(time=ts.time, id=ts.id)
    frames = tserde.encode_timestamped_inputs(["response", "text", "response"], meta, payload,
                                              Clock(ts))
    assert sorted(frames) == ["response", "text"]
    for input_id, frame in frames.items():
        assert frame == jserde.encode_timestamped(
            jd2n.Input(id=input_id, metadata=jmeta, data=jpayload), Clock(jts))
        assert tserde.decode_timestamped(frame).inner == td2n.Input(
            id=input_id, metadata=meta, data=payload)


def test_arrow_payload_of_a_text_equals_jax():
    import pyarrow as pa

    from dora_tpu.node.arrow import ipc_deserialize as jax_read
    from dora_tpu.node.arrow import ipc_serialize as jax_write
    from dora_tpu_torch.node import arrow

    for text in ("", " t42", "héllo wörld ✓", "x" * 5000):
        ours = arrow.ipc_serialize(arrow.to_arrow([text]))
        assert ours == jax_write(pa.array([text]))
        assert jax_read(ours).to_pylist() == [text]
        assert arrow.ipc_deserialize(jax_write(pa.array([text]))).to_pylist() == [text]
        assert arrow.ipc_max_size(arrow.to_arrow([text])) >= len(ours)


@pytest.mark.parametrize("comm", ["tcp", "uds", "shmem"])
def test_node_config_from_the_jax_spawner_decodes_in_the_port(comm):
    from dora_tpu.daemon.spawn import NODE_CONFIG_ENV as JAX_ENV
    from dora_tpu.daemon.spawn import encode_node_config
    from dora_tpu_torch.node import NODE_CONFIG_ENV, decode_node_config

    assert NODE_CONFIG_ENV == JAX_ENV
    jcomm = {"tcp": JAX["TcpCommunication"], "uds": JAX["UnixDomainCommunication"],
             "shmem": JAX["ShmemCommunication"]}[comm]
    jcfg = dataclasses.replace(JAX["NodeConfig"], daemon_communication=jcomm)
    cfg = decode_node_config(encode_node_config(jcfg))
    assert isinstance(cfg, td2n.NodeConfig)
    assert tserde.encode(cfg) == jserde.encode(jcfg)
    assert type(cfg.daemon_communication).__name__ == type(jcomm).__name__
    with pytest.raises(ValueError, match="does not contain a NodeConfig"):
        decode_node_config(base64.b64encode(jserde.encode(jd2n.Stop())).decode())


def test_shmem_region_reads_across_both_bindings():
    from dora_tpu.native import ShmemRegion as JaxRegion
    from dora_tpu_torch.native import ShmemRegion

    name = f"dtp-wire-{uuid.uuid4().hex[:12]}"
    payload = bytes(range(256)) * 20
    writer = JaxRegion.create(name, 8192)
    memoryview(writer)[: len(payload)] = payload
    reader = ShmemRegion.open(name)
    view = memoryview(reader)
    assert reader.size == 8192 and bytes(view[: len(payload)]) == payload
    with pytest.raises(BufferError):
        reader.close()  # a live view pins the mapping
    view.release()
    reader.close()
    writer.close()

    name = f"dtp-wire-{uuid.uuid4().hex[:12]}"
    ours = ShmemRegion.create(name, 4096)
    memoryview(ours)[:5] = b"torch"
    theirs = JaxRegion.open(name)
    assert bytes(memoryview(theirs)[:5]) == b"torch"
    theirs.close()
    ours.close()


def test_shmem_channel_talks_to_a_jax_server():
    """The daemon side of ShmemCommunication is the JAX binding's server
    channel; the port's client sends a request and reads the reply."""
    import threading

    from dora_tpu.native import ShmemChannel as JaxChannel
    from dora_tpu_torch.native import Disconnected, ShmemChannel

    name = f"dtp-chan-{uuid.uuid4().hex[:12]}"
    server = JaxChannel.create(name, capacity=1 << 16)
    client = ShmemChannel.open(name)

    def serve():
        req = server.recv(timeout=10)
        server.send(b"reply:" + req)

    t = threading.Thread(target=serve)
    t.start()
    client.send(b"request")
    assert client.recv(timeout=10) == b"reply:request"
    t.join(timeout=10)
    assert not t.is_alive()
    server.disconnect()
    with pytest.raises(Disconnected):
        client.recv(timeout=1)
    client.close()
    server.close()
