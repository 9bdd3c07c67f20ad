"""The port's cluster tier (dora_tpu_torch.coordinator, the daemon's attached
mode and its links between machines, the CLI's control commands) against the
JAX package's, on the CPU.

* Every control message (``message/coordinator.py``) encodes to the JAX
  codec's bytes and decodes across.
* tests/test_coordinator_multidaemon.py's three scenarios (the full life of
  a two-machine dataflow, a stop, a cascading cause across machines) run
  under a coordinator and two daemons on localhost, on machines A and B: the
  port's alone, a port coordinator with JAX daemons, a JAX coordinator with
  port daemons, and a port daemon beside a JAX one. Results, error causes
  and the sink's records equal the all-JAX run's.
* The port's CLI (``start --attach``, ``list``, ``logs``, ``stop``,
  ``metrics``, ``destroy``) against either coordinator, every process on a
  free port (never the default ones, which ``up`` keeps: its command lines
  are checked here, and it runs on the card).
* ``migrate`` reaches a node as a MIGRATE event with its handoff directory,
  a profile request as a PROFILE event whose report comes back as the
  reply; the trace, metrics history and alert planes answer, on the port's
  coordinator and on a JAX coordinator over port daemons.
* ``multiple-daemons.yml`` standalone, every node on this machine, under
  both daemons.

The JAX daemons take the daemon route (``DORA_P2P=0``). Each run has a time
limit of its own; no case asserts a time.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time

import pytest
import yaml

from dora_tpu.coordinator import Coordinator as JCoordinator
from dora_tpu.daemon import run_dataflow as jax_run
from dora_tpu.daemon.core import Daemon as JDaemon
from dora_tpu.message import common as jcommon
from dora_tpu.message import coordinator as jcm
from dora_tpu.message import serde as jserde
from dora_tpu_torch.cli import main as cli
from dora_tpu_torch.coordinator import Coordinator as PCoordinator
from dora_tpu_torch.daemon import run_dataflow as port_run
from dora_tpu_torch.daemon.core import Daemon as PDaemon
from dora_tpu_torch.message import common as pcommon
from dora_tpu_torch.message import coordinator as pcm
from dora_tpu_torch.message import serde as pserde

LIMIT_S = 60
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STACKS = {"jax": (JCoordinator, jcm), "port": (PCoordinator, pcm)}
#: (coordinator, daemon of A, daemon of B); the nodes are the port's unless
#: every part is JAX's
CLUSTERS = {
    "port": ("port", "port", "port"),
    "port-coordinator-jax-daemons": ("port", "jax", "jax"),
    "jax-coordinator-port-daemons": ("jax", "port", "port"),
    "port-and-jax-daemon": ("port", "port", "jax"),
}
DAEMONS = {"jax": JDaemon, "port": PDaemon}


@pytest.fixture(autouse=True)
def _daemon_route(monkeypatch):
    monkeypatch.setenv("DORA_P2P", "0")


# ---------------------------------------------------------------------------
# the control messages' bytes
# ---------------------------------------------------------------------------


def _classes(module) -> dict[str, type]:
    return {n: c for n, c in vars(module).items()
            if dataclasses.is_dataclass(c) and c.__module__ == module.__name__}


def _sample(typ: str, common, cm):
    """A value of the annotated type, built from one package's classes."""
    result = common.DataflowResult(uuid="u-1", node_results={
        "a": common.NodeResult(error=None),
        "b": common.NodeResult(error=common.NodeError(
            exit_status=common.NodeExitStatus(success=False, code=3),
            cause=common.NodeErrorCause(kind="cascading", caused_by_node="a")))})
    return {
        "int": 53291, "float": 2.5, "float | None": 0.25, "bool": True,
        "str": "node/x", "str | None": "name-1", "bytes": b"\x00log\xff",
        "bytes | None": b"\x01\x02", "list[str]": ["a/in", "b/in"],
        "dict[str, str]": {"A": "127.0.0.1:1", "B": "127.0.0.1:2"},
        "dict[str, Any]": {"nodes": [{"id": "n", "path": "x.py"}], "t": 1, "f": [1.5, None]},
        "Metadata": common.Metadata(type_info=common.TypeInfo(encoding="arrow-ipc", len=12),
                                    parameters={"i": 1, "t": "x"}),
        "LogMessage": common.LogMessage(dataflow_id="u-1", level="warn", message="slow",
                                        node_id="n", machine_id="A"),
        "DataflowResult": result,
        "list[DataflowListEntry]": [cm.DataflowListEntry(uuid="u-1", name=None),
                                    cm.DataflowListEntry(uuid="u-2", name="two")],
    }[typ]


def _instance(cls, common, cm):
    return cls(**{f.name: _sample(f.type, common, cm) for f in dataclasses.fields(cls)})


@pytest.mark.parametrize("name", sorted(_classes(jcm)))
def test_control_message_encodes_as_jax(name):
    assert sorted(_classes(pcm)) == sorted(_classes(jcm))
    jmsg = _instance(getattr(jcm, name), jcommon, jcm)
    pmsg = _instance(getattr(pcm, name), pcommon, pcm)
    assert [f.name for f in dataclasses.fields(pmsg)] == [f.name for f in dataclasses.fields(jmsg)]
    data = jserde.encode(jmsg)
    assert pserde.encode(pmsg) == data
    assert pserde.decode(data) == pmsg
    assert jserde.decode(pserde.encode(pmsg)) == jmsg


# ---------------------------------------------------------------------------
# two machines on localhost
# ---------------------------------------------------------------------------

SINK = """
import json
import os
import sys

from {pkg}.node import Node

records = []
with Node() as node:
    for event in node:
        if event["type"] == "INPUT":
            value = event["value"]
            records.append([event["type"], event["id"],
                            None if value is None else value.to_pylist()])
        else:
            records.append([event["type"], event.get("id")])
        with open(sys.argv[1] + ".tmp", "w") as f:
            json.dump(records, f)
        os.replace(sys.argv[1] + ".tmp", sys.argv[1])
"""

VICTIM = """
from {pkg}.node import Node

with Node() as node:
    for event in node:
        pass
"""


def _lifecycle_spec(pkg: str, work) -> dict:
    (work / "sink.py").write_text(SINK.format(pkg=pkg))
    return {"nodes": [
        {"id": "sender", "path": f"module:{pkg}.nodehub.pyarrow_sender", "outputs": ["data"],
         "env": {"DATA": "[5, 6, 7]", "COUNT": "3"}, "deploy": {"machine": "A"}},
        {"id": "receiver", "path": f"module:{pkg}.nodehub.pyarrow_assert",
         "inputs": {"in": "sender/data"}, "env": {"DATA": "[5, 6, 7]", "MIN_COUNT": "3"},
         "deploy": {"machine": "B"}},
        {"id": "sink", "path": "sink.py", "args": str(work / "records.json"),
         "inputs": {"in": "sender/data"}, "deploy": {"machine": "B"}},
    ]}


def _stop_spec(pkg: str, work) -> dict:
    (work / "sink.py").write_text(SINK.format(pkg=pkg))
    return {"nodes": [
        {"id": "ticker", "path": f"module:{pkg}.nodehub.echo",
         "inputs": {"in": "dora/timer/millis/100"}, "outputs": ["echo"],
         "deploy": {"machine": "A"}},
        {"id": "sink", "path": "sink.py", "args": str(work / "records.json"),
         "inputs": {"in": "ticker/echo"}, "deploy": {"machine": "B"}},
    ]}


def _cascade_spec(pkg: str, work) -> dict:
    (work / "bad.py").write_text("import sys; sys.exit(3)\n")
    (work / "victim.py").write_text(VICTIM.format(pkg=pkg))
    return {"nodes": [
        {"id": "bad", "path": "bad.py", "outputs": ["data"], "deploy": {"machine": "A"}},
        {"id": "victim", "path": "victim.py", "inputs": {"in": "bad/data"},
         "deploy": {"machine": "B"}},
    ]}


def _ticks(work) -> int:
    try:
        return sum(r[0] == "INPUT" for r in json.loads((work / "records.json").read_text()))
    except FileNotFoundError:
        return 0


async def _wait_machines(coord, cm, expected: set[str]) -> None:
    deadline = time.monotonic() + 20
    while set((await coord.handle_control_request(cm.ConnectedMachines())).machines) < expected:
        assert time.monotonic() < deadline, f"machines {expected} never registered"
        await asyncio.sleep(0.05)


async def _wait_finished(coord, cm, uuid: str):
    deadline = time.monotonic() + LIMIT_S
    while True:
        reply = await coord.handle_control_request(cm.Check(dataflow_uuid=uuid))
        if isinstance(reply, cm.DataflowStopped):
            return reply.result
        assert not isinstance(reply, cm.Error), reply.message
        assert time.monotonic() < deadline, "the dataflow never finished"
        await asyncio.sleep(0.1)


def _run_cluster(cluster: tuple[str, str, str], scenario: str, work) -> dict:
    """One scenario on a coordinator and daemons A and B of the named stacks,
    in this process; returns what the comparisons read."""
    coord_kind, kind_a, kind_b = cluster
    Coordinator, cm = STACKS[coord_kind]
    pkg = "dora_tpu" if set(cluster) == {"jax"} else "dora_tpu_torch"
    spec = {"lifecycle": _lifecycle_spec, "stop": _stop_spec,
            "cascade": _cascade_spec}[scenario](pkg, work)

    async def main():
        coord = Coordinator()
        await coord.start()
        addr = f"127.0.0.1:{coord.daemon_port}"
        tasks = [asyncio.create_task(DAEMONS[kind_a]().run(addr, "A")),
                 asyncio.create_task(DAEMONS[kind_b]().run(addr, "B"))]
        out: dict = {}
        try:
            await _wait_machines(coord, cm, {"A", "B"})
            assert (await coord.handle_control_request(cm.DaemonConnected())).connected
            start = await coord.handle_control_request(
                cm.Start(dataflow=spec, name=scenario, local_working_dir=str(work)))
            assert isinstance(start, cm.DataflowStarted), start
            listed = await coord.handle_control_request(cm.ListDataflows())
            assert [e.name for e in listed.dataflows] == [scenario]
            if scenario == "stop":
                deadline = time.monotonic() + LIMIT_S
                while _ticks(work) < 3:  # a few ticks crossed to B
                    assert time.monotonic() < deadline, "no ticks reached machine B"
                    await asyncio.sleep(0.05)
                stopped = await asyncio.wait_for(coord.handle_control_request(
                    cm.StopByName(name="stop", grace_duration_s=5)), LIMIT_S)
                assert isinstance(stopped, cm.DataflowStopped), stopped
                result = stopped.result
            else:
                result = await _wait_finished(coord, cm, start.uuid)
            out["ok"] = result.is_ok()
            out["nodes"] = sorted(result.node_results)
            out["errors"] = {nid: (e.cause.kind, e.cause.caused_by_node)
                             for nid, e in result.errors()}
            if scenario == "lifecycle":
                logs = await coord.handle_control_request(
                    cm.Logs(uuid=start.uuid, name=None, node="receiver"))
                out["receiver_log"] = logs.logs.decode()
                metrics = await coord.handle_control_request(cm.QueryMetrics(name="lifecycle"))
                out["links"] = metrics.metrics["links"]
            if scenario != "cascade":
                out["records"] = json.loads((work / "records.json").read_text())
            destroy = await coord.handle_control_request(cm.Destroy())
            assert isinstance(destroy, cm.DestroyOk), destroy
            await asyncio.wait_for(asyncio.gather(*tasks), timeout=20)
        finally:
            for t in tasks:
                t.cancel()
            await coord.close()
        return out

    return asyncio.run(main())


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """Each scenario on the JAX coordinator, daemons and nodes."""
    prev = os.environ.get("DORA_P2P")
    os.environ["DORA_P2P"] = "0"
    try:
        return {s: _run_cluster(("jax", "jax", "jax"), s, tmp_path_factory.mktemp(f"jax-{s}"))
                for s in ("lifecycle", "stop", "cascade")}
    finally:
        if prev is None:
            os.environ.pop("DORA_P2P", None)
        else:
            os.environ["DORA_P2P"] = prev


@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
def test_two_machine_lifecycle_equals_jax(tmp_path, jax_runs, cluster):
    got = _run_cluster(CLUSTERS[cluster], "lifecycle", tmp_path)
    want = jax_runs["lifecycle"]
    assert got["ok"] and want["ok"], got
    assert got["nodes"] == want["nodes"] == ["receiver", "sender", "sink"]
    assert "asserted 3 inputs OK" in got["receiver_log"]
    assert got["records"] == want["records"]
    assert want["records"] == [["INPUT", "in", [5, 6, 7]]] * 3 + [["INPUT_CLOSED", "in"]]
    # each daemon counts the link: the sender's on A, the arrivals on B
    assert got["links"]["sender/data"]["msgs"] == want["links"]["sender/data"]["msgs"]


@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
def test_two_machine_stop_equals_jax(tmp_path, jax_runs, cluster):
    got = _run_cluster(CLUSTERS[cluster], "stop", tmp_path)
    want = jax_runs["stop"]
    assert got["ok"] and want["ok"], got["errors"]
    assert got["nodes"] == want["nodes"] == ["sink", "ticker"]
    # the ticks are a timer's: their number is not fixed, their form is
    for records in (got["records"], want["records"]):
        ticks = [r for r in records if r[0] == "INPUT"]
        assert ticks and all(r[1:] == ["in", None] for r in ticks), records
        tail = records[len(ticks):]
        assert tail and all(r in (["INPUT_CLOSED", "in"], ["STOP", None]) for r in tail), records


@pytest.mark.parametrize("cluster", sorted(CLUSTERS))
def test_cascading_cause_across_machines_equals_jax(tmp_path, jax_runs, cluster):
    got = _run_cluster(CLUSTERS[cluster], "cascade", tmp_path)
    want = jax_runs["cascade"]
    assert not got["ok"] and not want["ok"]
    assert got["errors"] == want["errors"] == {"bad": ("other", None),
                                              "victim": ("cascading", "bad")}


# ---------------------------------------------------------------------------
# the CLI against either coordinator
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cli(capsys, *argv) -> tuple[int, str, str]:
    rc = cli.main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("coordinator", ["port", "jax"])
def test_cli_control_commands_against_either_coordinator(tmp_path, capsys, monkeypatch,
                                                          coordinator):
    monkeypatch.setenv("DORA_TPU_STATE_DIR", str(tmp_path / "state"))
    daemon_port, control_port = _free_port(), _free_port()
    ctl = f"127.0.0.1:{control_port}"
    coord_cli = ([sys.executable, "-m", "dora_tpu_torch.cli"] if coordinator == "port"
                 else [sys.executable, "-m", "dora_tpu.cli.main"])
    logs = open(tmp_path / "cluster.log", "wb")
    state = tmp_path / "state"
    state.mkdir()
    procs = []

    def spawn(log_name, argv):
        # as ``up`` starts them: ``destroy`` ends what it does not reach
        procs.append(subprocess.Popen(argv, stdout=logs, stderr=logs))
        (state / f"{log_name}.pid").write_text(str(procs[-1].pid))

    spawn("coordinator", coord_cli + ["coordinator", "--port", str(daemon_port),
                                      "--control-port", str(control_port), "--quiet"])
    try:
        for machine in ("A", "B"):
            spawn(f"daemon-{machine}", [sys.executable, "-m", "dora_tpu_torch.cli", "daemon",
                                        "--coordinator-addr", f"127.0.0.1:{daemon_port}",
                                        "--machine-id", machine])
        deadline = time.monotonic() + 30
        while set(cli._connected_machines(ctl) or ()) < {"A", "B"}:
            assert time.monotonic() < deadline, (tmp_path / "cluster.log").read_text()[-3000:]
            time.sleep(0.1)

        flow = tmp_path / "flow"
        flow.mkdir()
        (flow / "two.yml").write_text(yaml.safe_dump(_lifecycle_spec("dora_tpu_torch", flow)))
        rc, out, err = _cli(capsys, "start", str(flow / "two.yml"), "--name", "two", "--attach",
                            "--coordinator-addr", ctl)
        assert rc == 0, err
        uuid = out.splitlines()[0].strip()
        assert f"dataflow {uuid} finished successfully" in out
        rc, out, _ = _cli(capsys, "logs", "receiver", "--uuid", uuid, "--coordinator-addr", ctl)
        assert rc == 0 and "asserted 3 inputs OK" in out
        rc, out, _ = _cli(capsys, "metrics", "--name", "two", "--json", "--coordinator-addr", ctl)
        assert rc == 0 and json.loads(out)["links"]["sender/data"]["msgs"] == 6

        ticker = tmp_path / "ticker"
        ticker.mkdir()
        (ticker / "tick.yml").write_text(yaml.safe_dump(_stop_spec("dora_tpu_torch", ticker)))
        rc, out, _ = _cli(capsys, "start", str(ticker / "tick.yml"), "--name", "tick",
                          "--coordinator-addr", ctl)
        assert rc == 0
        tick_uuid = out.strip()
        rc, out, _ = _cli(capsys, "list", "--coordinator-addr", ctl)
        assert out.split() == [tick_uuid, "tick"]
        deadline = time.monotonic() + LIMIT_S
        while _ticks(ticker) < 3:  # started on both machines: a stop now is a clean one
            assert time.monotonic() < deadline, "no ticks reached machine B"
            time.sleep(0.05)
        rc, out, err = _cli(capsys, "stop", "--name", "tick", "--grace-duration", "5",
                            "--coordinator-addr", ctl)
        assert rc == 0 and "finished successfully" in out, err
        rc, out, _ = _cli(capsys, "list", "--coordinator-addr", ctl)
        assert out == ""

        rc, out, _ = _cli(capsys, "destroy", "--coordinator-addr", ctl)
        assert rc == 0 and "destroyed" in out
        assert not list(state.glob("*.pid"))
        for proc in procs:
            assert proc.wait(timeout=20) in (0, -signal.SIGTERM)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        logs.close()


def test_up_builds_the_port_processes_on_the_default_ports():
    exe = [sys.executable, "-m", "dora_tpu_torch.cli"]
    assert cli.up_commands(None) == {
        "coordinator": exe + ["coordinator", "--port", "53290", "--control-port", "6012"],
        "daemon": exe + ["daemon", "--coordinator-addr", "127.0.0.1:53290"],
    }
    # the daemon registers on the daemon port of the control address's host
    assert cli.up_commands("10.0.0.7:6012", "B")["daemon-B"] == exe + [
        "daemon", "--coordinator-addr", "10.0.0.7:53290", "--machine-id", "B"]


# ---------------------------------------------------------------------------
# migrate, profiles and the observability planes
# ---------------------------------------------------------------------------

MIGRATE_NODE = """
import json
import sys

from dora_tpu_torch.node import Node

with Node() as node:
    for event in node:
        if event["type"] == "PROFILE":
            action = event["metadata"]["action"]
            node.report_profile(f"capture-{action}", None if action == "start" else "no capture")
        if event["type"] == "MIGRATE":
            json.dump({"type": event["type"], "metadata": event["metadata"]},
                      open(sys.argv[1], "w"))
            break
"""


def test_migrate_reaches_the_node_and_every_plane_answers(tmp_path):
    (tmp_path / "serving.py").write_text(MIGRATE_NODE)
    spec = {"nodes": [{"id": "llm", "path": "serving.py", "args": str(tmp_path / "got.json"),
                       "deploy": {"machine": "B"}}]}

    async def main():
        coord = PCoordinator()
        await coord.start()
        task = asyncio.create_task(PDaemon().run(f"127.0.0.1:{coord.daemon_port}", "B"))
        try:
            await _wait_machines(coord, pcm, {"B"})
            start = await coord.handle_control_request(
                pcm.Start(dataflow=spec, name="serve", local_working_dir=str(tmp_path)))
            ctl = f"127.0.0.1:{coord.control_port}"
            replies = {}
            for request in (pcm.StartProfile(dataflow_uuid=None, node_id="llm", seconds=0.1,
                                             name="serve"),
                            pcm.StopProfile(dataflow_uuid=None, node_id="llm", name="serve")):
                replies[type(request).__name__] = await asyncio.wait_for(
                    coord.handle_control_request(request), 20)
            rc = await asyncio.to_thread(cli.main, [
                "migrate", "llm", "--handoff-dir", str(tmp_path / "handoff"), "--name", "serve",
                "--coordinator-addr", ctl])
            assert rc == 0
            result = await _wait_finished(coord, pcm, start.uuid)
            assert result.is_ok(), result.errors()
            for request in (pcm.QueryTrace(name="serve"), pcm.QueryMetricsHistory(name="serve"),
                            pcm.QueryAlerts(name="serve"),
                            pcm.StartProfile(dataflow_uuid=None, node_id="llm", name="serve")):
                reply = await asyncio.wait_for(coord.handle_control_request(request), 5)
                replies["after " + type(request).__name__] = reply
            fleet = await coord.handle_control_request(pcm.QueryFleet(name="serve"))
            await coord.handle_control_request(pcm.Destroy())
            await asyncio.wait_for(task, 20)
        finally:
            task.cancel()
            await coord.close()
        return replies, fleet

    replies, fleet = asyncio.run(main())
    got = json.loads((tmp_path / "got.json").read_text())
    assert got == {"type": "MIGRATE", "metadata": {"handoff_dir": str(tmp_path / "handoff")}}
    start, stop = replies["StartProfile"], replies["StopProfile"]
    assert isinstance(start, pcm.ProfileReply) and (start.node_id, start.artifact,
                                                    start.error) == ("llm", "capture-start", None)
    assert isinstance(stop, pcm.ProfileReply) and (stop.artifact, stop.error) == (
        "capture-stop", "no capture")
    trace = replies["after QueryTrace"]
    assert isinstance(trace, pcm.TraceReply)
    assert {p["machine"] for p in trace.trace["processes"]} <= {"B"}  # tracing off: no spans
    history = replies["after QueryMetricsHistory"]
    assert isinstance(history, pcm.MetricsHistoryReply) and history.history["machines"] == ["B"]
    assert history.history["samples"], "the finish takes a last sample"
    alerts = replies["after QueryAlerts"]
    assert isinstance(alerts, pcm.AlertsReply) and alerts.alerts["firing"] == 0
    assert set(alerts.alerts) >= {"rules", "transitions", "firing_total", "resolved_total"}
    # the dataflow finished: a profile has no node to go to
    late = replies["after StartProfile"]
    assert isinstance(late, pcm.Error) and "is not running" in late.message
    assert isinstance(fleet, pcm.FleetReply) and fleet.fleet["replicas"] == {}


def test_port_daemons_answer_a_jax_coordinator_for_every_plane(tmp_path, monkeypatch):
    """A JAX coordinator's trace, history and alert queries over port daemons
    get each machine's part, which the JAX merges read: the history of both
    machines (the finish's last sample), the alert status, the trace of the
    nodes' and daemons' rings with DORA_TRACING=1."""
    from dora_tpu import telemetry as jtel
    from dora_tpu_torch import telemetry as ptel

    monkeypatch.setenv("DORA_TRACING", "1")
    (tmp_path / "sink.py").write_text(SINK.format(pkg="dora_tpu_torch"))
    spec = _lifecycle_spec("dora_tpu_torch", tmp_path)

    async def main():
        coord = JCoordinator()
        await coord.start()
        addr = f"127.0.0.1:{coord.daemon_port}"
        tasks = [asyncio.create_task(PDaemon().run(addr, m)) for m in ("A", "B")]
        try:
            await _wait_machines(coord, jcm, {"A", "B"})
            start = await coord.handle_control_request(
                jcm.Start(dataflow=spec, name="q", local_working_dir=str(tmp_path)))
            await _wait_finished(coord, jcm, start.uuid)
            replies = [await asyncio.wait_for(coord.handle_control_request(r(name="q")), 15)
                       for r in (jcm.QueryTrace, jcm.QueryMetricsHistory, jcm.QueryAlerts)]
            await coord.handle_control_request(jcm.Destroy())
            await asyncio.wait_for(asyncio.gather(*tasks), 20)
        finally:
            for t in tasks:
                t.cancel()
            await coord.close()
        return replies

    saved = [(m.TRACING, m.TRACING.active, m.FLIGHT, m.FLIGHT.enabled) for m in (jtel, ptel)]
    try:
        trace, history, alerts = asyncio.run(main())
    finally:
        for tracing, active, flight, enabled in saved:
            tracing.active, flight.enabled = active, enabled
            flight.clear()
    assert isinstance(trace, jcm.TraceReply) and isinstance(history, jcm.MetricsHistoryReply)
    assert isinstance(alerts, jcm.AlertsReply) and alerts.alerts["firing"] == 0
    assert history.history["machines"] == ["A", "B"]
    assert {k for s in history.history["samples"] for k in s["counters"]} >= {
        "link:sender/data:msgs"}
    tracks = {(p["machine"], p["process"]) for p in trace.trace["processes"]}
    assert {("A", "sender"), ("B", "receiver"), ("B", "sink"), ("A", "(daemon)")} <= tracks
    kinds = {e[2] for p in trace.trace["processes"] for e in p["events"]}
    assert {"t_send", "t_route", "t_deliver", "t_recv"} <= kinds


# ---------------------------------------------------------------------------
# the two-machine example standalone, every node here
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("example", ["port", "jax"])
def test_multiple_daemons_example_runs_standalone_under_both_daemons(tmp_path, example):
    src = ("dora_tpu_torch/examples/multiple-daemons.yml" if example == "port"
           else "examples/multiple-daemons/dataflow.yml")
    logs = {}
    for daemon, run in (("port", port_run), ("jax", jax_run)):
        work = tmp_path / daemon
        work.mkdir()
        shutil.copy(os.path.join(REPO, src), work / "dataflow.yml")
        result = run(work / "dataflow.yml", timeout_s=LIMIT_S)
        assert result.is_ok(), (daemon, result.errors())
        assert sorted(result.node_results) == ["receiver", "sender"]
        log_dir = next((work / "out").iterdir())
        logs[daemon] = (log_dir / "log_receiver.txt").read_text()
    assert logs["port"] == logs["jax"] == "asserted 3 inputs OK\n"


def test_example_files_check(capsys):
    for name in ("multiple-daemons.yml", "openai-server.yml", "llm-server.yml"):
        path = os.path.join(REPO, "dora_tpu_torch", "examples", name)
        rc, out, err = _cli(capsys, "check", path)
        assert rc == 0, err
    spec = yaml.safe_load(open(os.path.join(REPO, "dora_tpu_torch/examples/llm-server.yml")))
    nodes = {n["id"]: n for n in spec["nodes"]}
    assert nodes["api"]["deploy"]["machine"] != nodes["llm"]["deploy"]["machine"]
    assert nodes["llm"]["path"] == "module:dora_tpu_torch.nodehub.llm_server"
