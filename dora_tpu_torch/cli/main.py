"""The port's CLI (dora_tpu/cli/main.py, its cluster and local commands).

Local: ``check`` validates a dataflow YAML and lints its alert rules
(``analysis.alertcheck``); ``build`` runs its nodes' and operators' ``build:``
commands from the YAML's directory; ``run`` (or ``daemon --run-dataflow``)
runs it to completion under the port's daemon in this process, every node on
this machine, and exits non-zero when a node failed.

Cluster: ``up`` starts a coordinator and a daemon as detached processes
(``python -m dora_tpu_torch.cli coordinator`` / ``daemon``, their pid and log
files under ``DORA_TPU_STATE_DIR``, default ``/tmp/dora-tpu``) on the default
ports; ``coordinator`` and ``daemon --coordinator-addr --machine-id`` start
one of them in the foreground. ``start [--name] [--attach [--hot-reload]]``
(``--hot-reload`` reloads a Python operator whose file changed), ``stop``,
``list``, ``logs``, ``migrate`` and ``destroy`` talk to the coordinator's
control port (``--coordinator-addr``, default ``127.0.0.1:6012``), and so do
the observability views: ``metrics [--watch] [--json]`` (the merged snapshot
as a table, rates from the history ring), ``top [--once] [--json]`` (the
dashboard over the history ring), ``alerts``, ``fleet``, ``trace [--out]
[--check]`` (the merged timeline as a Chrome trace) and ``profile NODE
[--seconds] [--stop]`` (a device profile capture of a serving node). A JAX
coordinator answers them as the port's does: the control wire is the same.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

from dora_tpu_torch.core.topics import (
    DORA_COORDINATOR_PORT_CONTROL_DEFAULT,
    DORA_COORDINATOR_PORT_DEFAULT,
)
from dora_tpu_torch.message import coordinator as cm

#: how long ``up`` waits for the coordinator to answer and the daemon to
#: register
UP_WAIT_S = 10.0
#: ``start --attach`` asks the coordinator this often whether it finished
ATTACH_POLL_S = 1.0


def _state_dir() -> Path:
    return Path(os.environ.get("DORA_TPU_STATE_DIR", "/tmp/dora-tpu"))


def _print_result(result) -> int:
    if result.is_ok():
        print(f"dataflow {result.uuid} finished successfully")
        return 0
    for node_id, error in result.errors():
        print(f"node {node_id!r} failed: {error}", file=sys.stderr)
    return 1


def _control(args):
    from dora_tpu_torch.cli.control import connect

    return connect(getattr(args, "coordinator_addr", None))


# ---------------------------------------------------------------------------
# local commands
# ---------------------------------------------------------------------------


def cmd_check(args) -> int:
    import json

    from dora_tpu_torch.analysis import errors
    from dora_tpu_torch.analysis.alertcheck import check_alerts
    from dora_tpu_torch.core.descriptor import Descriptor
    from dora_tpu_torch.core.validate import ValidationError

    try:
        descriptor = Descriptor.read(args.dataflow)
        descriptor.check(Path(args.dataflow).parent)
    except (ValidationError, ValueError) as e:
        print(f"{args.dataflow}: {e}", file=sys.stderr)
        return 1
    findings = check_alerts(descriptor)
    if args.json:
        print(json.dumps([f.to_dict() for f in findings], indent=2))
    else:
        for f in findings:
            print(f.render())
        if not errors(findings):
            print(f"{args.dataflow}: OK ({len(descriptor.nodes)} nodes)")
    return 1 if errors(findings) else 0


def cmd_build(args) -> int:
    """Run each node's and operator's ``build:`` command, in order, from the
    dataflow's directory; stop at the first that fails."""
    from dora_tpu_torch.core.descriptor import CustomNode, Descriptor, RuntimeNode

    descriptor = Descriptor.read(args.dataflow)
    working_dir = Path(args.dataflow).resolve().parent
    for node in descriptor.nodes:
        builds = []
        if isinstance(node.kind, CustomNode) and node.kind.build:
            builds.append(node.kind.build)
        elif isinstance(node.kind, RuntimeNode):
            builds += [op.build for op in node.kind.operators if op.build]
        for build in builds:
            print(f"[{node.id}] {build}", flush=True)
            rc = subprocess.run(build, shell=True, cwd=working_dir).returncode
            if rc != 0:
                print(f"build of node {node.id!r} failed with {rc}", file=sys.stderr)
                return rc
    return 0


def cmd_run(args) -> int:
    from dora_tpu_torch.daemon import run_dataflow

    return _print_result(run_dataflow(args.dataflow, local_comm=args.local_comm,
                                      timeout_s=args.timeout, stop_after_s=args.stop_after))


# ---------------------------------------------------------------------------
# the cluster's processes
# ---------------------------------------------------------------------------


def _daemon_log_name(machine_id: str) -> str:
    return f"daemon-{machine_id}" if machine_id else "daemon"


def up_commands(coordinator_addr: str | None, machine_id: str = "") -> dict[str, list[str]]:
    """The processes ``up`` starts, by log name: the coordinator on the
    default ports, and a daemon for ``machine_id`` registering on the
    coordinator's daemon port, on the host of ``coordinator_addr`` (the
    control address)."""
    host = (coordinator_addr or "127.0.0.1").rpartition(":")[0] or "127.0.0.1"
    cli = [sys.executable, "-m", "dora_tpu_torch.cli"]
    daemon = cli + ["daemon", "--coordinator-addr", f"{host}:{DORA_COORDINATOR_PORT_DEFAULT}"]
    if machine_id:
        daemon += ["--machine-id", machine_id]
    return {
        "coordinator": cli + ["coordinator", "--port", str(DORA_COORDINATOR_PORT_DEFAULT),
                              "--control-port", str(DORA_COORDINATOR_PORT_CONTROL_DEFAULT)],
        _daemon_log_name(machine_id): daemon,
    }


def _spawn_detached(argv: list[str], log_name: str) -> int:
    state = _state_dir()
    state.mkdir(parents=True, exist_ok=True)
    with open(state / f"{log_name}.log", "ab") as log:
        process = subprocess.Popen(argv, stdout=log, stderr=log, stdin=subprocess.DEVNULL,
                                   start_new_session=True)
    (state / f"{log_name}.pid").write_text(str(process.pid))
    return process.pid


def _kill_pidfile(pidfile: Path) -> bool:
    try:
        os.kill(int(pidfile.read_text()), signal.SIGTERM)
        killed = True
    except (ProcessLookupError, ValueError, OSError):
        killed = False
    pidfile.unlink(missing_ok=True)
    return killed


def _connected_machines(addr: str | None) -> list[str] | None:
    """The machines registered with the coordinator, None if it does not
    answer."""
    from dora_tpu_torch.cli.control import ControlConnection

    try:
        with ControlConnection(addr) as c:
            return c.request(cm.ConnectedMachines()).machines
    except OSError:
        return None


def cmd_up(args) -> int:
    """Start what is missing of a coordinator and a daemon for
    ``--machine-id`` on this machine."""
    commands = up_commands(args.coordinator_addr, args.machine_id)
    machines = _connected_machines(args.coordinator_addr)
    if machines is not None and args.machine_id in machines:
        print("coordinator + daemon already up")
        return 0
    if machines is None:
        _spawn_detached(commands["coordinator"], "coordinator")
        deadline = time.monotonic() + UP_WAIT_S
        while (machines := _connected_machines(args.coordinator_addr)) is None:
            if time.monotonic() > deadline:
                print("coordinator did not come up", file=sys.stderr)
                return 1
            time.sleep(0.2)
    log_name = _daemon_log_name(args.machine_id)
    _spawn_detached(commands[log_name], log_name)
    deadline = time.monotonic() + UP_WAIT_S
    while time.monotonic() < deadline:
        if args.machine_id in (_connected_machines(args.coordinator_addr) or []):
            print("coordinator + daemon up")
            return 0
        time.sleep(0.2)
    print("daemon did not register", file=sys.stderr)
    return 1


def cmd_destroy(args) -> int:
    try:
        with _control(args) as c:
            c.request(cm.Destroy())
            print("destroyed")
    except SystemExit:
        pass
    state = _state_dir()
    for pidfile in sorted(state.glob("daemon*.pid")) + [state / "coordinator.pid"]:
        if pidfile.exists():
            _kill_pidfile(pidfile)
    return 0


def cmd_coordinator(args) -> int:
    from dora_tpu_torch.coordinator import Coordinator

    async def main():
        coordinator = Coordinator()
        await coordinator.start(daemon_port=args.port, control_port=args.control_port)
        if not args.quiet:
            print(f"coordinator up (daemons: {coordinator.daemon_port}, "
                  f"control: {coordinator.control_port})", flush=True)
        await coordinator.wait_destroyed()
        await coordinator.close()

    asyncio.run(main())
    return 0


def cmd_daemon(args) -> int:
    from dora_tpu_torch.daemon.core import Daemon, run_dataflow_async

    if args.run_dataflow:
        return _print_result(asyncio.run(run_dataflow_async(args.run_dataflow,
                                                            local_comm=args.local_comm)))
    daemon = Daemon(local_comm=args.local_comm or "tcp")
    asyncio.run(daemon.run(args.coordinator_addr, args.machine_id))
    return 0


# ---------------------------------------------------------------------------
# control commands
# ---------------------------------------------------------------------------


def cmd_start(args) -> int:
    import yaml

    raw = yaml.safe_load(Path(args.dataflow).read_text())
    working_dir = str(Path(args.dataflow).resolve().parent)
    with _control(args) as c:
        reply = c.request(cm.Start(dataflow=raw, name=args.name, local_working_dir=working_dir))
        print(reply.uuid, flush=True)
        if not args.attach:
            return 0
        return _attach(c, reply.uuid, args)


def _attach(c, uuid: str, args) -> int:
    """Ask the coordinator each ``ATTACH_POLL_S`` whether the dataflow
    finished, printing its live log lines from a second connection; with
    ``--hot-reload``, a Python operator whose file changed is reloaded;
    ctrl-c stops it."""
    stream_stop = _start_log_stream(args, uuid)
    watcher = (HotReloadWatcher(args.dataflow, str(Path(args.dataflow).resolve().parent))
               if getattr(args, "hot_reload", False) else None)
    try:
        while True:
            reply = c.request(cm.Check(dataflow_uuid=uuid))
            if isinstance(reply, cm.DataflowStopped):
                return _print_result(reply.result)
            for node_id, operator_id in watcher.changed() if watcher is not None else ():
                print(f"reloading {node_id}/{operator_id}", flush=True)
                c.request(cm.ReloadRequest(dataflow_id=uuid, node_id=node_id,
                                           operator_id=operator_id))
            time.sleep(ATTACH_POLL_S)
    except KeyboardInterrupt:
        print("\nstopping dataflow...")
        reply = c.request(cm.StopRequest(dataflow_uuid=uuid, grace_duration_s=None))
        return _print_result(reply.result)
    finally:
        if stream_stop is not None:
            stream_stop()


class HotReloadWatcher:
    """Polls the files of a dataflow's Python operators for a newer mtime.
    Python operators only, as in the JAX CLI: a custom node owns its
    process, so swapping its code would be a restart; the runtime keeps a
    Python operator's state across its reload."""

    def __init__(self, dataflow_path: str, working_dir: str | None):
        from dora_tpu_torch.core.descriptor import Descriptor, PythonSource, RuntimeNode

        self.entries: list[tuple[Path, str, str, float]] = []
        base = Path(working_dir or Path(dataflow_path).parent)
        for node in Descriptor.read(dataflow_path).nodes:
            if not isinstance(node.kind, RuntimeNode):
                continue
            for op in node.kind.operators:
                if isinstance(op.source, PythonSource):
                    path = Path(op.source.source)
                    if not path.is_absolute():
                        path = base / path
                    if path.exists():
                        self.entries.append((path, str(node.id), str(op.id),
                                             path.stat().st_mtime))

    def changed(self) -> list[tuple[str, str]]:
        """(node id, operator id) of each file modified since the last call."""
        out = []
        for i, (path, node_id, op_id, mtime) in enumerate(self.entries):
            try:
                now = path.stat().st_mtime
            except OSError:
                continue
            if now > mtime:
                self.entries[i] = (path, node_id, op_id, now)
                out.append((node_id, op_id))
        return out


def _start_log_stream(args, uuid: str):
    """LogSubscribe on a second connection; prints the pushed lines."""
    import threading

    from dora_tpu_torch.cli.control import ControlConnection

    try:
        conn = ControlConnection(getattr(args, "coordinator_addr", None), timeout=None)
    except OSError:
        return None
    conn.send_only(cm.LogSubscribe(dataflow_id=uuid, level="info"))

    def pump():
        try:
            for msg in conn.stream():
                print(f"  [{getattr(msg, 'node_id', None) or ''}] "
                      f"{getattr(msg, 'message', msg)}", flush=True)
        except Exception:
            pass

    threading.Thread(target=pump, daemon=True).start()
    return conn.close


def cmd_stop(args) -> int:
    with _control(args) as c:
        if args.name:
            reply = c.request(cm.StopByName(name=args.name, grace_duration_s=args.grace_duration))
        elif args.uuid:
            reply = c.request(cm.StopRequest(dataflow_uuid=args.uuid,
                                             grace_duration_s=args.grace_duration))
        else:
            listed = c.request(cm.ListDataflows()).dataflows
            if len(listed) != 1:
                print(f"{len(listed)} dataflows running; pass --uuid or --name", file=sys.stderr)
                return 1
            reply = c.request(cm.StopRequest(dataflow_uuid=listed[0].uuid,
                                             grace_duration_s=args.grace_duration))
        return _print_result(reply.result)


def cmd_list(args) -> int:
    with _control(args) as c:
        for entry in c.request(cm.ListDataflows()).dataflows:
            print(f"{entry.uuid}  {entry.name or ''}")
    return 0


def _query(c, request):
    """One control request; an ``Error`` reply goes to stderr and gives None."""
    try:
        return c.request(request)
    except RuntimeError as e:
        print(e, file=sys.stderr)
        return None


def _refresh(text: str) -> None:
    print("\x1b[2J\x1b[H" + text, end="", flush=True)


def cmd_metrics(args) -> int:
    """A dataflow's merged metrics (per-link counters, latency percentiles,
    serving, fleet, SLO and alert blocks) as a table; ``--watch`` refreshes
    it with rates from the daemons' history rings (from two snapshots over
    the measured interval where the history is off); ``--json`` prints the
    snapshot."""
    import json

    from dora_tpu_torch.cli.metrics_view import render_metrics

    with _control(args) as c:
        prev = None
        history: list[dict] = []
        last_at: float | None = None
        while True:
            reply = _query(c, cm.QueryMetrics(dataflow_uuid=args.uuid, name=args.name))
            now = time.monotonic()
            if reply is None:
                return 1
            if args.json:
                print(json.dumps(reply.metrics, indent=2, sort_keys=True))
                return 0
            rates = None
            if args.watch:
                hist = _query(c, cm.QueryMetricsHistory(dataflow_uuid=args.uuid, name=args.name))
                if hist is not None and hist.history.get("samples"):
                    rates = hist.history.get("rates")
            elapsed = now - last_at if last_at is not None else None
            text = render_metrics(
                reply.dataflow_uuid, reply.metrics, prev=prev,
                interval=(elapsed if elapsed is not None else args.interval) if args.watch
                else None,
                history=history if args.watch else None, rates=rates)
            if not args.watch:
                print(text, end="")
                return 0
            _refresh(text)
            prev = reply.metrics
            history.append(reply.metrics)
            del history[:-48]  # the sparklines' window
            last_at = now
            time.sleep(args.interval)


def cmd_top(args) -> int:
    """The cluster dashboard: nodes, queues, serving, recovery, pages, SLO
    burn, fleet and alerts, with rates and sparklines from the history ring;
    ``--json`` prints the merged history with the fleet block."""
    import json

    from dora_tpu_torch.cli.top_view import render_top

    with _control(args) as c:
        while True:
            reply = _query(c, cm.QueryMetrics(dataflow_uuid=args.uuid, name=args.name))
            if reply is None:
                return 1
            hist = _query(c, cm.QueryMetricsHistory(dataflow_uuid=args.uuid, name=args.name))
            if hist is None:
                return 1
            if args.json:
                payload = dict(hist.history)
                payload["fleet"] = reply.metrics.get("fleet", {})
                print(json.dumps(payload, indent=2, sort_keys=True))
                return 0
            text = render_top(reply.dataflow_uuid, reply.metrics, hist.history)
            if args.once:
                print(text, end="")
                return 0
            _refresh(text)
            time.sleep(args.interval)


def _view(args, request, field_name: str, render) -> int:
    """A merged view as a table, refreshed with ``--watch``, or as JSON."""
    import json

    with _control(args) as c:
        while True:
            reply = _query(c, request)
            if reply is None:
                return 1
            value = getattr(reply, field_name)
            if args.json:
                print(json.dumps(value, indent=2, sort_keys=True))
                return 0
            text = render(reply.dataflow_uuid, value)
            if not args.watch:
                print(text, end="")
                return 0
            _refresh(text)
            time.sleep(args.interval)


def cmd_alerts(args) -> int:
    """The dataflow's alert status: each rule's instances, pending and firing
    first, merged over the machines (archived dataflows too)."""
    from dora_tpu_torch.cli.alerts_view import render_alerts

    return _view(args, cm.QueryAlerts(dataflow_uuid=args.uuid, name=args.name), "alerts",
                 render_alerts)


def cmd_fleet(args) -> int:
    """Every serving replica's latest engine-state digest (prefix cache,
    free-stream capacity, occupancy, config fingerprint), merged over the
    machines."""
    from dora_tpu_torch.cli.fleet_view import render_fleet

    return _view(args, cm.QueryFleet(dataflow_uuid=args.uuid, name=args.name), "fleet",
                 render_fleet)


def cmd_trace(args) -> int:
    """The dataflow's merged, clock-aligned timeline as Chrome trace JSON
    (for Perfetto or chrome://tracing); ``--check`` runs the exporter's
    offline self-check instead."""
    import json

    from dora_tpu_torch.tracing import self_check, to_chrome_trace, validate_chrome_trace

    if args.check:
        problems = self_check()
        for problem in problems:
            print(problem, file=sys.stderr)
        if problems:
            return 1
        print("trace export schema: OK")
        return 0
    with _control(args) as c:
        reply = _query(c, cm.QueryTrace(dataflow_uuid=args.uuid, name=args.name))
    if reply is None:
        return 1
    trace = to_chrome_trace(reply.trace)
    for problem in validate_chrome_trace(trace):
        print(f"warning: {problem}", file=sys.stderr)
    text = json.dumps(trace)
    if args.out:
        Path(args.out).write_text(text)
        print(f"wrote {args.out} ({len(trace['traceEvents'])} events) — load in Perfetto "
              "(ui.perfetto.dev) or chrome://tracing")
    else:
        print(text)
    return 0


def cmd_profile(args) -> int:
    """A device profile capture (``torch.profiler``) on a serving node for
    ``--seconds``, or ``--stop`` the one running; prints the artifact: the
    capture's directory, or a JSON marker that says why there is none."""
    with _control(args) as c:
        if args.stop:
            request = cm.StopProfile(dataflow_uuid=args.uuid, node_id=args.node, name=args.name)
        else:
            request = cm.StartProfile(dataflow_uuid=args.uuid, node_id=args.node,
                                      seconds=args.seconds, name=args.name)
        reply = _query(c, request)
    if reply is None:
        return 1
    if reply.error:
        print(f"profile on {reply.node_id} of {reply.uuid} failed: {reply.error}",
              file=sys.stderr)
        return 1
    print(reply.artifact)
    return 0


def cmd_migrate(args) -> int:
    """Drain a serving node's live streams into a handoff directory, which
    another engine watching it (``DORA_MIGRATE_DIR``) admits and continues."""
    handoff_dir = str(Path(args.handoff_dir).resolve())
    with _control(args) as c:
        try:
            reply = c.request(cm.MigrateNode(dataflow_uuid=args.uuid, node_id=args.node,
                                             handoff_dir=handoff_dir, name=args.name))
        except RuntimeError as e:
            print(e, file=sys.stderr)
            return 1
    print(f"migrating {reply.node_id} of {reply.uuid}: streams drain into {reply.handoff_dir}")
    return 0


def cmd_logs(args) -> int:
    from dora_tpu_torch.message.common import log_level_at_least, parse_level_prefix

    with _control(args) as c:
        reply = c.request(cm.Logs(uuid=args.uuid, name=args.name, node=args.node))
    text = reply.logs.decode(errors="replace")
    if args.level:
        text = "".join(line + "\n" for line in text.splitlines()
                       if log_level_at_least(parse_level_prefix(line) or "info", args.level))
    sys.stdout.write(text)
    return 0


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m dora_tpu_torch.cli",
        description="run dataflows on the port: on this machine, or on a cluster of a "
                    "coordinator and its daemons")
    sub = parser.add_subparsers(dest="command", required=True)

    def coordinator_addr(p):
        p.add_argument("--coordinator-addr", default=None,
                       help=f"control address (default "
                            f"127.0.0.1:{DORA_COORDINATOR_PORT_CONTROL_DEFAULT})")

    def local_comm(p):
        p.add_argument("--local-comm", default=None, choices=["tcp", "uds", "shmem"],
                       help="node channel transport; default: the YAML's "
                            "communication.local, else tcp")

    p = sub.add_parser("check", help="validate a dataflow YAML and lint its alert rules")
    p.add_argument("dataflow")
    p.add_argument("--json", action="store_true", help="the findings as JSON")
    p.set_defaults(fn=cmd_check)

    p = sub.add_parser("build", help="run the build: commands of a dataflow's nodes and "
                                     "operators")
    p.add_argument("dataflow")
    p.set_defaults(fn=cmd_build)

    p = sub.add_parser("run", help="run one dataflow to completion on this machine")
    p.add_argument("dataflow")
    local_comm(p)
    p.add_argument("--stop-after", type=float, default=None, metavar="SECONDS",
                   help="send STOP this long after every node started (a dataflow with "
                        "timers runs until stopped)")
    p.add_argument("--timeout", type=float, default=None, metavar="SECONDS",
                   help="give up after this long (default: wait for the end)")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("up", help="start a coordinator and a daemon on this machine")
    coordinator_addr(p)
    p.add_argument("--machine-id", default="", help="the daemon's machine id (default: none)")
    p.set_defaults(fn=cmd_up)

    p = sub.add_parser("destroy", help="stop every dataflow, the daemons and the coordinator")
    coordinator_addr(p)
    p.set_defaults(fn=cmd_destroy)

    p = sub.add_parser("start", help="start a dataflow on the cluster")
    p.add_argument("dataflow")
    p.add_argument("--name", default=None)
    p.add_argument("--attach", action="store_true",
                   help="wait for the end, printing the nodes' log lines")
    p.add_argument("--hot-reload", action="store_true",
                   help="with --attach: reload a Python operator whose file changed")
    coordinator_addr(p)
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("stop", help="stop a running dataflow")
    p.add_argument("--uuid", default=None)
    p.add_argument("--name", default=None)
    p.add_argument("--grace-duration", type=float, default=None)
    coordinator_addr(p)
    p.set_defaults(fn=cmd_stop)

    p = sub.add_parser("list", help="list running dataflows")
    coordinator_addr(p)
    p.set_defaults(fn=cmd_list)

    def target(p):
        p.add_argument("--uuid", default=None)
        p.add_argument("--name", default=None)

    def refresh(p, watch: str | None = "--watch"):
        if watch:
            p.add_argument(watch, action="store_true", help="refresh top-style")
        p.add_argument("--interval", type=float, default=2.0, help="refresh seconds")

    p = sub.add_parser("metrics", help="show a dataflow's routing, latency and serving metrics")
    target(p)
    refresh(p)
    p.add_argument("--json", action="store_true", help="print the raw merged snapshot")
    coordinator_addr(p)
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser("top", help="live cluster dashboard (rates and sparklines from the "
                                   "history ring)")
    target(p)
    refresh(p, watch=None)
    p.add_argument("--once", action="store_true", help="render one frame and exit")
    p.add_argument("--json", action="store_true",
                   help="print the raw merged history instead of the dashboard")
    coordinator_addr(p)
    p.set_defaults(fn=cmd_top)

    p = sub.add_parser("alerts", help="show a dataflow's alert status (pending / firing per "
                                      "rule)")
    target(p)
    refresh(p)
    p.add_argument("--json", action="store_true", help="print the raw merged status")
    coordinator_addr(p)
    p.set_defaults(fn=cmd_alerts)

    p = sub.add_parser("fleet", help="show every serving replica's engine-state digest")
    target(p)
    refresh(p)
    p.add_argument("--json", action="store_true", help="print the raw merged view")
    coordinator_addr(p)
    p.set_defaults(fn=cmd_fleet)

    p = sub.add_parser("trace", help="export a dataflow's message timeline (Chrome trace / "
                                     "Perfetto)")
    target(p)
    p.add_argument("--out", default=None, help="write the JSON here (default: stdout)")
    p.add_argument("--check", action="store_true",
                   help="offline schema self-check of the trace exporter (no cluster)")
    coordinator_addr(p)
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser("profile", help="capture a device profile on a serving node")
    p.add_argument("node", help="node id of the serving engine to profile")
    p.add_argument("--seconds", type=float, default=5.0,
                   help="capture duration before the node stops and reports (default 5)")
    p.add_argument("--stop", action="store_true",
                   help="stop an in-flight capture early and fetch its artifact")
    target(p)
    coordinator_addr(p)
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("migrate", help="drain a serving node's live streams into a handoff dir")
    p.add_argument("node", help="node id of the serving engine to drain")
    p.add_argument("--handoff-dir", required=True,
                   help="directory the target engine polls (its DORA_MIGRATE_DIR)")
    p.add_argument("--uuid", default=None)
    p.add_argument("--name", default=None)
    coordinator_addr(p)
    p.set_defaults(fn=cmd_migrate)

    p = sub.add_parser("logs", help="print a node's logs")
    p.add_argument("node")
    p.add_argument("--uuid", default=None)
    p.add_argument("--name", default=None)
    p.add_argument("--level", default=None, choices=["trace", "debug", "info", "warn", "error"],
                   help="only lines at or above this level (level prefix parsed)")
    coordinator_addr(p)
    p.set_defaults(fn=cmd_logs)

    p = sub.add_parser("coordinator", help="run the coordinator")
    p.add_argument("--port", type=int, default=DORA_COORDINATOR_PORT_DEFAULT)
    p.add_argument("--control-port", type=int, default=DORA_COORDINATOR_PORT_CONTROL_DEFAULT)
    p.add_argument("--quiet", action="store_true")
    p.set_defaults(fn=cmd_coordinator)

    p = sub.add_parser("daemon", help="run a daemon attached to a coordinator, or one "
                                      "dataflow standalone")
    p.add_argument("--coordinator-addr", default=f"127.0.0.1:{DORA_COORDINATOR_PORT_DEFAULT}",
                   help="the coordinator's daemon-register address")
    p.add_argument("--machine-id", default="")
    p.add_argument("--run-dataflow", default=None, metavar="DATAFLOW_YAML",
                   help="standalone mode: run one dataflow on this machine and exit")
    local_comm(p)
    p.set_defaults(fn=cmd_daemon)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except KeyboardInterrupt:
        return 130
