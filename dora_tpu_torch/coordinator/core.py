"""The coordinator (dora_tpu/coordinator/core.py).

Two listeners: daemons register on one (``daemon_port``), the CLI sends its
control requests on the other (``control_port``). A heartbeat goes to every
daemon each 3 s; a daemon silent for 15 s is warned of, for 30 s dropped.

Not here: the metrics history, alert, trace and profile planes and the
Prometheus scrape (``DORA_PROM_PORT``) with its OTLP push
(``init_cluster_metrics_export``). Their control requests
(``QueryMetricsHistory``, ``QueryAlerts``, ``QueryTrace``,
``StartProfile`` / ``StopProfile``) are answered at once with ``Error``,
whose message names the missing plane (``cm.MISSING_PLANES``).
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Any

from dora_tpu_torch import PROTOCOL_VERSION
from dora_tpu_torch.clock import HLC
from dora_tpu_torch.core.descriptor import CustomNode, Descriptor, new_dataflow_uuid
from dora_tpu_torch.fleet import merge_fleet_snapshots
from dora_tpu_torch.message import coordinator as cm
from dora_tpu_torch.message.common import (
    DataflowResult,
    LogMessage,
    NodeResult,
    log_level_at_least,
)
from dora_tpu_torch.message.serde import decode_timestamped, encode_timestamped
from dora_tpu_torch.metrics import merge_snapshots
from dora_tpu_torch.transport.framing import (
    ConnectionClosed,
    recv_frame_async,
    send_frame_async,
)

logger = logging.getLogger(__name__)

HEARTBEAT_INTERVAL_S = 3.0
HEARTBEAT_WARN_S = 15.0
HEARTBEAT_DROP_S = 30.0
#: how long close() waits for the listeners' connections to end
CLOSE_WAIT_S = 5.0


@dataclass
class DaemonHandle:
    machine_id: str
    outbox: asyncio.Queue
    listen_addr: str  # inter-daemon data address "host:port"
    last_heartbeat: float = field(default_factory=time.monotonic)
    connected: bool = True
    #: the register connection's StreamWriter (tests force-drop it to
    #: exercise the daemon's reconnect path)
    writer: Any = None


@dataclass
class RunningDataflow:
    uuid: str
    name: str | None
    descriptor: Descriptor
    machines: set[str]
    pending_machines: set[str]  # not yet ReadyOnMachine
    exited_before_subscribe: list[str] = field(default_factory=list)
    finished_machines: set[str] = field(default_factory=set)
    node_results: dict[str, NodeResult] = field(default_factory=dict)
    #: futures resolved with the final DataflowResult (CLI stop/attach waits)
    finish_waiters: list[asyncio.Future] = field(default_factory=list)
    spawn_errors: list[str] = field(default_factory=list)


@dataclass
class LogSubscriber:
    dataflow_id: str
    level: str
    writer: asyncio.StreamWriter


class Coordinator:
    """One coordinator per cluster."""

    def __init__(self):
        self.clock = HLC()
        self.daemons: dict[str, DaemonHandle] = {}
        self.running: dict[str, RunningDataflow] = {}
        self.archived: dict[str, tuple[RunningDataflow, DataflowResult]] = {}
        self.log_subscribers: list[LogSubscriber] = []
        self._daemon_server: asyncio.AbstractServer | None = None
        self._control_server: asyncio.AbstractServer | None = None
        self.daemon_port: int | None = None
        self.control_port: int | None = None
        self._heartbeat_task: asyncio.Task | None = None
        self._destroyed = asyncio.Event()
        #: correlation for log-file requests: (dataflow_id, node_id) -> future
        self._log_waiters: dict[tuple[str, str], asyncio.Future] = {}
        #: correlation for metrics and fleet requests: (dataflow_id, machine)
        #: -> future
        self._metrics_waiters: dict[tuple[str, str], asyncio.Future] = {}
        self._fleet_waiters: dict[tuple[str, str], asyncio.Future] = {}

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def start(self, daemon_port: int = 0, control_port: int = 0) -> None:
        self._daemon_server = await asyncio.start_server(
            self._handle_daemon, host="0.0.0.0", port=daemon_port
        )
        self.daemon_port = self._daemon_server.sockets[0].getsockname()[1]
        self._control_server = await asyncio.start_server(
            self._handle_control, host="0.0.0.0", port=control_port
        )
        self.control_port = self._control_server.sockets[0].getsockname()[1]
        self._heartbeat_task = asyncio.create_task(self._heartbeat_loop())

    async def close(self) -> None:
        if self._heartbeat_task is not None:
            self._heartbeat_task.cancel()
        # the servers' wait_closed waits for every connection: close the ones
        # this side keeps open (log streams nobody reads, daemons)
        writers = [sub.writer for sub in self.log_subscribers]
        writers += [h.writer for h in self.daemons.values() if h.writer is not None]
        self.log_subscribers.clear()
        for writer in writers:
            try:
                writer.close()
            except Exception:
                pass
        for server in (self._daemon_server, self._control_server):
            if server is not None:
                server.close()
                try:
                    await asyncio.wait_for(server.wait_closed(), CLOSE_WAIT_S)
                except Exception:
                    pass

    async def wait_destroyed(self) -> None:
        await self._destroyed.wait()

    # ------------------------------------------------------------------
    # daemon connections (register port)
    # ------------------------------------------------------------------

    async def _handle_daemon(self, reader, writer) -> None:
        machine_id: str | None = None
        handle: DaemonHandle | None = None
        try:
            frame = await recv_frame_async(reader)
            msg = decode_timestamped(frame, self.clock).inner
            if not isinstance(msg, cm.RegisterDaemon):
                await self._send(writer, cm.RegisterDaemonReply(error="expected RegisterDaemon"))
                return
            error = None
            ours = PROTOCOL_VERSION.split(".")[:2]
            if msg.protocol_version.split(".")[:2] != ours:
                error = (
                    f"incompatible protocol {msg.protocol_version} "
                    f"(coordinator speaks {PROTOCOL_VERSION})"
                )
            elif msg.machine_id in self.daemons and self.daemons[msg.machine_id].connected:
                # Re-register replaces the existing (likely half-open)
                # connection: a daemon only reconnects after losing its
                # side, and the heartbeat watchdog may not have noticed
                # yet. Last registration wins.
                logger.warning(
                    "machine %r re-registered; replacing stale connection",
                    msg.machine_id,
                )
                stale = self.daemons[msg.machine_id]
                stale.connected = False
                if stale.writer is not None:
                    try:
                        stale.writer.close()
                    except Exception:
                        pass
            await self._send(writer, cm.RegisterDaemonReply(error=error))
            if error:
                return
            machine_id = msg.machine_id
            peer_host = writer.get_extra_info("peername")[0]
            handle = DaemonHandle(
                machine_id=machine_id,
                outbox=asyncio.Queue(),
                listen_addr=f"{peer_host}:{msg.listen_port}",
                writer=writer,
            )
            self.daemons[machine_id] = handle
            logger.info("daemon %r registered (data %s)", machine_id, handle.listen_addr)
            sender = asyncio.create_task(self._daemon_sender(handle, writer))
            try:
                while True:
                    frame = await recv_frame_async(reader)
                    event = decode_timestamped(frame, self.clock).inner
                    self._handle_daemon_event(handle, event)
            finally:
                sender.cancel()
        except (ConnectionClosed, ConnectionError):
            pass
        except Exception:
            logger.exception("daemon connection failed")
        finally:
            # Identity check: if the daemon already re-registered, the
            # machine id maps to a FRESH handle — marking disconnected by
            # id alone would clobber the live re-registration.
            if handle is not None and self.daemons.get(machine_id) is handle:
                handle.connected = False
            try:
                writer.close()
            except Exception:
                pass

    async def _daemon_sender(self, handle: DaemonHandle, writer) -> None:
        try:
            while True:
                msg = await handle.outbox.get()
                await self._send(writer, msg)
        except (asyncio.CancelledError, ConnectionError, ConnectionClosed):
            pass

    async def _send(self, writer, msg: Any) -> None:
        await send_frame_async(writer, encode_timestamped(msg, self.clock))

    def _daemon_send(self, machine_id: str, msg: Any) -> None:
        handle = self.daemons.get(machine_id)
        if handle is not None and handle.connected:
            handle.outbox.put_nowait(msg)

    def _handle_daemon_event(self, handle: DaemonHandle, event: Any) -> None:
        handle.last_heartbeat = time.monotonic()
        if isinstance(event, cm.DaemonHeartbeat):
            return
        if isinstance(event, cm.ReadyOnMachine):
            self._machine_ready(handle.machine_id, event)
        elif isinstance(event, cm.AllNodesFinished):
            self._machine_finished(handle.machine_id, event)
        elif isinstance(event, cm.SpawnDataflowResult):
            df = self.running.get(event.dataflow_id)
            if df is not None and event.error:
                df.spawn_errors.append(f"{handle.machine_id}: {event.error}")
        elif isinstance(event, cm.DaemonLog):
            self._publish_log(event.log)
        elif isinstance(event, cm.LogsReplyFromDaemon):
            self.deliver_logs_reply(event.dataflow_id, event.node_id, event.logs)
        elif isinstance(event, cm.MetricsReplyFromDaemon):
            fut = self._metrics_waiters.get((event.dataflow_id, event.machine_id))
            if fut is not None and not fut.done():
                fut.set_result(event.metrics)
        elif isinstance(event, cm.FleetReplyFromDaemon):
            fut = self._fleet_waiters.get(
                (event.dataflow_id, event.machine_id)
            )
            if fut is not None and not fut.done():
                fut.set_result(event.fleet)
        elif isinstance(event, (cm.TraceReplyFromDaemon, cm.MetricsHistoryReplyFromDaemon,
                                cm.AlertsReplyFromDaemon, cm.ProfileReplyFromDaemon)):
            pass  # never asked for: the port has none of these planes
        else:
            logger.warning("unexpected daemon event %s", type(event).__name__)

    # ------------------------------------------------------------------
    # dataflow lifecycle
    # ------------------------------------------------------------------

    def _machine_ready(self, machine_id: str, event: cm.ReadyOnMachine) -> None:
        df = self.running.get(event.dataflow_id)
        if df is None:
            return
        df.pending_machines.discard(machine_id)
        df.exited_before_subscribe.extend(event.exited_before_subscribe)
        if not df.pending_machines:
            for machine in df.machines:
                self._daemon_send(
                    machine,
                    cm.AllNodesReady(
                        dataflow_id=df.uuid,
                        exited_before_subscribe=df.exited_before_subscribe,
                    ),
                )

    def _machine_finished(self, machine_id: str, event: cm.AllNodesFinished) -> None:
        df = self.running.get(event.dataflow_id)
        if df is None:
            return
        df.finished_machines.add(machine_id)
        df.node_results.update(event.result.node_results)
        if df.finished_machines >= df.machines:
            result = DataflowResult(uuid=df.uuid, node_results=df.node_results)
            del self.running[df.uuid]
            self.archived[df.uuid] = (df, result)
            for fut in df.finish_waiters:
                if not fut.done():
                    fut.set_result(result)
            df.finish_waiters.clear()

    async def start_dataflow(
        self,
        raw_descriptor: dict,
        name: str | None,
        local_working_dir: str | None,
    ) -> str:
        """Validate, split the nodes by ``deploy.machine`` and hand each
        daemon its part with every machine's inter-daemon address."""
        descriptor = Descriptor.parse(raw_descriptor)
        descriptor.check(local_working_dir)
        if name is not None:
            for df in self.running.values():
                if df.name == name:
                    raise ValueError(f"a dataflow named {name!r} is already running")

        machines = {n.deploy.machine or "" for n in descriptor.nodes}
        default_machine = ""
        if "" in machines and "" not in self.daemons:
            # Single registered daemon serves machine-less nodes.
            connected = [m for m, h in self.daemons.items() if h.connected]
            if len(connected) == 1:
                default_machine = connected[0]
                machines = {default_machine if m == "" else m for m in machines}
            else:
                raise ValueError(
                    "dataflow has nodes without deploy.machine but "
                    f"{len(connected)} daemons are connected"
                )
        missing = [m for m in machines if m not in self.daemons or not self.daemons[m].connected]
        if missing:
            raise ValueError(f"no daemon connected for machine(s) {missing}")

        uuid = new_dataflow_uuid()
        df = RunningDataflow(
            uuid=uuid,
            name=name,
            descriptor=descriptor,
            machines=set(machines),
            pending_machines=set(machines),
        )
        self.running[uuid] = df

        listen_ports = {
            m: self.daemons[m].listen_addr for m in machines
        }
        for machine in machines:
            local_nodes = [
                str(n.id)
                for n in descriptor.nodes
                if (n.deploy.machine or default_machine) == machine
            ]
            spawn_nodes = [
                nid
                for nid in local_nodes
                if not _is_dynamic(descriptor, nid)
            ]
            self._daemon_send(
                machine,
                cm.SpawnDataflowNodes(
                    dataflow_id=uuid,
                    working_dir=local_working_dir or ".",
                    nodes=local_nodes,
                    dataflow_descriptor=dict(raw_descriptor),
                    spawn_nodes=spawn_nodes,
                    machine_listen_ports=listen_ports,
                ),
            )
        return uuid

    def stop_dataflow(self, uuid: str, grace_s: float | None) -> asyncio.Future:
        """Send StopDataflow to every involved daemon; the returned future
        resolves with the final DataflowResult."""
        df = self.running.get(uuid)
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        if df is None:
            if uuid in self.archived:
                fut.set_result(self.archived[uuid][1])
            else:
                fut.set_exception(KeyError(f"no running dataflow {uuid!r}"))
            return fut
        df.finish_waiters.append(fut)
        for machine in df.machines:
            self._daemon_send(
                machine, cm.StopDataflow(dataflow_id=uuid, grace_duration_s=grace_s)
            )
        return fut

    def _query_target(self, dataflow_uuid: str | None, name: str | None):
        """Shared target resolution for QueryMetrics/QueryTrace: explicit
        uuid/name wins; otherwise the single running dataflow, else the
        single archived one. Returns a uuid or a ready-to-send Error."""
        target = dataflow_uuid or name
        if target is not None:
            return self.resolve_name(target)
        if len(self.running) == 1:
            return next(iter(self.running))
        if self.running:
            return cm.Error(
                message="multiple dataflows running; pass --uuid or --name"
            )
        if len(self.archived) == 1:
            return next(iter(self.archived))
        return cm.Error(message="no dataflow running")

    def resolve_name(self, name_or_uuid: str) -> str:
        """uuid | unique name -> uuid."""
        if name_or_uuid in self.running or name_or_uuid in self.archived:
            return name_or_uuid
        matches = [u for u, df in self.running.items() if df.name == name_or_uuid]
        if len(matches) == 1:
            return matches[0]
        if len(matches) > 1:
            raise KeyError(f"multiple running dataflows named {name_or_uuid!r}")
        # Finished dataflows stay addressable by name: logs and metrics
        # are explicitly queryable after completion (most recent wins —
        # archived insertion order is completion order).
        archived = [
            u for u, (df, _) in self.archived.items() if df.name == name_or_uuid
        ]
        if archived:
            return archived[-1]
        raise KeyError(f"no dataflow named {name_or_uuid!r}")

    async def request_logs(self, uuid: str, node_id: str) -> bytes:
        df = self.running.get(uuid)
        if df is None and uuid in self.archived:
            df = self.archived[uuid][0]
        if df is None:
            raise KeyError(f"unknown dataflow {uuid!r}")
        node = df.descriptor.node(node_id)
        machine = node.deploy.machine or next(iter(df.machines))
        fut = asyncio.get_running_loop().create_future()
        self._log_waiters[(uuid, node_id)] = fut
        self._daemon_send(machine, cm.LogsRequest(dataflow_id=uuid, node_id=node_id))
        try:
            return await asyncio.wait_for(fut, timeout=10)
        finally:
            self._log_waiters.pop((uuid, node_id), None)

    def deliver_logs_reply(self, uuid: str, node_id: str, logs: bytes) -> None:
        fut = self._log_waiters.get((uuid, node_id))
        if fut is not None and not fut.done():
            fut.set_result(logs)

    async def request_metrics(self, uuid: str) -> dict:
        """Fan a MetricsRequest out to every involved daemon and merge the
        per-machine snapshots (``metrics.merge_snapshots``). Works for
        archived dataflows too: daemons keep a finished dataflow's state."""
        df = self.running.get(uuid)
        if df is None and uuid in self.archived:
            df = self.archived[uuid][0]
        if df is None:
            raise KeyError(f"unknown dataflow {uuid!r}")
        loop = asyncio.get_running_loop()
        futs = []
        for machine in sorted(df.machines):
            fut = loop.create_future()
            self._metrics_waiters[(uuid, machine)] = fut
            self._daemon_send(machine, cm.MetricsRequest(dataflow_id=uuid))
            futs.append(fut)
        try:
            snapshots = await asyncio.wait_for(
                asyncio.gather(*futs, return_exceptions=True), timeout=10
            )
        finally:
            for machine in df.machines:
                self._metrics_waiters.pop((uuid, machine), None)
        return merge_snapshots([s for s in snapshots if isinstance(s, dict)])

    async def request_fleet(self, uuid: str) -> dict:
        """Fan a FleetRequest out to every involved daemon and merge
        the per-machine digest snapshots into one clock-aligned fleet
        view (``fleet.merge_fleet_snapshots``). Works for archived
        dataflows too: daemons keep a finished dataflow's state, its last
        digests included."""
        df = self.running.get(uuid)
        if df is None and uuid in self.archived:
            df = self.archived[uuid][0]
        if df is None:
            raise KeyError(f"unknown dataflow {uuid!r}")
        loop = asyncio.get_running_loop()
        futs = []
        for machine in sorted(df.machines):
            fut = loop.create_future()
            self._fleet_waiters[(uuid, machine)] = fut
            self._daemon_send(machine, cm.FleetRequest(dataflow_id=uuid))
            futs.append(fut)
        try:
            snapshots = await asyncio.wait_for(
                asyncio.gather(*futs, return_exceptions=True), timeout=10
            )
        finally:
            for machine in df.machines:
                self._fleet_waiters.pop((uuid, machine), None)
        return merge_fleet_snapshots(
            [s for s in snapshots if isinstance(s, dict)]
        )

    # ------------------------------------------------------------------
    # log streaming
    # ------------------------------------------------------------------

    def _publish_log(self, log: LogMessage) -> None:
        dead = []
        for sub in self.log_subscribers:
            if sub.dataflow_id != log.dataflow_id:
                continue
            if not log_level_at_least(log.level, sub.level):
                continue
            try:
                asyncio.create_task(self._send(sub.writer, log))
            except Exception:
                dead.append(sub)
        for sub in dead:
            self.log_subscribers.remove(sub)

    # ------------------------------------------------------------------
    # heartbeat watchdog
    # ------------------------------------------------------------------

    async def _heartbeat_loop(self) -> None:
        while True:
            await asyncio.sleep(HEARTBEAT_INTERVAL_S)
            now = time.monotonic()
            for machine, handle in list(self.daemons.items()):
                if not handle.connected:
                    continue
                silent = now - handle.last_heartbeat
                if silent > HEARTBEAT_DROP_S:
                    logger.error("daemon %r silent for %.0fs; dropping", machine, silent)
                    handle.connected = False
                    continue
                if silent > HEARTBEAT_WARN_S:
                    logger.warning("daemon %r silent for %.0fs", machine, silent)
                self._daemon_send(machine, cm.Heartbeat())

    # ------------------------------------------------------------------
    # control connections (CLI port)
    # ------------------------------------------------------------------

    async def _handle_control(self, reader, writer) -> None:
        try:
            while True:
                frame = await recv_frame_async(reader)
                request = decode_timestamped(frame, self.clock).inner
                if isinstance(request, cm.LogSubscribe):
                    # the connection becomes a push stream
                    self.log_subscribers.append(
                        LogSubscriber(
                            dataflow_id=request.dataflow_id,
                            level=request.level,
                            writer=writer,
                        )
                    )
                    return  # keep open; never reply
                reply = await self.handle_control_request(request)
                await self._send(writer, reply)
                if isinstance(reply, cm.DestroyOk):
                    return
        except (ConnectionClosed, ConnectionError):
            pass
        except Exception:
            logger.exception("control connection failed")
        finally:
            if not any(s.writer is writer for s in self.log_subscribers):
                try:
                    writer.close()
                except Exception:
                    pass

    async def handle_control_request(self, request: Any) -> Any:
        """The in-process control seam: the control listener's, and tests'."""
        try:
            return await self._control_request_inner(request)
        except Exception as e:
            return cm.Error(message=str(e))

    async def _control_request_inner(self, request: Any) -> Any:
        if isinstance(request, cm.Start):
            uuid = await self.start_dataflow(
                request.dataflow, request.name, request.local_working_dir
            )
            return cm.DataflowStarted(uuid=uuid)
        if isinstance(request, cm.Check):
            df = self.running.get(request.dataflow_uuid)
            if df is not None:
                if df.spawn_errors:
                    return cm.Error(message="; ".join(df.spawn_errors))
                return cm.DataflowSpawnResult(uuid=df.uuid)
            if request.dataflow_uuid in self.archived:
                result = self.archived[request.dataflow_uuid][1]
                return cm.DataflowStopped(uuid=result.uuid, result=result)
            return cm.Error(message=f"unknown dataflow {request.dataflow_uuid!r}")
        if isinstance(request, (cm.StopRequest, cm.StopByName)):
            if isinstance(request, cm.StopByName):
                uuid = self.resolve_name(request.name)
            else:
                uuid = request.dataflow_uuid
            result = await self.stop_dataflow(uuid, request.grace_duration_s)
            return cm.DataflowStopped(uuid=uuid, result=result)
        if isinstance(request, cm.ReloadRequest):
            df = self.running.get(request.dataflow_id)
            if df is None:
                return cm.Error(message=f"unknown dataflow {request.dataflow_id!r}")
            node = df.descriptor.node(request.node_id)
            machine = node.deploy.machine or next(iter(df.machines))
            self._daemon_send(
                machine,
                cm.ReloadDataflow(
                    dataflow_id=df.uuid,
                    node_id=request.node_id,
                    operator_id=request.operator_id,
                ),
            )
            return cm.DataflowReloaded(uuid=df.uuid)
        if isinstance(request, cm.MigrateNode):
            target = request.dataflow_uuid or request.name
            if target is not None:
                uuid = self.resolve_name(target)
            else:
                uuid = self._query_target(None, None)
                if isinstance(uuid, cm.Error):
                    return uuid
            df = self.running.get(uuid)
            if df is None:
                return cm.Error(message=f"dataflow {uuid!r} is not running")
            node = df.descriptor.node(request.node_id)
            machine = node.deploy.machine or next(iter(df.machines))
            self._daemon_send(
                machine,
                cm.MigrateDataflowNode(
                    dataflow_id=df.uuid,
                    node_id=request.node_id,
                    handoff_dir=request.handoff_dir,
                ),
            )
            return cm.NodeMigrated(
                uuid=df.uuid,
                node_id=request.node_id,
                handoff_dir=request.handoff_dir,
            )
        missing = _MISSING_PLANE_OF.get(type(request))
        if missing is not None:
            return cm.Error(message=cm.MISSING_PLANES[missing])
        if isinstance(request, cm.Logs):
            uuid = self.resolve_name(request.uuid or request.name)
            logs = await self.request_logs(uuid, request.node)
            return cm.LogsReply(logs=logs)
        if isinstance(request, cm.QueryMetrics):
            uuid = self._query_target(request.dataflow_uuid, request.name)
            if isinstance(uuid, cm.Error):
                return uuid
            metrics = await self.request_metrics(uuid)
            return cm.MetricsReply(dataflow_uuid=uuid, metrics=metrics)
        if isinstance(request, cm.QueryFleet):
            uuid = self._query_target(request.dataflow_uuid, request.name)
            if isinstance(uuid, cm.Error):
                return uuid
            fleet = await self.request_fleet(uuid)
            return cm.FleetReply(dataflow_uuid=uuid, fleet=fleet)
        if isinstance(request, cm.ListDataflows):
            entries = [
                cm.DataflowListEntry(uuid=u, name=df.name)
                for u, df in self.running.items()
            ]
            return cm.DataflowList(dataflows=entries)
        if isinstance(request, cm.DaemonConnected):
            return cm.DaemonConnectedReply(
                connected=any(h.connected for h in self.daemons.values())
            )
        if isinstance(request, cm.ConnectedMachines):
            return cm.ConnectedMachinesReply(
                machines=sorted(m for m, h in self.daemons.items() if h.connected)
            )
        if isinstance(request, cm.Destroy):
            for uuid in list(self.running):
                try:
                    await self.stop_dataflow(uuid, None)
                except Exception:
                    pass
            for machine in list(self.daemons):
                self._daemon_send(machine, cm.DestroyDaemon())
            self._destroyed.set()
            return cm.DestroyOk()
        return cm.Error(message=f"unknown control request {type(request).__name__}")


#: the control requests of the planes the port does not have
_MISSING_PLANE_OF = {
    cm.QueryTrace: "trace",
    cm.QueryMetricsHistory: "history",
    cm.QueryAlerts: "alerts",
    cm.StartProfile: "profile",
    cm.StopProfile: "profile",
}


def _is_dynamic(descriptor: Descriptor, node_id: str) -> bool:
    node = descriptor.node(node_id)
    return isinstance(node.kind, CustomNode) and node.kind.is_dynamic
