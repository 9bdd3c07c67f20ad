"""The coordinator (dora_tpu/coordinator/core.py).

Two listeners: daemons register on one (``daemon_port``), the CLI sends its
control requests on the other (``control_port``). A heartbeat goes to every
daemon each 3 s; a daemon silent for 15 s is warned of, for 30 s dropped.

The per-dataflow queries (metrics, the metrics history, alerts, fleet
digests, the trace) fan out to every machine of the dataflow and merge the
parts; a profile request goes to the node's machine and waits for the
node's capture. With ``DORA_PROM_PORT`` set (0: a free port, ``prom_port``)
the coordinator serves every dataflow's merged metrics at ``GET /metrics``
in the Prometheus text format (``prom.py``). Not here: the JAX package's
OTLP push (``init_cluster_metrics_export``).
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any

from dora_tpu_torch import PROTOCOL_VERSION
from dora_tpu_torch.clock import HLC
from dora_tpu_torch.core.descriptor import CustomNode, Descriptor, new_dataflow_uuid
from dora_tpu_torch.fleet import merge_fleet_snapshots
from dora_tpu_torch.message import coordinator as cm
from dora_tpu_torch.alerts import merge_alert_status
from dora_tpu_torch.message.common import (
    DataflowResult,
    LogMessage,
    NodeResult,
    log_level_at_least,
)
from dora_tpu_torch.message.serde import decode_timestamped, encode_timestamped
from dora_tpu_torch.metrics import merge_snapshots
from dora_tpu_torch.metrics_history import merge_history_snapshots
from dora_tpu_torch.tracing import merge_trace_snapshots
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
#: how long a query waits for every machine's part
QUERY_WAIT_S = 10.0
#: how long the scrape waits for one dataflow's metrics (an archived one's
#: daemons may be gone)
SCRAPE_WAIT_S = 3.0
#: a profile start waits for the capture's seconds and this, as JAX's
#: does (the node's report cadence and its capture thread's stop and
#: export); a stop this
PROFILE_REPLY_S = 15.0
PROFILE_STOP_S = 10.0

#: the per-dataflow queries: request class, the reply class from a daemon
#: and its payload field, and the merge of the machines' parts
_QUERIES = {
    "metrics": (cm.MetricsRequest, cm.MetricsReplyFromDaemon, "metrics", merge_snapshots),
    "history": (cm.MetricsHistoryRequest, cm.MetricsHistoryReplyFromDaemon, "history",
                merge_history_snapshots),
    "alerts": (cm.AlertsRequest, cm.AlertsReplyFromDaemon, "alerts",
               lambda parts: merge_alert_status([p for p in parts if p])),
    "fleet": (cm.FleetRequest, cm.FleetReplyFromDaemon, "fleet", merge_fleet_snapshots),
    "trace": (cm.TraceRequest, cm.TraceReplyFromDaemon, "trace", merge_trace_snapshots),
}
_QUERY_OF_REPLY = {reply: (plane, field_name)
                   for plane, (_req, reply, field_name, _merge) in _QUERIES.items()}


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
        #: correlation for the per-dataflow queries: plane ->
        #: (dataflow_id, machine) -> future
        self._query_waiters: dict[str, dict[tuple[str, str], asyncio.Future]] = {
            plane: {} for plane in _QUERIES}
        #: correlation for profile captures: (dataflow_id, node_id) -> future
        #: of (artifact, error)
        self._profile_waiters: dict[tuple[str, str], asyncio.Future] = {}
        #: the Prometheus endpoint (DORA_PROM_PORT)
        self._prom_server: asyncio.AbstractServer | None = None
        self.prom_port: int | None = None

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
        prom_port = os.environ.get("DORA_PROM_PORT", "")
        if prom_port != "":
            self._prom_server = await asyncio.start_server(
                self._handle_prom_scrape, host="0.0.0.0", port=int(prom_port))
            self.prom_port = self._prom_server.sockets[0].getsockname()[1]

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
        for server in (self._daemon_server, self._control_server, self._prom_server):
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
        elif type(event) in _QUERY_OF_REPLY:
            plane, field_name = _QUERY_OF_REPLY[type(event)]
            fut = self._query_waiters[plane].get((event.dataflow_id, event.machine_id))
            if fut is not None and not fut.done():
                fut.set_result(getattr(event, field_name))
        elif isinstance(event, cm.ProfileReplyFromDaemon):
            fut = self._profile_waiters.get((event.dataflow_id, event.node_id))
            if fut is not None and not fut.done():
                fut.set_result((event.artifact, event.error))
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

    async def query(self, uuid: str, plane: str) -> dict:
        """Fan one plane's request out to every machine of the dataflow and
        merge their parts (``_QUERIES``: the metrics, the history rings on one
        clock-aligned timeline, the alert statuses, the fleet digests, the
        trace). Works for archived dataflows too: daemons keep a finished
        dataflow's state, its ring, alert engine and trace buffers included.
        A machine that does not answer in QUERY_WAIT_S is left out."""
        request, _reply, _field, merge = _QUERIES[plane]
        df = self.running.get(uuid)
        if df is None and uuid in self.archived:
            df = self.archived[uuid][0]
        if df is None:
            raise KeyError(f"unknown dataflow {uuid!r}")
        waiters = self._query_waiters[plane]
        loop = asyncio.get_running_loop()
        futs = []
        for machine in sorted(df.machines):
            fut = loop.create_future()
            waiters[(uuid, machine)] = fut
            self._daemon_send(machine, request(dataflow_id=uuid))
            futs.append(fut)
        try:
            parts = await asyncio.wait_for(asyncio.gather(*futs, return_exceptions=True),
                                           timeout=QUERY_WAIT_S)
        finally:
            for machine in df.machines:
                waiters.pop((uuid, machine), None)
        return merge([p for p in parts if isinstance(p, dict)])

    async def profile(self, request) -> Any:
        """StartProfile / StopProfile: a PROFILE event to the node's machine,
        then the node's capture (``ProfileReplyFromDaemon``). A start waits
        for the capture's seconds and PROFILE_REPLY_S (the node reports at
        its report cadence), a stop PROFILE_STOP_S."""
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
        starting = isinstance(request, cm.StartProfile)
        seconds = request.seconds if starting else 0.0
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._profile_waiters[(df.uuid, request.node_id)] = fut
        self._daemon_send(machine, cm.ProfileDataflowNode(
            dataflow_id=df.uuid, node_id=request.node_id,
            action="start" if starting else "stop", seconds=seconds))
        timeout = seconds + PROFILE_REPLY_S if starting else PROFILE_STOP_S
        try:
            artifact, error = await asyncio.wait_for(fut, timeout=timeout)
        except asyncio.TimeoutError:
            return cm.Error(message=f"profile reply from {request.node_id!r} "
                                    f"timed out after {timeout:.0f}s")
        finally:
            self._profile_waiters.pop((df.uuid, request.node_id), None)
        return cm.ProfileReply(uuid=df.uuid, node_id=request.node_id, artifact=artifact,
                               error=error)

    # ------------------------------------------------------------------
    # Prometheus exposition (DORA_PROM_PORT)
    # ------------------------------------------------------------------

    async def prom_snapshots(self) -> dict[str, dict]:
        """The merged metrics of every running and archived dataflow, keyed
        by its exposition label (its name, else its uuid). A dataflow whose
        daemons do not answer in SCRAPE_WAIT_S is left out."""
        targets = [(u, df.name) for u, df in self.running.items()]
        targets += [(u, df.name) for u, (df, _) in self.archived.items()
                    if u not in self.running]
        out: dict[str, dict] = {}
        for uuid, name in targets:
            label = name or uuid
            if label in out:
                label = uuid  # a name used by two runs: the uuid tells them apart
            try:
                out[label] = await asyncio.wait_for(self.query(uuid, "metrics"),
                                                    timeout=SCRAPE_WAIT_S)
            except Exception:
                continue
        return out

    async def _handle_prom_scrape(self, reader, writer) -> None:
        """``GET /metrics`` (or ``/``) over HTTP/1.1, one response a
        connection; anything else is a 404."""
        from dora_tpu_torch import prom

        try:
            request_line = await reader.readline()
            while True:  # the headers
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
            parts = request_line.decode("latin1").split()
            path = parts[1].split("?")[0] if len(parts) > 1 else "/"
            if len(parts) > 1 and parts[0] == "GET" and path in ("/metrics", "/"):
                payload = prom.render_exposition(await self.prom_snapshots()).encode()
                status, ctype = "200 OK", prom.CONTENT_TYPE
            else:
                payload, status, ctype = b"not found\n", "404 Not Found", "text/plain"
            writer.write(f"HTTP/1.1 {status}\r\nContent-Type: {ctype}\r\n"
                         f"Content-Length: {len(payload)}\r\nConnection: close\r\n\r\n"
                         .encode() + payload)
            await writer.drain()
        except Exception:
            logger.exception("prometheus scrape failed")
        finally:
            try:
                writer.close()
            except Exception:
                pass

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
        if isinstance(request, (cm.StartProfile, cm.StopProfile)):
            return await self.profile(request)
        if isinstance(request, cm.Logs):
            uuid = self.resolve_name(request.uuid or request.name)
            logs = await self.request_logs(uuid, request.node)
            return cm.LogsReply(logs=logs)
        query = _CONTROL_QUERIES.get(type(request))
        if query is not None:
            plane, reply = query
            uuid = self._query_target(request.dataflow_uuid, request.name)
            if isinstance(uuid, cm.Error):
                return uuid
            return reply(uuid, await self.query(uuid, plane))
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


#: the CLI's per-dataflow queries: request class -> (plane, its reply)
_CONTROL_QUERIES = {
    cm.QueryMetrics: ("metrics", lambda u, v: cm.MetricsReply(dataflow_uuid=u, metrics=v)),
    cm.QueryMetricsHistory: ("history",
                             lambda u, v: cm.MetricsHistoryReply(dataflow_uuid=u, history=v)),
    cm.QueryAlerts: ("alerts", lambda u, v: cm.AlertsReply(dataflow_uuid=u, alerts=v)),
    cm.QueryFleet: ("fleet", lambda u, v: cm.FleetReply(dataflow_uuid=u, fleet=v)),
    cm.QueryTrace: ("trace", lambda u, v: cm.TraceReply(dataflow_uuid=u, trace=v)),
}


def _is_dynamic(descriptor: Descriptor, node_id: str) -> bool:
    node = descriptor.node(node_id)
    return isinstance(node.kind, CustomNode) and node.kind.is_dynamic
