"""Attached mode: the daemon's connection to the coordinator
(dora_tpu/daemon/coordinator_conn.py).

``run_attached`` registers the daemon under its machine id, with the port
of its inter-daemon listener, then serves the coordinator's events: spawn
this machine's nodes of a dataflow, release or fail the start barrier
across machines, stop, reload, migrate, profile, and answer for logs,
metrics, the metrics history, alerts, the trace and fleet digests; a node's
finished profile capture goes up as ``ProfileReplyFromDaemon``. The daemon sends a heartbeat every 5 s and drops a
connection the coordinator has left silent for 20 s.

A dropped connection is not fatal: the dataflows keep running and the
daemon registers again, with exponential backoff and jitter, for up to
``RECONNECT_WINDOW_S``, inside the coordinator's 30 s heartbeat drop, so its
machine is still listed when it is back. The outbox outlives a connection:
what was queued while disconnected (a result, log lines) goes out after the
new registration.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from typing import TYPE_CHECKING

from dora_tpu_torch import PROTOCOL_VERSION
from dora_tpu_torch.core.descriptor import Descriptor
from dora_tpu_torch.daemon import inter_daemon
from dora_tpu_torch.daemon.spawn import log_file_path
from dora_tpu_torch.message import coordinator as cm
from dora_tpu_torch.message.serde import decode_timestamped, encode_timestamped
from dora_tpu_torch.telemetry import FLIGHT
from dora_tpu_torch.transport.framing import (
    ConnectionClosed,
    recv_frame_async,
    send_frame_async,
)

if TYPE_CHECKING:
    from dora_tpu_torch.daemon.core import Daemon

logger = logging.getLogger(__name__)

HEARTBEAT_INTERVAL_S = 5.0
COORDINATOR_SILENCE_BAIL_S = 20.0

#: reconnect backoff: base * 2^attempt with +-25 % jitter, capped
RECONNECT_BACKOFF_BASE_S = 0.5
RECONNECT_BACKOFF_MAX_S = 5.0
#: how long a daemon tries to register again after a dropped connection;
#: under the coordinator's 30 s heartbeat drop
RECONNECT_WINDOW_S = 25.0


async def run_attached(daemon: "Daemon", coordinator_addr: str, machine_id: str,
                       register_timeout_s: float = 30.0) -> None:
    """Register with the coordinator at ``coordinator_addr`` (its daemon
    port) and serve its events until it destroys the cluster, or until a
    lost connection could not be registered again within
    ``RECONNECT_WINDOW_S``."""
    daemon.machine_id = machine_id
    await daemon.start()
    inter_server, inter_port = await inter_daemon.start_server(daemon)
    inter_client = inter_daemon.InterDaemonClient(daemon.clock)

    host, _, port = coordinator_addr.rpartition(":")
    outbox: asyncio.Queue = asyncio.Queue()

    def notify(kind: str, df, payload) -> None:
        if kind == "ready":
            outbox.put_nowait(cm.ReadyOnMachine(dataflow_id=df.id,
                                                exited_before_subscribe=payload))
        elif kind == "finished":
            outbox.put_nowait(cm.AllNodesFinished(dataflow_id=df.id, result=payload))

    daemon.coordinator_notify = notify
    daemon.log_sink = lambda log: outbox.put_nowait(cm.DaemonLog(log=log))
    daemon.profile_sink = lambda df_id, node_id, artifact, error: outbox.put_nowait(
        cm.ProfileReplyFromDaemon(dataflow_id=df_id, node_id=node_id, artifact=artifact,
                                  error=error))
    #: the sends in flight to other machines (each peer's lock keeps their order)
    sending: set[asyncio.Task] = set()

    def sent(task: asyncio.Task) -> None:
        sending.discard(task)
        if not task.cancelled() and task.exception() is not None:
            logger.error("inter-daemon send failed: %s", task.exception())

    def send_inter(df, machine, output_id, metadata, payload, closed=None):
        addr = df.machine_listen_ports.get(machine)
        if addr is None:
            logger.warning("no listen address for machine %r", machine)
            return
        if closed is not None:
            event = cm.InterDaemonInputsClosed(dataflow_id=df.id, inputs=closed)
        else:
            event = cm.InterDaemonOutput(dataflow_id=df.id, output_id=output_id,
                                         metadata=metadata, data=payload)
        task = asyncio.create_task(inter_client.send(addr, event))
        sending.add(task)
        task.add_done_callback(sent)

    daemon.inter_daemon_send = send_inter

    first = True
    try:
        while True:
            try:
                reader, writer = await _connect_register(
                    daemon, host, int(port), machine_id, inter_port,
                    timeout_s=register_timeout_s if first else RECONNECT_WINDOW_S)
            except (ConnectionError, RuntimeError):
                if first:
                    raise
                logger.error("could not register with the coordinator again within %ss; "
                             "giving up", RECONNECT_WINDOW_S)
                return
            if not first:
                logger.info("registered with the coordinator again")
                if FLIGHT.enabled:
                    FLIGHT.record("daemon_reconnect", machine_id, 0)
            first = False
            if await _serve_connection(daemon, reader, writer, outbox, machine_id):
                return
            logger.error("lost the coordinator connection; reconnecting")
    finally:
        inter_client.close()
        inter_server.close()
        await daemon.close()


async def _connect_register(daemon: "Daemon", host: str, port: int, machine_id: str,
                            inter_port: int, timeout_s: float):
    """Connect and send RegisterDaemon, with exponential backoff and jitter,
    until ``timeout_s`` has passed. A refused registration raises at once:
    asking again cannot change the coordinator's answer."""
    deadline = time.monotonic() + timeout_s
    attempt = 0
    while True:
        writer = None
        try:
            reader, writer = await asyncio.open_connection(host, port)
            await send_frame_async(writer, encode_timestamped(
                cm.RegisterDaemon(machine_id=machine_id, protocol_version=PROTOCOL_VERSION,
                                  listen_port=inter_port),
                daemon.clock))
            reply = decode_timestamped(await recv_frame_async(reader), daemon.clock).inner
            if not isinstance(reply, cm.RegisterDaemonReply) or reply.error:
                raise RuntimeError(f"daemon register failed: {getattr(reply, 'error', reply)}")
            return reader, writer
        except (ConnectionError, ConnectionClosed, OSError) as e:
            if writer is not None:
                try:
                    writer.close()
                except Exception:
                    pass
            if time.monotonic() > deadline:
                raise ConnectionError(f"coordinator unreachable: {e}") from e
            attempt += 1
            delay = min(RECONNECT_BACKOFF_BASE_S * (2 ** (attempt - 1)), RECONNECT_BACKOFF_MAX_S)
            await asyncio.sleep(delay * (0.75 + 0.5 * random.random()))


def _reply_for(daemon: "Daemon", event, machine_id: str):
    """The reply to a per-dataflow query of the coordinator, or None for an
    event that is not one."""
    df = daemon.dataflows.get(getattr(event, "dataflow_id", None))
    if isinstance(event, cm.LogsRequest):
        logs = b""
        if df is not None:
            path = log_file_path(df.working_dir, df.id, event.node_id)
            if path.exists():
                logs = path.read_bytes()
        return cm.LogsReplyFromDaemon(dataflow_id=event.dataflow_id, node_id=event.node_id,
                                      logs=logs)
    if isinstance(event, cm.MetricsRequest):
        return cm.MetricsReplyFromDaemon(
            dataflow_id=event.dataflow_id, machine_id=machine_id,
            metrics=daemon.metrics_snapshot(df) if df is not None else {})
    if isinstance(event, cm.FleetRequest):
        return cm.FleetReplyFromDaemon(
            dataflow_id=event.dataflow_id, machine_id=machine_id,
            fleet=daemon.fleet_snapshot(df) if df is not None else {})
    if isinstance(event, cm.TraceRequest):
        return cm.TraceReplyFromDaemon(
            dataflow_id=event.dataflow_id, machine_id=machine_id,
            trace=daemon.trace_snapshot(df) if df is not None else {})
    if isinstance(event, cm.MetricsHistoryRequest):
        return cm.MetricsHistoryReplyFromDaemon(
            dataflow_id=event.dataflow_id, machine_id=machine_id,
            history=daemon.history_snapshot(df) if df is not None else {})
    if isinstance(event, cm.AlertsRequest):
        return cm.AlertsReplyFromDaemon(
            dataflow_id=event.dataflow_id, machine_id=machine_id,
            alerts=daemon.alerts_snapshot(df) if df is not None else {})
    return None


async def _serve_connection(daemon: "Daemon", reader, writer, outbox: asyncio.Queue,
                            machine_id: str) -> bool:
    """Pump one coordinator connection. Returns True on DestroyDaemon, False
    when the connection dropped (the caller registers again)."""
    last_contact = time.monotonic()

    async def sender():
        while True:
            msg = await outbox.get()
            try:
                await send_frame_async(writer, encode_timestamped(msg, daemon.clock))
            except (ConnectionError, ConnectionClosed, OSError):
                outbox.put_nowait(msg)  # sent again after the next registration
                return

    async def heartbeat():
        while True:
            await asyncio.sleep(HEARTBEAT_INTERVAL_S)
            if time.monotonic() - last_contact > COORDINATOR_SILENCE_BAIL_S:
                logger.error("coordinator silent for >%ss; dropping the connection",
                             COORDINATOR_SILENCE_BAIL_S)
                writer.close()
                return
            outbox.put_nowait(cm.DaemonHeartbeat())

    tasks = [asyncio.create_task(sender()), asyncio.create_task(heartbeat())]
    try:
        while True:
            frame = await recv_frame_async(reader)
            last_contact = time.monotonic()
            event = decode_timestamped(frame, daemon.clock).inner
            if isinstance(event, cm.Heartbeat):
                continue
            if isinstance(event, cm.DestroyDaemon):
                return True
            if isinstance(event, cm.SpawnDataflowNodes):
                await _handle_spawn(daemon, outbox, event)
                continue
            reply = _reply_for(daemon, event, machine_id)
            if reply is not None:
                outbox.put_nowait(reply)
                continue
            df = daemon.dataflows.get(getattr(event, "dataflow_id", None))
            if isinstance(event, cm.AllNodesReady):
                if df is None:
                    continue
                if event.exited_before_subscribe:
                    daemon.poison_barrier(df, event.exited_before_subscribe[0])
                else:
                    daemon.release_barrier(df)
            elif isinstance(event, cm.StopDataflow):
                if df is not None:
                    daemon.stop_dataflow(df, event.grace_duration_s)
            elif isinstance(event, cm.ReloadDataflow):
                if df is not None:
                    daemon.reload_node(df, event.node_id, event.operator_id)
            elif isinstance(event, cm.MigrateDataflowNode):
                if df is not None:
                    daemon.migrate_node(df, event.node_id, event.handoff_dir)
            elif isinstance(event, cm.ProfileDataflowNode):
                if df is not None:
                    daemon.profile_node(df, event.node_id, event.action, event.seconds)
            else:
                logger.warning("unexpected coordinator event %s", type(event).__name__)
    except (ConnectionClosed, ConnectionError, OSError):
        return False
    finally:
        for t in tasks:
            t.cancel()
        try:
            writer.close()
        except Exception:
            pass


async def _handle_spawn(daemon: "Daemon", outbox, event: cm.SpawnDataflowNodes) -> None:
    error = None
    try:
        descriptor = Descriptor.parse(event.dataflow_descriptor)
        await daemon.spawn_dataflow(descriptor, dataflow_id=event.dataflow_id,
                                    working_dir=event.working_dir, local_nodes=set(event.nodes),
                                    machine_listen_ports=event.machine_listen_ports)
    except Exception as e:
        logger.exception("spawn failed")
        error = str(e)
    outbox.put_nowait(cm.SpawnDataflowResult(dataflow_id=event.dataflow_id, error=error))
