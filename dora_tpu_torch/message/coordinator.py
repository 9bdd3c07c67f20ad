"""Control-plane messages: CLI <-> coordinator <-> daemon, daemon <-> daemon
(dora_tpu/message/coordinator.py, every class).

Each class is registered with the port's serde under the JAX class's name and
fields, so it encodes to the same bytes: a coordinator, a daemon or a CLI of
either package talks to those of the other."""

from __future__ import annotations

from typing import Any

from dora_tpu_torch.message.common import DataflowResult, LogMessage, Metadata
from dora_tpu_torch.message.serde import message

# ---------------------------------------------------------------------------
# CLI -> coordinator (ControlRequest)
# ---------------------------------------------------------------------------


@message
class Start:
    dataflow: dict[str, Any]  # raw descriptor
    name: str | None = None
    local_working_dir: str | None = None
    uv: bool = False


@message
class Check:
    dataflow_uuid: str


@message
class ReloadRequest:
    dataflow_id: str
    node_id: str
    operator_id: str | None = None


@message
class StopRequest:
    dataflow_uuid: str
    grace_duration_s: float | None = None


@message
class StopByName:
    name: str
    grace_duration_s: float | None = None


@message
class Logs:
    uuid: str | None
    name: str | None
    node: str


@message
class ListDataflows:
    pass


@message
class DaemonConnected:
    pass


@message
class ConnectedMachines:
    pass


@message
class QueryMetrics:
    """Fetch the aggregated metrics snapshot of a dataflow (running or
    finished). With neither uuid nor name, resolves the single running
    dataflow."""

    dataflow_uuid: str | None = None
    name: str | None = None


@message
class QueryTrace:
    """Fetch the merged, clock-aligned trace timeline of a dataflow
    (running or finished). Resolution mirrors QueryMetrics."""

    dataflow_uuid: str | None = None
    name: str | None = None


@message
class QueryMetricsHistory:
    """Fetch the merged, clock-aligned metrics time series of a dataflow
    (running or finished). Resolution mirrors QueryMetrics."""

    dataflow_uuid: str | None = None
    name: str | None = None


@message
class QueryAlerts:
    """Fetch the merged alert status (pending/firing instances per rule)
    of a dataflow (running or finished). Resolution mirrors
    QueryMetrics."""

    dataflow_uuid: str | None = None
    name: str | None = None


@message
class QueryFleet:
    """Fetch the merged fleet view of a dataflow (latest per-replica
    engine-state digests with ages, clock-aligned across machines).
    Resolution mirrors QueryMetrics."""

    dataflow_uuid: str | None = None
    name: str | None = None


@message
class MigrateNode:
    """Drain a serving node's live KV streams at a window boundary and
    re-admit them on another engine: the node quiesces, serializes its
    active streams (tokens, positions, trace contexts, KV pages) into
    ``handoff_dir``, and a peer engine watching that directory
    (``DORA_MIGRATE_DIR``) re-admits them — clients see at most one
    decode window of added latency."""

    dataflow_uuid: str | None
    node_id: str
    handoff_dir: str
    name: str | None = None


@message
class StartProfile:
    """Start an on-demand deep profile capture on one serving node for ``seconds``, then reply with the artifact
    path. Resolution mirrors MigrateNode; the reply waits for the
    node's ReportProfile to round-trip through its daemon."""

    dataflow_uuid: str | None
    node_id: str
    seconds: float = 5.0
    name: str | None = None


@message
class StopProfile:
    """Stop an in-flight capture early; replies with the artifact path
    written so far."""

    dataflow_uuid: str | None
    node_id: str
    name: str | None = None


@message
class LogSubscribe:
    """Turn this control connection into a live log stream for a dataflow."""

    dataflow_id: str
    level: str = "info"


@message
class Destroy:
    pass


# ---------------------------------------------------------------------------
# coordinator -> CLI (ControlRequestReply)
# ---------------------------------------------------------------------------


@message
class Error:
    message: str


@message
class CoordinatorStopped:
    pass


@message
class DataflowStarted:
    uuid: str


@message
class DataflowReloaded:
    uuid: str


@message
class NodeMigrated:
    uuid: str
    node_id: str
    handoff_dir: str


@message
class ProfileReply:
    uuid: str
    node_id: str
    artifact: str  # capture directory, or the synthetic marker file
    error: str | None = None


@message
class DataflowStopped:
    uuid: str
    result: DataflowResult


@message
class DataflowSpawnResult:
    uuid: str
    error: str | None = None


@message
class DataflowListEntry:
    uuid: str
    name: str | None


@message
class DataflowList:
    dataflows: list[DataflowListEntry]


@message
class LogsReply:
    logs: bytes


@message
class MetricsReply:
    dataflow_uuid: str
    metrics: dict[str, Any]  # merged snapshot (metrics.merge_snapshots)


@message
class TraceReply:
    dataflow_uuid: str
    trace: dict[str, Any]  # merged timeline (tracing.merge_trace_snapshots)


@message
class MetricsHistoryReply:
    dataflow_uuid: str
    history: dict[str, Any]  # merged series (metrics_history.merge_history_snapshots)


@message
class AlertsReply:
    dataflow_uuid: str
    alerts: dict[str, Any]  # merged status (alerts.merge_alert_status)


@message
class FleetReply:
    dataflow_uuid: str
    fleet: dict[str, Any]  # merged view (fleet.merge_fleet_snapshots)


@message
class DaemonConnectedReply:
    connected: bool


@message
class ConnectedMachinesReply:
    machines: list[str]


@message
class DestroyOk:
    pass


# ---------------------------------------------------------------------------
# coordinator -> daemon (DaemonCoordinatorEvent)
# ---------------------------------------------------------------------------


@message
class RegisterDaemonReply:
    error: str | None = None


@message
class SpawnDataflowNodes:
    dataflow_id: str
    working_dir: str
    nodes: list[str]  # node ids this machine runs
    dataflow_descriptor: dict[str, Any]
    spawn_nodes: list[str]  # non-dynamic subset to actually spawn
    machine_listen_ports: dict[str, str]  # machine_id -> "host:port"
    uv: bool = False


@message
class AllNodesReady:
    """Coordinator broadcast: every machine's nodes subscribed — release the
    start barrier."""

    dataflow_id: str
    exited_before_subscribe: list[str]


@message
class StopDataflow:
    dataflow_id: str
    grace_duration_s: float | None = None


@message
class ReloadDataflow:
    dataflow_id: str
    node_id: str
    operator_id: str | None = None


@message
class MigrateDataflowNode:
    dataflow_id: str
    node_id: str
    handoff_dir: str


@message
class ProfileDataflowNode:
    dataflow_id: str
    node_id: str
    action: str  # "start" | "stop"
    seconds: float = 0.0


@message
class LogsRequest:
    dataflow_id: str
    node_id: str


@message
class MetricsRequest:
    dataflow_id: str


@message
class TraceRequest:
    dataflow_id: str


@message
class MetricsHistoryRequest:
    dataflow_id: str


@message
class AlertsRequest:
    dataflow_id: str


@message
class FleetRequest:
    dataflow_id: str


@message
class Heartbeat:
    pass


@message
class DestroyDaemon:
    pass


# ---------------------------------------------------------------------------
# daemon -> coordinator
# ---------------------------------------------------------------------------


@message
class RegisterDaemon:
    machine_id: str
    protocol_version: str
    listen_port: int  # inter-daemon data port


@message
class ReadyOnMachine:
    """All this machine's nodes of a dataflow subscribed (or some exited
    before subscribing — the barrier poison case)."""

    dataflow_id: str
    exited_before_subscribe: list[str]


@message
class AllNodesFinished:
    dataflow_id: str
    result: DataflowResult


@message
class DaemonHeartbeat:
    pass


@message
class DaemonLog:
    log: LogMessage


@message
class LogsReplyFromDaemon:
    dataflow_id: str
    node_id: str
    logs: bytes


@message
class ProfileReplyFromDaemon:
    dataflow_id: str
    node_id: str
    artifact: str
    error: str | None = None


@message
class MetricsReplyFromDaemon:
    dataflow_id: str
    machine_id: str
    metrics: dict[str, Any]  # per-machine snapshot (Daemon.metrics_snapshot)


@message
class TraceReplyFromDaemon:
    dataflow_id: str
    machine_id: str
    trace: dict[str, Any]  # per-machine snapshot (Daemon.trace_snapshot)


@message
class MetricsHistoryReplyFromDaemon:
    dataflow_id: str
    machine_id: str
    history: dict[str, Any]  # per-machine ring (Daemon.history_snapshot)


@message
class AlertsReplyFromDaemon:
    dataflow_id: str
    machine_id: str
    alerts: dict[str, Any]  # per-machine status (Daemon.alerts_snapshot)


@message
class FleetReplyFromDaemon:
    dataflow_id: str
    machine_id: str
    fleet: dict[str, Any]  # per-machine snapshot (Daemon.fleet_snapshot)


@message
class SpawnDataflowResult:
    dataflow_id: str
    error: str | None = None


# ---------------------------------------------------------------------------
# daemon -> daemon (InterDaemonEvent)
# ---------------------------------------------------------------------------


@message
class InterDaemonOutput:
    """A node output forwarded to another machine (payload always inline —
    shared memory never crosses machines)."""

    dataflow_id: str
    output_id: str
    metadata: Metadata
    data: bytes | None


@message
class InterDaemonInputsClosed:
    dataflow_id: str
    inputs: list[str]  # "<node>/<input>"
