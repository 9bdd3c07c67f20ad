"""The daemon: spawn a machine's nodes of a dataflow, route their messages,
own the timers and the shared-memory drop tokens (dora_tpu/daemon/core.py).

One daemon in one process runs one machine's part of its dataflows to
completion: the start barrier (every node subscribed before any event flows),
output routing through bounded per-input queues (inline payloads spliced as
wire bytes, shared-memory payloads tracked by their drop tokens), timers,
``InputClosed`` / ``AllInputsClosed`` as producers finish, STOP with a grace
kill, RELOAD, MIGRATE, ``send_stdout_as``, the restart policy with replay of
un-acked inputs, and the dataflow's result with each node's exit status.

A dataflow may span machines. Attached to a coordinator
(``coordinator_conn.run_attached``), the daemon runs the nodes whose
``deploy.machine`` is its ``machine_id``, reports its part of the start
barrier and its result through ``coordinator_notify``, forwards its node's
log lines through ``log_sink``, and sends outputs and closed inputs meant for
another machine through ``inter_daemon_send`` (``inter_daemon.py``): a
shared-memory payload is copied to bytes first, since shared memory never
crosses machines, and a frame spliced on the wire fast path is never
forwarded. :func:`run_dataflow` is the standalone mode (``python -m
dora_tpu_torch.cli run``, or ``daemon --run-dataflow``): every node runs on
this machine, whatever its ``deploy.machine``.

The observability planes, per dataflow: a node's serving snapshot and fleet
digest are kept for ``metrics_snapshot`` and ``fleet_snapshot``; the metrics
history ring (``metrics_history``, sampled every ``DORA_METRICS_HISTORY_S``)
and its alert engine (``alerts``) for ``history_snapshot`` and
``alerts_snapshot``; the nodes' ``ReportTrace`` chunks, beside this daemon's
own flight-recorder ring (its ``t_route`` / ``t_deliver`` spans with
``DORA_TRACING=1``), for ``trace_snapshot``; a node's ``ReportProfile`` goes
to ``profile_sink``. These counters and spans see only the edges the
daemon routes: a peer-to-peer edge (paired at barrier release between two
announced local nodes, ``node/p2p.py``) carries its messages past it.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import os
import random
import time
import uuid as uuid_mod
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

from dora_tpu_torch import PROTOCOL_VERSION, fleet
from dora_tpu_torch.alerts import AlertEngine, engine_for
from dora_tpu_torch.clock import HLC
from dora_tpu_torch.core.config import TimerMapping, UserMapping
from dora_tpu_torch.core.descriptor import CustomNode, Descriptor, new_dataflow_uuid
from dora_tpu_torch.daemon import spawn as spawn_mod
from dora_tpu_torch.daemon.connection import NodeConnection, ShmemConnection, serve_stream
from dora_tpu_torch.daemon.queues import DropQueue, NodeEventQueue
from dora_tpu_torch.daemon.replay_buffer import ReplayBuffer
from dora_tpu_torch.ids import DataId, InputId, NodeId, OutputId
from dora_tpu_torch.message import daemon_to_node as d2n
from dora_tpu_torch.message import fastroute
from dora_tpu_torch.message import node_to_daemon as n2d
from dora_tpu_torch.message.common import (
    ENCODING_RAW,
    DataflowResult,
    InlineData,
    LogMessage,
    Metadata,
    NodeError,
    NodeErrorCause,
    NodeExitStatus,
    NodeResult,
    SharedMemoryData,
    TypeInfo,
    new_drop_token,
)
from dora_tpu_torch.message.serde import (
    Timestamped,
    decode_timestamped,
    encode,
    encode_timestamped,
)
from dora_tpu_torch.metrics import DataflowMetrics
from dora_tpu_torch.metrics_history import MetricsHistoryRing, history_interval_s
from dora_tpu_torch.native import ShmemChannel, ShmemError, ShmemRegion, unlink_region
from dora_tpu_torch.telemetry import FLIGHT, OTEL_CTX_KEY, TRACING
from dora_tpu_torch.transport.framing import ConnectionClosed

logger = logging.getLogger(__name__)

#: stop grace period before leftover nodes are killed
DEFAULT_GRACE_S = 15.0

#: capacity of a shared-memory node channel: payloads of the zero-copy
#: threshold or more travel in their own regions, so the channel carries
#: control messages and inline payloads only
SHMEM_CHANNEL_CAPACITY = 1 << 20

#: trace plane: buffered ReportTrace events a node, oldest dropped first
MAX_NODE_TRACE_EVENTS = 20_000


def _extend_trace_buffer(df, node_id: str, events: list) -> None:
    """Append a node's ReportTrace chunk to its bounded buffer. What the cap
    trims is counted (``node_trace_drops``) and rides the trace snapshot, so
    a trace says how many events this second truncation point lost (the
    ring's own wrap losses arrive as ``trace_truncated`` events)."""
    buf = df.node_traces.setdefault(node_id, [])
    buf.extend(events)
    if len(buf) > MAX_NODE_TRACE_EVENTS:
        trim = len(buf) - MAX_NODE_TRACE_EVENTS
        df.node_trace_drops[node_id] = df.node_trace_drops.get(node_id, 0) + trim
        del buf[:trim]


@dataclass
class TokenState:
    """One shared-memory region in flight: who owns it, how many receivers
    still reference it."""

    owner: str  # node id, or CUSTODY
    pending: int = 0


#: the owner of a region the daemon copied a finished sender's payload into
CUSTODY = ""


@dataclass
class RunningNode:
    node_id: str
    process: Any = None  # asyncio.subprocess.Process | None (dynamic)
    finished: bool = False
    dynamic: bool = False


@dataclass
class DataflowState:
    id: str
    descriptor: Descriptor
    working_dir: Path
    #: the node ids this machine runs
    local_nodes: set[str]
    #: OutputId -> receiver InputIds, on this machine and on others
    mappings: dict[OutputId, set[InputId]] = field(default_factory=dict)
    open_outputs: set[OutputId] = field(default_factory=set)
    #: receiver node -> its user (non-timer) inputs that are still open
    open_inputs: dict[str, set[str]] = field(default_factory=dict)
    #: interval_ns -> receiver InputIds
    timers: dict[int, set[InputId]] = field(default_factory=dict)
    timer_tasks: list[asyncio.Task] = field(default_factory=list)
    queues: dict[str, NodeEventQueue] = field(default_factory=dict)
    drop_queues: dict[str, DropQueue] = field(default_factory=dict)
    #: shared-memory drop tokens still referenced by receivers
    tokens: dict[str, TokenState] = field(default_factory=dict)
    #: per receiver: tokens delivered in a NextEvents batch, not yet acked
    delivered_tokens: dict[str, set[str]] = field(default_factory=dict)
    #: (sender, output id) -> (OutputId, [(receiver, input id)]): the wire
    #: fast path's view of ``mappings`` (fixed after spawn)
    route_cache: dict[tuple[str, str], Any] = field(default_factory=dict)
    running_nodes: dict[str, RunningNode] = field(default_factory=dict)
    node_results: dict[str, NodeResult] = field(default_factory=dict)
    stderr_rings: dict[str, list[str]] = field(default_factory=dict)
    #: start barrier
    pending_nodes: set[str] = field(default_factory=set)
    started: asyncio.Event = field(default_factory=asyncio.Event)
    barrier_error: str | None = None
    #: the node whose exit before subscribing failed the barrier
    barrier_failed_node: str | None = None
    #: failure bookkeeping
    failed_nodes: list[str] = field(default_factory=list)
    grace_kills: set[str] = field(default_factory=set)
    stop_sent: bool = False
    done: asyncio.Future = field(
        default_factory=lambda: asyncio.get_event_loop().create_future())
    #: the dataflow's shared-memory node channels
    shmem_conns: list[Any] = field(default_factory=list)
    #: node id -> set once its control connection drained; exit handling
    #: waits on it so in-flight SendMessages are not lost
    control_done: dict[str, asyncio.Event] = field(default_factory=dict)
    #: routing counters and send-to-deliver latency
    metrics: DataflowMetrics = field(default_factory=DataflowMetrics)
    #: restart policy: node id -> respawns so far
    respawn_attempts: dict[str, int] = field(default_factory=dict)
    #: nodes between death and respawn (the finish check waits for them)
    respawning: set[str] = field(default_factory=set)
    #: node id -> un-acked delivered inputs, redelivered on respawn
    replay_buffers: dict[str, ReplayBuffer] = field(default_factory=dict)
    #: node id -> the task serving its event queue (cancelled on respawn
    #: before the replay, so a dead incarnation's loop consumes nothing)
    event_tasks: dict[str, asyncio.Task] = field(default_factory=dict)
    #: machine id -> its daemon's inter-daemon address "host:port"
    machine_listen_ports: dict[str, str] = field(default_factory=dict)
    #: node id -> the latest serving snapshot it reported (ReportServing)
    node_serving: dict[str, dict] = field(default_factory=dict)
    #: node id -> {"digest": dict, "recv_wall_ns": int}, its latest
    #: ReportEngineState with the time it arrived
    node_fleet: dict[str, dict] = field(default_factory=dict)
    #: trace plane: node id -> the flight-recorder events it shipped
    #: (ReportTrace; at most MAX_NODE_TRACE_EVENTS)
    node_traces: dict[str, list] = field(default_factory=dict)
    #: trace plane: node id -> events the buffer's cap trimmed
    node_trace_drops: dict[str, int] = field(default_factory=dict)
    #: the delta-encoded metrics history (None when DORA_METRICS_HISTORY_S
    #: <= 0), kept after the finish so an archived run stays queryable
    history: MetricsHistoryRing | None = None
    #: the sampler task feeding ``history`` (cancelled at the finish)
    history_task: asyncio.Task | None = None
    #: the alert rules evaluated on each history sample (None when history
    #: is off or DORA_ALERTS=0), kept after the finish like the ring
    alerts: AlertEngine | None = None
    #: node id -> [ERROR lines, WARN lines] of its log (``on_node_log``)
    log_counts: dict[str, list[int]] = field(default_factory=dict)
    #: node id -> {input id: channel name} it announced (P2PAnnounce)
    p2p_listeners: dict[str, dict[str, str]] = field(default_factory=dict)
    #: (sender, output, receiver, input) edges paired peer-to-peer at
    #: barrier release; the routing skips them
    p2p_edges: set = field(default_factory=set)
    #: token -> a region of the daemon's own holding a finished sender's
    #: payload for the receivers that have not read it yet
    custody: dict[str, ShmemRegion] = field(default_factory=dict)

    def node_machine(self, node_id: str) -> str:
        return self.descriptor.node(node_id).deploy.machine or ""


class Daemon:
    """The data-plane daemon of this machine."""

    def __init__(self, local_comm: str = "tcp", machine_id: str = ""):
        self.local_comm = local_comm
        self.machine_id = machine_id
        # the knobs may be set after this module was imported (tests, tools)
        FLIGHT.configure_from_env()
        TRACING.configure_from_env()
        self.clock = HLC()
        self.dataflows: dict[str, DataflowState] = {}
        self._server: asyncio.AbstractServer | None = None
        self._server_addr: str | None = None
        self._dynamic_server: asyncio.AbstractServer | None = None
        self.dynamic_port: int | None = None
        #: attached mode: send an output (or closed inputs) to another
        #: machine: ``(df, machine, output_id, metadata, payload, closed=None)``
        self.inter_daemon_send: Callable[..., Any] | None = None
        #: attached mode: ``(kind, df, payload)``, kind "ready" (payload: the
        #: nodes that exited before subscribing) or "finished" (the result)
        self.coordinator_notify: Callable[..., Any] | None = None
        #: attached mode: every node log line as a ``LogMessage``
        self.log_sink: Callable[..., Any] | None = None
        #: attached mode: a node's finished profile capture,
        #: ``(dataflow_id, node_id, artifact, error)``, for the coordinator's
        #: waiting StartProfile / StopProfile
        self.profile_sink: Callable[..., Any] | None = None

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    async def start(self) -> None:
        """Start the node-channel accept loop (tcp or uds) and the
        dynamic-node bootstrap listener (on a free port: ``dynamic_port``)."""
        if self.local_comm == "uds":
            import tempfile

            d = tempfile.mkdtemp(prefix="dora-tpu-torch-")
            self._server, self._server_addr = await serve_stream(
                self._handle_connection, uds_path=str(Path(d) / f"daemon-{id(self):x}.sock"))
        else:
            self._server, self._server_addr = await serve_stream(self._handle_connection)
        self._dynamic_server = await asyncio.start_server(
            self._handle_dynamic_client, host="127.0.0.1", port=0)
        self.dynamic_port = self._dynamic_server.sockets[0].getsockname()[1]

    async def close(self) -> None:
        for server in (self._server, self._dynamic_server):
            if server is not None:
                server.close()
                try:
                    await server.wait_closed()
                except Exception:
                    pass
        for df in list(self.dataflows.values()):
            for t in df.timer_tasks:
                t.cancel()
            if df.history_task is not None:
                df.history_task.cancel()
                df.history_task = None
            # Node processes never outlive the daemon: the graceful path
            # (stop and grace kill) has run for a healthy dataflow, so what
            # is left are stragglers of an aborted one.
            self._kill_stragglers(df)
            for conn in df.shmem_conns:
                conn.close_sync()
            df.shmem_conns.clear()

    async def run(self, coordinator_addr: str, machine_id: str = "",
                  register_timeout_s: float = 30.0) -> None:
        """Attached mode: register with the coordinator at ``coordinator_addr``
        (its daemon port) as ``machine_id`` and serve its events until it
        destroys the cluster."""
        from dora_tpu_torch.daemon.coordinator_conn import run_attached

        await run_attached(self, coordinator_addr, machine_id, register_timeout_s)

    # ------------------------------------------------------------------
    # dataflow spawn
    # ------------------------------------------------------------------

    async def spawn_dataflow(self, descriptor: Descriptor, dataflow_id: str | None = None,
                             working_dir: str | Path | None = None,
                             local_nodes: set[str] | None = None,
                             machine_listen_ports: dict[str, str] | None = None
                             ) -> DataflowState:
        """Build the routing tables and spawn this machine's nodes but the
        dynamic ones. ``local_nodes`` None: the nodes whose
        ``deploy.machine`` is this daemon's ``machine_id``."""
        dataflow_id = dataflow_id or new_dataflow_uuid()
        working_dir = Path(working_dir or Path.cwd()).resolve()
        if local_nodes is None:
            local_nodes = {str(n.id) for n in descriptor.nodes
                           if (n.deploy.machine or "") == self.machine_id}
        df = DataflowState(id=dataflow_id, descriptor=descriptor, working_dir=working_dir,
                           local_nodes=set(local_nodes),
                           machine_listen_ports=dict(machine_listen_ports or {}))
        self.dataflows[dataflow_id] = df

        # The history ring and its sampler (DORA_METRICS_HISTORY_S <= 0: off),
        # SLO targets from the nodes' ``slo:`` blocks; the alert engine (the
        # default pack merged under the ``alerts:`` block, sinks from
        # DORA_ALERT_SINK) evaluates on the same tick.
        interval = history_interval_s()
        if interval > 0:
            slo_targets = {str(n.id): n.slo.as_targets() for n in descriptor.nodes
                           if n.slo is not None}
            df.history = MetricsHistoryRing(interval_s=interval, slo_targets=slo_targets)
            df.alerts = engine_for(descriptor.alerts, interval_s=interval)
            df.history_task = asyncio.create_task(self._history_sampler(df))

        for node in descriptor.nodes:
            for output in node.outputs:
                df.open_outputs.add(OutputId(node.id, output))
        for node in descriptor.nodes:
            fused_internal = node.fused_internal_inputs()
            for input_id, inp in node.inputs.items():
                if input_id in fused_internal:
                    # two fused torch operators of one node: a tensor inside
                    # the node's step, not a routed input
                    continue
                target = InputId(node.id, input_id)
                if isinstance(inp.mapping, TimerMapping):
                    df.timers.setdefault(inp.mapping.interval_ns, set()).add(target)
                else:
                    mapping: UserMapping = inp.mapping
                    df.mappings.setdefault(mapping.output_id, set()).add(target)
                    df.open_inputs.setdefault(str(node.id), set()).add(str(input_id))

        for node in descriptor.nodes:
            nid = str(node.id)
            if nid not in df.local_nodes:
                continue
            df.queues[nid] = NodeEventQueue(
                node_id=nid,
                queue_sizes={str(iid): inp.queue_size for iid, inp in node.inputs.items()},
                on_token_unref=lambda token, df=df: self._unref_token(df, token),
                metrics=df.metrics,
            )
            df.drop_queues[nid] = DropQueue()
            df.control_done[nid] = asyncio.Event()
            if node.restart is not None:
                df.replay_buffers[nid] = ReplayBuffer(
                    nid, spill_dir=working_dir / ".dora-replay" / dataflow_id)
            dynamic = isinstance(node.kind, CustomNode) and node.kind.is_dynamic
            df.running_nodes[nid] = RunningNode(node_id=nid, dynamic=dynamic)
            if not dynamic:
                df.pending_nodes.add(nid)

        for node in descriptor.nodes:
            nid = str(node.id)
            if nid not in df.local_nodes or df.running_nodes[nid].dynamic:
                continue
            try:
                process = await spawn_mod.spawn_node(self, df, node,
                                                     self._make_node_config(df, nid))
            except RuntimeError as e:
                self.handle_node_exit(df, node.id, None, error=str(e))
                continue
            df.running_nodes[nid].process = process

        if not df.pending_nodes:
            self._release_barrier(df)
        return df

    def _make_node_config(self, df: DataflowState, node_id: str) -> d2n.NodeConfig:
        node = df.descriptor.node(node_id)
        run_config = d2n.RunConfig(
            inputs={str(i): inp.queue_size for i, inp in node.inputs.items()},
            outputs=[str(o) for o in node.outputs],
        )
        if self.local_comm == "shmem":
            # A random part: a crashed run's leaked segments must never
            # collide with a new run's (shm_open O_EXCL would fail).
            prefix = f"dtp-{df.id[:8]}-{uuid_mod.uuid4().hex[:8]}-{node_id}"
            comm: Any = d2n.ShmemCommunication(
                control_region_id=f"{prefix}-ctl",
                events_region_id=f"{prefix}-evt",
                drop_region_id=f"{prefix}-drop",
            )
            for name in (comm.control_region_id, comm.events_region_id, comm.drop_region_id):
                conn = ShmemConnection(ShmemChannel.create(name, SHMEM_CHANNEL_CAPACITY))
                df.shmem_conns.append(conn)
                asyncio.create_task(self._handle_connection(conn))
        elif self.local_comm == "uds":
            comm = d2n.UnixDomainCommunication(socket_file=self._server_addr)
        else:
            comm = d2n.TcpCommunication(socket_addr=self._server_addr)
        return d2n.NodeConfig(
            dataflow_id=df.id,
            node_id=node_id,
            run_config=run_config,
            daemon_communication=comm,
            dataflow_descriptor=dict(df.descriptor.raw),
            dynamic=df.running_nodes.get(node_id, RunningNode(node_id)).dynamic,
        )

    # ------------------------------------------------------------------
    # start barrier
    # ------------------------------------------------------------------

    def _node_subscribed(self, df: DataflowState, node_id: str) -> None:
        if node_id in df.pending_nodes:
            df.pending_nodes.discard(node_id)
            if not df.pending_nodes:
                self._local_nodes_ready(df, [])

    def _local_nodes_ready(self, df: DataflowState, exited: list[str]) -> None:
        """Every node of this machine subscribed (or ``exited`` before it).
        Across machines the coordinator gathers every machine's report and
        answers with AllNodesReady; on one machine the barrier opens here."""
        if self._is_multi_machine(df):
            self.coordinator_notify("ready", df, exited)
        if exited:
            self.poison_barrier(df, exited[0])
        elif not self._is_multi_machine(df):
            self._release_barrier(df)

    def _is_multi_machine(self, df: DataflowState) -> bool:
        return self.coordinator_notify is not None and len(df.descriptor.machines()) > 1

    def release_barrier(self, df: DataflowState) -> None:
        """The coordinator's AllNodesReady: every machine's nodes subscribed."""
        if not df.started.is_set():
            self._release_barrier(df)

    def _release_barrier(self, df: DataflowState, error: str | None = None,
                         failed_node: str | None = None) -> None:
        df.barrier_error = error
        df.barrier_failed_node = failed_node
        if error is None:
            self._compute_p2p(df)
        df.started.set()
        if error is None:
            for interval_ns, targets in df.timers.items():
                df.timer_tasks.append(
                    asyncio.create_task(self._timer_loop(df, interval_ns, targets)))

    def _compute_p2p(self, df: DataflowState) -> None:
        """Pair the peer-to-peer edges: both ends on this machine and
        announced, the receiver serving that input and without a
        ``restart`` policy (its crash replay needs the daemon to hold the
        in-flight inputs), and the output produced by the node itself (a
        ``send_stdout_as`` output is the daemon's stdout pump's). The
        routing skips the paired edges."""
        if os.environ.get("DORA_P2P", "1") in ("", "0"):
            return
        for oid, targets in df.mappings.items():
            sender = str(oid.node)
            if sender not in df.local_nodes or sender not in df.p2p_listeners:
                continue
            if df.descriptor.node(sender).send_stdout_as == str(oid.output):
                continue
            for target in targets:
                rnode = str(target.node)
                listeners = df.p2p_listeners.get(rnode)
                if (rnode in df.local_nodes and listeners is not None
                        and str(target.input) in listeners
                        and df.descriptor.node(rnode).restart is None):
                    df.p2p_edges.add((sender, str(oid.output), rnode, str(target.input)))
        logger.info("dataflow %s: peer-to-peer edges %s", df.id,
                    sorted(f"{s}/{o} -> {r}/{i}" for s, o, r, i in df.p2p_edges))

    def _p2p_edges_reply(self, df: DataflowState, node_id: str) -> d2n.P2PEdgesReply:
        outputs: dict[str, Any] = {}
        for oid, targets in df.mappings.items():
            if str(oid.node) != node_id:
                continue
            edges = []
            daemon_route = False
            for target in targets:
                rnode = str(target.node)
                if (node_id, str(oid.output), rnode, str(target.input)) in df.p2p_edges:
                    edges.append(d2n.P2PEdge(channel=df.p2p_listeners[rnode][str(target.input)],
                                             input_id=str(target.input), receiver=rnode))
                else:
                    daemon_route = True
            if edges:
                outputs[str(oid.output)] = d2n.P2POutput(edges=edges, daemon_route=daemon_route)
        return d2n.P2PEdgesReply(outputs=outputs)

    def poison_barrier(self, df: DataflowState, failed_node: str) -> None:
        """A node exited before subscribing: the whole start fails."""
        if not df.started.is_set():
            self._release_barrier(df, error=f"node {failed_node!r} exited before subscribing",
                                  failed_node=failed_node)

    # ------------------------------------------------------------------
    # timers
    # ------------------------------------------------------------------

    async def _timer_loop(self, df: DataflowState, interval_ns: int, targets: set[InputId]):
        period = interval_ns / 1e9
        timer_id = str(TimerMapping(interval_ns=interval_ns).data_id)
        next_tick = time.monotonic() + period
        while True:
            delay = next_tick - time.monotonic()
            if delay > 0:
                await asyncio.sleep(delay)
            next_tick += period
            metadata = Metadata(type_info=TypeInfo(encoding=ENCODING_RAW, len=0),
                                parameters={"timer": timer_id})
            for target in targets:
                queue = df.queues.get(str(target.node))
                if queue is None:
                    continue
                event = d2n.Input(id=str(target.input), metadata=metadata, data=None)
                ts = self.clock.new_timestamp()
                queue.push(Timestamped(inner=event, timestamp=ts), input_id=str(target.input),
                           send_ns=ts.physical_ns)

    # ------------------------------------------------------------------
    # routing
    # ------------------------------------------------------------------

    def send_out(self, df: DataflowState, sender: str, output_id: str, metadata: Metadata,
                 data: Any, send_ns: int = 0) -> None:
        """Route one output to every receiver's queue on this machine and to
        the daemons of the others. ``send_ns`` is the sender's HLC physical
        time (0: unknown, the route time stands in), the start of the
        send-to-deliver latency."""
        oid = OutputId(NodeId(sender), DataId(output_id))
        token = data.drop_token if isinstance(data, SharedMemoryData) else None
        if oid not in df.open_outputs:
            if token:
                self._notify_owner(df, sender, token)
            return
        if token is not None:
            df.tokens[token] = TokenState(owner=sender)
        nbytes = metadata.type_info.len
        df.metrics.count_link(sender, output_id, nbytes)
        if FLIGHT.enabled:
            FLIGHT.record("route", f"{sender}/{output_id}", nbytes)
        if TRACING.active:
            FLIGHT.record("t_route", f"{sender}/{output_id}",
                          str(metadata.parameters.get(OTEL_CTX_KEY, "")),
                          max(0, time.time_ns() - send_ns) if send_ns else 0)
        remote_machines: set[str] = set()
        for target in df.mappings.get(oid, ()):
            rnode = str(target.node)
            if (sender, output_id, rnode, str(target.input)) in df.p2p_edges:
                continue  # the sender published this edge peer-to-peer
            if rnode not in df.local_nodes:
                remote_machines.add(df.node_machine(rnode))
                continue
            queue = df.queues.get(rnode)
            if queue is None or str(target.input) not in df.open_inputs.get(rnode, set()):
                continue
            if token is not None:
                df.tokens[token].pending += 1
            event = d2n.Input(id=str(target.input), metadata=metadata, data=data)
            ts = self.clock.new_timestamp()
            queue.push(Timestamped(inner=event, timestamp=ts), input_id=str(target.input),
                       drop_token=token, send_ns=send_ns or ts.physical_ns)
        if remote_machines and self.inter_daemon_send is not None:
            # Shared memory never crosses machines: the payload is copied to
            # bytes here, before the token can be released below.
            payload = self._payload_bytes(data)
            for machine in sorted(remote_machines):
                self.inter_daemon_send(df, machine, str(oid), metadata, payload)
        # A push into a closed queue (its receiver died) releases the token
        # at once, so it can be gone here already.
        token_state = df.tokens.get(token) if token is not None else None
        if token_state is not None and token_state.pending == 0:
            del df.tokens[token]
            self._notify_owner(df, sender, token)

    @staticmethod
    def _payload_bytes(data: Any) -> bytes | None:
        if data is None:
            return None
        if isinstance(data, InlineData):
            return bytes(data.data)
        region = ShmemRegion.open(data.shmem_id)
        try:
            with memoryview(region) as view:
                return bytes(view[:data.len])
        finally:
            region.close(unlink=False, force=True)

    def send_out_wire(self, df: DataflowState, sender: str, fast: fastroute.FastSend) -> bool:
        """Route a shallow-parsed inline SendMessage by splicing its wire
        bytes into each receiver's Input event. Returns False, having routed
        nothing, when a receiver is on another machine: forwarding needs the
        decoded message, so the caller routes the frame through
        :meth:`send_out`."""
        key = (sender, fast.output_id)
        cached = df.route_cache.get(key)
        if cached is None:
            oid = OutputId(NodeId(sender), DataId(fast.output_id))
            receivers = [(str(t.node), str(t.input)) for t in df.mappings.get(oid, ())]
            cached = (oid, receivers, all(r in df.local_nodes for r, _ in receivers),
                      f"{sender}/{fast.output_id}")  # the flight label, built once
            df.route_cache[key] = cached
        oid, receivers, all_local, label = cached
        if oid not in df.open_outputs:
            return True  # dropped, as send_out drops on a closed output
        if not all_local:
            return False
        df.metrics.count_link(sender, fast.output_id, fast.payload_len)
        if FLIGHT.enabled:
            FLIGHT.record("fastroute_hit", label, fast.payload_len)
        send_ns = fast.timestamp.physical_ns
        if TRACING.active:
            # the context parse_send_message read off the wire
            FLIGHT.record("t_route", label, fast.ctx, max(0, time.time_ns() - send_ns))
        for rnode, input_id in receivers:
            if (sender, fast.output_id, rnode, input_id) in df.p2p_edges:
                continue  # the sender published this edge peer-to-peer
            queue = df.queues.get(rnode)
            if queue is None or input_id not in df.open_inputs.get(rnode, set()):
                continue
            queue.push(None, input_id=input_id,
                       wire=fastroute.build_input_event(input_id, fast.body,
                                                        self.clock.new_timestamp()),
                       send_ns=send_ns)
        return True

    def deliver_remote_output(self, df: DataflowState, output_id: str, metadata: Metadata,
                              payload: bytes | None) -> None:
        """An output another machine's daemon forwarded, to this machine's
        receivers. Its latency starts at its arrival here: two machines'
        clocks are not comparable."""
        oid = OutputId.parse(output_id)
        data = InlineData(data=payload) if payload is not None else None
        nbytes = metadata.type_info.len
        df.metrics.count_link(str(oid.node), str(oid.output), nbytes)
        if FLIGHT.enabled:
            FLIGHT.record("route_remote", output_id, nbytes)
        for target in df.mappings.get(oid, ()):
            rnode = str(target.node)
            if rnode not in df.local_nodes:
                continue
            queue = df.queues.get(rnode)
            if queue is None or str(target.input) not in df.open_inputs.get(rnode, set()):
                continue
            event = d2n.Input(id=str(target.input), metadata=metadata, data=data)
            ts = self.clock.new_timestamp()
            queue.push(Timestamped(inner=event, timestamp=ts), input_id=str(target.input),
                       send_ns=ts.physical_ns)

    def metrics_snapshot(self, df: DataflowState) -> dict:
        """The dataflow's routing counters (messages and bytes a link,
        drop-oldest drops, queue depths, send-to-deliver latency, the wire
        fast path's hits, respawns and replayed inputs), the nodes' serving
        and fleet blocks, and the SLO, log, trace-drop and alert blocks."""
        depths = {f"{nid}/{i}": c for nid, q in df.queues.items()
                  for i, c in q.input_counts.items() if c}
        snap = df.metrics.snapshot(depths)
        snap["fastroute"]["fallback_reasons"] = dict(fastroute.FALLBACKS)
        if df.node_serving:
            snap["serving"] = {nid: dict(s) for nid, s in df.node_serving.items()}
        if df.node_fleet:
            now_ns = time.time_ns()
            snap["fleet"] = {nid: fleet.fleet_gauges(e["digest"], (now_ns - e["recv_wall_ns"]) / 1e9)
                             for nid, e in df.node_fleet.items()}
        if df.history is not None and df.history.slo_targets:
            snap["slo"] = df.history.slo_status()
        if df.log_counts:
            snap["logs"] = {nid: {"errors": c[0], "warns": c[1]}
                            for nid, c in df.log_counts.items()}
        if df.node_trace_drops:
            snap["trace"] = {"drops": dict(df.node_trace_drops)}
        if df.alerts is not None:
            snap["alerts"] = df.alerts.status()
        return snap

    async def _history_sampler(self, df: DataflowState) -> None:
        """Feed the dataflow's history ring on its cadence. A sample that
        raises is logged and the next one is taken."""
        interval = df.history.interval_s
        while True:
            await asyncio.sleep(interval)
            try:
                self.sample_history(df)
            except Exception:
                logger.exception("history sample failed (%s)", df.id)

    def sample_history(self, df: DataflowState) -> None:
        """Take one history sample now (the sampler's tick, the final flush):
        SLO violations and alert transitions become flight instants on this
        daemon's trace track."""
        if df.history is None:
            return
        snap = self.metrics_snapshot(df)
        wall_ns = time.time_ns()
        hlc_ns = self.clock.new_timestamp().physical_ns
        for node, objective, observed, target in df.history.sample(snap, wall_ns, hlc_ns):
            FLIGHT.record("slo_violation", f"{node}:{objective}",
                          f"observed={observed} target={target}", None)
        if df.alerts is not None:
            for ev in df.alerts.evaluate_ring(df.history, wall_ns):
                FLIGHT.record(f"alert_{ev['phase']}", f"{ev['rule']}:{ev['instance']}",
                              f"value={ev['value']} threshold={ev['threshold']}", None)

    def history_snapshot(self, df: DataflowState) -> dict:
        """This machine's history ring, the payload of a
        MetricsHistoryRequest's reply, with its wall and HLC clocks read back
        to back, so that the merge (``metrics_history.merge_history_snapshots``)
        puts every machine's samples on one axis."""
        if df.history is None:
            return {}
        out = df.history.snapshot()
        out["machine_id"] = self.machine_id
        out["hlc_ns"] = self.clock.new_timestamp().physical_ns
        out["wall_ns"] = time.time_ns()
        return out

    def alerts_snapshot(self, df: DataflowState) -> dict:
        """This machine's alert status, the payload of an AlertsRequest's
        reply (states, not samples: no clocks to align)."""
        if df.alerts is None:
            return {}
        out = df.alerts.status()
        out["machine_id"] = self.machine_id
        return out

    def trace_snapshot(self, df: DataflowState) -> dict:
        """This machine's trace, the payload of a TraceRequest's reply: the
        events each node shipped, this daemon's own ring (process-wide, so
        shared by concurrent dataflows), the events the buffers' cap trimmed,
        and the wall and HLC clocks read back to back, so that the merge
        (``tracing.merge_trace_snapshots``) aligns every machine."""
        processes: dict[str, list] = {nid: [list(e) for e in events]
                                      for nid, events in df.node_traces.items()}
        daemon_events = [list(e) for e in FLIGHT.events()]
        if daemon_events:
            processes["(daemon)"] = daemon_events
        out = {
            "machine": self.machine_id,
            "wall_ns": time.time_ns(),
            "hlc_ns": self.clock.new_timestamp().physical_ns,
            "processes": processes,
        }
        if df.node_trace_drops:
            out["dropped_events"] = dict(df.node_trace_drops)
        return out

    def fleet_snapshot(self, df: DataflowState) -> dict:
        """This machine's fleet snapshot, the payload of a FleetRequest's
        reply: each replica's latest digest with its arrival stamp, and this
        machine's wall and HLC clocks read back to back, so that the merge
        (``fleet.merge_fleet_snapshots``) puts every machine's stamps on one
        axis."""
        if not df.node_fleet:
            return {}
        return {
            "machine_id": self.machine_id,
            "hlc_ns": self.clock.new_timestamp().physical_ns,
            "wall_ns": time.time_ns(),
            "replicas": {nid: {**e["digest"], "recv_wall_ns": e["recv_wall_ns"]}
                         for nid, e in df.node_fleet.items()},
        }

    def publish_stdout_line(self, df: DataflowState, node_id: NodeId, output: str,
                            line: str) -> None:
        """Publish a stdout line as an output (``send_stdout_as``): an Arrow
        string array in IPC format, as any other Arrow input."""
        import pyarrow as pa

        from dora_tpu_torch.node.arrow import ipc_serialize

        payload = ipc_serialize(pa.array([line]))
        metadata = Metadata(type_info=TypeInfo(encoding="arrow-ipc", len=len(payload)),
                            parameters={})
        self.send_out(df, str(node_id), output, metadata, InlineData(data=payload))

    # ------------------------------------------------------------------
    # drop tokens
    # ------------------------------------------------------------------

    def _unref_token(self, df: DataflowState, token: str) -> None:
        state = df.tokens.get(token)
        if state is None:
            return
        state.pending -= 1
        if state.pending <= 0:
            del df.tokens[token]
            self._notify_owner(df, state.owner, token)

    def _notify_owner(self, df: DataflowState, owner: str, token: str) -> None:
        if owner == CUSTODY:
            region = df.custody.pop(token, None)
            if region is not None:
                region.close(unlink=True, force=True)
            return
        drop_queue = df.drop_queues.get(owner)
        if drop_queue is not None:
            drop_queue.push(token)

    def take_custody(self, df: DataflowState, sender: str) -> None:
        """The sender has sent its last output (OutputsDone) and waits at
        most its ``DROP_TOKEN_WAIT_S`` for its regions before it unlinks
        them, while a busy receiver may not read its queue for longer. So
        each of its shared-memory payloads still queued here is copied into
        a region of the daemon's own, which lives until its receivers
        release it, and the sender's region is released now."""
        copies: dict[str, SharedMemoryData | None] = {}
        for queue in df.queues.values():
            for entry in queue.entries:
                token = entry.drop_token
                state = df.tokens.get(token) if token is not None else None
                if state is None or state.owner != sender or entry.event is None:
                    continue
                if token not in copies:
                    copies[token] = self._custody_copy(df, entry.event.inner.data)
                copy = copies[token]
                if copy is None:
                    continue  # the sender's region is gone already: as before
                entry.event = Timestamped(inner=dataclasses.replace(entry.event.inner, data=copy),
                                          timestamp=entry.event.timestamp)
                entry.drop_token = copy.drop_token
                df.tokens[copy.drop_token].pending += 1
                self._unref_token(df, token)

    def _custody_copy(self, df: DataflowState, data: SharedMemoryData) -> SharedMemoryData | None:
        """``data``'s bytes in a new region of the daemon's own (owner
        CUSTODY, no receiver yet); None when the region cannot be read."""
        try:
            payload = self._payload_bytes(data)
        except ShmemError:
            return None
        region = ShmemRegion.create(f"dtp-{uuid_mod.uuid4().hex[:16]}", max(data.len, 1))
        with memoryview(region) as view:
            view[:data.len] = payload
        copy = SharedMemoryData(shmem_id=region.name, len=data.len, drop_token=new_drop_token())
        df.custody[copy.drop_token] = region
        df.tokens[copy.drop_token] = TokenState(owner=CUSTODY)
        return copy

    def ack_tokens(self, df: DataflowState, node_id: str, tokens: list[str]) -> None:
        delivered = df.delivered_tokens.get(node_id)
        for token in tokens:
            if delivered is not None:
                delivered.discard(token)
            self._unref_token(df, token)

    # ------------------------------------------------------------------
    # output closing, node exit
    # ------------------------------------------------------------------

    def close_outputs(self, df: DataflowState, node_id: str, outputs: list[str]) -> None:
        """Close outputs: each receiver gets InputClosed, and AllInputsClosed
        after its last open input (a node with a timer keeps its stream); the
        daemons of other machines get their receivers' InputsClosed."""
        remote_closed: dict[str, list[str]] = {}
        for output in outputs:
            oid = OutputId(NodeId(node_id), DataId(output))
            if oid not in df.open_outputs:
                continue
            df.open_outputs.discard(oid)
            for target in df.mappings.get(oid, ()):
                rnode = str(target.node)
                if rnode not in df.local_nodes:
                    remote_closed.setdefault(df.node_machine(rnode), []).append(str(target))
                    continue
                self._close_input(df, rnode, str(target.input))
        if remote_closed and self.inter_daemon_send is not None:
            for machine, inputs in sorted(remote_closed.items()):
                self.inter_daemon_send(df, machine, None, None, None, closed=inputs)

    def close_remote_inputs(self, df: DataflowState, inputs: list[str]) -> None:
        """InputsClosed that another machine's daemon forwarded
        ("<node>/<input>" each)."""
        for s in inputs:
            node, _, input_id = s.partition("/")
            self._close_input(df, node, input_id)

    def _close_input(self, df: DataflowState, rnode: str, input_id: str) -> None:
        open_inputs = df.open_inputs.get(rnode)
        if open_inputs is None or input_id not in open_inputs:
            return
        open_inputs.discard(input_id)
        queue = df.queues.get(rnode)
        if queue is None:
            return
        queue.push(Timestamped(inner=d2n.InputClosed(id=input_id),
                               timestamp=self.clock.new_timestamp()))
        if not open_inputs and not any(str(t.node) == rnode for targets in df.timers.values()
                                       for t in targets):
            queue.push(Timestamped(inner=d2n.AllInputsClosed(),
                                   timestamp=self.clock.new_timestamp()))
            queue.close()

    def handle_node_exit(self, df: DataflowState, node_id: NodeId | str,
                         returncode: int | None, error: str | None = None) -> None:
        nid = str(node_id)
        running = df.running_nodes.get(nid)
        if running is None or running.finished:
            return
        running.finished = True

        if error is not None:
            status = NodeExitStatus(success=False, error=error)
        elif returncode == 0:
            status = NodeExitStatus(success=True, code=0)
        elif returncode is not None and returncode < 0:
            status = NodeExitStatus(success=False, signal=-returncode)
        else:
            status = NodeExitStatus(success=False, code=returncode)

        # Restart policy: decided before any failure bookkeeping, which
        # would cascade the rest of the dataflow, and before the queue
        # closes, which would end its receivers' streams under us.
        if not status.success and self._should_respawn(df, nid):
            attempt = df.respawn_attempts.get(nid, 0) + 1
            df.respawn_attempts[nid] = attempt
            df.respawning.add(nid)
            df.metrics.count_respawn(nid)
            if FLIGHT.enabled:
                FLIGHT.record("node_respawn", nid, attempt)
            logger.warning("node %s/%s failed (%s); respawn attempt %d", df.id, nid,
                           error or f"code {returncode}", attempt)
            asyncio.create_task(self._respawn_node(df, nid, attempt, status))
            return

        self._record_exit_result(df, nid, status)
        if nid in df.pending_nodes:
            df.pending_nodes.discard(nid)
            if not status.success:
                self._local_nodes_ready(df, [nid])
            elif not df.pending_nodes:
                self._local_nodes_ready(df, [])
        self._release_node(df, nid)
        # Outputs close once the node's control connection drained:
        # SendMessages still in the socket at exit must route first.
        asyncio.create_task(self._finalize_node_exit(df, nid))

    def _release_node(self, df: DataflowState, nid: str) -> None:
        """Release what a finished node still held: its queued tokens, the
        tokens delivered to it, its drop queue and replay buffer."""
        queue = df.queues.get(nid)
        if queue is not None:
            queue.release_all_tokens()
            queue.close()
        for token in df.delivered_tokens.pop(nid, set()):
            self._unref_token(df, token)
        drop_queue = df.drop_queues.get(nid)
        if drop_queue is not None:
            drop_queue.close()
        buffer = df.replay_buffers.get(nid)
        if buffer is not None:
            buffer.close()

    def _record_exit_result(self, df: DataflowState, nid: str, status: NodeExitStatus) -> None:
        """Classify an exit (grace_duration / cascading / other) and record
        its NodeResult."""
        if status.success:
            df.node_results[nid] = NodeResult(error=None)
            return
        if nid in df.grace_kills:
            cause = NodeErrorCause(kind="grace_duration")
        elif df.failed_nodes:
            cause = NodeErrorCause(kind="cascading", caused_by_node=df.failed_nodes[0])
        elif df.barrier_error is not None and nid != df.barrier_failed_node:
            cause = NodeErrorCause(kind="cascading", caused_by_node=df.barrier_failed_node)
        else:
            stderr = "\n".join(df.stderr_rings.get(nid, [])) or None
            cause = NodeErrorCause(kind="other", stderr=stderr)
        df.node_results[nid] = NodeResult(error=NodeError(exit_status=status, cause=cause))
        df.failed_nodes.append(nid)

    def _should_respawn(self, df: DataflowState, nid: str) -> bool:
        """A failed node respawns only while the dataflow is otherwise
        healthy: started cleanly, no stop sent, not grace-killed, no other
        node failed, restart budget left."""
        node = df.descriptor.node(nid)
        if node.restart is None:
            return False
        if df.stop_sent or nid in df.grace_kills or df.done.done():
            return False
        if not df.started.is_set() or df.barrier_error is not None or df.failed_nodes:
            return False
        return df.respawn_attempts.get(nid, 0) < node.restart.max_attempts

    async def _respawn_node(self, df: DataflowState, nid: str, attempt: int,
                            status: NodeExitStatus) -> None:
        """Back off, put the un-acked inputs back at the front of the node's
        queue, spawn a new incarnation. A dataflow stopped during the back-off
        records the failure as a plain exit."""
        node = df.descriptor.node(nid)
        policy = node.restart
        delay = min(policy.backoff_base_s * (2 ** (attempt - 1)), policy.backoff_max_s)
        await asyncio.sleep(delay * (0.75 + 0.5 * random.random()))

        if df.stop_sent or df.done.done():
            df.respawning.discard(nid)
            self._record_exit_result(df, nid, status)
            self._release_node(df, nid)
            await self._finalize_node_exit(df, nid)
            return

        df.control_done[nid] = asyncio.Event()
        # The dead incarnation's events loop may be parked in next_batch; the
        # replay below would wake it and hand the entries to a dead
        # connection. Cancel it first (next_batch consumes nothing then).
        stale = df.event_tasks.pop(nid, None)
        if stale is not None and not stale.done():
            stale.cancel()
            try:
                await stale
            except (asyncio.CancelledError, Exception):
                pass

        buffer = df.replay_buffers.get(nid)
        if buffer is not None and len(buffer):
            entries = buffer.drain()
            queue = df.queues.get(nid)
            if queue is not None:
                queue.requeue_front(entries)
            df.metrics.count_replayed(nid, len(entries))
            if FLIGHT.enabled:
                FLIGHT.record("replay_inputs", nid, len(entries))
            logger.info("node %s/%s: replaying %d un-acked input(s) on respawn", df.id, nid,
                        len(entries))

        df.running_nodes[nid] = RunningNode(node_id=nid, dynamic=df.running_nodes[nid].dynamic)
        df.respawning.discard(nid)
        try:
            process = await spawn_mod.spawn_node(self, df, node, self._make_node_config(df, nid))
        except RuntimeError as e:
            self.handle_node_exit(df, nid, None, error=str(e))
            return
        df.running_nodes[nid].process = process

    async def _finalize_node_exit(self, df: DataflowState, nid: str) -> None:
        done = df.control_done.get(nid)
        if done is not None and not done.is_set():
            try:
                await asyncio.wait_for(done.wait(), timeout=2)
            except asyncio.TimeoutError:
                pass
        self.close_outputs(df, nid, [str(o) for o in df.descriptor.node(nid).outputs])
        self._check_dataflow_finished(df)

    def _check_dataflow_finished(self, df: DataflowState) -> None:
        if any((not r.finished or r.node_id in df.respawning) and not r.dynamic
               for r in df.running_nodes.values()):
            return
        for t in df.timer_tasks:
            t.cancel()
        df.timer_tasks.clear()
        if df.history_task is not None:
            df.history_task.cancel()
            df.history_task = None
            # the final sample: the ring serves the archived run's tail
            try:
                self.sample_history(df)
            except Exception:
                logger.exception("final history sample failed (%s)", df.id)
        for queue in df.queues.values():
            queue.release_all_tokens()
            queue.close()
        for region in df.custody.values():
            region.close(unlink=True, force=True)
        df.custody.clear()
        for dq in df.drop_queues.values():
            dq.close()
        for buffer in df.replay_buffers.values():
            buffer.close()
        # Deferred close (never block the loop); Daemon.close() still
        # unlinks synchronously before the process exits.
        for conn in df.shmem_conns:
            conn.close()
        # announced edge channels a SIGKILLed node may have left (nodes
        # unlink their own on close)
        for listeners in df.p2p_listeners.values():
            for name in listeners.values():
                for victim in (name, name + "-a"):  # data and ack channels
                    unlink_region(victim)
        df.p2p_listeners.clear()
        result = DataflowResult(
            uuid=df.id,
            node_results={nid: df.node_results.get(nid, NodeResult(error=None))
                          for nid, r in df.running_nodes.items()
                          if not r.dynamic or nid in df.node_results},
        )
        if not df.done.done():
            df.done.set_result(result)
        if self.coordinator_notify is not None:
            self.coordinator_notify("finished", df, result)

    # ------------------------------------------------------------------
    # stop, reload, migrate
    # ------------------------------------------------------------------

    def stop_dataflow(self, df: DataflowState, grace_s: float | None = None) -> None:
        """STOP to every running node; whatever still runs after the grace
        period is killed."""
        if df.stop_sent:
            return
        df.stop_sent = True
        if not df.started.is_set():
            self._release_barrier(df, error="dataflow stopped before start")
        for nid, queue in df.queues.items():
            running = df.running_nodes.get(nid)
            if running is not None and running.finished:
                continue
            queue.push(Timestamped(inner=d2n.Stop(), timestamp=self.clock.new_timestamp()))
            queue.close()
        asyncio.create_task(self._grace_kill(df, grace_s or DEFAULT_GRACE_S))

    async def _grace_kill(self, df: DataflowState, grace_s: float) -> None:
        await asyncio.sleep(grace_s)
        self._kill_stragglers(df, record_grace=True)

    @staticmethod
    def _kill_stragglers(df: DataflowState, record_grace: bool = False) -> None:
        for nid, running in df.running_nodes.items():
            if running.finished or running.process is None:
                continue
            if record_grace:
                df.grace_kills.add(nid)
            try:
                running.process.kill()
            except ProcessLookupError:
                pass

    def reload_node(self, df: DataflowState, node_id: str, operator_id: str | None) -> None:
        """Queue a RELOAD event for one node (an operator of it, or all)."""
        queue = df.queues.get(node_id)
        if queue is not None:
            queue.push(Timestamped(inner=d2n.Reload(operator_id=operator_id),
                                   timestamp=self.clock.new_timestamp()))

    def migrate_node(self, df: DataflowState, node_id: str, handoff_dir: str) -> None:
        """Queue a MIGRATE event for a serving node: it drains its live
        streams into ``handoff_dir`` at its next window boundary."""
        queue = df.queues.get(node_id)
        if queue is not None:
            queue.push(Timestamped(inner=d2n.Migrate(handoff_dir=handoff_dir),
                                   timestamp=self.clock.new_timestamp()))

    def profile_node(self, df: DataflowState, node_id: str, action: str,
                     seconds: float) -> None:
        """Queue a PROFILE event for a serving node: ``action`` "start" a
        capture of ``seconds``, or "stop" the one running."""
        queue = df.queues.get(node_id)
        if queue is not None:
            queue.push(Timestamped(inner=d2n.Profile(action=action, seconds=seconds),
                                   timestamp=self.clock.new_timestamp()))

    def on_node_log(self, df: DataflowState, node_id: str, level: str, text: str) -> None:
        """A node's log line (stdout or stderr): ERROR and WARN lines are
        counted for the metrics (the ``log-errors`` rule reads them), and the
        line goes to ``log_sink`` if set."""
        if level in ("error", "warn"):
            counts = df.log_counts.get(node_id)
            if counts is None:
                counts = df.log_counts[node_id] = [0, 0]
            counts[0 if level == "error" else 1] += 1
        if self.log_sink is not None:
            self.log_sink(LogMessage(dataflow_id=df.id, level=level, message=text,
                                     node_id=node_id, machine_id=self.machine_id))

    # ------------------------------------------------------------------
    # node-channel listeners
    # ------------------------------------------------------------------

    async def _handle_connection(self, conn: NodeConnection) -> None:
        try:
            frame = await conn.recv()
            if frame is None:
                return
            register = decode_timestamped(frame, self.clock).inner
            if not isinstance(register, n2d.Register):
                await self._reply(conn, d2n.ReplyResult(error="expected Register"))
                return
            error = self._check_register(register)
            await self._reply(conn, d2n.ReplyResult(error=error))
            if error is not None:
                return
            df = self.dataflows[register.dataflow_id]
            if register.channel == n2d.CHANNEL_CONTROL:
                await self._control_loop(df, register.node_id, conn)
            elif register.channel == n2d.CHANNEL_EVENTS:
                await self._events_loop(df, register.node_id, conn)
            elif register.channel == n2d.CHANNEL_DROP:
                await self._drop_loop(df, register.node_id, conn)
        except (ConnectionError, ConnectionClosed):
            pass  # the node went away mid-reply; its exit watcher reports it
        except Exception:
            logger.exception("node connection failed")
        finally:
            conn.close()

    def _check_register(self, register: n2d.Register) -> str | None:
        if PROTOCOL_VERSION.split(".")[:2] != register.protocol_version.split(".")[:2]:
            return (f"incompatible protocol version {register.protocol_version} "
                    f"(daemon speaks {PROTOCOL_VERSION})")
        df = self.dataflows.get(register.dataflow_id)
        if df is None:
            return f"unknown dataflow {register.dataflow_id!r}"
        if register.node_id not in df.queues:
            return f"unknown node {register.node_id!r} on this machine"
        return None

    async def _reply(self, conn: NodeConnection, msg: Any) -> None:
        await conn.send(encode_timestamped(msg, self.clock))

    async def _control_loop(self, df: DataflowState, node_id: str, conn) -> None:
        try:
            while True:
                frame = await conn.recv()
                if frame is None:
                    return
                # Inline SendMessage frames route as wire bytes; anything
                # the fast path cannot prove routable is decoded below.
                fast = fastroute.parse_send_message(frame)
                if fast is not None:
                    # clock first: the routed events' timestamps follow the sender's
                    self.clock.update_with_timestamp(fast.timestamp)
                    if self.send_out_wire(df, node_id, fast):
                        df.metrics.fastroute_hits += 1
                        continue
                    # a receiver on another machine: decoded and routed below
                tsd = decode_timestamped(frame, self.clock)
                await self._control_request(df, node_id, conn, tsd.inner,
                                            tsd.timestamp.physical_ns)
        finally:
            done = df.control_done.get(node_id)
            if done is not None:
                done.set()

    async def _control_request(self, df: DataflowState, node_id: str, conn, msg,
                               send_ns: int) -> None:
        if isinstance(msg, n2d.SendMessage):
            df.metrics.fastroute_fallbacks += 1
            self.send_out(df, node_id, msg.output_id, msg.metadata, msg.data, send_ns=send_ns)
        elif isinstance(msg, n2d.ReportDropTokens):
            self.ack_tokens(df, node_id, msg.drop_tokens)
        elif isinstance(msg, n2d.ReportServing):
            df.node_serving[node_id] = msg.snapshot
        elif isinstance(msg, n2d.ReportEngineState):
            df.node_fleet[node_id] = {"digest": fleet.digest_as_dict(msg.digest),
                                      "recv_wall_ns": time.time_ns()}
        elif isinstance(msg, n2d.ReportTrace):
            _extend_trace_buffer(df, node_id, msg.events)
        elif isinstance(msg, n2d.ReportProfile):
            if self.profile_sink is not None:
                self.profile_sink(df.id, node_id, msg.artifact, msg.error)
        elif isinstance(msg, n2d.P2PAnnounce):
            df.p2p_listeners[node_id] = dict(msg.listeners)
            await self._reply(conn, d2n.ReplyResult())
        elif isinstance(msg, n2d.P2PEdgesRequest):
            await self._reply(conn, self._p2p_edges_reply(df, node_id))
        elif isinstance(msg, n2d.CloseOutputs):
            self.close_outputs(df, node_id, msg.outputs)
            await self._reply(conn, d2n.ReplyResult())
        elif isinstance(msg, n2d.OutputsDone):
            self.take_custody(df, node_id)
            # The send_stdout_as output is published by the stdout pump; it
            # closes when the node's exit is finalized, after the pump
            # drained, so the node's last lines are not lost.
            node = df.descriptor.node(node_id)
            self.close_outputs(df, node_id, [str(o) for o in node.outputs
                                             if str(o) != node.send_stdout_as])
            await self._reply(conn, d2n.ReplyResult())
        else:
            await self._reply(conn, d2n.ReplyResult(
                error=f"unexpected control request {type(msg).__name__}"))

    async def _events_loop(self, df: DataflowState, node_id: str, conn) -> None:
        frame = await conn.recv()
        if frame is None:
            return
        msg = decode_timestamped(frame, self.clock).inner
        if not isinstance(msg, n2d.Subscribe):
            await self._reply(conn, d2n.ReplyResult(error="expected Subscribe"))
            return
        # The start barrier: the reply waits until every node subscribed.
        self._node_subscribed(df, node_id)
        await df.started.wait()
        await self._reply(conn, d2n.ReplyResult(error=df.barrier_error))
        if df.barrier_error is not None:
            return

        queue = df.queues[node_id]
        delivered = df.delivered_tokens.setdefault(node_id, set())
        replay = df.replay_buffers.get(node_id)
        df.event_tasks[node_id] = asyncio.current_task()
        first_poll = True
        while True:
            frame = await conn.recv()
            if frame is None:
                return
            msg = decode_timestamped(frame, self.clock).inner
            if isinstance(msg, n2d.NextEvent):
                self.ack_tokens(df, node_id, msg.drop_tokens)
                if replay is not None and not first_poll:
                    # A poll acks the batch before it, on this connection
                    # only: a new incarnation's first poll consumed nothing.
                    replay.ack()
                first_poll = False
                batch = await queue.next_batch()
                if replay is not None:
                    replay.remember(batch)
                wires = []
                deliver_ns = time.time_ns()
                for entry in batch:
                    if entry.drop_token is not None:
                        delivered.add(entry.drop_token)
                    if entry.send_ns and entry.input_id is not None:
                        df.metrics.observe_latency(node_id, entry.input_id,
                                                   (deliver_ns - entry.send_ns) / 1000.0)
                        if TRACING.active:
                            # queue wait included; no context (the wire path
                            # never decodes metadata at delivery)
                            FLIGHT.record("t_deliver", f"{node_id}/{entry.input_id}", None,
                                          max(0, deliver_ns - entry.send_ns))
                    wires.append(entry.wire if entry.wire is not None else encode(entry.event))
                await conn.send(fastroute.build_next_events_frame(
                    wires, self.clock.new_timestamp()))
            elif isinstance(msg, n2d.EventStreamDropped):
                queue.release_all_tokens()
                queue.close()
                await self._reply(conn, d2n.ReplyResult())
            else:
                await self._reply(conn, d2n.ReplyResult(
                    error=f"unexpected event request {type(msg).__name__}"))

    async def _drop_loop(self, df: DataflowState, node_id: str, conn) -> None:
        frame = await conn.recv()
        if frame is None:
            return
        msg = decode_timestamped(frame, self.clock).inner
        if not isinstance(msg, n2d.SubscribeDrop):
            await self._reply(conn, d2n.ReplyResult(error="expected SubscribeDrop"))
            return
        await self._reply(conn, d2n.ReplyResult())
        drop_queue = df.drop_queues[node_id]
        while True:
            frame = await conn.recv()
            if frame is None:
                return
            msg = decode_timestamped(frame, self.clock).inner
            if isinstance(msg, n2d.NextDropEvents):
                tokens = await drop_queue.next_batch()
                await self._reply(conn, d2n.DropEvents(drop_tokens=tokens))
            elif isinstance(msg, n2d.ReportDropTokens):
                self.ack_tokens(df, node_id, msg.drop_tokens)
            else:
                await self._reply(conn, d2n.ReplyResult(
                    error=f"unexpected drop request {type(msg).__name__}"))

    # ------------------------------------------------------------------
    # dynamic-node bootstrap
    # ------------------------------------------------------------------

    async def _handle_dynamic_client(self, reader, writer) -> None:
        from dora_tpu_torch.transport.framing import recv_frame_async, send_frame_async

        try:
            msg = decode_timestamped(await recv_frame_async(reader), self.clock).inner
            if not isinstance(msg, n2d.NodeConfigRequest):
                reply = d2n.NodeConfigReply(error="expected NodeConfigRequest")
            else:
                reply = self._dynamic_node_config(msg.node_id)
            await send_frame_async(writer, encode_timestamped(reply, self.clock))
        except Exception:
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    def _dynamic_node_config(self, node_id: str) -> d2n.NodeConfigReply:
        matches = [df for df in self.dataflows.values()
                   if (r := df.running_nodes.get(node_id)) is not None and r.dynamic
                   and not r.finished]
        if not matches:
            return d2n.NodeConfigReply(
                error=f"no running dataflow has a dynamic node {node_id!r}")
        if len(matches) > 1:
            return d2n.NodeConfigReply(
                error=f"multiple running dataflows have a dynamic node {node_id!r}; "
                      "cannot disambiguate")
        return d2n.NodeConfigReply(node_config=self._make_node_config(matches[0], node_id))


# ---------------------------------------------------------------------------
# standalone mode
# ---------------------------------------------------------------------------


async def run_dataflow_async(dataflow: str | Path | Descriptor,
                             working_dir: str | Path | None = None,
                             local_comm: str | None = None,
                             timeout_s: float | None = None,
                             stop_after_s: float | None = None) -> DataflowResult:
    """Run one dataflow to completion with an in-process daemon, every node
    on this machine whatever its ``deploy.machine``.

    ``dataflow`` is a YAML path or a parsed :class:`Descriptor`.
    ``local_comm`` None takes the descriptor's ``communication: {local:
    tcp | uds | shmem}`` (tcp without one); a string overrides it.
    ``stop_after_s`` sends STOP that long after the start barrier opened (a
    dataflow with timers runs until stopped); ``timeout_s`` gives up."""
    if isinstance(dataflow, Descriptor):
        descriptor = dataflow
        working_dir = Path(working_dir or Path.cwd())
    else:
        path = Path(dataflow)
        descriptor = Descriptor.read(path)
        working_dir = Path(working_dir or path.parent)
    descriptor.check(working_dir)
    if local_comm is None:
        local_comm = descriptor.communication.local.kind

    daemon = Daemon(local_comm=local_comm)
    await daemon.start()
    try:
        df = await daemon.spawn_dataflow(descriptor, working_dir=working_dir,
                                         local_nodes={str(n.id) for n in descriptor.nodes})
        if any(r.dynamic for r in df.running_nodes.values()):
            logger.warning("dataflow %s: dynamic nodes connect to 127.0.0.1:%d "
                           "(DORA_DAEMON_ADDR)", df.id, daemon.dynamic_port)
        if stop_after_s is not None:
            asyncio.create_task(_stop_after(daemon, df, stop_after_s))
        if timeout_s is not None:
            return await asyncio.wait_for(asyncio.shield(df.done), timeout_s)
        return await df.done
    finally:
        await daemon.close()


async def _stop_after(daemon: Daemon, df: DataflowState, seconds: float) -> None:
    await df.started.wait()
    try:
        await asyncio.wait_for(asyncio.shield(df.done), seconds)
    except asyncio.TimeoutError:
        daemon.stop_dataflow(df)


def run_dataflow(dataflow: str | Path | Descriptor, working_dir: str | Path | None = None,
                 local_comm: str | None = None, timeout_s: float | None = None,
                 stop_after_s: float | None = None) -> DataflowResult:
    return asyncio.run(run_dataflow_async(dataflow, working_dir, local_comm, timeout_s,
                                          stop_after_s))
