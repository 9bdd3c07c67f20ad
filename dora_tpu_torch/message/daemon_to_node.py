"""daemon -> node replies, events and the node's bootstrap config: the
port's copy of the classes of dora_tpu/message/daemon_to_node.py a node
receives, the peer-to-peer edge assignments included."""

from __future__ import annotations

from typing import Any

from dora_tpu_torch.message.common import Metadata
from dora_tpu_torch.message.serde import Timestamped, message


@message
class ReplyResult:
    """Generic ok / error reply."""

    error: str | None = None


@message
class NextEvents:
    """Reply to NextEvent: zero or more timestamped events (an empty list
    means the stream is closed)."""

    events: list[Timestamped]


@message
class NodeConfigReply:
    error: str | None = None
    node_config: Any = None  # NodeConfig


@message
class DropEvents:
    """Reply to NextDropEvents: drop tokens whose shared-memory regions are
    free for the owning node to reuse (empty only on stream close)."""

    drop_tokens: list[str]


@message
class P2PEdge:
    """One peer-to-peer assignment of a sender's output: publish straight
    into ``channel`` (the receiver's shared-memory server) as input
    ``input_id`` of ``receiver``."""

    channel: str
    input_id: str
    receiver: str


@message
class P2POutput:
    """All peer-to-peer edges of one output, and whether the daemon must
    still be sent the output (receivers off peer-to-peer, or on other
    machines)."""

    edges: list[Any]  # list[P2PEdge]
    daemon_route: bool


@message
class P2PEdgesReply:
    """Reply to P2PEdgesRequest: output id -> P2POutput. An output not in
    the map goes through the daemon alone."""

    outputs: dict[str, Any]  # output id -> P2POutput


@message
class Stop:
    pass


@message
class Reload:
    """Hot-reload request for an operator."""

    operator_id: str | None = None


@message
class Migrate:
    """Drain live serving streams into ``handoff_dir`` (a serving engine
    without the checkpoint surface ignores it)."""

    handoff_dir: str


@message
class Profile:
    """Start ("start", for ``seconds``) or stop ("stop") an on-demand deep
    profile capture on a serving node."""

    action: str
    seconds: float = 0.0


@message
class Input:
    id: str
    metadata: Metadata
    data: Any  # InlineData | SharedMemoryData | None


@message
class InputClosed:
    id: str


@message
class AllInputsClosed:
    pass


@message
class TcpCommunication:
    socket_addr: str  # "host:port"


@message
class UnixDomainCommunication:
    socket_file: str


@message
class ShmemCommunication:
    """Shared-memory request-reply regions, one per node channel."""

    control_region_id: str
    events_region_id: str
    drop_region_id: str


@message
class RunConfig:
    """The node's IO signature: input id -> queue size, plus output ids."""

    inputs: dict[str, int]
    outputs: list[str]


@message
class NodeConfig:
    """Injected into node processes through the DORA_NODE_CONFIG env var, or
    fetched over TCP by dynamic nodes."""

    dataflow_id: str
    node_id: str
    run_config: RunConfig
    daemon_communication: Any  # one of the three *Communication kinds
    dataflow_descriptor: dict[str, Any]
    dynamic: bool = False
