"""node -> daemon requests: the port's copy of
dora_tpu/message/node_to_daemon.py (what its node sends, and what its
daemon receives from any node), with the reply-expectation matrix (the
fire-and-forget kinds get no reply)."""

from __future__ import annotations

from typing import Any

from dora_tpu_torch.message.common import EngineStateDigest, Metadata
from dora_tpu_torch.message.serde import message

#: channel kinds a node opens to its daemon
CHANNEL_CONTROL = "control"
CHANNEL_EVENTS = "events"
CHANNEL_DROP = "drop"


@message
class Register:
    """First message on every node channel; the daemon checks the protocol
    version and replies ReplyResult. ``channel`` names which of the three
    per-node channels this connection carries."""

    dataflow_id: str
    node_id: str
    protocol_version: str
    channel: str = CHANNEL_CONTROL


@message
class Subscribe:
    """Subscribe to the event stream; the reply waits for every node of the
    dataflow (the start barrier)."""


@message
class SubscribeDrop:
    """Subscribe to the drop stream (our regions no receiver references)."""


@message
class SendMessage:
    """Publish one output. No reply."""

    output_id: str
    metadata: Metadata
    data: Any  # InlineData | SharedMemoryData | None


@message
class CloseOutputs:
    """Close some outputs before the node ends."""

    outputs: list[str]


@message
class OutputsDone:
    """All outputs closed; sent on node close."""


@message
class NextEvent:
    """Blocking poll for the next batch of events, with acknowledged drop
    tokens piggybacked."""

    drop_tokens: list[str]


@message
class ReportDropTokens:
    """Out-of-band drop-token ack. No reply."""

    drop_tokens: list[str]


@message
class ReportTrace:
    """A chunk of the node's flight-recorder ring, each event a 6-slot
    ``[monotonic_ns, wall_ns, kind, a, b, c]``. No reply."""

    events: list[list[Any]]


@message
class ReportServing:
    """The serving node's ServingMetrics snapshot. No reply."""

    snapshot: dict[str, Any]


@message
class ReportEngineState:
    """The serving node's fleet digest. No reply."""

    digest: EngineStateDigest


@message
class ReportProfile:
    """A deep capture's artifact path (or its failure). No reply."""

    artifact: str
    error: str | None = None


@message
class NextDropEvents:
    """Blocking poll on the drop channel for released drop tokens."""


@message
class EventStreamDropped:
    """The node closed its event stream; the daemon stops queueing inputs."""


@message
class NodeConfigRequest:
    """Dynamic-node bootstrap: sent to the daemon's local listen port."""

    node_id: str


@message
class P2PAnnounce:
    """Peer-to-peer listeners a node announces before subscribing: input id
    -> the shared-memory channel the node already serves for it. The
    announcement also marks the node as a peer-to-peer sender; at barrier
    release the daemon pairs the edges of announced endpoints and stops
    routing those edges itself."""

    listeners: dict[str, str]


@message
class P2PEdgesRequest:
    """After the start barrier: which of my outputs go peer-to-peer, and
    where. Reply: daemon_to_node.P2PEdgesReply."""


def expects_reply(request: Any) -> bool:
    return not isinstance(
        request,
        (SendMessage, ReportDropTokens, ReportTrace, ReportServing,
         ReportEngineState, ReportProfile),
    )
