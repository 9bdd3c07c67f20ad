"""The node wire of the port: the messages a node sends to and receives from
its daemon, in the codec of dora_tpu/message (msgpack, a tagged-union
envelope, every top-level message inside a ``Timestamped`` HLC envelope).

The node <-> daemon pair is copied (``node_to_daemon``, ``daemon_to_node``,
the shared ``common`` types, and the daemon's wire fast path
``fastroute``), so either package's node runs under either daemon; so are
the control plane's (``coordinator``: CLI, coordinator, daemon and the links
between daemons), so either package's cluster tier talks to the other's."""

from dora_tpu_torch.message.serde import (  # noqa: F401
    Timestamped,
    decode,
    decode_timestamped,
    encode,
    encode_timestamped,
    message,
)
