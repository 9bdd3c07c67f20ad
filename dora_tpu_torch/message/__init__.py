"""The node wire of the port: the messages a node sends to and receives from
its daemon, in the codec of dora_tpu/message (msgpack, a tagged-union
envelope, every top-level message inside a ``Timestamped`` HLC envelope).

Only the channel pair a node speaks is copied (``node_to_daemon``,
``daemon_to_node`` and the shared ``common`` types); the daemon and
coordinator pairs stay in the JAX package, whose daemon runs the port's
node unchanged."""

from dora_tpu_torch.message.serde import (  # noqa: F401
    Timestamped,
    decode,
    decode_timestamped,
    encode,
    encode_timestamped,
    message,
)
