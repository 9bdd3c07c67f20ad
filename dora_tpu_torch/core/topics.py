"""Well-known ports and limits (dora_tpu/core/topics.py)."""

#: each daemon listens here for dynamic-node connections on its machine
DORA_DAEMON_LOCAL_LISTEN_PORT_DEFAULT = 53291

#: outputs this large or larger travel in shared memory, not inline
ZERO_COPY_THRESHOLD = 4096
