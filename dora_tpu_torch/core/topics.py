"""Well-known ports and limits (dora_tpu/core/topics.py)."""

#: the coordinator listens here for daemon registrations
DORA_COORDINATOR_PORT_DEFAULT = 53290

#: the coordinator listens here for the CLI's control connections
DORA_COORDINATOR_PORT_CONTROL_DEFAULT = 6012

#: each daemon listens here for dynamic-node connections on its machine
DORA_DAEMON_LOCAL_LISTEN_PORT_DEFAULT = 53291

#: outputs this large or larger travel in shared memory, not inline
ZERO_COPY_THRESHOLD = 4096
