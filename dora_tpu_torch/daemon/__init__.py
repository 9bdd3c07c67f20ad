"""The port's dataflow daemon (dora_tpu/daemon/).

One daemon in one process runs a machine's part of its dataflows: it spawns
the nodes, routes their messages over tcp, a Unix socket or shared memory,
runs their timers, respawns a node under a ``restart`` policy and stops the
dataflow. Standalone (``run_dataflow``) it runs every node of a dataflow
here; attached to a coordinator (``Daemon.run``, ``coordinator_conn.py``)
it runs its machine's nodes and forwards outputs to the other machines'
daemons (``inter_daemon.py``). It speaks the node wire of the JAX package byte for byte, so a
node of either package runs under it. It imports neither torch nor jax, and
it never touches the card. A single asyncio loop serves every node channel;
shared-memory channels, whose receive blocks in native code, are pumped by
threads that re-enter the loop.
"""

from dora_tpu_torch.daemon.core import Daemon, run_dataflow, run_dataflow_async

__all__ = ["Daemon", "run_dataflow", "run_dataflow_async"]
