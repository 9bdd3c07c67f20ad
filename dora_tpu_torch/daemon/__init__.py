"""The port's local dataflow daemon (dora_tpu/daemon/, its local half).

One daemon in one process runs a dataflow on this machine: it spawns the
nodes, routes their messages over tcp, a Unix socket or shared memory, runs
their timers, respawns a node under a ``restart`` policy and stops the
dataflow. It speaks the node wire of the JAX package byte for byte, so a
node of either package runs under it. It imports neither torch nor jax, and
it never touches the card. A single asyncio loop serves every node channel;
shared-memory channels, whose receive blocks in native code, are pumped by
threads that re-enter the loop.
"""

from dora_tpu_torch.daemon.core import Daemon, run_dataflow, run_dataflow_async

__all__ = ["Daemon", "run_dataflow", "run_dataflow_async"]
