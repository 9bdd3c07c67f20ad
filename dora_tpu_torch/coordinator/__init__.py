"""The control-plane coordinator, one a cluster (dora_tpu/coordinator/).

It keeps the daemons that registered, by machine id, and the dataflows'
life across machines: it hands each machine its nodes, gathers every
machine's ``ReadyOnMachine`` into one ``AllNodesReady`` and every machine's
``AllNodesFinished`` into the dataflow's result, proxies stop, reload,
migrate, logs, metrics and fleet queries, and drops a daemon silent for 30
s. ``Coordinator.handle_control_request`` is callable in-process, so tests
drive the whole life of a dataflow without the control socket.
"""

from dora_tpu_torch.coordinator.core import Coordinator

__all__ = ["Coordinator"]
