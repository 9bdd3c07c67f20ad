"""The port's command line (dora_tpu/cli/main.py's local and cluster
commands): ``python -m dora_tpu_torch.cli check | run`` on this machine,
and ``up``, ``coordinator``, ``daemon``, ``start``, ``stop``, ``list``,
``logs``, ``metrics``, ``migrate``, ``destroy`` on a cluster (see
``main.py``)."""
