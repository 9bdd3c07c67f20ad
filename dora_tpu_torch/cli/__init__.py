"""The port's command line, its local subset (dora_tpu/cli/main.py's
``check`` and ``daemon --run-dataflow``): ``python -m dora_tpu_torch.cli
check <dataflow.yml>`` and ``python -m dora_tpu_torch.cli run
<dataflow.yml>``. The control commands (up, start, stop, list, logs,
metrics) need the coordinator, which is not ported."""
