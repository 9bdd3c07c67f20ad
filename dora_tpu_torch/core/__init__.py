"""The dataflow graph model (dora_tpu/core/): typed input and communication
config, the YAML descriptor, validation and well-known constants."""
