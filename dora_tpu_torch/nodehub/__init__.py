"""See the package docstring of dora_tpu_torch."""
