"""Socket framing of the node wire (dora_tpu/transport's sync half)."""
