"""The port's measurement tools: counterparts of dora_tpu/tools/bench_serving.py,
bench_int8.py, bench_flash.py and the root bench_vlm.py, each run as
``python -m dora_tpu_torch.tools.<tool>`` and printing JSON lines."""
