"""What the port's measurement tools share: the device field of their JSON
lines, the kernels' launch and plain-call counters, and CUDA-event timing."""

from __future__ import annotations

import subprocess
import time

import torch


def device_field(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, or ``"cpu"``."""
    if dev.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    lines = out.splitlines()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index < len(lines):
        return lines[index].strip()
    return f"{torch.cuda.get_device_name(dev)}, power limit not read"


class KernelCounters:
    """Launches of the hand-written kernels and calls of their plain versions
    while the context is open (the wrappers' ``launches`` counters, reset on
    entry; each ``*_plain`` function counted by a wrapper installed in its
    module and removed on exit). On the card every model leg must show
    launches and no plain call; on the CPU every wrapper runs its plain
    version."""

    def __init__(self):
        from dora_tpu_torch.ops import decode_block as DB
        from dora_tpu_torch.ops import flash_attention as FA
        from dora_tpu_torch.ops import int8_matmul as IM
        from dora_tpu_torch.ops import lora as LO

        self._mods = (DB, LO, IM, FA)
        self._plain = [(DB, f"{fn.__name__}_plain") for fn in DB.KERNELS]
        self._plain += [(LO, "lora_gather_matmul_plain"), (IM, "int8_matmul_plain"),
                        (FA, "flash_attention_plain")]
        self._saved: list = []
        self.plain_calls = 0

    def __enter__(self) -> "KernelCounters":
        for mod in self._mods:
            mod.reset_launches()
        for mod, name in self._plain:
            fn = getattr(mod, name)
            self._saved.append((mod, name, fn))
            setattr(mod, name, self._counting(fn))
        return self

    def __exit__(self, *exc) -> None:
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        self._saved.clear()

    def _counting(self, fn):
        def run(*args, **kwargs):
            self.plain_calls += 1
            return fn(*args, **kwargs)
        return run

    def launches(self) -> dict[str, int]:
        """Nonzero launches by kernel (int8-KV and int4 forms apart)."""
        DB, LO, IM, FA = self._mods
        counts = {**DB.launch_counts(), "lora_gather_matmul": LO.lora_gather_matmul.launches,
                  "int8_matmul": IM.int8_matmul.launches,
                  "flash_attention": FA.flash_attention.launches}
        return {name: n for name, n in counts.items() if n}

    def report(self) -> dict:
        return {"launches": self.launches(), "plain_calls": self.plain_calls}


def time_ms(fn, dev: torch.device, iters: int, warmup: int = 3) -> float:
    """Milliseconds a call of ``fn``: on the card CUDA events around
    ``iters`` calls after ``warmup`` calls, synchronized; on the CPU the
    host clock around the same calls."""
    for _ in range(warmup):
        fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sync(dev: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def graph_ms(fn, dev: torch.device, iters: int, warmup: int = 3, replays: int = 3) -> float:
    """Device milliseconds a call of ``fn``: ``iters`` calls captured in one
    CUDA graph (the counterpart of the JAX tools' on-device chain of
    iterations: no host time between the calls), the graph replayed and
    timed with CUDA events. A wrapper's launch counter sees the captured
    calls once. On the CPU: :func:`time_ms`."""
    if dev.type != "cuda":
        return time_ms(fn, dev, iters, warmup)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return time_ms(graph.replay, dev, replays, warmup=1) / iters
