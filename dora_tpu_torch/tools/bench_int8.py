"""Kernel 7 (``int8_matmul``) against a bf16 product on decode shapes:
counterpart of dora_tpu/tools/bench_int8.py.

For each shape M x K x N one JSON line: the bf16 product ``torch.matmul``
(the JAX tool's own yardstick) and the int8 kernel, each in microseconds a
call of device time (``--iters`` calls captured in one CUDA graph and
replayed, timed with CUDA events: the JAX tool's on-device chain), the
weight bytes each reads a call over that time in GB/s, the speedup, the
same calls back to back without a graph (``*_eager_us``: host time
included, what an eager path pays), and the kernel's relative RMS distance
from its plain version on the same inputs. Each call reads the next of
enough weight copies to fill 128 MB, so weights come from HBM as a decode
layer finds them, not from the 50 MB L2. Lines carry ``device`` (the
card's name and power limit), ``launches`` (a graph's captured calls
counted once) and ``plain_calls``.

Usage::

    python -m dora_tpu_torch.tools.bench_int8 [--device cpu]
        [--shapes 16x1536x8960,...] [--iters N]

Runs on the card (cuda) unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys

#: launches a timing averages over
ITERS = 1024
#: the decode shapes: ffn up, ffn down, attention q/o, lm_head
SHAPES = ((16, 1536, 8960), (16, 8960, 1536), (16, 1536, 1536), (16, 1536, 152064))
#: the weight copies a timing cycles through fill this many bytes (> L2)
COLD_BYTES = 128e6


def inputs(m: int, k: int, n: int, dev, seed: int = 0):
    """(x [M, K] bf16, q [K, N] int8, scale [1, N] f32, w [K, N] bf16): a
    normal x and weight from ``seed``, the weight quantized per column."""
    import torch

    from dora_tpu_torch.ops.int8_matmul import quantize_int8

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((k, n), generator=gen, device=dev)
    wq = quantize_int8(w)
    return x, wq["int8"], wq["scale"], w.to(torch.bfloat16)


def bench_shape(m: int, k: int, n: int, dev, device: str, iters: int = ITERS) -> dict:
    import math

    import torch

    from dora_tpu_torch.ops import int8_matmul as IM
    from dora_tpu_torch.tools._common import KernelCounters, graph_ms, time_ms

    x, q, s, w16 = inputs(m, k, n, dev)
    want = IM.int8_matmul_plain(x, q, s).float()
    copies = 1  # the CPU has no card cache to defeat
    if dev.type == "cuda":
        copies = max(1, min(iters + 3, math.ceil(COLD_BYTES / (k * n))))
    qs = [q] + [q.clone() for _ in range(copies - 1)]
    ws = [w16] + [w16.clone() for _ in range(copies - 1)]
    turn = [0]

    def bf16():
        turn[0] += 1
        return torch.matmul(x, ws[turn[0] % copies])

    def int8():
        turn[0] += 1
        return IM.int8_matmul(x, qs[turn[0] % copies], s)

    with KernelCounters() as counters:
        got = IM.int8_matmul(x, q, s).float()
        t16 = graph_ms(bf16, dev, iters) * 1e-3
        t8 = graph_ms(int8, dev, iters) * 1e-3
        e16 = time_ms(bf16, dev, iters) * 1e-3
        e8 = time_ms(int8, dev, iters) * 1e-3
    rel_rms = float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
    return {
        "device": device,
        "shape": [m, k, n],
        "bf16_us": round(t16 * 1e6, 2),
        "bf16_gbs": round(k * n * 2 / t16 / 1e9, 1),
        "int8_us": round(t8 * 1e6, 2),
        "int8_gbs": round(k * n / t8 / 1e9, 1),
        "speedup": round(t16 / t8, 3),
        "bf16_eager_us": round(e16 * 1e6, 2),
        "int8_eager_us": round(e8 * 1e6, 2),
        "rel_rms": rel_rms,
        "weight_copies": copies,
        "iters": iters,
        **counters.report(),
    }


def _shape(text: str) -> tuple[int, int, int]:
    m, k, n = (int(v) for v in text.lower().split("x"))
    return m, k, n


def main(argv=None) -> int:
    from dora_tpu_torch._device import resolve_device
    from dora_tpu_torch.tools._common import device_field

    ap = argparse.ArgumentParser(description="int8_matmul against a bf16 product")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--shapes", default=None, help="MxKxN,... (default: the decode shapes)")
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    device = device_field(dev)
    shapes = [_shape(t) for t in args.shapes.split(",")] if args.shapes else SHAPES
    for m, k, n in shapes:
        print(json.dumps(bench_shape(m, k, n, dev, device, args.iters)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
