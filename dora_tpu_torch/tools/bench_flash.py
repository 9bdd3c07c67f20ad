"""Kernel 11 (``flash_attention``) at long contexts: counterpart of
dora_tpu/tools/bench_flash.py.

For each sequence length T, attention over (1, 8, T, 128) bf16, causal:
one JSON line with the kernel's milliseconds a call of device time
(``--iters`` calls captured in one CUDA graph and replayed, timed with CUDA
events: the JAX tool's on-device chain) and its TFLOP/s counting the
scores and values products over the live (causal: half) area, the same
calls back to back without a graph (``eager_ms``, host time included), and
``scaled_dot_product_attention`` on the same inputs, timed the same way,
the yardstick the port's tables use (nothing on a path calls it). At the first T the line
also holds the JAX tool's parity check: the kernel's largest absolute
distance from dense attention in f32. Lines carry ``device`` (the card's
name and power limit), ``launches`` and ``plain_calls`` over the kernel's
calls.

Usage::

    python -m dora_tpu_torch.tools.bench_flash [--device cpu]
        [--seq 2048,8192,16384] [--heads 8] [--head-dim 128] [--iters N]

Runs on the card (cuda) unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys

SEQS = (2048, 8192, 16384)
HEADS, HEAD_DIM = 8, 128
ITERS = 8


def inputs(t: int, h: int, d: int, dev, seed: int = 0):
    """q, k, v [1, h, t, d] bf16, normal from ``seed``."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn((1, h, t, d), generator=gen, device=dev).to(torch.bfloat16)
                 for _ in range(3))


def dense_f32(q, k, v, causal: bool):
    """Dense attention in f32: the parity reference."""
    from dora_tpu_torch.models import layers as L

    mask = L.causal_mask(q.shape[2], k.shape[2], device=q.device) if causal else None
    return L.attention(q.float(), k.float(), v.float(), mask)


def bench(t: int, dev, device: str, h: int = HEADS, d: int = HEAD_DIM, causal: bool = True,
          iters: int = ITERS, check_parity: bool = False) -> dict:
    import torch

    from dora_tpu_torch.ops import flash_attention as FA
    from dora_tpu_torch.tools._common import KernelCounters, graph_ms, time_ms

    q, k, v = inputs(t, h, d, dev)
    with KernelCounters() as counters:
        ours = FA.flash_attention(q, k, v, causal=causal)
        ms = graph_ms(lambda: FA.flash_attention(q, k, v, causal=causal), dev, iters)
        eager_ms = time_ms(lambda: FA.flash_attention(q, k, v, causal=causal), dev, iters)
    sdpa_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=causal), dev, iters)
    flops = 4.0 * h * t * t * d * (0.5 if causal else 1.0)
    out = {
        "device": device,
        "t": t,
        "heads": h,
        "head_dim": d,
        "causal": causal,
        "ms": round(ms, 4),
        "tflops": round(flops / (ms * 1e-3) / 1e12, 2),
        "sdpa_ms": round(sdpa_ms, 4),
        "sdpa_tflops": round(flops / (sdpa_ms * 1e-3) / 1e12, 2),
        "eager_ms": round(eager_ms, 4),
        "iters": iters,
    }
    if check_parity:
        ref = dense_f32(q, k, v, causal)
        out["parity_max_abs_err"] = float((ours.float() - ref).abs().max())
    out.update(counters.report())
    return out


def main(argv=None) -> int:
    from dora_tpu_torch._device import resolve_device
    from dora_tpu_torch.tools._common import device_field

    ap = argparse.ArgumentParser(description="flash_attention at long contexts")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--seq", default=None, help="T,... (default 2048,8192,16384)")
    ap.add_argument("--heads", type=int, default=HEADS)
    ap.add_argument("--head-dim", type=int, default=HEAD_DIM)
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    device = device_field(dev)
    seqs = [int(t) for t in args.seq.split(",")] if args.seq else SEQS
    for i, t in enumerate(seqs):
        print(json.dumps(bench(t, dev, device, args.heads, args.head_dim, iters=args.iters,
                               check_parity=i == 0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
