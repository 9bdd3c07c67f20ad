"""VLM benchmarks on the port: counterpart of the repository root's bench_vlm.py.

Modes, each printing one JSON line a metric (``metric``, ``value``,
``unit`` and the JAX mode's extra keys, ``backend`` as ``device``: the
card's name and power limit, or ``"cpu"``), then one line of the kernels'
launches and plain-version calls over the mode:

* ``model``: ``VLMConfig.bench_2b`` (a 32-layer ViT 1280 wide and a
  Qwen2-1.5B-shaped LM) with seeded random weights, resident in bf16 on the
  card; ``DORA_INT8_DECODE`` or ``DORA_INT4_DECODE`` quantizes the LM blocks
  and head (the fused decode kernels then run). Prefill ms, decode
  tokens/s, MBU and MFU against the card's data-sheet peaks
  (``profiling.detect_peak_flops``, ``detect_peak_hbm_bytes``; null where
  the card is unknown or on the CPU), single-stream FPS, and with
  ``DORA_SPEC_DECODE`` speculative decode. ``BENCH_MAX_NEW`` new tokens
  (64).
* ``batch``: batched fused decode (``vlm.decode_batch_fused``, one LM weight
  stream for every row) at batches 1, 4 and 8, int8 weights unless
  ``DORA_INT4_DECODE``; each batch's decode is the port's own step loop,
  timed on the host clock ending in a synchronize.
* ``e2e``: the camera -> VLM -> counting sink dataflow through the port's
  own daemon (``dora_tpu_torch.daemon.run_dataflow``): ``BENCH_FRAMES``
  seeded frames (100) at 20 ms, at the model's image size, the VLM (``--size``) in the port's runtime
  node with ``BENCH_MAX_NEW`` new tokens a frame (4), its image sampled
  latest-wins. Frames a second at the sink after five warmup outputs, the
  p50 gap, the best 50-output window, and the launch line of the VLM node's
  process (``tools/counted.py``).

MFU counts analytic matmul FLOPs (weights 2 m n a token, attention 4 T dim a
layer; embedding gathers and norms left out: a lower bound). Times are CUDA
events or host clocks that end in ``torch.cuda.synchronize()``.

Usage::

    python -m dora_tpu_torch.tools.bench_vlm [model | batch | e2e]
        [--device cpu] [--size bench | tiny]

Runs on the card (cuda) unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def _emit(metric: str, value, unit: str, **extra) -> None:
    print(json.dumps({"metric": metric, "value": None if value is None else round(value, 3),
                      "unit": unit, **extra}), flush=True)


# ---------------------------------------------------------------------------
# analytic FLOPs (a lower bound: matmuls only)
# ---------------------------------------------------------------------------


def lm_matmul_flops_per_token(cfg) -> float:
    """Weight-matmul FLOPs for one LM token (no attention scores)."""
    hd = cfg.head_dim
    per_layer = 2 * (
        cfg.dim * cfg.heads * hd           # wq
        + 2 * cfg.dim * cfg.kv_heads * hd  # wk, wv
        + cfg.heads * hd * cfg.dim         # wo
        + 3 * cfg.dim * cfg.ffn            # gate, up, down
    )
    return cfg.layers * per_layer + 2 * cfg.dim * cfg.vocab  # + lm_head


def lm_attention_flops(cfg, context: int) -> float:
    """Score + value FLOPs for one token attending over ``context`` keys."""
    return cfg.layers * 4.0 * context * cfg.dim


def vision_matmul_flops(cfg) -> float:
    """Vision tower FLOPs for one image (all patches)."""
    p = cfg.n_patches
    patch_dim = cfg.patch_size * cfg.patch_size * 3
    per_layer = 2 * (4 * cfg.vision_dim**2 + 3 * cfg.vision_dim * cfg.vision_ffn)
    attn = 4.0 * p * cfg.vision_dim  # per patch, full self-attention
    return p * (
        2 * patch_dim * cfg.vision_dim
        + cfg.vision_layers * per_layer
        + cfg.vision_layers * attn
        + 2 * cfg.vision_dim * cfg.dim
    )


# ---------------------------------------------------------------------------
# the modes
# ---------------------------------------------------------------------------


def _config(size: str):
    from dora_tpu_torch.models import vlm

    return {"bench": vlm.VLMConfig.bench_2b, "tiny": vlm.VLMConfig.tiny}[size]()


def _resident(params, dev):
    """Float leaves in the device's compute dtype (bf16 on the card), as
    the JAX mode keeps its serving weights."""
    from dora_tpu_torch._device import compute_dtype

    if isinstance(params, dict):
        return {k: _resident(v, dev) for k, v in params.items()}
    return params.to(compute_dtype(dev)) if params.is_floating_point() else params


def _launch_line(prefix: str, device: str, counters) -> None:
    report = counters.report()
    _emit(f"{prefix} kernel launches", sum(report["launches"].values()), "launches",
          device=device, **report)


def bench_model(dev, device: str, size: str = "bench", max_new: int = 64,
                prefill_iters: int = 16, generate_iters: int = 4) -> dict:
    import torch

    from dora_tpu_torch import profiling
    from dora_tpu_torch.models import vlm
    from dora_tpu_torch.tools._common import KernelCounters, sync, time_ms

    cfg = _config(size)
    prefix = f"vlm-{'2b' if size == 'bench' else size}"
    t0 = time.perf_counter()
    params = _resident(vlm.init_params(cfg, seed=0, device=dev), dev)
    int8 = bool(os.environ.get("DORA_INT8_DECODE"))
    int4 = bool(os.environ.get("DORA_INT4_DECODE"))
    if int8 or int4:
        params = vlm.quantize_decode(params)
    n_params = vlm.param_count(params)
    sync(dev)
    print(f"# {n_params / 1e9:.2f}B params in {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    image = torch.zeros((1, cfg.image_size, cfg.image_size, 3), device=dev)
    prompt = (torch.arange(16, dtype=torch.int32, device=dev)[None] % cfg.vocab)
    spec = bool(os.environ.get("DORA_SPEC_DECODE"))
    with KernelCounters() as counters:
        prefill_s = time_ms(lambda: vlm.prefill(params, cfg, image, prompt), dev,
                            prefill_iters, warmup=1) * 1e-3
        generate_s = time_ms(lambda: vlm.generate(params, cfg, image, prompt, max_new), dev,
                             generate_iters, warmup=1) * 1e-3
        spec_s = spec_passes = None
        if spec:
            def spec_once() -> int:
                _, passes = vlm.generate_speculative(params, cfg, image, prompt, max_new)
                sync(dev)
                return int(passes)

            spec_passes = spec_once()  # warmup and the pass count
            samples = []
            for _ in range(3):
                t = time.perf_counter()
                spec_once()
                samples.append(time.perf_counter() - t)
            spec_s = statistics.median(samples)
    decode_s = max(generate_s - prefill_s, 1e-9)
    tokens_per_s = max_new / decode_s

    # FLOPs: prefill runs the image and patches + prompt tokens; each decode
    # token runs the full stack over a growing context.
    prefill_tokens = cfg.n_patches + int(prompt.shape[1])
    per_tok = lm_matmul_flops_per_token(cfg)
    prefill_flops = (vision_matmul_flops(cfg) + prefill_tokens * per_tok
                     + sum(lm_attention_flops(cfg, t) for t in range(1, prefill_tokens + 1)))
    decode_flops = sum(per_tok + lm_attention_flops(cfg, prefill_tokens + i)
                       for i in range(max_new))
    peak = profiling.detect_peak_flops(dev)
    peak_hbm = profiling.detect_peak_hbm_bytes(dev)
    prefill_mfu = prefill_flops / prefill_s / peak if peak else None
    decode_mfu = decode_flops / decode_s / peak if peak else None
    fps = 1.0 / generate_s
    # Batch-1 decode streams the LM weights once a token: MBU (weight bytes
    # a second over the peak memory rate) is its efficiency number.
    bytes_per_param = 0.5 if int4 else (1.0 if int8 else 2.0)
    lm_param_bytes = bytes_per_param * (per_tok / 2)
    decode_mbu = lm_param_bytes * tokens_per_s / peak_hbm if peak_hbm else None

    tag = " int4" if int4 else (" int8" if int8 else "")
    peak_tflops = peak / 1e12 if peak else None
    _emit(f"{prefix} prefill latency", prefill_s * 1e3, "ms", device=device,
          prefill_tokens=prefill_tokens)
    _emit(f"{prefix} decode{tag} throughput", tokens_per_s, "tokens/s", device=device,
          max_new=max_new)
    _emit(f"{prefix} decode{tag} MBU", None if decode_mbu is None else decode_mbu * 100, "%",
          peak_hbm_gbs=peak_hbm / 1e9 if peak_hbm else None, device=device)
    _emit(f"{prefix} decode MFU", None if decode_mfu is None else decode_mfu * 100, "%",
          peak_tflops=peak_tflops, device=device)
    _emit(f"{prefix} prefill MFU", None if prefill_mfu is None else prefill_mfu * 100, "%",
          peak_tflops=peak_tflops, device=device)
    _emit(f"{prefix} single-stream FPS ({max_new} new tokens)", fps, "fps", device=device)
    if spec_s is not None:
        spec_tok_s = max_new / max(spec_s - prefill_s, 1e-9)
        _emit(f"{prefix} speculative decode{tag} throughput", spec_tok_s, "tokens/s",
              model_passes=spec_passes, max_new=max_new,
              note="greedy-exact prompt-lookup speculation", device=device)
    _launch_line(prefix, device, counters)
    return {"fps": fps, "tokens_per_s": tokens_per_s, "decode_mfu": decode_mfu,
            "decode_mbu": decode_mbu, "prefill_ms": prefill_s * 1e3}


def bench_batch(dev, device: str, size: str = "bench", batches=(1, 4, 8), steps: int = 8,
                chains: int = 6) -> dict:
    """Continuous-batching decode throughput: B independent rows through the
    batched fused kernels (``attention_batch_step``), one LM weight stream
    for every row, so aggregate tokens/s should grow nearly linearly in B."""
    import torch

    from dora_tpu_torch.models import vlm
    from dora_tpu_torch.tools._common import KernelCounters, sync

    cfg = _config(size)
    prefix = f"vlm-{'2b' if size == 'bench' else size}"
    t0 = time.perf_counter()
    params = vlm.quantize_decode(vlm.init_params(cfg, seed=0, device=dev))
    sync(dev)
    print(f"# params ready {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    position = min(300, cfg.max_seq - steps)

    results = {}
    base = None
    with KernelCounters() as counters:
        for b in batches:
            caches = vlm.init_cache(cfg, b, device=dev)
            positions = torch.full((b,), position, dtype=torch.int32, device=dev)
            tokens = torch.arange(b, dtype=torch.int32, device=dev) + 5

            def chain(tokens=tokens, caches=caches, positions=positions):
                t, p = tokens, positions
                for _ in range(steps):
                    t, _ = vlm.decode_batch_fused(params, cfg, t, caches, p)
                    p = p + 1
                return t

            chain()  # warmup
            sync(dev)
            t = time.perf_counter()
            for _ in range(chains):
                chain()
            sync(dev)
            per_chain = (time.perf_counter() - t) / chains
            tokps = b * steps / per_chain
            if base is None:
                base = tokps
            results[b] = tokps
            _emit(f"{prefix} batched fused decode (batch {b})", tokps, "tokens/s",
                  per_stream=round(tokps / b, 1), vs_batch1=round(tokps / base, 2),
                  ms_per_step=round(per_chain / steps * 1e3, 2), device=device)
    _launch_line(prefix, device, counters)
    return results


#: the sink of the e2e dataflow: stamps each output, writes fps.json at the end
E2E_SINK = """
import json
import statistics
import time

from dora_tpu_torch.node import Node

stamps = []
with Node() as node:
    for event in node:
        if event["type"] == "INPUT":
            stamps.append(time.perf_counter())
assert len(stamps) >= 2, f"only {len(stamps)} outputs"
# steady state: the first outputs straddle the node's warmup
warmup = min(5, len(stamps) - 2)
window = stamps[warmup:]
fps = (len(window) - 1) / (window[-1] - window[0])
gaps = [b - a for a, b in zip(window, window[1:])]
peak, w = fps, 50
for i in range(max(0, len(window) - w)):
    peak = max(peak, (w - 1) / (window[i + w - 1] - window[i]))
with open("fps.json", "w") as f:
    json.dump({"fps": fps, "outputs": len(stamps), "measured_outputs": len(window),
               "p50_gap_ms": statistics.median(gaps) * 1e3, "peak_window_fps": peak,
               "fps_incl_warmup": (len(stamps) - 1) / (stamps[-1] - stamps[0])}, f)
"""

#: serving levers passed through to the VLM node when set
E2E_KNOBS = ("DORA_INT8_DECODE", "DORA_INT8_PURE", "DORA_INT4_DECODE", "DORA_PIPELINE_DEPTH",
             "DORA_FETCH_EVERY", "DORA_SPEC_DECODE")


def bench_e2e(tmp, dev, device: str, size: str, max_new: int = 4, frames: int = 100) -> dict:
    """camera -> VLM node -> counting sink through the port's daemon."""
    from pathlib import Path

    from dora_tpu_torch.core.descriptor import Descriptor
    from dora_tpu_torch.daemon import run_dataflow
    from dora_tpu_torch.models import vlm

    side = str((vlm.VLMConfig.tiny() if size == "tiny" else vlm.VLMConfig.bench_2b()).image_size)
    tmp = Path(tmp)
    (tmp / "fps_sink.py").write_text(E2E_SINK)
    counts = tmp / "vlm.launches.json"
    desc = Descriptor.parse({"nodes": [
        {"id": "camera", "path": "module:dora_tpu_torch.nodehub.camera",
         "inputs": {"tick": "dora/timer/millis/20"}, "outputs": ["image"],
         "env": {"IMAGE_WIDTH": side, "IMAGE_HEIGHT": side, "MAX_FRAMES": str(frames),
                 "SEED": "0"}},
        {"id": "vlm", "path": "module:dora_tpu_torch.tools.counted",
         "args": f"{counts} dora_tpu_torch.runtime "
                 f"--operator op=dora_tpu_torch.nodehub.ops:make_vlm --device {dev.type}",
         "inputs": {"op/image": {"source": "camera/image", "queue_size": 1}},
         "outputs": ["op/tokens"],
         "env": {"DORA_MODEL_SIZE": size, "DORA_MAX_NEW_TOKENS": str(max_new),
                 **{k: os.environ[k] for k in E2E_KNOBS if k in os.environ}}},
        {"id": "sink", "path": "fps_sink.py", "inputs": {"tokens": "vlm/op/tokens"}},
    ]})
    result = run_dataflow(desc, working_dir=tmp, timeout_s=1800)
    if not result.is_ok():
        raise RuntimeError(f"e2e bench failed: {result.errors()}")
    data = json.loads((tmp / "fps.json").read_text())
    _emit(f"camera->vlm-{size} end-to-end FPS ({max_new} new tokens/frame)", data["fps"], "fps",
          outputs=data["outputs"], measured_outputs=data["measured_outputs"],
          p50_gap_ms=round(data["p50_gap_ms"], 1),
          peak_window_fps=round(data["peak_window_fps"], 1),
          fps_incl_warmup=round(data["fps_incl_warmup"], 3), device=device)
    report = json.loads(counts.read_text())
    _emit(f"camera->vlm-{size} e2e kernel launches", sum(report["launches"].values()),
          "launches", device=device, launches=report["launches"],
          plain_calls=report["plain_calls"])
    return data


def main(argv=None) -> int:
    from dora_tpu_torch._device import resolve_device
    from dora_tpu_torch.tools._common import device_field

    ap = argparse.ArgumentParser(description="VLM benchmarks of the PyTorch/CUDA port")
    ap.add_argument("mode", nargs="?", default="model", choices=("model", "batch", "e2e"))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--size", default="bench", choices=("bench", "tiny"),
                    help="VLMConfig.bench_2b (default) or the test-size tiny config")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    device = device_field(dev)
    if args.mode == "e2e":
        import tempfile

        with tempfile.TemporaryDirectory(prefix="dora-vlm-bench-") as tmp:
            bench_e2e(tmp, dev, device, args.size,
                      max_new=int(os.environ.get("BENCH_MAX_NEW", "4")),
                      frames=int(os.environ.get("BENCH_FRAMES", "100")))
    elif args.mode == "model":
        bench_model(dev, device, args.size, max_new=int(os.environ.get("BENCH_MAX_NEW", "64")))
    else:
        bench_batch(dev, device, args.size)
    return 0


if __name__ == "__main__":
    sys.exit(main())
