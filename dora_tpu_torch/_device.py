"""Device resolution: CUDA by default, never a silent fall back to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means ``"cuda"``. A CUDA device without a usable card raises:
    a caller who wants the CPU (the tests) says ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dora_tpu_torch: CUDA is not available; pass device='cpu' to "
            "run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"dora_tpu_torch runs on cuda or cpu, not {dev}")
    return dev


def compute_dtype(device: str | torch.device) -> torch.dtype:
    """bf16 on the card, f32 on the CPU (dora_tpu/models/layers.py's rule)."""
    return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
