"""Transformer primitives the serving path needs, on torch tensors.

Counterpart of the matching functions of dora_tpu/models/layers.py:
``compute_dtype`` (bf16 on the card, f32 on the CPU), the f32 rotary
tables and RMSNorm with f32 statistics.
"""

from __future__ import annotations

import torch

from dora_tpu_torch._device import compute_dtype, resolve_device

__all__ = ["compute_dtype", "rms_norm", "rope_table"]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * weight.float()).to(dtype)


def rope_table(max_len: int, head_dim: int, base: float = 10000.0,
               device: str | torch.device | None = None):
    """(cos, sin) tables [max_len, head_dim/2] in float32."""
    device = resolve_device(device)
    inv_freq = 1.0 / base ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    )
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)
