"""Self-contained voice activity detection (the Silero class), on torch
tensors (dora_tpu/models/vad.py): framed, energy-normalized audio, one
dense feature layer, a GRU over the frames (a host loop; the JAX package
scans it) and a per-chunk speech probability. The GRU's hidden state is
the carry a stream threads from chunk to chunk."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from dora_tpu_torch._device import resolve_device


@dataclass(frozen=True)
class VADConfig:
    sample_rate: int = 16000
    frame: int = 512  # samples per feature frame
    n_features: int = 32
    hidden: int = 64
    threshold: float = 0.5

    @classmethod
    def tiny(cls) -> "VADConfig":
        return cls(frame=128, n_features=8, hidden=16)


def init_params(cfg: VADConfig, *, seed: int = 0, device=None) -> dict:
    """Seeded random f32 parameters on ``device`` (default cuda), with the
    JAX package's shapes and distributions (uniform in +-1/sqrt(d_in), a
    zero GRU bias); ``params_from_jax`` carries the JAX package's."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def dense(i, o):
        s = 1.0 / math.sqrt(i)
        return torch.rand((i, o), generator=gen, device=dev) * (2 * s) - s

    return {
        "feat": dense(cfg.frame, cfg.n_features),
        "gru_xz": dense(cfg.n_features, 3 * cfg.hidden),
        "gru_hz": dense(cfg.hidden, 3 * cfg.hidden),
        "gru_b": torch.zeros((3 * cfg.hidden,), device=dev),
        "out": dense(cfg.hidden, 1),
    }


def _gru_step(params, h, x):
    xz, xr, xn = (x @ params["gru_xz"] + params["gru_b"]).chunk(3, dim=-1)
    hz, hr, hn = (h @ params["gru_hz"]).chunk(3, dim=-1)
    z = torch.sigmoid(xz + hz)
    r = torch.sigmoid(xr + hr)
    n = torch.tanh(xn + r * hn)
    return (1 - z) * h + z * n


def speech_prob(params, cfg: VADConfig, audio, h0=None):
    """audio [B, samples] -> (prob [B], h [B, hidden]), f32. Frames the
    chunk and runs the GRU over its frames from the carry ``h0`` (zeros
    when None)."""
    dev = params["feat"].device
    audio = torch.as_tensor(audio, device=dev).float()
    b, n = audio.shape
    frames = max(n // cfg.frame, 1)
    x = audio[:, : frames * cfg.frame].reshape(b, frames, cfg.frame)
    x = x / torch.clamp(x.std(dim=-1, unbiased=False, keepdim=True), min=1e-5)
    feats = torch.tanh(x @ params["feat"])  # [B, frames, F]
    h = h0 if h0 is not None else torch.zeros((b, cfg.hidden), device=dev)
    for t in range(frames):
        h = _gru_step(params, h, feats[:, t])
    return torch.sigmoid(h @ params["out"])[:, 0], h


def segment_speech(probs, threshold: float = 0.5, min_run: int = 2):
    """A boolean speech mask over a [T] chunk-probability track, single-chunk
    gaps closed (host-side)."""
    mask = np.asarray(torch.as_tensor(probs).cpu()) >= threshold
    for i in range(1, len(mask) - 1):
        if not mask[i] and mask[i - 1] and mask[i + 1]:
            mask[i] = True
    return mask
