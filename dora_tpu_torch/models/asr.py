"""Self-contained speech recognition (the Distil-Whisper class), on torch
tensors (dora_tpu/models/asr.py).

An HTK log-mel frontend on the device, a conv-downsampled encoder of
RMSNorm + SwiGLU blocks, a causal rotary decoder with cross-attention over
a static KV cache, and greedy decoding as a host loop of one-row passes
(the JAX package scans it), with no fetch until the end."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from dora_tpu_torch._device import resolve_device
from dora_tpu_torch.models import layers as L


@dataclass(frozen=True)
class ASRConfig:
    sample_rate: int = 16000
    n_fft: int = 400
    hop: int = 160
    n_mels: int = 80
    max_frames: int = 3000  # 30 s
    dim: int = 384
    enc_layers: int = 4
    dec_layers: int = 4
    heads: int = 6
    ffn: int = 1536
    vocab: int = 8192
    max_tokens: int = 128

    @classmethod
    def tiny(cls) -> "ASRConfig":
        return cls(n_mels=32, max_frames=64, dim=64, enc_layers=2, dec_layers=2, heads=4,
                   ffn=128, vocab=128, max_tokens=16)

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


# ---------------------------------------------------------------------------
# log-mel frontend
# ---------------------------------------------------------------------------


def mel_filterbank(cfg: ASRConfig, device=None) -> torch.Tensor:
    """[n_fft // 2 + 1, n_mels] triangular mel filters (HTK scale), f32."""
    n_freqs = cfg.n_fft // 2 + 1
    f32 = torch.float32

    def hz_to_mel(f):
        return 2595.0 * torch.log10(1.0 + f / 700.0)

    mels = torch.linspace(float(hz_to_mel(torch.tensor(0.0, dtype=f32))),
                          float(hz_to_mel(torch.tensor(cfg.sample_rate / 2, dtype=f32))),
                          cfg.n_mels + 2, dtype=f32)
    hz = 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    bins = torch.floor((cfg.n_fft + 1) * hz / cfg.sample_rate).to(torch.int32)
    freqs = torch.arange(n_freqs, dtype=f32)
    fb = torch.zeros((n_freqs, cfg.n_mels), dtype=f32)
    for m in range(cfg.n_mels):
        left, center, right = (int(bins[m + j]) for j in range(3))
        up = (freqs - left) / max(center - left, 1)
        down = (right - freqs) / max(right - center, 1)
        fb[:, m] = torch.clamp(torch.minimum(up, down), 0.0, 1.0)
    return fb.to(resolve_device(device))


def log_mel(cfg: ASRConfig, audio: torch.Tensor) -> torch.Tensor:
    """audio [B, samples] f32 -> [B, frames, n_mels] log-mel, padded or
    trimmed to ``max_frames`` (the clamp is against the batch's maximum)."""
    n = audio.shape[1]
    frames = 1 + (n - cfg.n_fft) // cfg.hop if n >= cfg.n_fft else 1
    dev = audio.device
    idx = (torch.arange(cfg.n_fft, device=dev)[None, :]
           + cfg.hop * torch.arange(frames, device=dev)[:, None]).clamp(max=n - 1)
    framed = audio[:, idx]  # [B, frames, n_fft]
    window = torch.from_numpy(np.hanning(cfg.n_fft).astype(np.float32)).to(dev)
    spec = torch.fft.rfft(framed * window, dim=-1).abs() ** 2
    mel = spec @ mel_filterbank(cfg, dev)
    logmel = torch.log10(torch.clamp(mel, min=1e-10))
    logmel = (torch.maximum(logmel, logmel.max() - 8.0) + 4.0) / 4.0
    if frames < cfg.max_frames:
        logmel = F.pad(logmel, (0, 0, 0, cfg.max_frames - frames))
    return logmel[:, : cfg.max_frames]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _cross_block_init(init: L.Init, dim: int, heads: int, ffn: int) -> dict:
    """A decoder block: the self-attention block's weights, then the
    cross-attention's RMSNorm weight and four dense projections."""
    return {**init.block(dim, heads, ffn), "x_norm": init.ones(dim),
            "x_wq": init.dense(dim, dim), "x_wk": init.dense(dim, dim),
            "x_wv": init.dense(dim, dim), "x_wo": init.dense(dim, dim)}


def init_params(cfg: ASRConfig, *, seed: int = 0, device=None) -> dict:
    """Seeded random f32 parameters on ``device`` (default cuda), with the
    JAX package's shapes and distributions (dense weights uniform in
    +-1/sqrt(d_in), convolutions normal / sqrt(fan-in), positions and the
    embedding normal x 0.02, norms one). The numbers come from a
    ``torch.Generator``; ``params_from_jax`` carries the JAX package's."""
    init = L.Init(seed, device)
    d = cfg.dim
    return {
        "conv1": init.normal(3, cfg.n_mels, d, std=1.0 / math.sqrt(3 * cfg.n_mels)),
        "conv2": init.normal(3, d, d, std=1.0 / math.sqrt(3 * d)),
        "enc_pos": init.normal(cfg.max_frames // 2, d),
        "enc_blocks": {str(i): init.block(d, cfg.heads, cfg.ffn)
                       for i in range(cfg.enc_layers)},
        "enc_norm": init.ones(d),
        "embed": init.normal(cfg.vocab, d),
        "dec_blocks": {str(i): _cross_block_init(init, d, cfg.heads, cfg.ffn)
                       for i in range(cfg.dec_layers)},
        "dec_norm": init.ones(d),
    }


# ---------------------------------------------------------------------------
# encoder / decoder
# ---------------------------------------------------------------------------


def _conv1d_same(x, w, stride: int = 1):
    """x [B, T, C_in], w [k, C_in, C_out]: XLA's "SAME" padding (the odd
    pad on the high side), no bias."""
    t, k = x.shape[1], w.shape[0]
    total = max((-(-t // stride) - 1) * stride + k - t, 0)
    x = F.pad(x.transpose(1, 2), (total // 2, total - total // 2))
    return F.conv1d(x, w.permute(2, 1, 0), stride=stride).transpose(1, 2)


def encode(params, cfg: ASRConfig, mel):
    """[B, frames, n_mels] -> [B, frames / 2, dim]."""
    dtype = L.compute_dtype(mel.device)
    x = mel.to(dtype)
    x = F.gelu(_conv1d_same(x, params["conv1"].to(dtype)), approximate="tanh")
    x = F.gelu(_conv1d_same(x, params["conv2"].to(dtype), stride=2), approximate="tanh")
    x = x + params["enc_pos"].to(dtype)[None, : x.shape[1]]
    for i in range(cfg.enc_layers):
        x, _ = L.block_forward(params["enc_blocks"][str(i)], x, cfg.heads)
    return L.rms_norm(x, params["enc_norm"])


def _cross_attend(block, h, enc_kv, n_heads: int):
    b, t, dim = h.shape
    dtype = h.dtype
    q = L.rms_norm(h, block["x_norm"]) @ block["x_wq"].to(dtype)
    q = q.reshape(b, t, n_heads, dim // n_heads).transpose(1, 2)
    out = L.attention(q, *enc_kv).transpose(1, 2).reshape(b, t, dim)
    return h + out @ block["x_wo"].to(dtype)


def _encoder_kv(params, cfg: ASRConfig, enc):
    """Cross-attention K / V of every decoder layer, once per utterance."""
    dtype = enc.dtype
    b, s, _ = enc.shape
    kv = {}
    for i in range(cfg.dec_layers):
        block = params["dec_blocks"][str(i)]
        k = (enc @ block["x_wk"].to(dtype)).reshape(b, s, cfg.heads, cfg.head_dim)
        v = (enc @ block["x_wv"].to(dtype)).reshape(b, s, cfg.heads, cfg.head_dim)
        kv[str(i)] = (k.transpose(1, 2), v.transpose(1, 2))
    return kv


def _decoder_forward(params, cfg: ASRConfig, h, enc_kv, positions, mask, caches, cache_index,
                     rope):
    new_caches = {}
    for i in range(cfg.dec_layers):
        block = params["dec_blocks"][str(i)]
        h, new_cache = L.block_forward(block, h, cfg.heads, rope=rope, positions=positions,
                                       mask=mask, cache=caches[str(i)],
                                       cache_index=cache_index)
        new_caches[str(i)] = new_cache
        h = _cross_attend(block, h, enc_kv[str(i)], cfg.heads)
    return L.rms_norm(h, params["dec_norm"]), new_caches


def transcribe(params, cfg: ASRConfig, audio, bos_token: int, max_new_tokens: int):
    """audio [B, samples] -> greedy tokens [B, max_new_tokens] int32: log-mel,
    encoder, then one decoder pass a token from ``bos_token``."""
    dev = params["embed"].device
    audio = torch.as_tensor(audio, device=dev).float()
    dtype = L.compute_dtype(dev)
    enc = encode(params, cfg, log_mel(cfg, audio))
    enc_kv = _encoder_kv(params, cfg, enc)
    b = audio.shape[0]
    shape = (b, cfg.heads, cfg.max_tokens, cfg.head_dim)
    caches = {str(i): {"k": torch.zeros(shape, dtype=dtype, device=dev),
                       "v": torch.zeros(shape, dtype=dtype, device=dev)}
              for i in range(cfg.dec_layers)}
    embed = params["embed"].to(dtype)
    head = embed.T  # tied softmax head
    rope = L.rope_table(cfg.max_tokens, cfg.head_dim, device=dev)
    slots = torch.arange(cfg.max_tokens, device=dev)
    token = torch.full((b,), bos_token, dtype=torch.int32, device=dev)
    out = []
    for pos in range(max_new_tokens):
        h = embed[token.long()][:, None, :]
        positions = torch.full((b, 1), pos, dtype=torch.long, device=dev)
        mask = (slots <= pos)[None, None, None, :]
        h, caches = _decoder_forward(params, cfg, h, enc_kv, positions, mask, caches, pos, rope)
        token = torch.argmax((h[:, -1] @ head).float(), dim=-1).to(torch.int32)
        out.append(token)
    if not out:
        return torch.zeros((b, 0), dtype=torch.int32, device=dev)
    return torch.stack(out, dim=1)
