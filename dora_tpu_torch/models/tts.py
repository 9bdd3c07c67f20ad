"""Text-to-speech (the Parler-TTS class), on torch tensors
(dora_tpu/models/tts.py).

A non-autoregressive FastSpeech-style stack with static shapes: text ids
-> rotary RMSNorm + SwiGLU encoder (plus a learned style voice) -> a fixed
x frames_per_token upsample -> frame decoder -> mel head -> a vocoder of
three transposed convolutions -> waveform. The vocoder runs in NCL with
torch ``ConvTranspose1d`` weights [in, out, k]; ``params_from_jax`` turns
the JAX package's LOI kernels (which ``lax.conv_transpose`` correlates
unflipped over the stride-dilated input) into them, flipped. Training
(``loss_fn``) is not ported."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from dora_tpu_torch.models import layers as L


@dataclass(frozen=True)
class TTSConfig:
    vocab: int = 259  # byte codec + specials
    dim: int = 256
    enc_layers: int = 4
    dec_layers: int = 4
    heads: int = 4
    ffn: int = 1024
    max_text: int = 128
    frames_per_token: int = 4  # static duration expansion
    n_mels: int = 80
    hop: int = 256  # vocoder upsample: samples per frame
    sample_rate: int = 16000
    n_styles: int = 8

    @classmethod
    def tiny(cls) -> "TTSConfig":
        return cls(dim=32, enc_layers=1, dec_layers=1, heads=2, ffn=64,
                   max_text=16, frames_per_token=2, n_mels=8, hop=16)

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @property
    def max_frames(self) -> int:
        return self.max_text * self.frames_per_token

    @property
    def max_samples(self) -> int:
        return self.max_frames * self.hop


def _vocoder_strides(hop: int) -> tuple[int, int, int]:
    """Factor ``hop`` into three upsample strides (largest first)."""
    s1 = next((c for c in (8, 5, 4, 3, 2) if hop % c == 0), 1)
    rest = hop // s1
    s2 = next((c for c in (8, 5, 4, 3, 2) if rest % c == 0), 1)
    return s1, s2, rest // s2


def init_params(cfg: TTSConfig, *, seed: int = 0, device=None) -> dict:
    """Seeded random f32 parameters on ``device`` (default cuda) with the
    JAX package's shapes and distributions; the vocoder's kernels [in,
    out, 2 x stride] uniform in +-1/sqrt(in x width)."""
    init = L.Init(seed, device)
    s1, s2, s3 = _vocoder_strides(cfg.hop)
    c1, c2 = max(cfg.dim // 2, 8), max(cfg.dim // 4, 4)

    def deconv(c_in, c_out, width):
        return init.uniform((c_in, c_out, width), 1.0 / math.sqrt(c_in * width))

    return {
        "embed": init.normal(cfg.vocab, cfg.dim),
        "style": init.normal(cfg.n_styles, cfg.dim),
        "enc_blocks": {str(i): init.block(cfg.dim, cfg.heads, cfg.ffn)
                       for i in range(cfg.enc_layers)},
        "enc_norm": init.ones(cfg.dim),
        "dec_blocks": {str(i): init.block(cfg.dim, cfg.heads, cfg.ffn)
                       for i in range(cfg.dec_layers)},
        "dec_norm": init.ones(cfg.dim),
        "mel_head": init.dense(cfg.dim, cfg.n_mels),
        "voc_in": init.dense(cfg.n_mels, cfg.dim),
        "voc1": deconv(cfg.dim, c1, 2 * s1),
        "voc2": deconv(c1, c2, 2 * s2),
        "voc3": deconv(c2, 1, 2 * s3),
    }


def deconv_from_jax(w: torch.Tensor) -> torch.Tensor:
    """A ``lax.conv_transpose`` LOI kernel [k, out, in] as the torch
    ConvTranspose1d weight [in, out, k] that :func:`_deconv` takes: axes
    reversed and the taps flipped (torch's transposed convolution flips
    its kernel, JAX's with ``transpose_kernel=False`` does not)."""
    return w.permute(2, 1, 0).flip(-1).contiguous()


def params_from_jax(tree, device=None) -> dict:
    """The JAX package's TTS parameters as the port's tensors on
    ``device``: values bit for bit, the vocoder's kernels relaid by
    :func:`deconv_from_jax`."""
    from dora_tpu_torch.models.hf.qwen2 import params_from_jax as carry

    params = carry(tree, device=device)
    for name in ("voc1", "voc2", "voc3"):
        params[name] = deconv_from_jax(params[name])
    return params


def _deconv(x, w, stride: int):
    """[B, C_in, T] -> [B, C_out, T * stride]: ``lax.conv_transpose(...,
    "SAME")`` of the JAX package. XLA correlates the unflipped kernel over
    the input dilated by ``stride`` and padded (pad_a, k + stride - 2 -
    pad_a), pad_a = k - 1 when stride > k - 1, else ceil((k + stride - 2) /
    2); that is torch's full transposed convolution with the flipped kernel
    ``w`` from row k - 1 - pad_a, zero past its end."""
    k, n = w.shape[-1], x.shape[-1]
    pad_a = k - 1 if stride > k - 1 else -(-(k + stride - 2) // 2)
    full = F.conv_transpose1d(x, w.to(x.dtype), stride=stride)
    start = k - 1 - pad_a
    end = start + n * stride
    if end > full.shape[-1]:
        full = F.pad(full, (0, end - full.shape[-1]))
    return full[..., start:end]


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()


def encode_text(params, cfg: TTSConfig, text_ids, style_id):
    """[B, T] ids -> [B, T, dim] states with the style voice added."""
    dev = params["embed"].device
    dtype = L.compute_dtype(dev)
    text_ids = torch.as_tensor(text_ids, device=dev).long()
    style_id = torch.as_tensor(style_id, device=dev).long()
    x = params["embed"].to(dtype)[text_ids] + params["style"].to(dtype)[style_id][:, None, :]
    rope = L.rope_table(cfg.max_text, cfg.head_dim, device=dev)
    for i in range(cfg.enc_layers):
        x, _ = L.block_forward(params["enc_blocks"][str(i)], x, cfg.heads, rope=rope)
    return L.rms_norm(x, params["enc_norm"])


def decode_frames(params, cfg: TTSConfig, enc):
    """Upsample x frames_per_token and run the frame decoder -> [B, frames,
    n_mels]."""
    x = torch.repeat_interleave(enc, cfg.frames_per_token, dim=1)
    rope = L.rope_table(cfg.max_frames, cfg.head_dim, device=enc.device)
    for i in range(cfg.dec_layers):
        x, _ = L.block_forward(params["dec_blocks"][str(i)], x, cfg.heads, rope=rope)
    x = L.rms_norm(x, params["dec_norm"])
    return x @ params["mel_head"].to(x.dtype)


def vocode(params, cfg: TTSConfig, mel):
    """[B, frames, n_mels] -> [B, frames x hop] f32 waveform in [-1, 1]
    (tanh-approximated GELUs between the transposed convolutions, as
    ``jax.nn.gelu``'s default), on cuDNN's deterministic algorithms
    (``layers.cudnn_exact``): one input gives one waveform."""
    dtype = mel.dtype
    s1, s2, s3 = _vocoder_strides(cfg.hop)
    x = (mel @ params["voc_in"].to(dtype)).transpose(1, 2)  # NCL from here
    with L.cudnn_exact():
        x = F.gelu(_deconv(x, params["voc1"], s1), approximate="tanh")
        x = F.gelu(_deconv(x, params["voc2"], s2), approximate="tanh")
        x = torch.tanh(_deconv(x, params["voc3"], s3))
    return x[:, 0].float()


def synthesize(params, cfg: TTSConfig, text_ids, style_id):
    """[B, max_text] ids (and a style a row) -> [B, max_samples] f32."""
    enc = encode_text(params, cfg, text_ids, style_id)
    return vocode(params, cfg, decode_frames(params, cfg, enc))
