"""Whisper-family ASR over pretrained HF checkpoints, on torch tensors
(dora_tpu/models/hf/whisper.py).

transformers' ``WhisperForConditionalGeneration`` graph: the log-mel
frontend of ``WhisperFeatureExtractor``, two GELU convolutions, learned
positions, LayerNorm pre-norm blocks with biased projections (bias-free k),
a GELU MLP, cross-attention over the encoder output and the tied head.
Attention is the plain einsum of ``layers.attention``, as the JAX package
leaves it to XLA (the encoder's blocks run without ``flash``). Encode and
prefill are single passes; the greedy decode is a host loop of one-row
decoder passes over a static KV cache (the JAX package scans it), with no
fetch until the end; ``transcribe_tokens_speculative`` runs the shared
prompt-lookup loop (``spec_decode.run_loop``)."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from dora_tpu_torch._device import resolve_device
from dora_tpu_torch.models import layers as L
from dora_tpu_torch.models.hf.loader import (
    linear,
    maybe_bias,
    read_config,
    read_safetensors,
    to_device,
)


@dataclass(frozen=True)
class WhisperConfig:
    vocab: int
    dim: int
    enc_layers: int
    dec_layers: int
    heads: int
    dec_heads: int
    ffn: int
    n_mels: int
    max_source: int  # encoder positions (frames / 2)
    max_target: int  # decoder positions
    decoder_start_token: int
    eos_token: int

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @property
    def dec_head_dim(self) -> int:
        return self.dim // self.dec_heads

    @classmethod
    def from_hf(cls, config: dict) -> "WhisperConfig":
        return cls(
            vocab=config["vocab_size"],
            dim=config["d_model"],
            enc_layers=config["encoder_layers"],
            dec_layers=config["decoder_layers"],
            heads=config["encoder_attention_heads"],
            dec_heads=config.get("decoder_attention_heads", config["encoder_attention_heads"]),
            ffn=config["encoder_ffn_dim"],
            n_mels=config["num_mel_bins"],
            max_source=config["max_source_positions"],
            max_target=config["max_target_positions"],
            decoder_start_token=config.get("decoder_start_token_id", 50258),
            eos_token=config.get("eos_token_id", 50257),
        )


def load(model_dir: str | Path, device=None):
    """(config, params) from a HF checkpoint directory; weights as f32 on
    ``device`` (default cuda)."""
    dev = resolve_device(device)
    cfg = WhisperConfig.from_hf(read_config(model_dir))
    return cfg, to_device(map_params(read_safetensors(model_dir), cfg), dev)


def _attn_params(tensors: dict, prefix: str) -> dict:
    p: dict[str, Any] = {
        "wq": linear(tensors, prefix + "q_proj.weight"),
        "wk": linear(tensors, prefix + "k_proj.weight"),
        "wv": linear(tensors, prefix + "v_proj.weight"),
        "wo": linear(tensors, prefix + "out_proj.weight"),
    }
    maybe_bias(p, "bq", tensors, prefix + "q_proj.bias")
    maybe_bias(p, "bk", tensors, prefix + "k_proj.bias")  # absent in whisper
    maybe_bias(p, "bv", tensors, prefix + "v_proj.bias")
    maybe_bias(p, "bo", tensors, prefix + "out_proj.bias")
    return p


def map_params(tensors: dict, cfg: WhisperConfig) -> dict:
    """Checkpoint names -> the JAX package's parameter tree (convolutions
    in its [k, in, out] layout)."""
    prefix = "model." if any(k.startswith("model.") for k in tensors) else ""

    def layer(lp: str) -> dict:
        return {
            "attn_norm": tensors[lp + "self_attn_layer_norm.weight"],
            "attn_norm_b": tensors[lp + "self_attn_layer_norm.bias"],
            **_attn_params(tensors, lp + "self_attn."),
            "ffn_norm": tensors[lp + "final_layer_norm.weight"],
            "ffn_norm_b": tensors[lp + "final_layer_norm.bias"],
            "w_up": linear(tensors, lp + "fc1.weight"),
            "b_up": tensors[lp + "fc1.bias"],
            "w_down": linear(tensors, lp + "fc2.weight"),
            "b_down": tensors[lp + "fc2.bias"],
        }

    def dec_layer(i: int) -> dict:
        lp = f"{prefix}decoder.layers.{i}."
        return {
            **layer(lp),
            "cross": {
                "norm": tensors[lp + "encoder_attn_layer_norm.weight"],
                "norm_b": tensors[lp + "encoder_attn_layer_norm.bias"],
                **_attn_params(tensors, lp + "encoder_attn."),
            },
        }

    def conv(name: str):  # [out, in, k] -> [k, in, out]
        return tensors[f"{prefix}encoder.{name}.weight"].permute(2, 1, 0).contiguous()

    return {
        "conv1": conv("conv1"),
        "conv1_b": tensors[f"{prefix}encoder.conv1.bias"],
        "conv2": conv("conv2"),
        "conv2_b": tensors[f"{prefix}encoder.conv2.bias"],
        "enc_pos": tensors[f"{prefix}encoder.embed_positions.weight"],
        "enc_blocks": {str(i): layer(f"{prefix}encoder.layers.{i}.")
                       for i in range(cfg.enc_layers)},
        "enc_norm": tensors[f"{prefix}encoder.layer_norm.weight"],
        "enc_norm_b": tensors[f"{prefix}encoder.layer_norm.bias"],
        "embed": tensors[f"{prefix}decoder.embed_tokens.weight"],
        "dec_pos": tensors[f"{prefix}decoder.embed_positions.weight"],
        "dec_blocks": {str(i): dec_layer(i) for i in range(cfg.dec_layers)},
        "dec_norm": tensors[f"{prefix}decoder.layer_norm.weight"],
        "dec_norm_b": tensors[f"{prefix}decoder.layer_norm.bias"],
    }


# ---------------------------------------------------------------------------
# log-mel frontend (WhisperFeatureExtractor: slaney mel filterbank, hann
# window, log10, max - 8 clamp, (x + 4) / 4)
# ---------------------------------------------------------------------------


def slaney_mel_filters(n_freqs: int, n_mels: int, sample_rate: int = 16000,
                       n_fft: int = 400) -> np.ndarray:
    """[n_freqs, n_mels] slaney-normalized triangular filters (float32)."""

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        mels = 3.0 * f / 200.0
        log_region = f >= 1000.0
        return np.where(
            log_region, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0),
            mels)

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        f = 200.0 * m / 3.0
        log_region = m >= 15.0
        return np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)

    fft_freqs = np.linspace(0, sample_rate / 2, n_freqs)
    mel_pts = np.linspace(hz_to_mel(0.0), hz_to_mel(sample_rate / 2.0), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    fb = np.zeros((n_mels, n_freqs))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        fb[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    fb *= enorm[:, None]
    return fb.T.astype(np.float32)


def _hann(n_fft: int) -> np.ndarray:
    return np.hanning(n_fft + 1)[:-1].astype(np.float32)


def log_mel_features(audio: np.ndarray, n_mels: int, n_fft: int = 400, hop: int = 160,
                     n_samples: int = 480000) -> np.ndarray:
    """audio [B, samples] float32 -> input_features [B, n_mels, 3000] on
    the host, as WhisperFeatureExtractor computes them (pad or trim to
    30 s, reflect-padded STFT, slaney mel, log10, dynamic-range clamp,
    (x + 4) / 4)."""
    b, n = audio.shape
    if n < n_samples:
        audio = np.pad(audio, ((0, 0), (0, n_samples - n)))
    audio = audio[:, :n_samples]
    pad = n_fft // 2
    audio = np.pad(audio, ((0, 0), (pad, pad)), mode="reflect")
    frames = 1 + (audio.shape[1] - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(frames)[:, None]
    framed = audio[:, idx]
    spec = np.abs(np.fft.rfft(framed * _hann(n_fft), axis=-1)) ** 2
    mel = spec @ slaney_mel_filters(n_fft // 2 + 1, n_mels, n_fft=n_fft)
    log_spec = np.log10(np.maximum(mel, 1e-10))[:, :-1]  # drop the last frame
    log_spec = np.maximum(log_spec, log_spec.max(axis=(1, 2), keepdims=True) - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec.transpose(0, 2, 1).astype(np.float32)


def log_mel_traced(audio: torch.Tensor, n_mels: int, n_fft: int = 400, hop: int = 160,
                   n_samples: int = 480000) -> torch.Tensor:
    """:func:`log_mel_features` on the device: audio [B, samples] f32 ->
    input_features [B, n_mels, 3000] f32 on audio's device."""
    dev = audio.device
    n = audio.shape[1]
    if n < n_samples:
        audio = F.pad(audio, (0, n_samples - n))
    audio = audio[:, :n_samples]
    pad = n_fft // 2
    audio = F.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]
    framed = audio.unfold(1, n_fft, hop)  # [B, frames, n_fft]
    window = torch.from_numpy(_hann(n_fft)).to(dev)
    spec = torch.fft.rfft(framed * window, dim=-1).abs() ** 2
    fb = torch.from_numpy(slaney_mel_filters(n_fft // 2 + 1, n_mels, n_fft=n_fft)).to(dev)
    log_spec = torch.log10(torch.clamp(spec @ fb, min=1e-10))[:, :-1]
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(1, 2), keepdim=True) - 8.0)
    return ((log_spec + 4.0) / 4.0).transpose(1, 2)


# ---------------------------------------------------------------------------
# encoder / decoder
# ---------------------------------------------------------------------------


def _conv1d(x, w, b, stride: int):
    """x [B, T, C_in], w [k, C_in, C_out] (the JAX layout), padding 1."""
    out = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), b, stride=stride, padding=1)
    return out.transpose(1, 2)


def _dtype(params):
    return L.compute_dtype(params["embed"].device)


def encode(params, cfg: WhisperConfig, input_features):
    """input_features [B, n_mels, T] -> [B, T/2, dim] in the compute dtype."""
    dtype = _dtype(params)
    x = input_features.to(params["embed"].device, dtype).transpose(1, 2)  # [B, T, n_mels]
    x = F.gelu(_conv1d(x, params["conv1"].to(dtype), params["conv1_b"].to(dtype), 1))
    x = F.gelu(_conv1d(x, params["conv2"].to(dtype), params["conv2_b"].to(dtype), 2))
    x = x + params["enc_pos"].to(dtype)[None, : x.shape[1]]
    for i in range(cfg.enc_layers):
        x, _ = L.block_forward(params["enc_blocks"][str(i)], x, cfg.heads, norm="ln",
                               mlp="gelu", norm_eps=1e-5)
    return L.layer_norm(x, params["enc_norm"], params["enc_norm_b"])


def _cross_attend(block, h, kv, n_heads: int):
    cross = block["cross"]
    b, t, dim = h.shape
    q = L.layer_norm(h, cross["norm"], cross["norm_b"])
    q = L.dense(q, cross, "wq", "bq").reshape(b, t, n_heads, dim // n_heads).transpose(1, 2)
    out = L.attention(q, kv[0], kv[1]).transpose(1, 2).reshape(b, t, dim)
    return h + L.dense(out, cross, "wo", "bo")


def encoder_kv(params, cfg: WhisperConfig, enc):
    """Cross-attention K / V of every decoder layer, once per utterance."""
    b, s, _ = enc.shape
    kv = {}
    for i in range(cfg.dec_layers):
        cross = params["dec_blocks"][str(i)]["cross"]
        k = L.dense(enc, cross, "wk", "bk").reshape(b, s, cfg.dec_heads, cfg.dec_head_dim)
        v = L.dense(enc, cross, "wv", "bv").reshape(b, s, cfg.dec_heads, cfg.dec_head_dim)
        kv[str(i)] = (k.transpose(1, 2), v.transpose(1, 2))
    return kv


def _decoder(params, cfg: WhisperConfig, h, kv, mask, caches=None,
             cache_index: int | None = None):
    new_caches = {}
    for i in range(cfg.dec_layers):
        block = params["dec_blocks"][str(i)]
        # HF layer order: self-attention -> cross-attention -> feed-forward
        h, new_cache = L.attention_sublayer(
            block, h, cfg.dec_heads, mask=mask, norm="ln", norm_eps=1e-5,
            cache=None if caches is None else caches[str(i)], cache_index=cache_index)
        if new_cache is not None:
            new_caches[str(i)] = new_cache
        h = _cross_attend(block, h, kv[str(i)], cfg.dec_heads)
        h = L.mlp_sublayer(block, h, norm="ln", mlp="gelu", norm_eps=1e-5)
    return L.layer_norm(h, params["dec_norm"], params["dec_norm_b"]), new_caches


def _embed(params, tokens, positions, dtype):
    """Token embeddings plus learned positions (tokens [B, T], positions [T]);
    the rows are gathered, then cast."""
    return (params["embed"][tokens.long()].to(dtype)
            + params["dec_pos"][positions].to(dtype)[None])


def decoder_logits(params, cfg: WhisperConfig, enc, tokens):
    """Teacher-forced decoder: tokens [B, T] -> logits [B, T, vocab] f32."""
    dtype = _dtype(params)
    dev = params["embed"].device
    t = tokens.shape[1]
    tokens = torch.as_tensor(tokens, device=dev)
    h = _embed(params, tokens, torch.arange(t, device=dev), dtype)
    kv = encoder_kv(params, cfg, enc.to(dev, dtype))
    h, _ = _decoder(params, cfg, h, kv, L.causal_mask(t, t, device=dev))
    return (h @ params["embed"].to(dtype).T).float()


def _dec_cache(cfg: WhisperConfig, b: int, dtype, device):
    shape = (b, cfg.dec_heads, cfg.max_target, cfg.dec_head_dim)
    return {str(i): {"k": torch.zeros(shape, dtype=dtype, device=device),
                     "v": torch.zeros(shape, dtype=dtype, device=device)}
            for i in range(cfg.dec_layers)}


def _forced(cfg: WhisperConfig, b: int, forced_tokens, device):
    if forced_tokens is None:
        return torch.full((b, 1), cfg.decoder_start_token, dtype=torch.int32, device=device)
    return torch.as_tensor(forced_tokens, dtype=torch.int32, device=device)


def _prefill(params, cfg: WhisperConfig, input_features, forced):
    """Encoder, cross K / V and the forced prefix through the decoder into
    a fresh cache. Returns (kv, caches, first greedy token [B] int32, head)."""
    dtype = _dtype(params)
    dev = params["embed"].device
    enc = encode(params, cfg, input_features)
    kv = encoder_kv(params, cfg, enc)
    b, f = forced.shape
    h = _embed(params, forced, torch.arange(f, device=dev), dtype)
    mask = (L.causal_mask(f, cfg.max_target, device=dev)
            & (torch.arange(cfg.max_target, device=dev) < f)[None, None, None, :])
    caches = _dec_cache(cfg, b, dtype, dev)
    h, caches = _decoder(params, cfg, h, kv, mask, caches=caches, cache_index=0)
    head = params["embed"].to(dtype).T
    first = torch.argmax((h[:, -1] @ head).float(), dim=-1).to(torch.int32)
    return kv, caches, first, head


def transcribe_tokens(params, cfg: WhisperConfig, input_features, max_new: int,
                      forced_tokens=None):
    """Greedy decode: input_features [B, n_mels, T] -> tokens [B, max_new]
    int32 (on the params' device). ``forced_tokens`` ([B, F], e.g. start /
    language / task ids) seed the decoder; default the config's
    decoder_start_token."""
    dev = params["embed"].device
    b = input_features.shape[0]
    forced = _forced(cfg, b, forced_tokens, dev)
    f = forced.shape[1]
    if f + max_new > cfg.max_target:
        raise ValueError(
            f"forced prefix ({f}) + max_new ({max_new}) exceeds the decoder's "
            f"max_target_positions ({cfg.max_target})")
    if max_new == 0:
        return torch.zeros((b, 0), dtype=torch.int32, device=dev)
    dtype = _dtype(params)
    kv, caches, token, head = _prefill(params, cfg, input_features, forced)
    positions = torch.arange(cfg.max_target, device=dev)
    out = [token]
    # token j + 1 comes from the pass at position f + j; the last token
    # needs no pass after it
    for pos in range(f, f + max_new - 1):
        h = _embed(params, token[:, None], positions[pos : pos + 1], dtype)
        mask = (positions <= pos)[None, None, None, :]
        h, caches = _decoder(params, cfg, h, kv, mask, caches=caches, cache_index=pos)
        token = torch.argmax((h[:, -1] @ head).float(), dim=-1).to(torch.int32)
        out.append(token)
    return torch.stack(out, dim=1)


def transcribe_tokens_speculative(params, cfg: WhisperConfig, input_features, max_new: int,
                                  forced_tokens=None, k: int | None = None,
                                  ngram: int | None = None):
    """Greedy transcription with prompt-lookup speculation: the tokens of
    :func:`transcribe_tokens`, up to k + 1 per decoder pass. Batch 1.
    Returns (tokens [1, max_new] int32, decoder passes)."""
    from dora_tpu_torch.models import spec_decode

    k = spec_decode.SPEC_K if k is None else k
    ngram = spec_decode.SPEC_NGRAM if ngram is None else ngram
    if input_features.shape[0] != 1:
        raise ValueError("speculative decode is batch-1")
    dev = params["embed"].device
    forced = _forced(cfg, 1, forced_tokens, dev)
    f = forced.shape[1]
    spec_decode.check_headroom(f, max_new, cfg.max_target, "forced prefix", k)
    dtype = _dtype(params)
    kv, caches, first, head = _prefill(params, cfg, input_features, forced)
    history = torch.zeros((cfg.max_target,), dtype=torch.int32, device=dev)
    history[:f] = forced[0]
    history[f] = first[0]
    positions = torch.arange(cfg.max_target, device=dev)

    def verify(chunk, n_emitted, caches):
        # generated token j sits at decoder position f + j; chunk[0, 0] is
        # generated index n_emitted - 1
        cache_index = f + n_emitted - 1
        chunk_pos = cache_index + torch.arange(chunk.shape[1], device=dev)
        mask = positions[None, None, None, :] <= chunk_pos[None, None, :, None]
        h = _embed(params, chunk, chunk_pos, dtype)
        h, new_caches = _decoder(params, cfg, h, kv, mask, caches=caches,
                                 cache_index=cache_index)
        return torch.argmax((h[0] @ head).float(), dim=-1).to(torch.int32), new_caches

    return spec_decode.run_loop(
        caches=caches, history=history, hist_len=f + 1, first=first[0],
        max_new_tokens=max_new, seq=cfg.max_target, verify=verify, k=k, ngram=ngram,
        body=spec_decode.fitting_body_passes(f, max_new, cfg.max_target, k))


def make_serving_step(cfg: WhisperConfig, max_new_tokens: int,
                      forced_tokens: np.ndarray | None = None, speculative: bool = False):
    """A ``(params, audio [samples]) -> tokens [1, max_new_tokens] int32``
    function: the log-mel frontend on the device, the encoder and the
    greedy decode (``speculative``: prompt-lookup speculation, the same
    tokens in fewer decoder passes)."""
    n_samples = cfg.max_source * 2 * 160  # the encoder takes 2 * max_source frames

    def step_fn(params, audio):
        audio = torch.as_tensor(audio, device=params["embed"].device)
        feats = log_mel_traced(audio[None].float(), cfg.n_mels, n_samples=n_samples)
        if speculative:
            tokens, _ = transcribe_tokens_speculative(params, cfg, feats, max_new_tokens,
                                                      forced_tokens)
            return tokens
        return transcribe_tokens(params, cfg, feats, max_new_tokens, forced_tokens)

    return step_fn


def trim_after_eos(tokens, eos: int) -> list[list[int]]:
    """Cut each row at its first EOS (host-side postprocess)."""
    out = []
    for row in np.asarray(torch.as_tensor(tokens).cpu()):
        ids = []
        for t in row.tolist():
            if t == eos:
                break
            ids.append(t)
        out.append(ids)
    return out
