"""Text-to-text translation (the Opus-MT class), on torch tensors
(dora_tpu/models/translation.py).

An encoder-decoder transformer over token ids: a rotary RMSNorm + SwiGLU
encoder, and the ASR's decoder (self-attention over a static KV cache,
then cross-attention, models/asr.py) with a tied head. Greedy decoding is
a host loop of one-row passes (the JAX package scans it), with no fetch
until the end."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from dora_tpu_torch.models import layers as L
from dora_tpu_torch.models.asr import _cross_block_init, _decoder_forward, _encoder_kv


@dataclass(frozen=True)
class TranslatorConfig:
    vocab: int = 8192
    dim: int = 384
    enc_layers: int = 4
    dec_layers: int = 4
    heads: int = 6
    ffn: int = 1536
    max_src: int = 256
    max_tokens: int = 256

    @classmethod
    def tiny(cls) -> "TranslatorConfig":
        return cls(vocab=300, dim=64, enc_layers=2, dec_layers=2, heads=4,
                   ffn=128, max_src=32, max_tokens=16)

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


def init_params(cfg: TranslatorConfig, *, seed: int = 0, device=None) -> dict:
    """Seeded random f32 parameters on ``device`` (default cuda) with the
    JAX package's shapes and distributions (``layers.Init``)."""
    init = L.Init(seed, device)
    return {
        "embed": init.normal(cfg.vocab, cfg.dim),
        "enc_blocks": {str(i): init.block(cfg.dim, cfg.heads, cfg.ffn)
                       for i in range(cfg.enc_layers)},
        "enc_norm": init.ones(cfg.dim),
        "dec_blocks": {str(i): _cross_block_init(init, cfg.dim, cfg.heads, cfg.ffn)
                       for i in range(cfg.dec_layers)},
        "dec_norm": init.ones(cfg.dim),
    }


def params_from_jax(tree, device=None) -> dict:
    """The JAX package's translator parameters as tensors on ``device``,
    bit for bit (the layouts are the same)."""
    from dora_tpu_torch.models.hf.qwen2 import params_from_jax as carry

    return carry(tree, device=device)


def encode(params, cfg: TranslatorConfig, src_ids):
    """src_ids [B, S] -> encoder states [B, S, dim] (rotary positions)."""
    dev = params["embed"].device
    dtype = L.compute_dtype(dev)
    src_ids = torch.as_tensor(src_ids, device=dev)
    x = params["embed"].to(dtype)[src_ids.long()]
    rope = L.rope_table(cfg.max_src, cfg.head_dim, device=dev)
    for i in range(cfg.enc_layers):
        x, _ = L.block_forward(params["enc_blocks"][str(i)], x, cfg.heads, rope=rope)
    return L.rms_norm(x, params["enc_norm"])


def translate(params, cfg: TranslatorConfig, src_ids, bos_token: int, max_new_tokens: int):
    """Greedy translation: [B, S] -> [B, max_new_tokens] int32. More new
    tokens than the cache's ``max_tokens`` are refused (the JAX scan would
    clamp its cache writes onto the last row)."""
    if max_new_tokens > cfg.max_tokens:
        raise ValueError(f"max_new_tokens ({max_new_tokens}) exceeds the KV-cache capacity "
                         f"({cfg.max_tokens})")
    dev = params["embed"].device
    dtype = L.compute_dtype(dev)
    enc = encode(params, cfg, src_ids)
    enc_kv = _encoder_kv(params, cfg, enc)
    b = enc.shape[0]
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
