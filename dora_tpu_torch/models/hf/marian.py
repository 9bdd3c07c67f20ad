"""Marian / Opus-MT translation over pretrained HF checkpoints, on torch
tensors (dora_tpu/models/hf/marian.py).

transformers' ``MarianMTModel`` graph: a post-LayerNorm encoder-decoder
with sinusoidal positions, embeddings scaled by sqrt(dim), the SiLU
("swish") activation, the head tied to the shared embedding plus
``final_logits_bias`` (a plain product). Greedy decoding is a host loop of
one-row decoder passes over a static KV cache written in place at the
position (the JAX package scans it and writes with
``dynamic_update_slice``), with no fetch until the end;
``translate_speculative`` runs the shared prompt-lookup loop
(``spec_decode.run_loop``). :class:`MarianTokenizer` segments with the
port's own sentencepiece reader (models/spm.py)."""

from __future__ import annotations

import json
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
class MarianConfig:
    vocab: int
    dim: int
    enc_layers: int
    dec_layers: int
    heads: int
    ffn: int
    max_positions: int
    pad_token: int
    eos_token: int
    decoder_start_token: int
    scale_embedding: bool
    activation: str
    forced_eos_token: int | None = None
    max_tokens: int = 128

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @classmethod
    def from_hf(cls, config: dict, max_tokens: int | None = None) -> "MarianConfig":
        return cls(
            vocab=config["vocab_size"],
            dim=config["d_model"],
            enc_layers=config["encoder_layers"],
            dec_layers=config["decoder_layers"],
            heads=config["encoder_attention_heads"],
            ffn=config["encoder_ffn_dim"],
            max_positions=config.get("max_position_embeddings", 512),
            pad_token=config.get("pad_token_id", 0),
            eos_token=config.get("eos_token_id", 0),
            decoder_start_token=config.get(
                "decoder_start_token_id", config.get("pad_token_id", 0)),
            scale_embedding=config.get("scale_embedding", False),
            activation=config.get("activation_function", "swish"),
            forced_eos_token=config.get("forced_eos_token_id"),
            max_tokens=max_tokens or 128,
        )


class MarianTokenizer:
    """Tokenizer of an Opus-MT checkpoint: sentencepiece segmentation
    (``source.spm`` / ``target.spm``) and the ``vocab.json`` piece -> id
    map, ``</s>`` appended, ``<unk>`` for unmapped pieces: transformers'
    MarianTokenizer on the inference path."""

    def __init__(self, model_dir: str | Path):
        from dora_tpu_torch.models.spm import SentencePieceModel

        model_dir = Path(model_dir)
        self.vocab: dict[str, int] = json.loads((model_dir / "vocab.json").read_text())
        self.ids: dict[int, str] = {v: k for k, v in self.vocab.items()}
        self.source_spm = SentencePieceModel.load(model_dir / "source.spm")
        target = model_dir / "target.spm"
        self.target_spm = SentencePieceModel.load(target) if target.exists() else self.source_spm
        self.unk_id = self.vocab.get("<unk>", 0)
        self.eos_id = self.vocab.get("</s>", 0)
        self.pad_id = self.vocab.get("<pad>", self.eos_id)

    def encode(self, text: str) -> list[int]:
        pieces = self.source_spm.encode(text)
        return [self.vocab.get(p, self.unk_id) for p in pieces] + [self.eos_id]

    def decode(self, ids) -> str:
        from dora_tpu_torch.models.spm import WORD_BOUNDARY

        pieces = []
        for i in ids:
            i = int(i)
            if i in (self.eos_id, self.pad_id):
                continue
            piece = self.ids.get(i)
            if piece and not (piece.startswith("<") and piece.endswith(">")):
                pieces.append(piece)
        return "".join(pieces).replace(WORD_BOUNDARY, " ").strip()


def sinusoidal_positions(n_positions: int, dim: int) -> np.ndarray:
    """Marian's sinusoidal table: sin in the first dim / 2 columns, cos in
    the second half (transformers MarianSinusoidalPositionalEmbedding)."""
    position = np.arange(n_positions, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32) * -(np.log(10000.0) / dim))
    table = np.zeros((n_positions, dim), np.float32)
    half = dim // 2
    table[:, :half] = np.sin(position * div)
    table[:, half:] = np.cos(position * div)
    return table


def load(model_dir: str | Path, max_tokens: int | None = None, device=None):
    """(config, params) from a HF Marian checkpoint directory; weights as
    f32 on ``device`` (default cuda)."""
    dev = resolve_device(device)
    cfg = MarianConfig.from_hf(read_config(model_dir), max_tokens)
    return cfg, to_device(map_params(read_safetensors(model_dir), cfg), dev)


def _attn_params(tensors: dict, prefix: str) -> dict:
    p = {"wq": linear(tensors, prefix + "q_proj.weight"),
         "wk": linear(tensors, prefix + "k_proj.weight"),
         "wv": linear(tensors, prefix + "v_proj.weight"),
         "wo": linear(tensors, prefix + "out_proj.weight")}
    for key, name in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj"), ("bo", "out_proj")):
        maybe_bias(p, key, tensors, f"{prefix}{name}.bias")
    return p


def map_params(tensors: dict, cfg: MarianConfig) -> dict:
    """Checkpoint names -> the JAX package's tree. The encoder, decoder and
    head share ``model.shared.weight``; ``positions`` is the sinusoidal
    table."""
    prefix = "model." if any(k.startswith("model.") for k in tensors) else ""
    shared = tensors.get(f"{prefix}shared.weight")
    if shared is None:
        shared = tensors[f"{prefix}encoder.embed_tokens.weight"]
    bias = tensors.get("final_logits_bias")
    if bias is None:
        bias = torch.zeros((cfg.vocab,), device=shared.device)

    def block(lp: str, cross: bool) -> dict:
        b: dict[str, Any] = {
            "attn": _attn_params(tensors, lp + "self_attn."),
            "attn_ln_w": tensors[lp + "self_attn_layer_norm.weight"],
            "attn_ln_b": tensors[lp + "self_attn_layer_norm.bias"],
            "fc1": linear(tensors, lp + "fc1.weight"), "fc1_b": tensors[lp + "fc1.bias"],
            "fc2": linear(tensors, lp + "fc2.weight"), "fc2_b": tensors[lp + "fc2.bias"],
            "final_ln_w": tensors[lp + "final_layer_norm.weight"],
            "final_ln_b": tensors[lp + "final_layer_norm.bias"],
        }
        if cross:
            b.update({"xattn": _attn_params(tensors, lp + "encoder_attn."),
                      "xattn_ln_w": tensors[lp + "encoder_attn_layer_norm.weight"],
                      "xattn_ln_b": tensors[lp + "encoder_attn_layer_norm.bias"]})
        return b

    return {
        "embed": shared,
        "final_logits_bias": bias.reshape(-1),
        "enc_blocks": {str(i): block(f"{prefix}encoder.layers.{i}.", False)
                       for i in range(cfg.enc_layers)},
        "dec_blocks": {str(i): block(f"{prefix}decoder.layers.{i}.", True)
                       for i in range(cfg.dec_layers)},
        "positions": torch.from_numpy(sinusoidal_positions(cfg.max_positions, cfg.dim)).to(
            shared.device),
    }


def _ln(x, w, b):
    return L.layer_norm(x, w, b, eps=1e-5)


def _proj(x, p, wk: str, bk: str):
    y = x @ p[wk].to(x.dtype)
    if bk in p:
        y = y + p[bk].to(x.dtype)
    return y


def _heads(x, heads: int):
    b, t, dim = x.shape
    return x.reshape(b, t, heads, dim // heads).transpose(1, 2)


def _mha(p, q_in, kv, heads: int, mask=None, cache=None, cache_index=None):
    """Marian attention (1 / sqrt(head_dim) scaling). ``kv`` is the key and
    value input, or a precomputed (k, v) pair; with ``cache`` the rows' K
    and V are written in place at ``cache_index`` (the start clamped so they
    fit, as ``dynamic_update_slice`` clamps) and attention runs over the
    whole cache."""
    dtype = q_in.dtype
    b, tq, dim = q_in.shape
    q = _heads(_proj(q_in, p, "wq", "bq"), heads)
    if isinstance(kv, tuple):
        k, v = kv
    else:
        k = _heads(_proj(kv, p, "wk", "bk"), heads)
        v = _heads(_proj(kv, p, "wv", "bv"), heads)
    if cache is not None:
        start = max(0, min(int(cache_index), cache["k"].shape[2] - tq))
        cache["k"][:, :, start : start + tq] = k.to(cache["k"].dtype)
        cache["v"][:, :, start : start + tq] = v.to(cache["v"].dtype)
        k, v = cache["k"], cache["v"]
    out = L.attention(q, k.to(dtype), v.to(dtype), mask)
    return _proj(out.transpose(1, 2).reshape(b, tq, dim), p, "wo", "bo")


_ACTIVATIONS = {
    "swish": F.silu,
    "silu": F.silu,
    "relu": torch.relu,
    "gelu": F.gelu,  # exact (erf)
}


def _ffn(block, x, activation: str):
    h = x @ block["fc1"].to(x.dtype) + block["fc1_b"].to(x.dtype)
    h = _ACTIVATIONS[activation](h)
    return h @ block["fc2"].to(x.dtype) + block["fc2_b"].to(x.dtype)


def _embed_scale(cfg: MarianConfig) -> float:
    return float(np.sqrt(cfg.dim)) if cfg.scale_embedding else 1.0


def _dtype(params):
    return L.compute_dtype(params["embed"].device)


def encode(params, cfg: MarianConfig, src_ids, src_mask=None):
    """src_ids [B, S] -> encoder states [B, S, dim]; ``src_mask`` [B, S] bool
    marks the real (non-pad) tokens (default: all)."""
    dev = params["embed"].device
    dtype = _dtype(params)
    src_ids = torch.as_tensor(src_ids, device=dev).long()
    s = src_ids.shape[1]
    x = params["embed"].to(dtype)[src_ids] * _embed_scale(cfg)
    x = x + params["positions"][:s].to(dtype)[None]
    attn_mask = None if src_mask is None else _key_mask(src_mask, dev)
    for i in range(cfg.enc_layers):
        block = params["enc_blocks"][str(i)]
        x = _ln(x + _mha(block["attn"], x, x, cfg.heads, mask=attn_mask),
                block["attn_ln_w"], block["attn_ln_b"])
        x = _ln(x + _ffn(block, x, cfg.activation), block["final_ln_w"], block["final_ln_b"])
    return x


def _key_mask(src_mask, dev):
    return torch.as_tensor(src_mask, device=dev).bool()[:, None, None, :]


def _decoder(params, cfg: MarianConfig, tok_embed, positions_slice, enc_kv, self_mask,
             caches, cache_index, cross_mask=None):
    x = tok_embed + positions_slice
    for i in range(cfg.dec_layers):
        block = params["dec_blocks"][str(i)]
        h = _mha(block["attn"], x, x, cfg.heads, mask=self_mask,
                 cache=None if caches is None else caches[str(i)], cache_index=cache_index)
        x = _ln(x + h, block["attn_ln_w"], block["attn_ln_b"])
        h = _mha(block["xattn"], x, enc_kv[str(i)], cfg.heads, mask=cross_mask)
        x = _ln(x + h, block["xattn_ln_w"], block["xattn_ln_b"])
        x = _ln(x + _ffn(block, x, cfg.activation), block["final_ln_w"], block["final_ln_b"])
    return x


def _enc_kv(params, cfg: MarianConfig, enc):
    """Cross-attention K / V of every decoder layer, once per source."""
    return {str(i): (_heads(_proj(enc, params["dec_blocks"][str(i)]["xattn"], "wk", "bk"),
                            cfg.heads),
                     _heads(_proj(enc, params["dec_blocks"][str(i)]["xattn"], "wv", "bv"),
                            cfg.heads))
            for i in range(cfg.dec_layers)}


def _logits(params, x, embed):
    return (x @ embed.T + params["final_logits_bias"]).float()


def forward(params, cfg: MarianConfig, src_ids, dec_ids):
    """Teacher-forced logits [B, T, vocab] f32."""
    dev = params["embed"].device
    dtype = _dtype(params)
    enc = encode(params, cfg, src_ids)
    dec_ids = torch.as_tensor(dec_ids, device=dev).long()
    t = dec_ids.shape[1]
    embed = params["embed"].to(dtype)
    tok = embed[dec_ids] * _embed_scale(cfg)
    pos = params["positions"][:t].to(dtype)[None]
    x = _decoder(params, cfg, tok, pos, _enc_kv(params, cfg, enc), L.causal_mask(t, t, device=dev),
                 None, None)
    return _logits(params, x, embed)


def _positions_rows(params, start: int, width: int, dtype):
    """``width`` rows of the positions table from ``start``, the start
    clamped so they fit (``dynamic_slice``'s rule)."""
    table = params["positions"]
    start = max(0, min(start, table.shape[0] - width))
    return table[start : start + width].to(dtype)[None]


def _init_decode(params, cfg: MarianConfig, src_ids, src_mask):
    dev = params["embed"].device
    dtype = _dtype(params)
    enc = encode(params, cfg, src_ids, src_mask=src_mask)
    b = enc.shape[0]
    shape = (b, cfg.heads, cfg.max_tokens, cfg.head_dim)
    caches = {str(i): {"k": torch.zeros(shape, dtype=dtype, device=dev),
                       "v": torch.zeros(shape, dtype=dtype, device=dev)}
              for i in range(cfg.dec_layers)}
    cross_mask = None if src_mask is None else _key_mask(src_mask, dev)
    return enc, _enc_kv(params, cfg, enc), caches, cross_mask, params["embed"].to(dtype)


def translate(params, cfg: MarianConfig, src_ids, max_new_tokens: int, src_mask=None):
    """Greedy decode [B, S] -> [B, max_new_tokens] int32 from
    ``decoder_start_token``. ``src_mask`` [B, S] bool marks the real source
    tokens (padding is masked out of the encoder's self-attention and the
    decoder's cross-attention). With ``forced_eos_token`` the last token is
    replaced by it, as transformers does at the length limit. More new
    tokens than ``cfg.max_tokens`` are refused."""
    if max_new_tokens > cfg.max_tokens:
        raise ValueError(
            f"max_new_tokens ({max_new_tokens}) exceeds the KV-cache capacity "
            f"({cfg.max_tokens}); reload with a larger max_tokens")
    dev = params["embed"].device
    dtype = _dtype(params)
    enc, enc_kv, caches, cross_mask, embed = _init_decode(params, cfg, src_ids, src_mask)
    b = enc.shape[0]
    scale = _embed_scale(cfg)
    slots = torch.arange(cfg.max_tokens, device=dev)
    token = torch.full((b,), cfg.decoder_start_token, dtype=torch.int32, device=dev)
    out = []
    for pos in range(max_new_tokens):
        tok = embed[token.long()][:, None, :] * scale
        mask = (slots <= pos)[None, None, None, :]
        x = _decoder(params, cfg, tok, _positions_rows(params, pos, 1, dtype), enc_kv, mask,
                     caches, pos, cross_mask=cross_mask)
        token = torch.argmax(_logits(params, x[:, -1], embed), dim=-1).to(torch.int32)
        if cfg.forced_eos_token is not None and pos == max_new_tokens - 1:
            token = torch.full_like(token, cfg.forced_eos_token)
        out.append(token)
    if not out:
        return torch.zeros((b, 0), dtype=torch.int32, device=dev)
    return torch.stack(out, dim=1)


def translate_speculative(params, cfg: MarianConfig, src_ids, max_new_tokens: int,
                          src_mask=None, k: int | None = None, ngram: int | None = None):
    """Greedy translation with prompt-lookup speculation: the tokens of
    :func:`translate`, up to k + 1 a decoder pass. Batch 1. Returns (tokens
    [1, max_new_tokens] int32, model passes)."""
    from dora_tpu_torch.models import spec_decode

    k = spec_decode.SPEC_K if k is None else k
    ngram = spec_decode.SPEC_NGRAM if ngram is None else ngram
    dev = params["embed"].device
    src_ids = torch.as_tensor(src_ids, device=dev)
    if src_ids.shape[0] != 1:
        raise ValueError(f"speculative decode is batch-1, not {src_ids.shape[0]}")
    # the context is the decoder-start token; cache rows reach (max_new - 1) + k
    spec_decode.check_headroom(1, max_new_tokens, cfg.max_tokens, "decoder start", k)
    dtype = _dtype(params)
    enc, enc_kv, caches, cross_mask, embed = _init_decode(params, cfg, src_ids, src_mask)
    scale = _embed_scale(cfg)
    slots = torch.arange(cfg.max_tokens, device=dev)

    # prefill: the decoder-start token at position 0
    start = torch.full((1, 1), cfg.decoder_start_token, dtype=torch.long, device=dev)
    x = _decoder(params, cfg, embed[start] * scale, _positions_rows(params, 0, 1, dtype), enc_kv,
                 (slots <= 0)[None, None, None, :], caches, 0, cross_mask=cross_mask)
    first = torch.argmax(_logits(params, x[:, -1], embed), dim=-1).to(torch.int32)
    history = torch.zeros((cfg.max_tokens,), dtype=torch.int32, device=dev)
    history[0] = cfg.decoder_start_token
    history[1] = first[0]

    def verify(chunk, n_emitted, caches):
        # chunk[0, 0] is generated index n_emitted - 1, at decoder position n_emitted
        width = chunk.shape[1]
        chunk_pos = n_emitted + torch.arange(width, device=dev)
        mask = slots[None, None, None, :] <= chunk_pos[None, None, :, None]
        x = _decoder(params, cfg, embed[chunk.long()] * scale,
                     _positions_rows(params, n_emitted, width, dtype), enc_kv, mask, caches,
                     n_emitted, cross_mask=cross_mask)
        return torch.argmax(_logits(params, x[0], embed), dim=-1).to(torch.int32), caches

    tokens, passes = spec_decode.run_loop(
        caches=caches, history=history, hist_len=2, first=first[0],
        max_new_tokens=max_new_tokens, seq=cfg.max_tokens, verify=verify, k=k, ngram=ngram,
        body=spec_decode.fitting_body_passes(1, max_new_tokens, cfg.max_tokens, k))
    if cfg.forced_eos_token is not None:
        # the replaced emission is never consumed, so replacing it afterwards is the same
        tokens[:, max_new_tokens - 1] = cfg.forced_eos_token
    return tokens, passes
