"""Qwen2-family causal LM on the paged serving path, on torch tensors.

Counterpart of the serving part of dora_tpu/models/hf/qwen2.py: the config,
checkpoint loading and int8 decode quantization, the fused paged batch and
chunk steps, the page pool and ``make_paged_engine``. ``params_from_jax``
turns the JAX package's parameter tree into this package's, so the two can
be held against each other on the same weights.

Not ported yet: the unfused ``forward``/``generate``, the dense batch engine,
speculative decoding, int8 KV pools, LoRA and int4 weights.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch

from dora_tpu_torch._device import resolve_device
from dora_tpu_torch.models import layers as L
from dora_tpu_torch.models.hf.loader import (
    linear,
    maybe_bias,
    read_config,
    read_safetensors,
)


@dataclass(frozen=True)
class Qwen2Config:
    vocab: int
    dim: int
    layers: int
    heads: int
    kv_heads: int
    ffn: int
    rope_theta: float
    norm_eps: float
    tie_embeddings: bool
    max_seq: int = 2048

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @classmethod
    def from_hf(cls, config: dict, max_seq: int | None = None) -> "Qwen2Config":
        return cls(
            vocab=config["vocab_size"],
            dim=config["hidden_size"],
            layers=config["num_hidden_layers"],
            heads=config["num_attention_heads"],
            kv_heads=config.get("num_key_value_heads", config["num_attention_heads"]),
            ffn=config["intermediate_size"],
            rope_theta=config.get("rope_theta", 10000.0),
            norm_eps=config.get("rms_norm_eps", 1e-6),
            tie_embeddings=config.get("tie_word_embeddings", False),
            max_seq=max_seq
            or min(config.get("max_position_embeddings", 2048), 2048),
        )

    @classmethod
    def qwen2_1_5b(cls, layers: int = 28, max_seq: int = 2048) -> "Qwen2Config":
        """Qwen/Qwen2-1.5B's shape (its config.json); the language model of
        the repo's Qwen2-VL-2B benchmark shape. ``layers`` cuts depth only."""
        return cls(
            vocab=151936, dim=1536, layers=layers, heads=12, kv_heads=2,
            ffn=8960, rope_theta=1000000.0, norm_eps=1e-6,
            tie_embeddings=True, max_seq=max_seq,
        )


#: configs a caller may name (``llm_server --random-config``)
CONFIGS = {"qwen2_1_5b": Qwen2Config.qwen2_1_5b}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def load(model_dir: str | Path, max_seq: int | None = None, device=None):
    """(config, params) from a HF checkpoint directory; float weights as
    f32 on ``device`` (default cuda)."""
    dev = resolve_device(device)
    cfg = Qwen2Config.from_hf(read_config(model_dir), max_seq)
    tensors = read_safetensors(model_dir)
    prefix = "model." if any(k.startswith("model.") for k in tensors) else ""
    return cfg, _to(map_params(tensors, cfg, prefix), dev)


def map_params(tensors: dict, cfg: Qwen2Config, prefix: str = "model.") -> dict:
    """Checkpoint names -> the shared-block parameter layout (f32)."""
    params: dict[str, Any] = {
        "embed": tensors[f"{prefix}embed_tokens.weight"],
        "out_norm": tensors[f"{prefix}norm.weight"],
        "blocks": {},
    }
    for i in range(cfg.layers):
        lp = f"{prefix}layers.{i}."
        block: dict[str, Any] = {
            "attn_norm": tensors[lp + "input_layernorm.weight"],
            "wq": linear(tensors, lp + "self_attn.q_proj.weight"),
            "wk": linear(tensors, lp + "self_attn.k_proj.weight"),
            "wv": linear(tensors, lp + "self_attn.v_proj.weight"),
            "wo": linear(tensors, lp + "self_attn.o_proj.weight"),
            "ffn_norm": tensors[lp + "post_attention_layernorm.weight"],
            "w_gate": linear(tensors, lp + "mlp.gate_proj.weight"),
            "w_up": linear(tensors, lp + "mlp.up_proj.weight"),
            "w_down": linear(tensors, lp + "mlp.down_proj.weight"),
        }
        maybe_bias(block, "bq", tensors, lp + "self_attn.q_proj.bias")
        maybe_bias(block, "bk", tensors, lp + "self_attn.k_proj.bias")
        maybe_bias(block, "bv", tensors, lp + "self_attn.v_proj.bias")
        maybe_bias(block, "bo", tensors, lp + "self_attn.o_proj.bias")
        params["blocks"][str(i)] = block
    if not cfg.tie_embeddings and "lm_head.weight" in tensors:
        params["lm_head"] = linear(tensors, "lm_head.weight")

    def f32(tree):
        if isinstance(tree, dict):
            return {k: f32(v) for k, v in tree.items()}
        return tree.float().contiguous()

    return f32(params)


def random_params(cfg: Qwen2Config, *, seed: int = 0, std: float = 0.02,
                  device=None) -> dict:
    """Seeded random f32 weights at ``cfg``'s shape (normal, ``std``; norm
    weights one), made on ``device`` — for serving without a checkpoint."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=dev) * std

    d, hd = cfg.dim, cfg.head_dim
    params: dict[str, Any] = {
        "embed": normal(cfg.vocab, d),
        "out_norm": torch.ones(d, device=dev),
        "blocks": {},
    }
    for i in range(cfg.layers):
        params["blocks"][str(i)] = {
            "attn_norm": torch.ones(d, device=dev),
            "wq": normal(d, cfg.heads * hd),
            "wk": normal(d, cfg.kv_heads * hd),
            "wv": normal(d, cfg.kv_heads * hd),
            "bq": normal(cfg.heads * hd),
            "bk": normal(cfg.kv_heads * hd),
            "bv": normal(cfg.kv_heads * hd),
            "wo": normal(cfg.heads * hd, d),
            "ffn_norm": torch.ones(d, device=dev),
            "w_gate": normal(d, cfg.ffn),
            "w_up": normal(d, cfg.ffn),
            "w_down": normal(cfg.ffn, d),
        }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(d, cfg.vocab)
    return params


def quantize_decode(params, cfg: Qwen2Config) -> dict:
    """Quantize the decode path (blocks + head) into the int8 fused kernel
    layout; a tied head is quantized from the embedding transpose, and the
    embedding itself stays float for the gather. int8 only, without the
    bf16 sidecar (see ops/int8_matmul.py)."""
    from dora_tpu_torch.ops.int8_matmul import quantize_int8, quantize_tree

    out = dict(params)
    out["blocks"] = quantize_tree(params["blocks"])
    head = params.get("lm_head")
    if cfg.tie_embeddings or head is None:
        head = params["embed"].T
    out["lm_head"] = quantize_int8(head)
    return out


def params_from_jax(tree, device=None) -> dict:
    """The JAX package's parameter tree (arrays or numpy arrays, quantized
    dicts included) as this package's tensors on ``device`` (default cuda).
    The ``bf16`` sidecar of quantized dicts is dropped: the fused path never
    reads it."""
    dev = resolve_device(device)

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items() if k != "bf16"}
        return torch.from_numpy(np.array(v)).to(dev)

    return conv(tree)


def _rope(cfg: Qwen2Config, device):
    return L.rope_table(cfg.max_seq, cfg.head_dim, base=cfg.rope_theta,
                        device=device)


def fused_paged_batch_step(params, cfg, tokens, pools, positions,
                           block_tables, rope=None):
    """One fused decode step for B independent streams over paged pools.
    tokens/positions [B] int32; block_tables [B, max_pages] int32 (0 = the
    null page); ``rope`` the (cos, sin) tables, made here when None.
    Returns (greedy [B], pools)."""
    from dora_tpu_torch.models import vlm as _vlm
    from dora_tpu_torch.ops import decode_block as DB

    embed = params["embed"]
    cos_t, sin_t = rope if rope is not None else _rope(cfg, embed.device)
    cos_rows, sin_rows = DB.rope_rows_at(cos_t, sin_t, positions)
    x = embed[tokens.long()].to(L.compute_dtype(embed.device))
    return _vlm.fused_paged_pass_batch(
        params, x, pools, positions, block_tables, cos_rows, sin_rows,
        heads=cfg.heads, kv_heads=cfg.kv_heads, head_dim=cfg.head_dim,
        layers=cfg.layers, eps=cfg.norm_eps,
    )


def fused_paged_chunk_step(params, cfg, chunk_ids, pools, position: int,
                           block_table, rope=None):
    """One prefill chunk into paged pools: chunk_ids [C] int32 at positions
    ``position..position+C-1`` (page multiples; the tail chunk is
    right-padded and its pad rows are overwritten by decode before any row
    attends them). Returns (greedy [C], pools)."""
    from dora_tpu_torch.models import vlm as _vlm
    from dora_tpu_torch.ops import decode_block as DB

    embed = params["embed"]
    cos_t, sin_t = rope if rope is not None else _rope(cfg, embed.device)
    cos_rows, sin_rows = DB.rope_rows(cos_t, sin_t, position, chunk_ids.shape[0])
    x = embed[chunk_ids.long()].to(L.compute_dtype(embed.device))
    return _vlm.fused_paged_pass_chunk(
        params, x, pools, position, block_table, cos_rows, sin_rows,
        heads=cfg.heads, kv_heads=cfg.kv_heads, head_dim=cfg.head_dim,
        layers=cfg.layers, eps=cfg.norm_eps,
    )


def init_page_pool(cfg: Qwen2Config, num_pages: int, page_size: int,
                   dtype=None, device=None):
    """Per-layer paged KV pools {layer: {k/v: [P, KV, page, hd]}}, zeroed,
    in the compute dtype of ``device`` (default cuda). Page 0 is the null
    page."""
    dev = resolve_device(device)
    dtype = dtype or L.compute_dtype(dev)
    shape = (num_pages, cfg.kv_heads, page_size, cfg.head_dim)
    return {
        str(i): {
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
        }
        for i in range(cfg.layers)
    }


def page_pool_bytes(cfg: Qwen2Config, page_size: int,
                    dtype: torch.dtype = torch.bfloat16) -> int:
    """Bytes of one page of one layer's K+V."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 2 * cfg.kv_heads * page_size * cfg.head_dim * itemsize


def make_paged_engine(params, cfg: Qwen2Config, *, max_slots: int = 16,
                      eos: int | None = None, page_size: int = 16,
                      chunk: int | None = None, num_pages: int | None = None,
                      window: int | None = None, device=None):
    """Paged-KV continuous-batching engine over ``quantize_decode`` params,
    on ``device`` (default cuda; the params move there). The pool defaults
    to the dense engine's 4-slot footprint (4 * max_seq rows per layer,
    null page included); ``window`` is the decode window K (default: env
    ``DORA_MULTISTEP_K``, else 8)."""
    from dora_tpu_torch.models import vlm as _vlm
    from dora_tpu_torch.models.batch_engine import PagedBatchEngine

    if not _vlm.fused_batch_ready(params):
        raise ValueError("paged engine needs quantize_decode params")
    dev = resolve_device(device)
    params = _to(params, dev)
    chunk = chunk or min(256, cfg.max_seq)
    if num_pages is None:
        num_pages = 4 * cfg.max_seq // page_size
    if window is None:
        window = int(os.environ.get("DORA_MULTISTEP_K", "8"))
    rope = _rope(cfg, dev)

    def batch_step(tokens, pools, positions, bts):
        return fused_paged_batch_step(params, cfg, tokens, pools, positions,
                                      bts, rope=rope)

    def chunk_step(ids, pools, position, bt):
        return fused_paged_chunk_step(params, cfg, ids, pools, position, bt,
                                      rope=rope)

    return PagedBatchEngine(
        init_pool=lambda n: init_page_pool(cfg, n, page_size, device=dev),
        chunk_prefill=chunk_step,
        window_step=_vlm.make_paged_window(batch_step, k=window, eos=eos),
        window=window,
        max_slots=max_slots,
        max_seq=cfg.max_seq,
        page_size=page_size,
        chunk=chunk,
        num_pages=num_pages,
        eos=eos,
        device=dev,
    )
