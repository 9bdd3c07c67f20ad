"""Qwen2-family causal LM, on torch tensors.

Counterpart of dora_tpu/models/hf/qwen2.py: the config, checkpoint loading
and int8 or int4 decode quantization (with the bf16 sidecar unless
``DORA_INT8_PURE``); the unfused model (``_lm``, ``forward``,
``prefill_padded``) over models/layers.py; batch-1 greedy ``generate`` and
its fused step ``fused_step`` (one row, or a speculative verify's W rows,
over dense caches from ``init_cache``); the dense continuous-batching
engine ``make_batch_engine`` over ``fused_batch_step``; the fused paged
batch, chunk and speculative-verify steps (with multi-tenant LoRA deltas),
the page pool (fp or int8 KV), the adapter catalog ``make_lora_pool`` and
``make_paged_engine`` (speculation, the prefix cache, int8 KV and LoRA
included). ``params_from_jax`` turns the JAX package's parameter tree into
this package's, so the two can be held against each other on the same
weights. ``quantize_decode`` gives int8 weights, or the grouped int4 layout
under ``DORA_INT4_DECODE`` / ``DORA_WEIGHT_BITS=4``, and every engine serves
either.
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
from dora_tpu_torch.ops import lora as LO


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
    return _f32(params)


def _on(x, device) -> torch.Tensor:
    """A numpy array or tensor as a tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _host_ids(ids) -> np.ndarray:
    """Token ids (a tensor, an array or nested lists) as a host array."""
    return ids.cpu().numpy() if isinstance(ids, torch.Tensor) else np.asarray(ids)


def _f32(tree):
    """Every leaf of a checkpoint tree as a contiguous f32 tensor."""
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float().contiguous()


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
    """Quantize the decode path (blocks + head) into the fused kernel layout;
    a tied head is quantized from the embedding transpose, and the embedding
    itself stays float for the gather. Each weight keeps its bf16 sidecar for
    the large-M unfused products (prefill) unless ``DORA_INT8_PURE`` is set,
    as in the JAX package. ``DORA_INT4_DECODE``, or ``DORA_WEIGHT_BITS=4``,
    picks the grouped int4 layout (ops/int4.py) for every weight, the head
    included; any ``DORA_WEIGHT_BITS`` other than 4 or 8 raises."""
    from dora_tpu_torch.ops.int8_matmul import quantize_int8, quantize_tree

    bits = os.environ.get("DORA_WEIGHT_BITS", "")
    if bits and bits not in ("4", "8"):
        raise ValueError(f"DORA_WEIGHT_BITS must be 4 or 8, got {bits!r}")
    quantizer = quantize_int8
    if os.environ.get("DORA_INT4_DECODE") or bits == "4":
        from dora_tpu_torch.ops.int4 import quantize_int4 as quantizer
    keep_bf16 = not os.environ.get("DORA_INT8_PURE")
    out = dict(params)
    out["blocks"] = quantize_tree(params["blocks"], keep_bf16=keep_bf16, quantizer=quantizer)
    head = params.get("lm_head")
    if cfg.tie_embeddings or head is None:
        head = params["embed"].T
    out["lm_head"] = quantizer(head, keep_bf16)
    return out


def params_from_jax(tree, device=None):
    """The JAX package's parameter tree (arrays or numpy arrays in dicts,
    tuples and lists, quantized dicts and their ``bf16`` sidecars included,
    e.g. the VAD's ``(params, h0)`` state) as this package's tensors on
    ``device`` (default cuda), bit for bit, in the same containers."""
    dev = resolve_device(device)

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (tuple, list)):
            return type(v)(conv(x) for x in v)
        a = np.array(v)
        if a.dtype.name == "bfloat16":  # numpy's bf16 extension type: move the bits
            return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
        return torch.from_numpy(a).to(dev)

    return conv(tree)


def _rope(cfg: Qwen2Config, device):
    return L.rope_table(cfg.max_seq, cfg.head_dim, base=cfg.rope_theta,
                        device=device)


# ---------------------------------------------------------------------------
# the unfused model, batch-1 decode and the dense batch engine
# ---------------------------------------------------------------------------


def _head(params, cfg: Qwen2Config, dtype):
    head = params.get("lm_head")
    if isinstance(head, dict):  # quantized (quantize_decode)
        return head
    if cfg.tie_embeddings or head is None:
        return params["embed"].to(dtype).T
    return head.to(dtype)


def _head_logits(h, head):
    """h @ head in f32 logits, for a float head or a quantized head dict
    (whose one-row products take the int8 kernel, models/layers.matmul)."""
    if isinstance(head, dict):
        return L.matmul(h, head).float()
    return (h @ head).float()


def _lm(params, cfg: Qwen2Config, h, positions, mask, caches=None,
        cache_index: int | None = None, rope=None):
    """The unfused blocks over h [B, T, dim], then the final norm. With
    ``caches`` ({layer: {k, v}} [B, KV, S, hd]) each layer writes its rows at
    ``cache_index`` in place. Returns (h, caches or {})."""
    rope = rope if rope is not None else _rope(cfg, h.device)
    new_caches = {}
    for i in range(cfg.layers):
        h, new_cache = L.block_forward(
            params["blocks"][str(i)], h, cfg.heads, n_kv_heads=cfg.kv_heads,
            rope=rope, positions=positions, mask=mask,
            cache=None if caches is None else caches[str(i)],
            cache_index=cache_index, norm_eps=cfg.norm_eps,
        )
        if new_cache is not None:
            new_caches[str(i)] = new_cache
    return L.rms_norm(h, params["out_norm"], cfg.norm_eps), new_caches


def forward(params, cfg: Qwen2Config, tokens):
    """tokens [B, T] int -> logits [B, T, vocab] f32 (causal, no cache)."""
    embed = params["embed"]
    dev = embed.device
    dtype = L.compute_dtype(dev)
    b, t = tokens.shape
    h = embed[tokens.long().to(dev)].to(dtype)
    positions = torch.arange(t, device=dev).expand(b, t)
    h, _ = _lm(params, cfg, h, positions, L.causal_mask(t, t, device=dev))
    return _head_logits(h, _head(params, cfg, dtype))


def init_cache(cfg: Qwen2Config, batch: int, dtype=None, device=None):
    """Dense KV caches {layer: {k/v: [batch, KV, max_seq, hd]}}, zeroed, in
    the compute dtype of ``device`` (default cuda)."""
    dev = resolve_device(device)
    dtype = dtype or L.compute_dtype(dev)
    shape = (batch, cfg.kv_heads, cfg.max_seq, cfg.head_dim)
    return {
        str(i): {"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev)}
        for i in range(cfg.layers)
    }


def _prefill(params, cfg: Qwen2Config, prompt_ids, rope=None, h=None):
    """The unfused prompt pass of ``generate`` and ``prefill_padded``: the
    T prompt rows into fresh caches at 0 (each attending the rows before it
    among the first T). ``h`` [B, T, dim] is the embedded prompt when the
    caller made it (image features scattered in), else the token
    embeddings. Returns (h [B, T, dim], caches)."""
    embed = params["embed"]
    dev = embed.device
    b, t = prompt_ids.shape
    if h is None:
        h = embed[prompt_ids.long().to(dev)].to(L.compute_dtype(dev))
    positions = torch.arange(t, device=dev).expand(b, t)
    mask = L.causal_mask(t, cfg.max_seq, device=dev) & (
        torch.arange(cfg.max_seq, device=dev)[None, None, None, :] < t)
    caches = init_cache(cfg, b, device=dev)
    return _lm(params, cfg, h, positions, mask, caches=caches, cache_index=0, rope=rope)


def prefill_padded(params, cfg: Qwen2Config, prompt_ids, true_len: int, rope=None):
    """Prefill for the batching engine: ``prompt_ids`` [1, TB] is the prompt
    RIGHT-padded to a bucket length. Pad rows sit after the real tokens, so
    no real token attends one; the first generated token reads the hidden
    state at ``true_len - 1``; pad cache rows sit at >= true_len and decode
    overwrites each before it becomes attendable. Returns (first [1] int32,
    caches [1, ...], position = true_len)."""
    dtype = L.compute_dtype(params["embed"].device)
    h, caches = _prefill(params, cfg, prompt_ids, rope)
    last = h[:, int(true_len) - 1]
    first = torch.argmax(_head_logits(last, _head(params, cfg, dtype)), dim=-1)
    return first.to(torch.int32), caches, int(true_len)


def fused_step(params, cfg: Qwen2Config, tokens, caches, position: int, rope=None):
    """Standard-RoPE fused decode pass: tokens [1, W] at cache and rope
    positions ``position..position+W-1`` (W = 1: ``attention_step``; W > 1,
    a speculative verify: ``attention_chunk_step``). Returns (greedy [W]
    int32, caches), greedy[i] continuing the prefix through token i. Gate
    with models/vlm.fused_decode_ready."""
    from dora_tpu_torch.models import vlm as _vlm
    from dora_tpu_torch.ops import decode_block as DB

    embed = params["embed"]
    cos_t, sin_t = rope if rope is not None else _rope(cfg, embed.device)
    w = tokens.shape[1]
    cos_rows, sin_rows = DB.rope_rows(cos_t, sin_t, position, w)
    # ids past the vocab (DORA_SPEC_WORST_CASE drafts) clamp, as JAX's gather does
    ids = tokens[0].long().clamp(0, embed.shape[0] - 1)
    x = embed[ids].to(L.compute_dtype(embed.device))  # [W, dim]
    return _vlm.fused_decode_pass(
        params, x, caches, position, cos_rows, sin_rows, heads=cfg.heads,
        kv_heads=cfg.kv_heads, head_dim=cfg.head_dim, layers=cfg.layers,
        eps=cfg.norm_eps,
    )


def fused_batch_step(params, cfg: Qwen2Config, tokens, caches, positions, rope=None):
    """One fused decode step for B independent sequences over dense caches
    [B, KV, S, hd] per layer (standard RoPE at each row's own position).
    tokens/positions [B] int32. Returns (greedy [B] int32, caches): the
    dense engine's inner step."""
    from dora_tpu_torch.models import vlm as _vlm
    from dora_tpu_torch.ops import decode_block as DB

    embed = params["embed"]
    cos_t, sin_t = rope if rope is not None else _rope(cfg, embed.device)
    cos_rows, sin_rows = DB.rope_rows_at(cos_t, sin_t, positions)
    x = embed[tokens.long()].to(L.compute_dtype(embed.device))  # [B, dim]
    return _vlm.fused_decode_pass_batch(
        params, x, caches, positions, cos_rows, sin_rows, heads=cfg.heads,
        kv_heads=cfg.kv_heads, head_dim=cfg.head_dim, layers=cfg.layers,
        eps=cfg.norm_eps,
    )


def fused_gate(what: str, params, cfg, batch: int) -> bool:
    """models/vlm.fused_decode_ready for a decode of ``batch`` rows; when it
    holds, a model whose shapes the kernels do not take is refused
    on the card, each limit named (models/vlm.refuse_unkernelled). ``cfg``
    gives heads, kv_heads and head_dim (any Qwen2-class text config)."""
    from dora_tpu_torch.models import vlm as _vlm

    use_fused = _vlm.fused_decode_ready(params, batch)
    if use_fused:
        _vlm.refuse_unkernelled(what, params["embed"].device, heads=cfg.heads,
                                kv_heads=cfg.kv_heads, head_dim=cfg.head_dim, params=params)
    return use_fused


def generate(params, cfg: Qwen2Config, prompt_ids, max_new_tokens: int):
    """Greedy generation of ``max_new_tokens`` per row, as a host loop of
    steps. prompt_ids [B, T]; returns [B, max_new_tokens] int32 ([B, 0] at 0,
    as the JAX scan returns). The prompt
    runs unfused; each decode step runs the fused batch-1 pass when
    models/vlm.fused_decode_ready allows (B = 1, the quantized layout,
    ``DORA_FUSED_DECODE`` not 0), else the unfused blocks over one row."""
    b, t = prompt_ids.shape
    if t + max_new_tokens > cfg.max_seq:
        # Out-of-bounds cache rows would be silently clamped, corrupting the
        # KV cache: fail loudly instead (the JAX package's message).
        raise ValueError(
            f"prompt ({t}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_seq ({cfg.max_seq}); reload with a larger max_seq"
        )
    if max_new_tokens == 0:
        # The JAX scan of length 0: no token, not even the prefill's.
        return torch.zeros((b, 0), dtype=torch.int32, device=prompt_ids.device)
    dev = params["embed"].device
    use_fused = fused_gate("qwen2.generate", params, cfg, b)
    rope = _rope(cfg, dev)
    h, caches = _prefill(params, cfg, prompt_ids, rope)
    head = _head(params, cfg, L.compute_dtype(dev))
    token = torch.argmax(_head_logits(h[:, -1], head), dim=-1).to(torch.int32)
    return _greedy_steps(params, cfg, token, caches, t, max_new_tokens, use_fused, rope)


def _greedy_steps(params, cfg: Qwen2Config, token, caches, t: int, max_new_tokens: int,
                  use_fused: bool, rope):
    """``generate``'s tokens from the prompt's greedy token [B] and its
    caches over T = ``t`` rows: [B, max_new_tokens] int32, each later token
    from one step (the fused batch-1 pass, or the unfused blocks)."""
    embed = params["embed"]
    dev = embed.device
    dtype = L.compute_dtype(dev)
    head = _head(params, cfg, dtype)
    b = token.shape[0]
    out = [token]
    # Token j + 1 comes from the step at position t + j; the last token
    # needs no step after it.
    for position in range(t, t + max_new_tokens - 1):
        if use_fused:
            token, caches = fused_step(params, cfg, token[:, None], caches, position, rope)
        else:
            h = embed[token.long()].to(dtype)[:, None, :]
            mask = (torch.arange(cfg.max_seq, device=dev) <= position)[None, None, None, :]
            h, caches = _lm(params, cfg, h, torch.full((b, 1), position, device=dev), mask,
                            caches=caches, cache_index=position, rope=rope)
            token = torch.argmax(_head_logits(h[:, -1], head), dim=-1).to(torch.int32)
        out.append(token)
    return torch.stack(out, dim=1)


def make_batch_engine(params, cfg: Qwen2Config, *, max_slots: int = 4,
                      eos: int | None = None, device=None,
                      graphs: bool | None = None):
    """Dense continuous-batching engine (models/batch_engine.BatchEngine) on
    ``device`` (default cuda; the params move there): every slot owns a
    [KV, max_seq, hd] plane per layer, prompts prefill unfused into a
    bucket-padded one-slot cache, and each step is one ``fused_batch_step``
    over all slots. Needs ``quantize_decode`` params and the fused tier
    (models/vlm.fused_batch_ready: ``DORA_FUSED_DECODE=0`` refuses).
    ``graphs`` (default: on for a CUDA device; True on the CPU raises) runs
    each step as one CUDA-graph replay (models/vlm.GraphedWindow); False is
    the eager step."""
    from dora_tpu_torch import profiling
    from dora_tpu_torch.models import vlm as _vlm
    from dora_tpu_torch.models.batch_engine import BatchEngine

    if not _vlm.fused_batch_ready(params):
        raise ValueError("batch engine needs quantize_decode params and the fused "
                         "decode tier (DORA_FUSED_DECODE not 0)")
    _vlm.refuse_unkernelled("make_batch_engine", device, heads=cfg.heads,
                            kv_heads=cfg.kv_heads, head_dim=cfg.head_dim, params=params)
    dev = resolve_device(device)
    params = _to(params, dev)
    rope = _rope(cfg, dev)
    engine = BatchEngine(
        init_caches=lambda n: init_cache(cfg, n, device=dev),
        prefill=lambda ids, true_len: prefill_padded(params, cfg, ids, true_len, rope),
        batch_step=lambda tokens, caches, positions: fused_batch_step(
            params, cfg, tokens, caches, positions, rope),
        max_slots=max_slots,
        max_seq=cfg.max_seq,
        eos=eos,
        device=dev,
        graphs=graphs,
    )
    engine.flops_per_token = profiling.flops_per_token_config(cfg)
    engine.device_peak_flops = profiling.detect_peak_flops(dev)
    return engine


def fused_paged_batch_step(params, cfg, tokens, pools, positions,
                           block_tables, rope=None, lora=None):
    """One fused decode step for B independent streams over paged pools.
    tokens/positions [B] int32; block_tables [B, max_pages] int32 (0 = the
    null page); ``rope`` the (cos, sin) tables, made here when None;
    ``lora`` is ``(adapters [B], a_stack [S, L, dim, r], b_stack [S, L, r,
    dim])``, each row's adapter delta (slot 0 = base). Returns
    (greedy [B], pools)."""
    from dora_tpu_torch.models import vlm as _vlm
    from dora_tpu_torch.ops import decode_block as DB

    embed = params["embed"]
    cos_t, sin_t = rope if rope is not None else _rope(cfg, embed.device)
    cos_rows, sin_rows = DB.rope_rows_at(cos_t, sin_t, positions)
    x = embed[tokens.long()].to(L.compute_dtype(embed.device))
    return _vlm.fused_paged_pass_batch(
        params, x, pools, positions, block_tables, cos_rows, sin_rows,
        heads=cfg.heads, kv_heads=cfg.kv_heads, head_dim=cfg.head_dim,
        layers=cfg.layers, eps=cfg.norm_eps, lora=lora,
    )


def fused_paged_spec_step(params, cfg, chunks, pools, positions, block_tables,
                          rope=None, lora=None):
    """Speculative verification pass for B streams over paged pools:
    chunks [B, m] int32 holds each stream's last token and m-1 drafts at
    positions ``positions[b]..positions[b]+m-1``; greedy[b, i] continues
    stream b's prefix through candidate i. Returns (greedy [B, m], pools).
    The spec window's inner step (models/vlm.make_paged_spec_window).
    ``lora`` as in :func:`fused_paged_batch_step`, one adapter per stream:
    every candidate row of a stream gathers that stream's adapter."""
    from dora_tpu_torch.models import vlm as _vlm
    from dora_tpu_torch.ops import decode_block as DB

    embed = params["embed"]
    b, m = chunks.shape
    cos_t, sin_t = rope if rope is not None else _rope(cfg, embed.device)
    flat_pos = (positions[:, None] + torch.arange(m, dtype=positions.dtype,
                                                  device=positions.device)[None, :])
    cos_rows, sin_rows = DB.rope_rows_at(cos_t, sin_t, flat_pos.reshape(b * m))
    x = embed[chunks.reshape(b * m).long()].to(L.compute_dtype(embed.device))
    if lora is not None:
        groups, a_stack, b_stack = lora
        # each stream's id for its m rows (an expand: no host sync, so the
        # pass stays capturable in a CUDA graph)
        lora = (groups[:, None].expand(b, m).reshape(b * m), a_stack, b_stack)
    greedy, pools = _vlm.fused_paged_pass_spec(
        params, x, pools, positions, block_tables, cos_rows, sin_rows,
        heads=cfg.heads, kv_heads=cfg.kv_heads, head_dim=cfg.head_dim,
        layers=cfg.layers, m=m, eps=cfg.norm_eps, lora=lora,
    )
    return greedy.reshape(b, m), pools


def fused_paged_chunk_step(params, cfg, chunk_ids, pools, position: int,
                           block_table, rope=None, lora=None):
    """One prefill chunk into paged pools: chunk_ids [C] int32 at positions
    ``position..position+C-1`` (page multiples; the tail chunk is
    right-padded and its pad rows are overwritten by decode before any row
    attends them). ``lora`` is ``(adapter, a_stack, b_stack)`` with the
    prompt's one adapter slot, broadcast to the C rows. Returns
    (greedy [C], pools)."""
    from dora_tpu_torch.models import vlm as _vlm
    from dora_tpu_torch.ops import decode_block as DB

    embed = params["embed"]
    cos_t, sin_t = rope if rope is not None else _rope(cfg, embed.device)
    c = chunk_ids.shape[0]
    cos_rows, sin_rows = DB.rope_rows(cos_t, sin_t, position, c)
    x = embed[chunk_ids.long()].to(L.compute_dtype(embed.device))
    if lora is not None:
        adapter, a_stack, b_stack = lora
        groups = torch.full((c,), int(adapter), dtype=torch.int32, device=x.device)
        lora = (groups, a_stack, b_stack)
    return _vlm.fused_paged_pass_chunk(
        params, x, pools, position, block_table, cos_rows, sin_rows,
        heads=cfg.heads, kv_heads=cfg.kv_heads, head_dim=cfg.head_dim,
        layers=cfg.layers, eps=cfg.norm_eps, lora=lora,
    )


def init_page_pool(cfg: Qwen2Config, num_pages: int, page_size: int,
                   dtype=None, device=None, kv_int8: bool = False):
    """Per-layer paged KV pools {layer: {k/v: [P, KV, page, hd]}}, zeroed,
    in the compute dtype of ``device`` (default cuda). Page 0 is the null
    page. ``kv_int8`` makes the value pools int8 and adds ``ks``/``vs``
    [P, KV, page] f32 scale planes (one scale per page row per kv head) in
    the same per-layer dict, so whatever moves a layer's pools moves values
    and scales together."""
    dev = resolve_device(device)
    dtype = torch.int8 if kv_int8 else (dtype or L.compute_dtype(dev))
    shape = (num_pages, cfg.kv_heads, page_size, cfg.head_dim)
    pools = {
        str(i): {
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
        }
        for i in range(cfg.layers)
    }
    if kv_int8:
        for lp in pools.values():
            lp["ks"] = torch.zeros(shape[:3], dtype=torch.float32, device=dev)
            lp["vs"] = torch.zeros(shape[:3], dtype=torch.float32, device=dev)
    return pools


def page_pool_bytes(cfg: Qwen2Config, page_size: int,
                    dtype: torch.dtype = torch.bfloat16,
                    kv_int8: bool = False) -> int:
    """Bytes of one page of one layer's K+V in ``dtype``, or with
    ``kv_int8`` its int8 values plus their f32 scale planes: the unit the
    int8 pool is sized in."""
    values = 2 * cfg.kv_heads * page_size * cfg.head_dim
    if kv_int8:
        return values + 2 * cfg.kv_heads * page_size * 4
    return values * torch.empty((), dtype=dtype).element_size()


def make_lora_pool(cfg: Qwen2Config, lora_dir, *, max_resident: int = 8,
                   rank: int | None = None, device=None):
    """Adapter catalog + resident pool for multi-tenant LoRA serving
    (models/lora_pool.AdapterPool) on ``device`` (default cuda).
    ``lora_dir`` holds one ``<name>.npz`` per servable adapter with
    per-layer keys ``a_{i}`` [dim, r] / ``b_{i}`` [r, dim]; the file stem is
    the tenant name requests route on. The resident stack is homogeneous in
    rank: ``rank`` defaults to the largest in the catalog and smaller
    adapters are zero-padded into it (zero rows and columns add exactly
    zero), so admission never changes the stack's shape. The stack per
    slot is ``{"a": [L, dim, r], "b": [L, r, dim]}`` in the compute dtype."""
    from dora_tpu_torch.models import vlm as _vlm
    from dora_tpu_torch.models.lora_pool import AdapterPool

    files = {
        f[: -len(".npz")]: os.path.join(lora_dir, f)
        for f in sorted(os.listdir(lora_dir))
        if f.endswith(".npz")
    }
    if not files:
        raise ValueError(f"DORA_LORA_DIR {lora_dir!r} has no .npz adapters")
    if rank is None:
        rank = 1
        for path in files.values():
            with np.load(path) as z:
                rank = max(rank, z["a_0"].shape[-1])
    if _vlm.on_card(device):
        limits = LO.kernel_shape_limits(rank, cfg.dim)
        if limits:
            raise ValueError("make_lora_pool: " + "; ".join(limits))
    dev = resolve_device(device)
    dtype = L.compute_dtype(dev)
    template = {
        "a": torch.zeros((cfg.layers, cfg.dim, rank), dtype=dtype, device=dev),
        "b": torch.zeros((cfg.layers, rank, cfg.dim), dtype=dtype, device=dev),
    }

    def loader(name):
        with np.load(files[name]) as z:
            a = np.stack([z[f"a_{i}"] for i in range(cfg.layers)])
            b = np.stack([z[f"b_{i}"] for i in range(cfg.layers)])
        r = a.shape[-1]
        if r > rank:
            raise ValueError(f"adapter {name!r} has rank {r} > the stack's {rank}")
        a = np.pad(a, ((0, 0), (0, 0), (0, rank - r)))
        b = np.pad(b, ((0, 0), (0, rank - r), (0, 0)))
        return {"a": torch.from_numpy(a).to(dev, dtype),
                "b": torch.from_numpy(b).to(dev, dtype)}

    return AdapterPool(loader, template, max_resident=max_resident,
                       known=set(files))


def make_paged_engine(params, cfg: Qwen2Config, *, max_slots: int = 16,
                      eos: int | None = None, page_size: int = 16,
                      chunk: int | None = None, num_pages: int | None = None,
                      window: int | None = None, spec_k: int | None = None,
                      spec_ngram: int | None = None,
                      prefix_cache: bool | None = None,
                      prefix_cache_pages: int | None = None,
                      kv_int8: bool | None = None, lora_dir: str | None = None,
                      lora_max_resident: int | None = None, device=None,
                      graphs: bool | None = None):
    """Paged-KV continuous-batching engine over ``quantize_decode`` params,
    on ``device`` (default cuda; the params move there). The pool defaults
    to the dense engine's 4-slot footprint (4 * max_seq rows per layer,
    null page included); ``window`` is the decode window K (default: env
    ``DORA_MULTISTEP_K``, else 8).

    ``spec_k`` (default: env ``DORA_SPEC_K``, else 0 = off) folds
    prompt-lookup speculation into every window tick
    (models/vlm.make_paged_spec_window), drafting by the trailing
    ``spec_ngram`` (env ``DORA_SPEC_NGRAM``, default 2); tokens are those
    of ``spec_k = 0``. ``prefix_cache`` (default: env ``DORA_PREFIX_CACHE``,
    else off at this raw level; the serving front door turns it on) maps
    cached prompt pages into new streams, capped at ``prefix_cache_pages``
    (env ``DORA_PREFIX_CACHE_PAGES``, 0 = no cap).

    ``kv_int8`` (default: env ``DORA_KV_INT8``, else off) keeps KV pages in
    int8 with per-row f32 scales, and the default pool then holds as many
    int8 pages as fit the fp pool's byte budget. ``lora_dir`` (default: env
    ``DORA_LORA_DIR``) turns on multi-tenant LoRA: a resident-adapter pool
    (:func:`make_lora_pool`, ``lora_max_resident`` slots, env
    ``DORA_LORA_MAX_RESIDENT``, default 8; stack rank from env
    ``DORA_LORA_RANK``, else the catalog's largest), and every pass adds
    each stream's adapter delta.

    ``graphs`` (default: on for a CUDA device; True on the CPU raises) runs
    each decode window as one CUDA-graph replay, captured once per (K,
    spec_k) (models/vlm.GraphedWindow); False is the eager window. The
    prefill chunk is eager either way."""
    from dora_tpu_torch import profiling
    from dora_tpu_torch.models import vlm as _vlm
    from dora_tpu_torch.models.batch_engine import PagedBatchEngine

    if not _vlm.fused_batch_ready(params):
        raise ValueError("paged engine needs quantize_decode params")
    _vlm.refuse_unkernelled("make_paged_engine", device, heads=cfg.heads,
                            kv_heads=cfg.kv_heads, head_dim=cfg.head_dim, page=page_size,
                            params=params)
    dev = resolve_device(device)
    params = _to(params, dev)
    chunk = chunk or min(256, cfg.max_seq)
    if kv_int8 is None:
        kv_int8 = os.environ.get("DORA_KV_INT8", "0") != "0"
    if num_pages is None:
        num_pages = 4 * cfg.max_seq // page_size
        if kv_int8:
            # The fp default's byte budget, in int8 pages (scales included).
            budget = num_pages * page_pool_bytes(cfg, page_size, L.compute_dtype(dev))
            num_pages = budget // page_pool_bytes(cfg, page_size, kv_int8=True)
    if window is None:
        window = int(os.environ.get("DORA_MULTISTEP_K", "8"))
    if spec_k is None:
        spec_k = int(os.environ.get("DORA_SPEC_K", "0"))
    if spec_ngram is None:
        spec_ngram = int(os.environ.get("DORA_SPEC_NGRAM", "2"))
    if prefix_cache is None:
        prefix_cache = os.environ.get("DORA_PREFIX_CACHE", "0") != "0"
    if prefix_cache_pages is None:
        prefix_cache_pages = int(os.environ.get("DORA_PREFIX_CACHE_PAGES", "0"))
    if lora_dir is None:
        lora_dir = os.environ.get("DORA_LORA_DIR") or None
    lora_pool = None
    if lora_dir:
        if lora_max_resident is None:
            lora_max_resident = int(os.environ.get("DORA_LORA_MAX_RESIDENT", "8"))
        rank_env = os.environ.get("DORA_LORA_RANK")
        lora_pool = make_lora_pool(cfg, lora_dir, max_resident=lora_max_resident,
                                   rank=int(rank_env) if rank_env else None,
                                   device=dev)
    rope = _rope(cfg, dev)

    # With an adapter pool every step takes the stream's adapter slot(s) and
    # the resident stack as trailing operands.
    def _lora(adapters, ls):
        return (adapters, ls["a"], ls["b"])

    def batch_step(tokens, pools, positions, bts, *lora):
        return fused_paged_batch_step(params, cfg, tokens, pools, positions,
                                      bts, rope=rope, lora=_lora(*lora) if lora else None)

    def spec_step(chunks, pools, positions, bts, *lora):
        return fused_paged_spec_step(params, cfg, chunks, pools, positions,
                                     bts, rope=rope, lora=_lora(*lora) if lora else None)

    def chunk_step(ids, pools, position, bt, *lora):
        return fused_paged_chunk_step(params, cfg, ids, pools, position, bt,
                                      rope=rope, lora=_lora(*lora) if lora else None)

    def window_factory(k, sk):
        """(k, spec_k) -> window; the engine caches what it builds."""
        if sk:
            return _vlm.make_paged_spec_window(spec_step, k=k, spec_k=sk,
                                               ngram=spec_ngram, eos=eos,
                                               lora=lora_pool is not None)
        return _vlm.make_paged_window(batch_step, k=k, eos=eos,
                                      lora=lora_pool is not None)

    engine = PagedBatchEngine(
        init_pool=lambda n: init_page_pool(cfg, n, page_size, device=dev,
                                           kv_int8=kv_int8),
        chunk_prefill=chunk_step,
        window_step=window_factory(window, spec_k),
        window_factory=window_factory,
        window=window,
        max_slots=max_slots,
        max_seq=cfg.max_seq,
        page_size=page_size,
        chunk=chunk,
        num_pages=num_pages,
        eos=eos,
        spec_k=spec_k,
        spec_ngram=spec_ngram,
        prefix_cache=prefix_cache,
        prefix_cache_pages=prefix_cache_pages,
        lora_pool=lora_pool,
        device=dev,
        graphs=graphs,
    )
    engine.flops_per_token = profiling.flops_per_token_config(cfg)
    engine.device_peak_flops = profiling.detect_peak_flops(dev)
    return engine
