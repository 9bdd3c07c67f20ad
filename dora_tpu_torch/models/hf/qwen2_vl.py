"""Qwen2-VL serving HF checkpoints, on torch tensors.

Counterpart of dora_tpu/models/hf/qwen2_vl.py (transformers'
``Qwen2VLForConditionalGeneration``): the config (``VisionConfig``,
``Qwen2VLConfig``), checkpoint loading over both on-disk layouts, with the
text model built by models/hf/qwen2.map_params; the vision tower (the
Conv3d patch embedding as one product, 2-D rotary over the patch grid from
``vision_rotary``, pre-LN blocks with a fused biased qkv, dense attention
(``_block_diag_mask`` keeps each image to its own patches), QuickGELU, then
the 2 x 2 PatchMerger with an exact GELU into the LM width); M-RoPE
(``rope_index`` on the host, ``_mrope_tables`` splitting the rotary
channels over the t / h / w position axes by ``mrope_section``); image
features scattered over the ``<|image_pad|>`` positions in order
(``_embed_with_images``); ``forward``; greedy ``generate`` and prompt-lookup
``generate_speculative`` as host loops (the JAX package scans), each decode
pass the fused batch-1 tier when models/vlm.fused_decode_ready allows
(``attention_step`` or ``attention_chunk_step`` and ``mlp_step`` a layer,
then ``lm_head_argmax``) with its rope rows at the M-RoPE position, which
is not the cache position once an image has been through; and the
operator-tier step: ``smart_resize``, ``preprocess_image`` (the HF
processor's window-major patches), ``build_prompt_ids`` and
``make_serving_step``.

Entry points run where the parameters are (``load`` puts them on
``device``, default cuda); host-side bookkeeping (rotary angles, the
block-diagonal mask, the M-RoPE positions) stays in numpy, as in the JAX
package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch

from dora_tpu_torch._device import resolve_device
from dora_tpu_torch.models import layers as L
from dora_tpu_torch.models import vlm as _vlm
from dora_tpu_torch.models.hf import qwen2
from dora_tpu_torch.models.hf.loader import linear, read_config, read_safetensors
from dora_tpu_torch.models.hf.qwen2 import _host_ids, _on
from dora_tpu_torch.ops import decode_block as DB


@dataclass(frozen=True)
class VisionConfig:
    depth: int
    embed_dim: int
    heads: int
    mlp_ratio: float
    patch_size: int
    temporal_patch_size: int
    spatial_merge_size: int
    in_channels: int
    out_dim: int  # LM hidden size (merger output)

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.heads

    @property
    def merge_dim(self) -> int:
        return self.embed_dim * self.spatial_merge_size**2


@dataclass(frozen=True)
class Qwen2VLConfig:
    vocab: int
    dim: int
    layers: int
    heads: int
    kv_heads: int
    ffn: int
    rope_theta: float
    norm_eps: float
    tie_embeddings: bool
    mrope_section: tuple[int, ...]
    image_token_id: int
    video_token_id: int
    vision_start_token_id: int
    vision_end_token_id: int
    vision: VisionConfig
    max_seq: int = 2048

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @classmethod
    def from_hf(cls, config: dict, max_seq: int | None = None) -> "Qwen2VLConfig":
        vision = config["vision_config"]
        rope_scaling = config.get("rope_scaling") or {}
        head_dim = config["hidden_size"] // config["num_attention_heads"]
        return cls(
            vocab=config["vocab_size"],
            dim=config["hidden_size"],
            layers=config["num_hidden_layers"],
            heads=config["num_attention_heads"],
            kv_heads=config.get("num_key_value_heads", config["num_attention_heads"]),
            ffn=config["intermediate_size"],
            rope_theta=config.get("rope_theta", 1e6),
            norm_eps=config.get("rms_norm_eps", 1e-6),
            tie_embeddings=config.get("tie_word_embeddings", False),
            mrope_section=tuple(rope_scaling.get("mrope_section") or [head_dim // 2]),
            image_token_id=config.get("image_token_id", 151655),
            video_token_id=config.get("video_token_id", 151656),
            vision_start_token_id=config.get("vision_start_token_id", 151652),
            vision_end_token_id=config.get("vision_end_token_id", 151653),
            vision=VisionConfig(
                depth=vision["depth"],
                embed_dim=vision["embed_dim"],
                heads=vision["num_heads"],
                mlp_ratio=vision.get("mlp_ratio", 4.0),
                patch_size=vision.get("patch_size", 14),
                temporal_patch_size=vision.get("temporal_patch_size", 2),
                spatial_merge_size=vision.get("spatial_merge_size", 2),
                in_channels=vision.get("in_channels", 3),
                out_dim=vision.get("hidden_size", config["hidden_size"]),
            ),
            max_seq=max_seq or min(config.get("max_position_embeddings", 2048), 2048),
        )


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


def load(model_dir: str | Path, max_seq: int | None = None, device=None):
    """(config, params) from a HF checkpoint directory; weights as f32 on
    ``device`` (default cuda)."""
    dev = resolve_device(device)
    cfg = Qwen2VLConfig.from_hf(read_config(model_dir), max_seq)
    return cfg, qwen2._to(map_params(read_safetensors(model_dir), cfg), dev)


def map_params(tensors: dict, cfg: Qwen2VLConfig) -> dict:
    """Checkpoint names -> the parameter tree (f32): the text model's
    (models/hf/qwen2.map_params) with a ``vision`` subtree. Newer checkpoints
    nest under model.language_model / model.visual; the original layout has
    model.* for the text and visual.* at the top."""
    if any(k.startswith("model.language_model.") for k in tensors):
        text_prefix, vis_prefix = "model.language_model.", "model.visual."
    else:
        text_prefix, vis_prefix = "model.", "visual."
    text_cfg = qwen2.Qwen2Config(
        vocab=cfg.vocab, dim=cfg.dim, layers=cfg.layers, heads=cfg.heads,
        kv_heads=cfg.kv_heads, ffn=cfg.ffn, rope_theta=cfg.rope_theta,
        norm_eps=cfg.norm_eps, tie_embeddings=cfg.tie_embeddings, max_seq=cfg.max_seq,
    )
    params = qwen2.map_params(tensors, text_cfg, prefix=text_prefix)

    v = cfg.vision
    vis: dict[str, Any] = {
        # Conv3d with stride == kernel over flattened patches is one product:
        # [embed, C, tp, ps, ps] -> [C*tp*ps*ps, embed].
        "patch_proj": tensors[vis_prefix + "patch_embed.proj.weight"]
        .reshape(v.embed_dim, -1).T,
        "blocks": {},
        "merger_ln": tensors[vis_prefix + "merger.ln_q.weight"],
        "merger_ln_b": tensors[vis_prefix + "merger.ln_q.bias"],
        "merger_fc1": linear(tensors, vis_prefix + "merger.mlp.0.weight"),
        "merger_fc1_b": tensors[vis_prefix + "merger.mlp.0.bias"],
        "merger_fc2": linear(tensors, vis_prefix + "merger.mlp.2.weight"),
        "merger_fc2_b": tensors[vis_prefix + "merger.mlp.2.bias"],
    }
    for i in range(v.depth):
        bp = f"{vis_prefix}blocks.{i}."
        vis["blocks"][str(i)] = {
            "norm1": tensors[bp + "norm1.weight"],
            "norm1_b": tensors[bp + "norm1.bias"],
            "qkv": linear(tensors, bp + "attn.qkv.weight"),
            "qkv_b": tensors[bp + "attn.qkv.bias"],
            "proj": linear(tensors, bp + "attn.proj.weight"),
            "proj_b": tensors[bp + "attn.proj.bias"],
            "norm2": tensors[bp + "norm2.weight"],
            "norm2_b": tensors[bp + "norm2.bias"],
            "fc1": linear(tensors, bp + "mlp.fc1.weight"),
            "fc1_b": tensors[bp + "mlp.fc1.bias"],
            "fc2": linear(tensors, bp + "mlp.fc2.weight"),
            "fc2_b": tensors[bp + "mlp.fc2.bias"],
        }
    params["vision"] = qwen2._f32(vis)
    return params


# ---------------------------------------------------------------------------
# vision tower
# ---------------------------------------------------------------------------


def vision_rotary(cfg: VisionConfig, grid_thw: np.ndarray) -> np.ndarray:
    """Per-patch 2-D rotary angle table [seq, head_dim/2] (host-side;
    mirrors Qwen2VisionTransformer.rot_pos_emb)."""
    merge = cfg.spatial_merge_size
    pos_ids = []
    for t, h, w in np.asarray(grid_thw):
        hpos = np.broadcast_to(np.arange(h)[:, None], (h, w))
        hpos = hpos.reshape(h // merge, merge, w // merge, merge).transpose(0, 2, 1, 3).reshape(-1)
        wpos = np.broadcast_to(np.arange(w)[None, :], (h, w))
        wpos = wpos.reshape(h // merge, merge, w // merge, merge).transpose(0, 2, 1, 3).reshape(-1)
        pos_ids.append(np.tile(np.stack([hpos, wpos], axis=-1), (t, 1)))
    pos = np.concatenate(pos_ids, axis=0)  # [seq, 2]
    dim = cfg.head_dim // 2  # rotary dim per spatial axis
    inv_freq = 1.0 / 10000.0 ** (np.arange(0, dim, 2, dtype=np.float64) / dim)
    freqs = pos[:, :, None] * inv_freq[None, None, :]  # [seq, 2, dim/2]
    return freqs.reshape(pos.shape[0], -1).astype(np.float32)  # [seq, hd/2]


def _block_diag_mask(grid_thw: np.ndarray) -> np.ndarray | None:
    """[1,1,seq,seq] boolean mask limiting attention to each image's own
    patches (cu_seqlens semantics); None for a single image."""
    lengths = [int(t * h * w) for t, h, w in np.asarray(grid_thw)]
    if len(lengths) <= 1:
        return None
    seg = np.repeat(np.arange(len(lengths)), lengths)
    return (seg[:, None] == seg[None, :])[None, None]


def _vision_forward(params, cfg: VisionConfig, patches, cos, sin, mask):
    """patches [seq, C*tp*ps*ps] -> merged image tokens [seq / merge^2,
    out_dim] in the compute dtype of the parameters' device; cos / sin
    [seq, head_dim/2] f32, mask [1, 1, seq, seq] bool or None."""
    dev = params["embed"].device
    dtype = L.compute_dtype(dev)
    vp = params["vision"]
    x = patches.to(dev, dtype) @ vp["patch_proj"].to(dtype)  # [seq, embed]
    seq = x.shape[0]
    for i in range(cfg.depth):
        bp = vp["blocks"][str(i)]
        h = L.layer_norm(x, bp["norm1"], bp["norm1_b"], eps=1e-6)
        qkv = (h @ bp["qkv"].to(dtype)) + bp["qkv_b"].to(dtype)
        qkv = qkv.reshape(seq, 3, cfg.heads, cfg.head_dim)
        q, k, v = (qkv[:, j].transpose(0, 1)[None] for j in range(3))  # [1, H, seq, hd]
        q = L.apply_rope_tables(q, cos, sin)
        k = L.apply_rope_tables(k, cos, sin)
        out = L.attention(q, k, v, mask)
        out = out.transpose(1, 2).reshape(seq, cfg.embed_dim)
        x = x + (out @ bp["proj"].to(dtype)) + bp["proj_b"].to(dtype)
        h = L.layer_norm(x, bp["norm2"], bp["norm2_b"], eps=1e-6)
        h = (h @ bp["fc1"].to(dtype)) + bp["fc1_b"].to(dtype)
        h = h * torch.sigmoid(1.702 * h)  # QuickGELU
        x = x + (h @ bp["fc2"].to(dtype)) + bp["fc2_b"].to(dtype)

    # PatchMerger: LN then 2x2 spatial groups (sequence order is already
    # window-major) -> MLP into LM width.
    x = L.layer_norm(x, vp["merger_ln"], vp["merger_ln_b"], eps=1e-6)
    x = x.reshape(-1, cfg.merge_dim)
    x = (x @ vp["merger_fc1"].to(dtype)) + vp["merger_fc1_b"].to(dtype)
    x = torch.nn.functional.gelu(x)
    return (x @ vp["merger_fc2"].to(dtype)) + vp["merger_fc2_b"].to(dtype)


def _vision_tables(cfg: VisionConfig, grid_thw, device):
    """(cos, sin, mask) of the tower for these images, on ``device``."""
    freqs = vision_rotary(cfg, grid_thw)
    mask = _block_diag_mask(grid_thw)
    return (_on(np.cos(freqs), device), _on(np.sin(freqs), device),
            None if mask is None else _on(mask, device))


def encode_images(params, cfg: Qwen2VLConfig, pixel_values, grid_thw):
    """pixel_values [seq, C*tp*ps*ps] (HF processor layout) + grid_thw
    [n_images, 3] -> merged image tokens [seq/merge^2, lm_dim]."""
    dev = params["embed"].device
    cos, sin, mask = _vision_tables(cfg.vision, np.asarray(grid_thw), dev)
    return _vision_forward(params, cfg.vision, _on(pixel_values, dev), cos, sin, mask)


# ---------------------------------------------------------------------------
# M-RoPE position bookkeeping (host-side; mirrors get_rope_index)
# ---------------------------------------------------------------------------


def rope_index(cfg: Qwen2VLConfig, input_ids: np.ndarray,
               grid_thw: np.ndarray | None) -> tuple[np.ndarray, np.ndarray]:
    """3-D position ids [3, B, T] + per-row next-position deltas [B]."""
    input_ids = np.asarray(input_ids)
    b, t = input_ids.shape
    if grid_thw is None or len(np.asarray(grid_thw)) == 0:
        pos = np.broadcast_to(np.arange(t)[None, None], (3, b, t)).copy()
        return pos, np.zeros((b,), np.int64)

    grid_thw = np.asarray(grid_thw)
    merge = cfg.vision.spatial_merge_size
    position_ids = np.zeros((3, b, t), dtype=np.int64)
    deltas = np.zeros((b,), np.int64)
    image_index = 0
    for i in range(b):
        tokens = input_ids[i].tolist()
        chunks: list[np.ndarray] = []
        st = 0
        while True:
            try:
                ed = tokens.index(cfg.image_token_id, st)
            except ValueError:
                break
            gt, gh, gw = grid_thw[image_index]
            image_index += 1
            gh, gw = gh // merge, gw // merge
            st_idx = int(chunks[-1].max()) + 1 if chunks else 0
            text_len = ed - st
            chunks.append(np.broadcast_to(np.arange(text_len) + st_idx, (3, text_len)))
            t_idx = np.repeat(np.arange(gt), gh * gw)
            h_idx = np.tile(np.repeat(np.arange(gh), gw), gt)
            w_idx = np.tile(np.arange(gw), gt * gh)
            chunks.append(np.stack([t_idx, h_idx, w_idx]) + text_len + st_idx)
            st = ed + gt * gh * gw
        if st < len(tokens):
            st_idx = int(chunks[-1].max()) + 1 if chunks else 0
            rest = len(tokens) - st
            chunks.append(np.broadcast_to(np.arange(rest) + st_idx, (3, rest)))
        pos = np.concatenate(chunks, axis=1)
        position_ids[:, i, :] = pos
        deltas[i] = pos.max() + 1
    return position_ids, deltas


def _mrope_tables(cfg: Qwen2VLConfig, position_ids):
    """position_ids [3, B, T] -> per-token (cos, sin) [B, T, head_dim/2] f32
    with the channel range split across the t/h/w axes (mrope_section)."""
    half = cfg.head_dim // 2
    inv_freq = 1.0 / cfg.rope_theta ** (
        torch.arange(0, cfg.head_dim, 2, dtype=torch.float32, device=position_ids.device)
        / cfg.head_dim
    )
    freqs = position_ids.float()[..., None] * inv_freq  # [3, B, T, half]
    sections = np.cumsum(cfg.mrope_section)[:-1].tolist()
    parts = torch.tensor_split(freqs, sections, dim=-1)
    combined = torch.cat([part[i % 3] for i, part in enumerate(parts)], dim=-1)
    assert combined.shape[-1] == half
    return torch.cos(combined), torch.sin(combined)


def _lm(params, cfg: Qwen2VLConfig, h, cos, sin, mask, caches=None, cache_index=None):
    """The unfused blocks over h [B, T, dim] with per-token M-RoPE tables,
    then the final norm. With ``caches`` each layer writes its rows at
    ``cache_index`` in place. Returns (h, caches or {})."""
    new_caches = {}
    for i in range(cfg.layers):
        h, new_cache = L.block_forward(
            params["blocks"][str(i)], h, cfg.heads, n_kv_heads=cfg.kv_heads,
            rope_tables=(cos, sin), mask=mask,
            cache=None if caches is None else caches[str(i)],
            cache_index=cache_index, norm_eps=cfg.norm_eps,
        )
        if new_cache is not None:
            new_caches[str(i)] = new_cache
    return L.rms_norm(h, params["out_norm"], cfg.norm_eps), new_caches


# the head of a Qwen2-class LM: float (tied or not) or quantized
_head = qwen2._head
_head_logits = qwen2._head_logits


def quantize_decode(params, cfg: Qwen2VLConfig) -> dict:
    """Quantize the LM decode path into the fused kernel layout
    (models/hf/qwen2.quantize_decode: int8, or int4 under
    ``DORA_INT4_DECODE`` / ``DORA_WEIGHT_BITS=4``); the vision tower and the
    embedding stay float."""
    return qwen2.quantize_decode(params, cfg)


def _embed_with_images(params, cfg, input_ids, image_feats, dtype):
    """Token embeddings with image features scattered over the positions of
    ``cfg.image_token_id`` (<|image_pad|>; InternVL's <IMG_CONTEXT>) in
    order; ids past the vocab clamp, as JAX's gather does."""
    embed = params["embed"]
    ids = input_ids.long()
    h = embed[ids.clamp(0, embed.shape[0] - 1)].to(dtype)  # [B, T, dim]
    if image_feats is None:
        return h
    is_image = ids == cfg.image_token_id  # [B, T]
    order = torch.cumsum(is_image.reshape(-1), dim=0) - 1  # flat index into feats
    feats = image_feats.to(dtype)[order.clamp(0, image_feats.shape[0] - 1)].reshape(h.shape)
    return torch.where(is_image[..., None], feats, h)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def forward(params, cfg: Qwen2VLConfig, input_ids, image_feats, position_ids):
    """Teacher-forced logits [B, T, vocab] f32. ``image_feats`` may be None
    (text-only); ``position_ids`` [3, B, T] from :func:`rope_index`."""
    dev = params["embed"].device
    dtype = L.compute_dtype(dev)
    input_ids = _on(input_ids, dev)
    h = _embed_with_images(params, cfg, input_ids, image_feats, dtype)
    cos, sin = _mrope_tables(cfg, _on(position_ids, dev))
    t = input_ids.shape[1]
    h, _ = _lm(params, cfg, h, cos, sin, L.causal_mask(t, t, device=dev))
    return _head_logits(h, _head(params, cfg, dtype))


# dense KV caches {layer: {k/v: [batch, KV, max_seq, hd]}}, as the text model's
init_cache = qwen2.init_cache


def _prefill(params, cfg: Qwen2VLConfig, input_ids, image_feats, position_ids):
    """The prompt rows into fresh dense caches at 0, each row attending the
    rows before it among the first T. Returns (first [B] int32, caches)."""
    dev = params["embed"].device
    dtype = L.compute_dtype(dev)
    b, t = input_ids.shape
    h = _embed_with_images(params, cfg, input_ids, image_feats, dtype)
    cos, sin = _mrope_tables(cfg, position_ids)
    mask = L.causal_mask(t, cfg.max_seq, device=dev) & (
        torch.arange(cfg.max_seq, device=dev)[None, None, None, :] < t)
    caches = init_cache(cfg, b, device=dev)
    h, caches = _lm(params, cfg, h, cos, sin, mask, caches=caches, cache_index=0)
    first = torch.argmax(_head_logits(h[:, -1], _head(params, cfg, dtype)), dim=-1)
    return first.to(torch.int32), caches


def _fused_pass(params, cfg: Qwen2VLConfig, tokens, caches, cache_index: int,
                rope_position: int, rope):
    """The fused batch-1 pass (models/vlm.fused_decode_pass) over tokens
    [1, W] at cache rows ``cache_index..`` and M-RoPE positions
    ``rope_position..``: past the prompt all three axes advance together,
    so the rows are standard rope rows at the rope position, which an
    image puts below the cache position. Returns (greedy [W], caches)."""
    cos_t, sin_t = rope
    cos_rows, sin_rows = DB.rope_rows(cos_t, sin_t, rope_position, tokens.shape[1])
    return _vlm.fused_decode_pass(
        params, _vlm._embed(params, tokens[0]), caches, cache_index, cos_rows, sin_rows,
        heads=cfg.heads, kv_heads=cfg.kv_heads, head_dim=cfg.head_dim, layers=cfg.layers,
        eps=cfg.norm_eps,
    )


def _text_tables(cfg: Qwen2VLConfig, rope_pos):
    """M-RoPE tables of text rows whose three axes share ``rope_pos`` [B, W]."""
    return _mrope_tables(cfg, rope_pos[None].expand(3, *rope_pos.shape))


def _generate(params, cfg: Qwen2VLConfig, input_ids, image_feats, position_ids,
              max_new_tokens: int, delta):
    """The body of :func:`generate` and the serving step: the prefill, then
    one pass a token. ``delta`` [B] is each row's next M-RoPE position."""
    dev = params["embed"].device
    b, t = input_ids.shape
    if max_new_tokens == 0:
        # The JAX scan of length 0: no token, not even the prefill's.
        return torch.zeros((b, 0), dtype=torch.int32, device=dev)
    use_fused = qwen2.fused_gate("qwen2_vl.generate", params, cfg, b)
    dtype = L.compute_dtype(dev)
    head = _head(params, cfg, dtype)
    rope = L.rope_table(cfg.max_seq, cfg.head_dim, base=cfg.rope_theta, device=dev)
    delta = [int(d) for d in np.asarray(delta).reshape(-1)]
    token, caches = _prefill(params, cfg, input_ids, image_feats, position_ids)
    out = [token]
    # Token i + 1 comes from the step at cache row t + i and rope position
    # delta + i; the last token needs no step after it.
    for i in range(max_new_tokens - 1):
        cache_index = t + i
        if use_fused:
            token, caches = _fused_pass(params, cfg, token[:, None], caches, cache_index,
                                        delta[0] + i, rope)
        else:
            rope_pos = torch.tensor(delta, device=dev)[:, None] + i  # [B, 1]
            cos, sin = _text_tables(cfg, rope_pos)
            h = _vlm._embed(params, token)[:, None, :]
            mask = (torch.arange(cfg.max_seq, device=dev) <= cache_index)[None, None, None, :]
            h, caches = _lm(params, cfg, h, cos, sin, mask, caches=caches,
                            cache_index=cache_index)
            token = torch.argmax(_head_logits(h[:, -1], head), dim=-1).to(torch.int32)
        out.append(token)
    return torch.stack(out, dim=1)


def generate(params, cfg: Qwen2VLConfig, input_ids, pixel_values, grid_thw,
             max_new_tokens: int):
    """Greedy generation: prompt ids [B, T] with <|image_pad|> runs +
    flattened patches (or None) -> [B, max_new_tokens] int32 on the
    parameters' device, a host loop of passes (fused when
    models/vlm.fused_decode_ready allows: batch 1, quantized, not
    ``DORA_FUSED_DECODE=0``)."""
    ids = _host_ids(input_ids)
    t = ids.shape[1]
    if t + max_new_tokens > cfg.max_seq:
        raise ValueError(
            f"prompt ({t}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_seq ({cfg.max_seq}); reload with a larger max_seq")
    qwen2.fused_gate("qwen2_vl.generate", params, cfg, ids.shape[0])  # refuse first
    dev = params["embed"].device
    feats = None
    if pixel_values is not None:
        feats = encode_images(params, cfg, pixel_values, grid_thw)
    position_ids, deltas = rope_index(cfg, ids, grid_thw if pixel_values is not None else None)
    return _generate(params, cfg, _on(ids, dev), feats, _on(position_ids, dev),
                     max_new_tokens, deltas)


# ---------------------------------------------------------------------------
# speculative decoding (prompt lookup, models/spec_decode.run_loop)
# ---------------------------------------------------------------------------


def generate_speculative(params, cfg: Qwen2VLConfig, input_ids, pixel_values, grid_thw,
                         max_new_tokens: int, k: int = 4, ngram: int = 2):
    """Greedy generation with prompt-lookup speculation: the tokens of
    :func:`generate`, up to k+1 of them per model pass (the fused
    ``attention_chunk_step`` tier when it is ready). Batch 1; text
    continuation under M-RoPE is uniform (all three axes advance together),
    so a chunk's rope positions are ``delta + i``. Returns (tokens [1,
    max_new_tokens] int32, model passes)."""
    from dora_tpu_torch.models.spec_decode import check_headroom

    ids = _host_ids(input_ids)
    if ids.shape[0] != 1:
        raise ValueError("speculative decode is batch-1")
    check_headroom(ids.shape[1], max_new_tokens, cfg.max_seq, "prompt", k)
    qwen2.fused_gate("qwen2_vl.generate_speculative", params, cfg, 1)  # refuse first
    dev = params["embed"].device
    feats = None
    if pixel_values is not None:
        feats = encode_images(params, cfg, pixel_values, grid_thw)
    position_ids, deltas = rope_index(cfg, ids, grid_thw if pixel_values is not None else None)
    return _generate_spec(params, cfg, _on(ids, dev), feats, _on(position_ids, dev),
                          max_new_tokens, deltas, k, ngram)


def _generate_spec(params, cfg: Qwen2VLConfig, input_ids, image_feats, position_ids,
                   max_new_tokens: int, delta, k: int, ngram: int):
    from dora_tpu_torch.models import spec_decode

    dev = params["embed"].device
    dtype = L.compute_dtype(dev)
    t = input_ids.shape[1]
    use_fused = qwen2.fused_gate("qwen2_vl.generate_speculative", params, cfg, 1)
    head = _head(params, cfg, dtype)
    rope = L.rope_table(cfg.max_seq, cfg.head_dim, base=cfg.rope_theta, device=dev)
    delta0 = int(np.asarray(delta).reshape(-1)[0])
    first, caches = _prefill(params, cfg, input_ids, image_feats, position_ids)
    history = torch.zeros((cfg.max_seq,), dtype=torch.int32, device=dev)
    history[:t] = input_ids[0].to(torch.int32)
    history[t] = first[0]

    def verify(chunk, n_emitted, caches):
        # generated token j (0-based) lives at cache row t + j with M-RoPE
        # position delta + j; chunk[0, 0] is generated index n_emitted - 1.
        w = chunk.shape[1]  # k+1, or 1 for an adaptive plain pass
        gen_idx = n_emitted - 1
        cache_index = t + gen_idx
        if use_fused:
            return _fused_pass(params, cfg, chunk, caches, cache_index, delta0 + gen_idx, rope)
        ccos, csin = _text_tables(cfg, (delta0 + gen_idx + torch.arange(w, device=dev))[None])
        cache_pos = cache_index + torch.arange(w, device=dev)
        mask = (torch.arange(cfg.max_seq, device=dev)[None, None, None, :]
                <= cache_pos[None, None, :, None])
        h, new_caches = _lm(params, cfg, _vlm._embed(params, chunk), ccos, csin, mask,
                            caches=caches, cache_index=cache_index)
        greedy = torch.argmax(_head_logits(h[0], head), dim=-1)
        return greedy.to(torch.int32), new_caches

    return spec_decode.run_loop(
        caches=caches, history=history, hist_len=t + 1, first=first[0],
        max_new_tokens=max_new_tokens, seq=cfg.max_seq, verify=verify, k=k, ngram=ngram,
        body=spec_decode.fitting_body_passes(t, max_new_tokens, cfg.max_seq, k),
    )


# ---------------------------------------------------------------------------
# image preprocessing + serving step (the operator tier's path)
# ---------------------------------------------------------------------------

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def smart_resize(height: int, width: int, factor: int = 28, min_pixels: int = 56 * 56,
                 max_pixels: int = 14 * 14 * 4 * 1280) -> tuple[int, int]:
    """Target (h, w): divisible by ``factor``, pixel count within bounds,
    aspect ratio preserved (mirrors the HF image processor)."""
    h_bar = max(factor, round(height / factor) * factor)
    w_bar = max(factor, round(width / factor) * factor)
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, math.floor(height / beta / factor) * factor)
        w_bar = max(factor, math.floor(width / beta / factor) * factor)
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = math.ceil(height * beta / factor) * factor
        w_bar = math.ceil(width * beta / factor) * factor
    return h_bar, w_bar


def preprocess_image(image, cfg: VisionConfig, target_h: int, target_w: int):
    """[H, W, 3] frame tensor (uint8 or float) -> flattened patches
    [gh*gw, C*tp*ps*ps] f32 in the HF processor's window-major layout, on
    the image's device; resized (antialiased bilinear) when its size is not
    the target's."""
    x = image.float()
    if image.dtype == torch.uint8:
        x = x / 255.0
    if tuple(x.shape[:2]) != (target_h, target_w):
        x = L.resize_image(x, target_h, target_w, "bilinear")
    mean = torch.tensor(OPENAI_CLIP_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(OPENAI_CLIP_STD, dtype=torch.float32, device=x.device)
    x = ((x - mean) / std).permute(2, 0, 1)  # [C, H, W]
    # Temporal tiling (an image repeats over the 2-frame temporal patch),
    # then the processor's window-major reshape.
    tp, ps, merge = cfg.temporal_patch_size, cfg.patch_size, cfg.spatial_merge_size
    c = x.shape[0]
    gh, gw = target_h // ps, target_w // ps
    x = x[None].expand(tp, c, target_h, target_w)
    x = x.reshape(1, tp, c, gh // merge, merge, ps, gw // merge, merge, ps)
    x = x.permute(0, 3, 6, 4, 7, 2, 1, 5, 8)
    return x.reshape(gh * gw, c * tp * ps * ps)


def make_serving_step(cfg: Qwen2VLConfig, prompt_ids: np.ndarray, target_h: int,
                      target_w: int, max_new_tokens: int, speculative: bool = False):
    """A ``(params, image) -> tokens [1, max_new_tokens] int32`` function
    with a static prompt and image geometry (the operator tier's step):
    ``image`` is an [H, W, 3] uint8 or float tensor on the parameters'
    device. ``prompt_ids`` must already hold the ``<|image_pad|>`` run of
    the image's merged-patch count (:func:`build_prompt_ids`).
    ``speculative`` decodes by prompt-lookup speculation (the same greedy
    tokens; needs k+1 = 5 rows of max_seq headroom)."""
    from dora_tpu_torch.models import spec_decode

    ps = cfg.vision.patch_size
    grid_thw = np.array([[1, target_h // ps, target_w // ps]])
    freqs = vision_rotary(cfg.vision, grid_thw)
    cos, sin = np.cos(freqs), np.sin(freqs)
    prompt_ids = np.asarray(prompt_ids)
    position_ids, deltas = rope_index(cfg, prompt_ids, grid_thw)
    headroom = spec_decode.spec_headroom() if speculative else 0
    if prompt_ids.shape[1] + max_new_tokens + headroom > cfg.max_seq:
        raise ValueError("prompt + max_new_tokens exceeds max_seq")
    what = "qwen2_vl.make_serving_step"

    def step_fn(params, image):
        dev = params["embed"].device
        qwen2.fused_gate(what, params, cfg, 1)  # refuse before any work
        patches = preprocess_image(image, cfg.vision, target_h, target_w)
        feats = _vision_forward(params, cfg.vision, patches, _on(cos, dev), _on(sin, dev), None)
        prompt, pos = _on(prompt_ids, dev), _on(position_ids, dev)
        if speculative:
            tokens, _ = _generate_spec(params, cfg, prompt, feats, pos, max_new_tokens,
                                       deltas, spec_decode.SPEC_K, spec_decode.SPEC_NGRAM)
            return tokens
        return _generate(params, cfg, prompt, feats, pos, max_new_tokens, deltas)

    return step_fn


def build_prompt_ids(cfg: Qwen2VLConfig, text_ids: list[int], target_h: int,
                     target_w: int) -> np.ndarray:
    """Prompt ids with the image placeholder run sized for the given
    geometry: <|vision_start|> <|image_pad|>*N <|vision_end|> <text ids>,
    the image-region format every Qwen2-VL checkpoint was trained on."""
    ps, merge = cfg.vision.patch_size, cfg.vision.spatial_merge_size
    n_merged = (target_h // ps) * (target_w // ps) // (merge * merge)
    ids = ([cfg.vision_start_token_id] + [cfg.image_token_id] * n_merged
           + [cfg.vision_end_token_id] + list(text_ids))
    return np.asarray([ids], dtype=np.int64)
