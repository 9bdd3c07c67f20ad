"""InternVL serving HF checkpoints, on torch tensors.

Counterpart of dora_tpu/models/hf/internvl.py (transformers'
``InternVLForConditionalGeneration``, the HF-format InternVL2 / 2.5 / 3
checkpoints): the config (``VisionConfig``, ``InternVLConfig``, its text
model a models/hf/qwen2.Qwen2Config), checkpoint loading over both on-disk
layouts; the InternViT tower (the conv patch embedding as one product, the
cls token and learned absolute positions, pre-LN blocks with separate q/k/v
projections, the optional q/k RMSNorm over the full width, layer-scale
residuals, exact GELU, dense attention), the 2 x 2 pixel shuffle and the
LayerNorm + two-layer projector into the LM width; the Qwen2 language model
(models/hf/qwen2: ``_lm`` for the prompt and the unfused steps,
``fused_step`` for the fused batch-1 tier) with image features scattered
over the ``<IMG_CONTEXT>`` positions; greedy ``generate`` and prompt-lookup
``generate_speculative`` as host loops (the JAX package scans); and the
aspect-ratio tiling of the operator tier (``target_ratios``,
``closest_aspect_ratio``, ``tile_grid``, ``preprocess_tiles`` with
antialiased bicubic resizing, ``build_prompt_ids``, ``make_serving_step``).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch

from dora_tpu_torch._device import resolve_device
from dora_tpu_torch.models import layers as L
from dora_tpu_torch.models import vlm as _vlm
from dora_tpu_torch.models.hf import qwen2
from dora_tpu_torch.models.hf.loader import linear, maybe_bias, read_config, read_safetensors
from dora_tpu_torch.models.hf.qwen2 import _host_ids, _on
# image features over the <IMG_CONTEXT> positions, as Qwen2-VL's over its pads
from dora_tpu_torch.models.hf.qwen2_vl import _embed_with_images

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclass(frozen=True)
class VisionConfig:
    depth: int
    embed_dim: int
    heads: int
    ffn: int
    image_size: int
    patch_size: int
    use_qk_norm: bool
    norm_eps: float

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.heads

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclass(frozen=True)
class InternVLConfig:
    text: qwen2.Qwen2Config
    vision: VisionConfig
    downsample_ratio: float
    image_token_id: int

    @property
    def tokens_per_tile(self) -> int:
        return int(self.vision.n_patches * self.downsample_ratio**2)

    @classmethod
    def from_hf(cls, config: dict, max_seq: int | None = None) -> "InternVLConfig":
        vision = config["vision_config"]
        image_size = vision.get("image_size", [448, 448])
        patch_size = vision.get("patch_size", [14, 14])
        if isinstance(image_size, (list, tuple)):
            image_size = image_size[0]
        if isinstance(patch_size, (list, tuple)):
            patch_size = patch_size[0]
        return cls(
            text=qwen2.Qwen2Config.from_hf(config["text_config"], max_seq),
            vision=VisionConfig(
                depth=vision["num_hidden_layers"],
                embed_dim=vision["hidden_size"],
                heads=vision["num_attention_heads"],
                ffn=vision["intermediate_size"],
                image_size=image_size,
                patch_size=patch_size,
                use_qk_norm=vision.get("use_qk_norm", False),
                norm_eps=vision.get("layer_norm_eps", 1e-6),
            ),
            downsample_ratio=config.get("downsample_ratio", 0.5),
            image_token_id=config.get("image_token_id", 151667),
        )


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


def load(model_dir: str | Path, max_seq: int | None = None, device=None):
    """(config, params) from an HF-format InternVL checkpoint directory;
    weights as f32 on ``device`` (default cuda)."""
    dev = resolve_device(device)
    cfg = InternVLConfig.from_hf(read_config(model_dir), max_seq)
    return cfg, qwen2._to(map_params(read_safetensors(model_dir), cfg), dev)


def map_params(tensors: dict, cfg: InternVLConfig) -> dict:
    """Checkpoint names -> the parameter tree (f32). Two on-disk layouts: the
    legacy export ("language_model.model.*", "vision_tower.*",
    "language_model.lm_head.weight") and the nested one
    ("model.language_model.*", "model.vision_tower.*", "lm_head.weight")."""
    if any(k.startswith("model.language_model.") for k in tensors):
        text_prefix, vt = "model.language_model.", "model.vision_tower."
        mp = "model.multi_modal_projector."
    else:
        text_prefix, vt = "language_model.model.", "vision_tower."
        mp = "multi_modal_projector."
        if "language_model.lm_head.weight" in tensors:
            tensors = dict(tensors)
            tensors["lm_head.weight"] = tensors["language_model.lm_head.weight"]
    params = qwen2.map_params(tensors, cfg.text, prefix=text_prefix)

    v = cfg.vision
    vis: dict[str, Any] = {
        "cls_token": tensors[vt + "embeddings.cls_token"][0],  # [1, embed]
        "pos_embed": tensors[vt + "embeddings.position_embeddings"][0],
        # Conv2d stride == kernel over (c, i, j)-flattened patches is one
        # product: [embed, C, ps, ps] -> [C*ps*ps, embed].
        "patch_proj": tensors[vt + "embeddings.patch_embeddings.projection.weight"]
        .reshape(v.embed_dim, -1).T,
        "patch_proj_b": tensors[vt + "embeddings.patch_embeddings.projection.bias"],
        "blocks": {},
    }
    for i in range(v.depth):
        bp = f"{vt}encoder.layer.{i}."
        block: dict[str, Any] = {
            "norm1": tensors[bp + "layernorm_before.weight"],
            "norm1_b": tensors[bp + "layernorm_before.bias"],
            "wq": linear(tensors, bp + "attention.q_proj.weight"),
            "wk": linear(tensors, bp + "attention.k_proj.weight"),
            "wv": linear(tensors, bp + "attention.v_proj.weight"),
            "wo": linear(tensors, bp + "attention.projection_layer.weight"),
            "wo_b": tensors[bp + "attention.projection_layer.bias"],
            "lambda1": tensors[bp + "lambda_1"],
            "lambda2": tensors[bp + "lambda_2"],
            "norm2": tensors[bp + "layernorm_after.weight"],
            "norm2_b": tensors[bp + "layernorm_after.bias"],
            "fc1": linear(tensors, bp + "mlp.fc1.weight"),
            "fc1_b": tensors[bp + "mlp.fc1.bias"],
            "fc2": linear(tensors, bp + "mlp.fc2.weight"),
            "fc2_b": tensors[bp + "mlp.fc2.bias"],
        }
        maybe_bias(block, "bq", tensors, bp + "attention.q_proj.bias")
        maybe_bias(block, "bk", tensors, bp + "attention.k_proj.bias")
        maybe_bias(block, "bv", tensors, bp + "attention.v_proj.bias")
        if v.use_qk_norm:
            block["q_norm"] = tensors[bp + "attention.q_norm.weight"]
            block["k_norm"] = tensors[bp + "attention.k_norm.weight"]
        vis["blocks"][str(i)] = block

    vis["proj_ln"] = tensors[mp + "layer_norm.weight"]
    vis["proj_ln_b"] = tensors[mp + "layer_norm.bias"]
    vis["proj_fc1"] = linear(tensors, mp + "linear_1.weight")
    vis["proj_fc1_b"] = tensors[mp + "linear_1.bias"]
    vis["proj_fc2"] = linear(tensors, mp + "linear_2.weight")
    vis["proj_fc2_b"] = tensors[mp + "linear_2.bias"]
    params["vision"] = qwen2._f32(vis)
    return params


# ---------------------------------------------------------------------------
# vision tower
# ---------------------------------------------------------------------------


def _patchify(pixel_values, ps: int):
    """[B, C, H, W] -> [B, gh*gw, C*ps*ps] in the conv kernel's (c, i, j)
    flattening order."""
    b, c, h, w = pixel_values.shape
    gh, gw = h // ps, w // ps
    x = pixel_values.reshape(b, c, gh, ps, gw, ps)
    x = x.permute(0, 2, 4, 1, 3, 5)  # [B, gh, gw, C, ps, ps]
    return x.reshape(b, gh * gw, c * ps * ps)


def _pixel_shuffle(x, scale: float):
    """transformers' InternVLModel.pixel_shuffle, op for op (input
    [B, W, H, C] spatial grid; the double transpose keeps orientation)."""
    b, w, h, c = x.shape
    x = x.reshape(b, w, int(h * scale), int(c / scale))
    x = x.permute(0, 2, 1, 3)
    x = x.reshape(b, int(h * scale), int(w * scale), int(c / scale**2))
    return x.permute(0, 2, 1, 3)


def _vision_forward(params, cfg: InternVLConfig, pixel_values):
    """[B, C, H, W] normalized tiles -> projected image tokens
    [B, tokens_per_tile, lm_dim] in the compute dtype of the parameters'
    device."""
    v = cfg.vision
    dev = params["embed"].device
    dtype = L.compute_dtype(dev)
    vp = params["vision"]
    b = pixel_values.shape[0]

    x = _patchify(pixel_values.to(dev, dtype), v.patch_size)
    x = x @ vp["patch_proj"].to(dtype) + vp["patch_proj_b"].to(dtype)
    cls = vp["cls_token"].to(dtype).expand(b, 1, v.embed_dim)
    x = torch.cat([cls, x], dim=1)  # [B, 1+P, embed]
    x = x + vp["pos_embed"].to(dtype)[None]
    seq = x.shape[1]

    for i in range(v.depth):
        bp = vp["blocks"][str(i)]
        h = L.layer_norm(x, bp["norm1"], bp["norm1_b"], eps=v.norm_eps)
        q = L.dense(h, bp, "wq", "bq")
        k = L.dense(h, bp, "wk", "bk")
        v_ = L.dense(h, bp, "wv", "bv")
        if "q_norm" in bp:
            q = L.rms_norm(q, bp["q_norm"], v.norm_eps)
            k = L.rms_norm(k, bp["k_norm"], v.norm_eps)
        q, k, v_ = (z.reshape(b, seq, v.heads, v.head_dim).transpose(1, 2) for z in (q, k, v_))
        out = L.attention(q, k, v_, None)
        out = out.transpose(1, 2).reshape(b, seq, v.embed_dim)
        out = L.dense(out, bp, "wo", "wo_b")
        x = x + out * bp["lambda1"].to(dtype)
        h = L.layer_norm(x, bp["norm2"], bp["norm2_b"], eps=v.norm_eps)
        h = L.dense(h, bp, "fc1", "fc1_b")
        h = torch.nn.functional.gelu(h)
        h = L.dense(h, bp, "fc2", "fc2_b")
        x = x + h * bp["lambda2"].to(dtype)

    # select: drop cls, fold to the spatial grid, pixel shuffle, project
    x = x[:, 1:]
    fs = v.image_size // v.patch_size
    x = x.reshape(b, fs, fs, v.embed_dim)
    x = _pixel_shuffle(x, cfg.downsample_ratio)
    x = x.reshape(b, -1, x.shape[-1])
    x = L.layer_norm(x, vp["proj_ln"], vp["proj_ln_b"], eps=1e-5)
    x = x @ vp["proj_fc1"].to(dtype) + vp["proj_fc1_b"].to(dtype)
    x = torch.nn.functional.gelu(x)
    return x @ vp["proj_fc2"].to(dtype) + vp["proj_fc2_b"].to(dtype)


def encode_images(params, cfg: InternVLConfig, pixel_values):
    """[n_tiles, C, H, W] -> image tokens [n_tiles * tokens_per_tile, lm_dim]."""
    feats = _vision_forward(params, cfg, _on(pixel_values, params["embed"].device))
    return feats.reshape(-1, feats.shape[-1])


# ---------------------------------------------------------------------------
# language model (Qwen2 + scattered image features)
# ---------------------------------------------------------------------------


def forward(params, cfg: InternVLConfig, input_ids, image_feats):
    """Teacher-forced logits [B, T, vocab] f32; ``image_feats`` may be None
    (text-only)."""
    dev = params["embed"].device
    dtype = L.compute_dtype(dev)
    input_ids = _on(input_ids, dev)
    b, t = input_ids.shape
    h = _embed_with_images(params, cfg, input_ids, image_feats, dtype)
    positions = torch.arange(t, device=dev).expand(b, t)
    h, _ = qwen2._lm(params, cfg.text, h, positions, L.causal_mask(t, t, device=dev))
    return qwen2._head_logits(h, qwen2._head(params, cfg.text, dtype))


def _prefill(params, cfg: InternVLConfig, input_ids, image_feats, rope):
    """The prompt rows (image features scattered in) into fresh dense caches
    at 0 (models/hf/qwen2._prefill). Returns (first [B] int32, caches)."""
    dtype = L.compute_dtype(params["embed"].device)
    h = _embed_with_images(params, cfg, input_ids, image_feats, dtype)
    h, caches = qwen2._prefill(params, cfg.text, input_ids, rope, h=h)
    first = torch.argmax(qwen2._head_logits(h[:, -1], qwen2._head(params, cfg.text, dtype)),
                         dim=-1)
    return first.to(torch.int32), caches


def _generate(params, cfg: InternVLConfig, input_ids, image_feats, max_new_tokens: int):
    """The body of :func:`generate` and the serving step: the prefill, then
    one pass a token (models/hf/qwen2._greedy_steps; standard RoPE, so
    cache and rope positions agree)."""
    dev = params["embed"].device
    b, t = input_ids.shape
    if max_new_tokens == 0:
        # The JAX scan of length 0: no token, not even the prefill's.
        return torch.zeros((b, 0), dtype=torch.int32, device=dev)
    use_fused = qwen2.fused_gate("internvl.generate", params, cfg.text, b)
    rope = qwen2._rope(cfg.text, dev)
    token, caches = _prefill(params, cfg, input_ids, image_feats, rope)
    return qwen2._greedy_steps(params, cfg.text, token, caches, t, max_new_tokens, use_fused,
                               rope)


def generate(params, cfg: InternVLConfig, input_ids, pixel_values, max_new_tokens: int):
    """Greedy generation: prompt ids [B, T] with <IMG_CONTEXT> runs +
    normalized tiles [n_tiles, C, H, W] (or None) -> [B, max_new_tokens]
    int32 on the parameters' device, a host loop of passes (fused when
    models/vlm.fused_decode_ready allows)."""
    ids = _host_ids(input_ids)
    t = ids.shape[1]
    if t + max_new_tokens > cfg.text.max_seq:
        raise ValueError(
            f"prompt ({t}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"max_seq ({cfg.text.max_seq}); reload with a larger max_seq")
    qwen2.fused_gate("internvl.generate", params, cfg.text, ids.shape[0])  # refuse first
    feats = None if pixel_values is None else encode_images(params, cfg, pixel_values)
    return _generate(params, cfg, _on(ids, params["embed"].device), feats, max_new_tokens)


# ---------------------------------------------------------------------------
# speculative decoding (prompt lookup, models/spec_decode.run_loop)
# ---------------------------------------------------------------------------


def generate_speculative(params, cfg: InternVLConfig, input_ids, pixel_values,
                         max_new_tokens: int, k: int = 4, ngram: int = 2):
    """Greedy generation with prompt-lookup speculation: the tokens of
    :func:`generate`, up to k+1 of them per model pass. Batch 1; standard
    RoPE, so a chunk's positions are t + i. Returns (tokens [1,
    max_new_tokens] int32, model passes)."""
    from dora_tpu_torch.models.spec_decode import check_headroom

    ids = _host_ids(input_ids)
    if ids.shape[0] != 1:
        raise ValueError("speculative decode is batch-1")
    check_headroom(ids.shape[1], max_new_tokens, cfg.text.max_seq, "prompt", k)
    qwen2.fused_gate("internvl.generate_speculative", params, cfg.text, 1)  # refuse first
    feats = None if pixel_values is None else encode_images(params, cfg, pixel_values)
    return _generate_spec(params, cfg, _on(ids, params["embed"].device), feats,
                          max_new_tokens, k, ngram)


def _generate_spec(params, cfg: InternVLConfig, input_ids, image_feats, max_new_tokens: int,
                   k: int, ngram: int):
    from dora_tpu_torch.models import spec_decode

    tc = cfg.text
    dev = params["embed"].device
    dtype = L.compute_dtype(dev)
    t = input_ids.shape[1]
    use_fused = qwen2.fused_gate("internvl.generate_speculative", params, tc, 1)
    head = qwen2._head(params, tc, dtype)
    rope = qwen2._rope(tc, dev)
    first, caches = _prefill(params, cfg, input_ids, image_feats, rope)
    history = torch.zeros((tc.max_seq,), dtype=torch.int32, device=dev)
    history[:t] = input_ids[0].to(torch.int32)
    history[t] = first[0]

    def verify(chunk, n_emitted, caches):
        # Standard RoPE: generated token j sits at position t + j for both
        # the cache and the rotary; chunk[0, 0] is generated index
        # n_emitted - 1.
        cache_index = t + n_emitted - 1
        if use_fused:
            return qwen2.fused_step(params, tc, chunk, caches, cache_index, rope)
        chunk_pos = cache_index + torch.arange(chunk.shape[1], device=dev)
        mask = (torch.arange(tc.max_seq, device=dev)[None, None, None, :]
                <= chunk_pos[None, None, :, None])
        h, new_caches = qwen2._lm(params, tc, _vlm._embed(params, chunk), chunk_pos[None], mask,
                                  caches=caches, cache_index=cache_index, rope=rope)
        greedy = torch.argmax(qwen2._head_logits(h[0], head), dim=-1)
        return greedy.to(torch.int32), new_caches

    return spec_decode.run_loop(
        caches=caches, history=history, hist_len=t + 1, first=first[0],
        max_new_tokens=max_new_tokens, seq=tc.max_seq, verify=verify, k=k, ngram=ngram,
        body=spec_decode.fitting_body_passes(t, max_new_tokens, tc.max_seq, k),
    )


def quantize_decode(params, cfg: InternVLConfig) -> dict:
    """Quantize the LM decode path into the fused kernel layout
    (models/hf/qwen2.quantize_decode); the vision tower stays float."""
    return qwen2.quantize_decode(params, cfg.text)


# ---------------------------------------------------------------------------
# tile-based dynamic preprocessing
# ---------------------------------------------------------------------------


def target_ratios(min_num: int = 1, max_num: int = 12) -> list[tuple[int, int]]:
    """(cols, rows) grids with min_num <= cols*rows <= max_num, area-sorted."""
    ratios = {
        (i, j)
        for n in range(min_num, max_num + 1)
        for i in range(1, n + 1)
        for j in range(1, n + 1)
        if min_num <= i * j <= max_num
    }
    return sorted(ratios, key=lambda r: r[0] * r[1])


def closest_aspect_ratio(width: int, height: int, ratios: list[tuple[int, int]],
                         tile: int) -> tuple[int, int]:
    """The tie-broken closest-ratio search: the nearest aspect ratio; on a
    tie the larger grid when the source image has the pixels to fill it."""
    aspect = width / height
    best, best_diff = (1, 1), float("inf")
    area = width * height
    for ratio in ratios:
        diff = abs(aspect - ratio[0] / ratio[1])
        if diff < best_diff:
            best, best_diff = ratio, diff
        elif diff == best_diff and area > 0.5 * tile * tile * ratio[0] * ratio[1]:
            best = ratio
    return best


def tile_grid(width: int, height: int, tile: int = 448, min_num: int = 1, max_num: int = 12,
              use_thumbnail: bool = True) -> tuple[int, int, int]:
    """(cols, rows, n_tiles) for an image; n_tiles includes the thumbnail
    tile when the grid has more than one tile."""
    cols, rows = closest_aspect_ratio(width, height, target_ratios(min_num, max_num), tile)
    blocks = cols * rows
    return cols, rows, blocks + (1 if use_thumbnail and blocks != 1 else 0)


def preprocess_tiles(image, cols: int, rows: int, tile: int = 448, use_thumbnail: bool = True):
    """[H, W, 3] frame tensor (uint8 or float in [0, 1]) -> normalized tiles
    [n_tiles, 3, tile, tile] f32 on the image's device: resized
    (antialiased bicubic) to the (cols, rows) grid, cropped into row-major
    tiles, the thumbnail appended, clamped to [0, 1] and normalized."""
    x = image.float()
    if image.dtype == torch.uint8:
        x = x / 255.0
    grid = L.resize_image(x, rows * tile, cols * tile, "bicubic")
    tiles = grid.reshape(rows, tile, cols, tile, 3)
    tiles = tiles.permute(0, 2, 1, 3, 4).reshape(-1, tile, tile, 3)
    if use_thumbnail and cols * rows != 1:
        thumb = L.resize_image(x, tile, tile, "bicubic")
        tiles = torch.cat([tiles, thumb[None]], dim=0)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    tiles = (tiles.clamp(0.0, 1.0) - mean) / std
    return tiles.permute(0, 3, 1, 2)  # [n, C, H, W]


def build_prompt_ids(cfg: InternVLConfig, text_ids: list[int], n_tiles: int,
                     start_id: int | None = None, end_id: int | None = None) -> np.ndarray:
    """Prompt ids with the per-tile <IMG_CONTEXT> runs the checkpoints were
    trained on; start / end ids wrap the run when the tokenizer provides
    <img> / </img>."""
    run = [cfg.image_token_id] * (cfg.tokens_per_tile * n_tiles)
    ids = (([start_id] if start_id is not None else []) + run
           + ([end_id] if end_id is not None else []) + list(text_ids))
    return np.asarray([ids], dtype=np.int64)


def make_serving_step(cfg: InternVLConfig, prompt_ids: np.ndarray, cols: int, rows: int,
                      tile: int, max_new_tokens: int, speculative: bool = False):
    """A ``(params, image) -> tokens [1, max_new_tokens] int32`` function
    with static tile geometry (the operator tier's step): ``image`` is an
    [H, W, 3] uint8 or float tensor on the parameters' device.
    ``speculative`` decodes by prompt-lookup speculation (the same greedy
    tokens; needs k+1 = 5 rows of max_seq headroom)."""
    from dora_tpu_torch.models import spec_decode

    headroom = spec_decode.spec_headroom() if speculative else 0
    prompt_ids = np.asarray(prompt_ids)
    if prompt_ids.shape[1] + max_new_tokens + headroom > cfg.text.max_seq:
        raise ValueError("prompt + max_new_tokens exceeds max_seq")

    def step_fn(params, image):
        dev = params["embed"].device
        qwen2.fused_gate("internvl.make_serving_step", params, cfg.text, 1)  # refuse first
        feats = encode_images(params, cfg, preprocess_tiles(image, cols, rows, tile))
        prompt = _on(prompt_ids, dev)
        if speculative:
            tokens, _ = _generate_spec(params, cfg, prompt, feats, max_new_tokens,
                                       spec_decode.SPEC_K, spec_decode.SPEC_NGRAM)
            return tokens
        return _generate(params, cfg, prompt, feats, max_new_tokens)

    return step_fn
