"""YOLOS-family object detection over pretrained HF checkpoints, on torch
tensors (dora_tpu/models/hf/yolos.py).

transformers' ``YolosForObjectDetection`` graph: a pre-LN ViT with qkv
biases and GELU (``layers.block_forward(norm="ln", mlp="gelu")``, dense
attention as the JAX package leaves it to XLA: no flash), cls and
detection tokens, learned positions, optional per-layer mid position
embeddings, and 3-layer ReLU-MLP heads for the classes and the sigmoid
cxcywh boxes. Images are NHWC at the checkpoint's resolution, HF-normalized
(:func:`preprocess`); :func:`nchw` adapts torch-layout inputs."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from dora_tpu_torch._device import resolve_device
from dora_tpu_torch.models import layers as L
from dora_tpu_torch.models.detection import top_k as _top_k
from dora_tpu_torch.models.hf.loader import linear, read_config, read_safetensors, to_device


@dataclass(frozen=True)
class YolosConfig:
    dim: int
    layers: int
    heads: int
    ffn: int
    image_size: tuple[int, int]  # (H, W)
    patch_size: int
    n_det: int
    n_labels: int  # real classes (logits have +1 no-object column)
    layer_norm_eps: float
    use_mid_pos: bool

    @property
    def n_patches(self) -> int:
        h, w = self.image_size
        return (h // self.patch_size) * (w // self.patch_size)

    @classmethod
    def from_hf(cls, config: dict) -> "YolosConfig":
        size = config["image_size"]
        if isinstance(size, int):
            size = [size, size]
        n_labels = config.get("num_labels")
        if n_labels is None:
            n_labels = len(config.get("id2label", {})) or 91
        return cls(
            dim=config["hidden_size"],
            layers=config["num_hidden_layers"],
            heads=config["num_attention_heads"],
            ffn=config["intermediate_size"],
            image_size=(int(size[0]), int(size[1])),
            patch_size=config["patch_size"],
            n_det=config.get("num_detection_tokens", 100),
            n_labels=int(n_labels),
            layer_norm_eps=config.get("layer_norm_eps", 1e-12),
            use_mid_pos=config.get("use_mid_position_embeddings", True),
        )


def load(model_dir: str | Path, device=None):
    """(config, params) from a HF YOLOS checkpoint directory; weights as
    f32 on ``device`` (default cuda)."""
    dev = resolve_device(device)
    cfg = YolosConfig.from_hf(read_config(model_dir))
    return cfg, to_device(map_params(read_safetensors(model_dir), cfg), dev)


def _mlp_head(tensors: dict, prefix: str) -> dict:
    return {str(i): {"w": linear(tensors, f"{prefix}layers.{i}.weight"),
                     "b": tensors[f"{prefix}layers.{i}.bias"]} for i in range(3)}


def map_params(tensors: dict, cfg: YolosConfig) -> dict:
    """Checkpoint names -> the JAX package's tree. The patch embedding's
    conv [dim, 3, ps, ps] becomes a dense [ps * ps * 3, dim] over the (i, j,
    c)-flattened patches ``vlm.patchify`` makes."""
    conv = tensors["vit.embeddings.patch_embeddings.projection.weight"]
    patch_proj = conv.permute(2, 3, 1, 0).reshape(-1, cfg.dim).contiguous()

    def layer(i: int) -> dict:
        lp = f"vit.encoder.layer.{i}."
        att = lp + "attention.attention."
        return {
            "attn_norm": tensors[lp + "layernorm_before.weight"],
            "attn_norm_b": tensors[lp + "layernorm_before.bias"],
            "wq": linear(tensors, att + "query.weight"), "bq": tensors[att + "query.bias"],
            "wk": linear(tensors, att + "key.weight"), "bk": tensors[att + "key.bias"],
            "wv": linear(tensors, att + "value.weight"), "bv": tensors[att + "value.bias"],
            "wo": linear(tensors, lp + "attention.output.dense.weight"),
            "bo": tensors[lp + "attention.output.dense.bias"],
            "ffn_norm": tensors[lp + "layernorm_after.weight"],
            "ffn_norm_b": tensors[lp + "layernorm_after.bias"],
            "w_up": linear(tensors, lp + "intermediate.dense.weight"),
            "b_up": tensors[lp + "intermediate.dense.bias"],
            "w_down": linear(tensors, lp + "output.dense.weight"),
            "b_down": tensors[lp + "output.dense.bias"],
        }

    params = {
        "patch_proj": patch_proj,
        "patch_bias": tensors["vit.embeddings.patch_embeddings.projection.bias"],
        "cls_token": tensors["vit.embeddings.cls_token"][0],          # [1, dim]
        "det_tokens": tensors["vit.embeddings.detection_tokens"][0],  # [n_det, dim]
        "pos_embed": tensors["vit.embeddings.position_embeddings"][0],
        "blocks": {str(i): layer(i) for i in range(cfg.layers)},
        "out_norm": tensors["vit.layernorm.weight"],
        "out_norm_b": tensors["vit.layernorm.bias"],
        "class_head": _mlp_head(tensors, "class_labels_classifier."),
        "bbox_head": _mlp_head(tensors, "bbox_predictor."),
    }
    mid = tensors.get("vit.encoder.mid_position_embeddings")
    if cfg.use_mid_pos and mid is not None and mid.shape[0] > 0:
        params["mid_pos"] = mid[:, 0]  # [layers - 1, seq, dim]
    return params


def _run_head(head: dict, x):
    for i in range(3):
        x = x @ head[str(i)]["w"].float() + head[str(i)]["b"].float()
        if i < 2:
            x = torch.relu(x)
    return x


def forward(params, cfg: YolosConfig, images):
    """images [B, H, W, 3] (HF-normalized) -> (logits [B, n_det, n_labels +
    1], boxes [B, n_det, 4] cxcywh in [0, 1]), both f32. Rows and columns
    past the last whole patch are dropped, as the checkpoint's patch
    convolution (stride = kernel) drops them (hustvl/yolos-small's 1333
    columns make 83 patches of 16); the JAX package's reshape takes only
    whole multiples."""
    from dora_tpu_torch.models.vlm import patchify

    dev = params["patch_proj"].device
    dtype = L.compute_dtype(dev)
    images = torch.as_tensor(images, device=dev)
    b, h, w = images.shape[:3]
    ps = cfg.patch_size
    x = patchify(images[:, : h - h % ps, : w - w % ps].to(dtype), ps)
    x = x @ params["patch_proj"].to(dtype) + params["patch_bias"].to(dtype)
    cls = params["cls_token"].to(dtype).expand(b, 1, cfg.dim)
    det = params["det_tokens"].to(dtype).expand(b, cfg.n_det, cfg.dim)
    x = torch.cat([cls, x, det], dim=1) + params["pos_embed"].to(dtype)[None]
    for i in range(cfg.layers):
        x, _ = L.block_forward(params["blocks"][str(i)], x, cfg.heads, mask=None, norm="ln",
                               mlp="gelu", norm_eps=cfg.layer_norm_eps)
        if "mid_pos" in params and i < cfg.layers - 1:
            x = x + params["mid_pos"][i].to(dtype)[None]
    x = L.layer_norm(x, params["out_norm"], params["out_norm_b"], eps=cfg.layer_norm_eps)
    det_out = x[:, -cfg.n_det:].float()
    return (_run_head(params["class_head"], det_out),
            torch.sigmoid(_run_head(params["bbox_head"], det_out)))


def detect(params, cfg: YolosConfig, images, threshold, top_k: int = 100):
    """HF ``post_process_object_detection``'s detections at fixed shape:
    softmax over the classes without the trailing no-object column, scores
    under ``threshold`` zeroed, boxes as normalized xyxy; exactly
    ``min(top_k, n_det)`` rows, largest score first and equal scores (the
    zeroed ones) lowest index first, as ``lax.top_k`` orders them."""
    logits, boxes = forward(params, cfg, images)
    probs = torch.softmax(logits, dim=-1)[..., :-1]
    scores, classes = probs.max(dim=-1)
    scores = torch.where(scores >= threshold, scores, 0.0)
    cx, cy, w, h = boxes.unbind(-1)
    xyxy = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
    top_scores, idx = _top_k(scores, min(top_k, scores.shape[-1]))
    idx = idx.long()
    return {"scores": top_scores,
            "classes": torch.gather(classes, 1, idx).to(torch.int32),
            "boxes": torch.gather(xyxy, 1, idx[..., None].expand(-1, -1, 4))}


#: ImageNet normalization the HF YolosImageProcessor applies.
IMAGE_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGE_STD = np.array([0.229, 0.224, 0.225], np.float32)


def preprocess(images, cfg: YolosConfig):
    """[B, H, W, 3] float in [0, 1] (at cfg.image_size) -> normalized f32
    NHWC, on the images' device."""
    images = torch.as_tensor(images)
    mean = torch.from_numpy(IMAGE_MEAN).to(images.device)
    std = torch.from_numpy(IMAGE_STD).to(images.device)
    return ((images - mean) / std).float()


def nchw(pixel_values):
    """Adapt torch-layout [B, 3, H, W] inputs to NHWC."""
    return torch.as_tensor(pixel_values).permute(0, 2, 3, 1)
