"""Single-shot object detector (the YOLOv8 class), on torch tensors
(dora_tpu/models/detection.py).

An anchor-free conv detector: a strided backbone of residual blocks, a
decoupled head per scale predicting centre, size, objectness and classes
per cell, then fixed-shape postprocessing (a top-K selection and a greedy
IoU suppression of exactly K steps, no dynamic NMS). The convolutions run
in NCHW with OIHW weights; the API's images are NHWC, as the JAX package's,
and change layout once at the entry (``params_from_jax`` turns the JAX
package's HWIO kernels into OIHW). The suppression is a loop of K steps
over device tensors, with no fetch."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from dora_tpu_torch.models import layers as L


@dataclass(frozen=True)
class DetectorConfig:
    image_size: int = 640
    num_classes: int = 80
    widths: tuple = (32, 64, 128, 256)  # stem + 3 stages (stride 8/16/32 heads)
    blocks_per_stage: int = 2
    max_detections: int = 100
    score_threshold: float = 0.25
    iou_threshold: float = 0.45

    @classmethod
    def tiny(cls) -> "DetectorConfig":
        return cls(image_size=64, num_classes=4, widths=(8, 16, 32, 64),
                   blocks_per_stage=1, max_detections=10)


def init_params(cfg: DetectorConfig, *, seed: int = 0, device=None) -> dict:
    """Seeded random OIHW kernels on ``device`` (default cuda), uniform in
    +-1/sqrt(k * k * c_in) as the JAX package's ``_conv_init``."""
    init = L.Init(seed, device)

    def kernel(k, c_in, c_out):
        return init.uniform((c_out, c_in, k, k), 1.0 / math.sqrt(k * k * c_in))

    widths = cfg.widths
    params: dict = {"stem": kernel(3, 3, widths[0]), "stages": {}, "heads": {}}
    for s in range(1, len(widths)):
        params["stages"][str(s)] = {
            "down": kernel(3, widths[s - 1], widths[s]),
            "blocks": [{"c1": kernel(1, widths[s], widths[s] // 2),
                        "c2": kernel(3, widths[s] // 2, widths[s])}
                       for _ in range(cfg.blocks_per_stage)],
        }
        params["heads"][str(s)] = {"conv": kernel(3, widths[s], widths[s]),
                                   "out": kernel(1, widths[s], 5 + cfg.num_classes)}
    return params


def params_from_jax(tree, device=None) -> dict:
    """The JAX package's detector parameters (HWIO kernels) as the port's
    OIHW tensors on ``device``, values bit for bit."""
    from dora_tpu_torch.models.hf.qwen2 import params_from_jax as carry

    def oihw(v):
        if isinstance(v, dict):
            return {k: oihw(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(oihw(x) for x in v)
        return v.permute(3, 2, 0, 1).contiguous()

    return oihw(carry(tree, device=device))


def conv(x, w, stride: int = 1):
    """NCHW convolution with XLA's "SAME" padding (the odd pad on the high
    side), no bias."""
    k = w.shape[-1]
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad takes the last axis first
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), w.to(x.dtype), stride=stride)


def backbone_features(params, cfg: DetectorConfig, images):
    """images [B, H, W, 3] in [0, 1] -> per-stride NCHW feature maps."""
    dtype = L.compute_dtype(images.device)
    x = F.silu(conv(images.to(dtype).permute(0, 3, 1, 2), params["stem"], stride=2))
    feats = []
    for s in range(1, len(cfg.widths)):
        stage = params["stages"][str(s)]
        x = F.silu(conv(x, stage["down"], stride=2))
        for blk in stage["blocks"]:
            y = F.silu(conv(x, blk["c1"]))
            x = x + F.silu(conv(y, blk["c2"]))
        feats.append(x)
    return feats


def forward(params, cfg: DetectorConfig, images):
    """Raw per-cell predictions, concatenated over scales: [B, cells, 5 +
    classes] f32 (cx, cy, w, h in pixels, objectness and class logits),
    cells in row-major order of each scale."""
    images = torch.as_tensor(images, device=params["stem"].device)
    outs = []
    for s, feat in enumerate(backbone_features(params, cfg, images), start=1):
        head = params["heads"][str(s)]
        p = conv(F.silu(conv(feat, head["conv"])), head["out"]).permute(0, 2, 3, 1)
        b, hs, ws, c = p.shape
        stride = cfg.image_size // hs
        gy, gx = torch.meshgrid(torch.arange(hs, device=p.device),
                                torch.arange(ws, device=p.device), indexing="ij")
        grid = torch.stack([gx, gy], dim=-1).to(p.dtype)
        xy = (torch.sigmoid(p[..., 0:2]) + grid) * stride
        wh = torch.exp(torch.clamp(p[..., 2:4], -8, 8)) * stride
        outs.append(torch.cat([xy, wh, p[..., 4:]], dim=-1).reshape(b, hs * ws, c))
    return torch.cat(outs, dim=1).float()


def top_k(scores, k: int):
    """The ``k`` largest of ``scores`` along the last axis, largest first,
    equal values lowest index first (``lax.top_k``'s order): a stable
    descending sort. Returns (values, int32 indices)."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k].to(torch.int32)


def _iou_matrix(boxes):
    """boxes [..., K, 4] cxcywh -> [..., K, K] IoU."""
    cx, cy, w, h = boxes.unbind(-1)
    x1, y1, x2, y2 = cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2
    area = w * h
    iw = torch.clamp(torch.minimum(x2[..., :, None], x2[..., None, :])
                     - torch.maximum(x1[..., :, None], x1[..., None, :]), min=0.0)
    ih = torch.clamp(torch.minimum(y2[..., :, None], y2[..., None, :])
                     - torch.maximum(y1[..., :, None], y1[..., None, :]), min=0.0)
    inter = iw * ih
    return inter / torch.clamp(area[..., :, None] + area[..., None, :] - inter, min=1e-9)


def postprocess(cfg: DetectorConfig, predictions):
    """Fixed-shape detection decoding of [cells, 5 + C] (one image) or [B,
    cells, 5 + C]: boxes [.., K, 4] (cxcywh), scores [.., K] (0 below the
    threshold or suppressed), classes [.., K] int32, K = max_detections.
    Candidate i is suppressed when a kept higher-scored candidate of its
    class overlaps it by more than ``iou_threshold``: K sequential steps
    in score order."""
    single = predictions.dim() == 2
    if single:
        predictions = predictions[None]
    scores_all = torch.sigmoid(predictions[..., 4:5]) * torch.sigmoid(predictions[..., 5:])
    best_score, best_cls = scores_all.max(dim=-1)
    k = cfg.max_detections
    top_scores, top_idx = top_k(best_score, k)
    idx = top_idx.long()
    boxes = torch.gather(predictions[..., 0:4], 1, idx[..., None].expand(-1, -1, 4))
    classes = torch.gather(best_cls, 1, idx).to(torch.int32)
    overlap = ((_iou_matrix(boxes) > cfg.iou_threshold)
               & (classes[..., :, None] == classes[..., None, :]))
    kept = top_scores >= cfg.score_threshold
    for i in range(1, k):  # candidate 0 has no higher-scored rival
        suppressed = (overlap[:, i, :i] & kept[:, :i]).any(dim=-1)
        kept[:, i] &= ~suppressed
    out = {"boxes": boxes, "scores": torch.where(kept, top_scores, 0.0), "classes": classes}
    return {key: v[0] for key, v in out.items()} if single else out


def detect(params, cfg: DetectorConfig, images):
    """images [B, H, W, 3] -> batched fixed-shape detections (backbone,
    heads, decode and suppression)."""
    return postprocess(cfg, forward(params, cfg, images))
