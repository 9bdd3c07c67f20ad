"""Wav2Vec2 audio-frame classification (the VAD class) over HF checkpoints,
on torch tensors (dora_tpu/models/hf/wav2vec2.py).

transformers' ``Wav2Vec2ForAudioFrameClassification`` graph: the conv
feature extractor (group norm on the first layer, or layer norm), the
feature projection, the weight-normed convolutional positions, post-LN
encoder blocks and a per-frame linear head. The products run in the
compute dtype (f32 on the CPU, as the JAX package computes; bf16 on the
card, where the JAX package stays f32), with norm statistics and logits in
f32."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any

import torch
import torch.nn.functional as F

from dora_tpu_torch._device import resolve_device
from dora_tpu_torch.models import layers as L
from dora_tpu_torch.models.hf.loader import linear, read_config, read_safetensors, to_device


@dataclass(frozen=True)
class Wav2Vec2Config:
    dim: int
    layers: int
    heads: int
    ffn: int
    conv_dims: tuple
    conv_strides: tuple
    conv_kernels: tuple
    pos_conv_kernel: int
    pos_conv_groups: int
    num_labels: int
    layer_norm_eps: float
    feat_extract_norm: str  # "group" (base) | "layer" (large)

    @classmethod
    def from_hf(cls, config: dict) -> "Wav2Vec2Config":
        return cls(
            dim=config["hidden_size"],
            layers=config["num_hidden_layers"],
            heads=config["num_attention_heads"],
            ffn=config["intermediate_size"],
            conv_dims=tuple(config["conv_dim"]),
            conv_strides=tuple(config["conv_stride"]),
            conv_kernels=tuple(config["conv_kernel"]),
            pos_conv_kernel=config["num_conv_pos_embeddings"],
            pos_conv_groups=config["num_conv_pos_embedding_groups"],
            num_labels=config.get("num_labels", 2),
            layer_norm_eps=config.get("layer_norm_eps", 1e-5),
            feat_extract_norm=config.get("feat_extract_norm", "group"),
        )


def load(model_dir: str | Path, device=None):
    """(config, params) from a HF checkpoint directory; weights as f32 on
    ``device`` (default cuda)."""
    dev = resolve_device(device)
    hf = read_config(model_dir)
    if hf.get("do_stable_layer_norm", False):
        raise NotImplementedError(
            "do_stable_layer_norm (the pre-LN wav2vec2-large variant) is not mapped; "
            "VAD-class checkpoints are the base post-LN architecture")
    cfg = Wav2Vec2Config.from_hf(hf)
    return cfg, to_device(map_params(read_safetensors(model_dir), cfg), dev)


def _weight_norm_conv(tensors: dict, prefix: str) -> torch.Tensor:
    """A weight-normed conv kernel rebuilt: w = g * v / ||v||, the norm over
    (out, in) per kernel position (weight_norm dim=2); newer torch saves
    parametrizations.weight.original0 / 1."""
    for g_name, v_name in ((prefix + "weight_g", prefix + "weight_v"),
                           (prefix + "parametrizations.weight.original0",
                            prefix + "parametrizations.weight.original1")):
        if g_name in tensors:
            g = tensors[g_name].float()
            v = tensors[v_name].float()
            norm = torch.sqrt((v**2).sum(dim=(0, 1), keepdim=True))
            return g * v / torch.clamp(norm, min=1e-12)
    return tensors[prefix + "weight"]


def map_params(tensors: dict, cfg: Wav2Vec2Config) -> dict:
    """Checkpoint names -> the JAX package's tree (conv weights in torch's
    [out, in, k] layout)."""
    prefix = "wav2vec2." if any(k.startswith("wav2vec2.") for k in tensors) else ""
    fe = prefix + "feature_extractor.conv_layers."
    params: dict[str, Any] = {"conv": {}, "blocks": {}}
    for i in range(len(cfg.conv_dims)):
        layer = {"w": tensors[f"{fe}{i}.conv.weight"]}
        if f"{fe}{i}.conv.bias" in tensors:
            layer["b"] = tensors[f"{fe}{i}.conv.bias"]
        if f"{fe}{i}.layer_norm.weight" in tensors:
            layer["ln_w"] = tensors[f"{fe}{i}.layer_norm.weight"]
            layer["ln_b"] = tensors[f"{fe}{i}.layer_norm.bias"]
        params["conv"][str(i)] = layer
    fp = prefix + "feature_projection."
    params["proj_ln_w"] = tensors[fp + "layer_norm.weight"]
    params["proj_ln_b"] = tensors[fp + "layer_norm.bias"]
    params["proj_w"] = linear(tensors, fp + "projection.weight")
    params["proj_b"] = tensors[fp + "projection.bias"]
    enc = prefix + "encoder."
    params["pos_conv_w"] = _weight_norm_conv(tensors, enc + "pos_conv_embed.conv.")
    params["pos_conv_b"] = tensors[enc + "pos_conv_embed.conv.bias"]
    params["enc_ln_w"] = tensors[enc + "layer_norm.weight"]
    params["enc_ln_b"] = tensors[enc + "layer_norm.bias"]
    for i in range(cfg.layers):
        lp = f"{enc}layers.{i}."
        params["blocks"][str(i)] = {
            "wq": linear(tensors, lp + "attention.q_proj.weight"),
            "bq": tensors[lp + "attention.q_proj.bias"],
            "wk": linear(tensors, lp + "attention.k_proj.weight"),
            "bk": tensors[lp + "attention.k_proj.bias"],
            "wv": linear(tensors, lp + "attention.v_proj.weight"),
            "bv": tensors[lp + "attention.v_proj.bias"],
            "wo": linear(tensors, lp + "attention.out_proj.weight"),
            "bo": tensors[lp + "attention.out_proj.bias"],
            "ln1_w": tensors[lp + "layer_norm.weight"],
            "ln1_b": tensors[lp + "layer_norm.bias"],
            "fc1": linear(tensors, lp + "feed_forward.intermediate_dense.weight"),
            "fc1_b": tensors[lp + "feed_forward.intermediate_dense.bias"],
            "fc2": linear(tensors, lp + "feed_forward.output_dense.weight"),
            "fc2_b": tensors[lp + "feed_forward.output_dense.bias"],
            "ln2_w": tensors[lp + "final_layer_norm.weight"],
            "ln2_b": tensors[lp + "final_layer_norm.bias"],
        }
    params["head_w"] = linear(tensors, "classifier.weight")
    params["head_b"] = tensors["classifier.bias"]
    return params


def _group_norm(x, w, b, eps: float):
    """GroupNorm with one group per channel: x [B, C, T], statistics over
    time in f32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * w.float()[None, :, None] + b.float()[None, :, None]).to(x.dtype)


def _conv1d(x, w, b=None, stride: int = 1, padding: int = 0, groups: int = 1):
    """x [B, C_in, T], w [C_out, C_in / groups, K] in x's dtype."""
    return F.conv1d(x, w.to(x.dtype), None if b is None else b.to(x.dtype), stride=stride,
                    padding=padding, groups=groups)


def feature_extractor(params, cfg: Wav2Vec2Config, audio):
    """audio [B, samples] -> features [B, T, conv_dim[-1]] in the compute
    dtype."""
    dev = params["proj_w"].device
    x = torch.as_tensor(audio, device=dev).float()[:, None, :].to(L.compute_dtype(dev))
    for i, s in enumerate(cfg.conv_strides):
        layer = params["conv"][str(i)]
        x = _conv1d(x, layer["w"], layer.get("b"), stride=s)
        if "ln_w" in layer:
            if cfg.feat_extract_norm == "layer":  # LayerNorm over channels
                x = L.layer_norm(x.transpose(1, 2), layer["ln_w"], layer["ln_b"],
                                 cfg.layer_norm_eps).transpose(1, 2)
            else:
                x = _group_norm(x, layer["ln_w"], layer["ln_b"], cfg.layer_norm_eps)
        x = F.gelu(x)
    return x.transpose(1, 2)


def _attention(block, x, heads: int):
    b, t, dim = x.shape
    q, k, v = (L.dense(x, block, f"w{n}", f"b{n}").reshape(b, t, heads, dim // heads)
               .transpose(1, 2) for n in "qkv")
    out = L.attention(q, k, v).transpose(1, 2).reshape(b, t, dim)
    return L.dense(out, block, "wo", "bo")


def forward(params, cfg: Wav2Vec2Config, audio):
    """audio [B, samples] -> frame logits [B, T, num_labels] f32."""
    eps = cfg.layer_norm_eps
    x = feature_extractor(params, cfg, audio)
    x = L.layer_norm(x, params["proj_ln_w"], params["proj_ln_b"], eps)
    x = L.dense(x, params, "proj_w", "proj_b")
    # convolutional relative positions ("same" pad; an even kernel drops
    # the last step, as torch does)
    pos = _conv1d(x.transpose(1, 2), params["pos_conv_w"], params["pos_conv_b"],
                  padding=cfg.pos_conv_kernel // 2, groups=cfg.pos_conv_groups)
    if cfg.pos_conv_kernel % 2 == 0:
        pos = pos[:, :, :-1]
    x = x + F.gelu(pos).transpose(1, 2)
    x = L.layer_norm(x, params["enc_ln_w"], params["enc_ln_b"], eps)
    for i in range(cfg.layers):
        block = params["blocks"][str(i)]
        x = L.layer_norm(x + _attention(block, x, cfg.heads), block["ln1_w"], block["ln1_b"],
                         eps)
        h = L.dense(F.gelu(L.dense(x, block, "fc1", "fc1_b")), block, "fc2", "fc2_b")
        x = L.layer_norm(x + h, block["ln2_w"], block["ln2_b"], eps)
    return L.dense(x, params, "head_w", "head_b").float()


def speech_probability(params, cfg: Wav2Vec2Config, audio):
    """audio [B, samples] -> per-frame speech probability [B, T] f32: the
    heads are multi-label (one sigmoid per speaker), so presence is the
    largest label's sigmoid."""
    return torch.sigmoid(forward(params, cfg, audio)).amax(dim=-1)
