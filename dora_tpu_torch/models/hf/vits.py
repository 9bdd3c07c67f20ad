"""VITS / MMS-TTS over pretrained HF checkpoints, on torch tensors
(dora_tpu/models/hf/vits.py).

transformers' ``VitsModel`` inference graph (facebook/mms-tts-* and
kakao-enterprise/vits-* checkpoints): a text encoder of windowed
relative-position attention and conv feed-forwards projecting to the
per-phoneme prior (mean, log-variance); the plain conv duration predictor
or the stochastic one (dilated depth-separable convs, rational-quadratic
spline flows run in reverse, no noise drawn: zeros, as the JAX package
keeps); length regulation by ceil(exp(log_dur) / rate) repeats; the
residual-coupling flow inverted; the HiFiGAN decoder. Everything computes
in the parameters' dtype (f32), in the torch [B, C, T] layout, so the
checkpoint's conv weights map straight across (weight norm folded at load).

On the card every entry point runs with TF32 off for its convolutions and
products, on cuDNN's deterministic algorithms (:func:`_f32_exact`),
whatever the process set: a duration is an integer, and TF32's rounding
moves a log-duration enough to add or drop a frame. :func:`synthesize`
orchestrates on the host (durations fetched, the repeat built on the
host); :func:`synthesize_bucketed`, the serving path,
pads text and frames to bucket edges and keeps the alignment on the device,
with two host round trips: the frame count, then the waveform. Noise for
the prior comes from a ``torch.Generator`` where the JAX package takes a
key, else from ``np.random.default_rng()`` as there."""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from dora_tpu_torch._device import resolve_device
from dora_tpu_torch.models import layers as L
from dora_tpu_torch.models.hf.loader import read_config, read_safetensors, to_device


@dataclass(frozen=True)
class VitsConfig:
    vocab: int
    dim: int
    layers: int
    heads: int
    ffn: int
    ffn_kernel: int
    window_size: int
    flow_size: int
    spectrogram_bins: int
    duration_kernel: int
    duration_filters: int
    use_stochastic_duration: bool
    duration_num_flows: int
    duration_flow_bins: int
    duration_tail_bound: float
    depth_separable_layers: int
    depth_separable_channels: int
    prior_num_flows: int
    prior_wavenet_layers: int
    wavenet_kernel: int
    wavenet_dilation: int
    upsample_initial: int
    upsample_rates: tuple[int, ...]
    upsample_kernels: tuple[int, ...]
    resblock_kernels: tuple[int, ...]
    resblock_dilations: tuple[tuple[int, ...], ...]
    leaky_relu_slope: float
    norm_eps: float
    speaking_rate: float
    noise_scale: float
    noise_scale_duration: float
    num_speakers: int
    speaker_embed_size: int
    sampling_rate: int

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @classmethod
    def from_hf(cls, c: dict) -> "VitsConfig":
        return cls(
            vocab=c["vocab_size"],
            dim=c["hidden_size"],
            layers=c["num_hidden_layers"],
            heads=c["num_attention_heads"],
            ffn=c["ffn_dim"],
            ffn_kernel=c.get("ffn_kernel_size", 3),
            window_size=c.get("window_size", 4),
            flow_size=c.get("flow_size", 192),
            spectrogram_bins=c.get("spectrogram_bins", 513),
            duration_kernel=c.get("duration_predictor_kernel_size", 3),
            duration_filters=c.get("duration_predictor_filter_channels", 256),
            use_stochastic_duration=c.get("use_stochastic_duration_prediction", True),
            duration_num_flows=c.get("duration_predictor_num_flows", 4),
            duration_flow_bins=c.get("duration_predictor_flow_bins", 10),
            duration_tail_bound=c.get("duration_predictor_tail_bound", 5.0),
            depth_separable_layers=c.get("depth_separable_num_layers", 3),
            depth_separable_channels=c.get("depth_separable_channels", 2),
            prior_num_flows=c.get("prior_encoder_num_flows", 4),
            prior_wavenet_layers=c.get("prior_encoder_num_wavenet_layers", 4),
            wavenet_kernel=c.get("wavenet_kernel_size", 5),
            wavenet_dilation=c.get("wavenet_dilation_rate", 1),
            upsample_initial=c.get("upsample_initial_channel", 512),
            upsample_rates=tuple(c.get("upsample_rates", [8, 8, 2, 2])),
            upsample_kernels=tuple(c.get("upsample_kernel_sizes", [16, 16, 4, 4])),
            resblock_kernels=tuple(c.get("resblock_kernel_sizes", [3, 7, 11])),
            resblock_dilations=tuple(tuple(d) for d in c.get(
                "resblock_dilation_sizes", [[1, 3, 5], [1, 3, 5], [1, 3, 5]])),
            leaky_relu_slope=c.get("leaky_relu_slope", 0.1),
            norm_eps=c.get("layer_norm_eps", 1e-5),
            speaking_rate=c.get("speaking_rate", 1.0),
            noise_scale=c.get("noise_scale", 0.667),
            noise_scale_duration=c.get("noise_scale_duration", 0.8),
            num_speakers=c.get("num_speakers", 1),
            speaker_embed_size=c.get("speaker_embedding_size", 0),
            sampling_rate=c.get("sampling_rate", 16000),
        )


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


def load(model_dir: str | Path, device=None):
    """(config, params) from a HF VITS checkpoint directory; weights as f32
    on ``device`` (default cuda)."""
    dev = resolve_device(device)
    cfg = VitsConfig.from_hf(read_config(model_dir))
    return cfg, to_device(map_params(read_safetensors(model_dir), cfg), dev)


def _fold(g, v):
    """Weight norm g * v / ||v|| (the norm over every axis but the first),
    in f64 as the JAX package folds it."""
    g, v = g.double(), v.double()
    norm = torch.sqrt((v ** 2).sum(dim=(1, 2), keepdim=True))
    return (g * v / torch.clamp(norm, min=1e-12)).float()


def _conv_weight(tensors: dict, name: str):
    """A conv weight, the weight-norm parametrization (``parametrizations.
    weight.original0/1``, or the legacy ``weight_g`` / ``weight_v``) folded
    when the checkpoint stores it."""
    if name + ".parametrizations.weight.original0" in tensors:
        return _fold(tensors[name + ".parametrizations.weight.original0"],
                     tensors[name + ".parametrizations.weight.original1"])
    if name + ".weight_g" in tensors:
        return _fold(tensors[name + ".weight_g"], tensors[name + ".weight_v"])
    return tensors[name + ".weight"]


def _conv(tensors: dict, name: str) -> dict:
    out = {"w": _conv_weight(tensors, name)}
    if name + ".bias" in tensors:
        out["b"] = tensors[name + ".bias"]
    return out


def _dds(tensors: dict, prefix: str, n_layers: int) -> dict:
    return {str(i): {"dilated": _conv(tensors, f"{prefix}.convs_dilated.{i}"),
                     "pointwise": _conv(tensors, f"{prefix}.convs_pointwise.{i}"),
                     "norm1": tensors[f"{prefix}.norms_1.{i}.weight"],
                     "norm1_b": tensors[f"{prefix}.norms_1.{i}.bias"],
                     "norm2": tensors[f"{prefix}.norms_2.{i}.weight"],
                     "norm2_b": tensors[f"{prefix}.norms_2.{i}.bias"]}
            for i in range(n_layers)}


def _wavenet(tensors: dict, prefix: str, n_layers: int) -> dict:
    return {"in": {str(i): _conv(tensors, f"{prefix}.in_layers.{i}") for i in range(n_layers)},
            "res_skip": {str(i): _conv(tensors, f"{prefix}.res_skip_layers.{i}")
                         for i in range(n_layers)}}


def map_params(tensors: dict, cfg: VitsConfig) -> dict:
    """Checkpoint names -> the JAX package's tree (linears as [in, out],
    convolutions in torch's [out, in, k] and [in, out, k] layouts)."""
    params: dict[str, Any] = {
        "embed": tensors["text_encoder.embed_tokens.weight"],
        "project": _conv(tensors, "text_encoder.project"),
        "enc_blocks": {},
    }
    for i in range(cfg.layers):
        lp = f"text_encoder.encoder.layers.{i}."
        att = lp + "attention."
        params["enc_blocks"][str(i)] = {
            **{f"w{x}": tensors[f"{att}{n}_proj.weight"].T.contiguous()
               for x, n in (("q", "q"), ("k", "k"), ("v", "v"), ("o", "out"))},
            **{f"b{x}": tensors[f"{att}{n}_proj.bias"]
               for x, n in (("q", "q"), ("k", "k"), ("v", "v"), ("o", "out"))},
            "rel_k": tensors[att + "emb_rel_k"][0],
            "rel_v": tensors[att + "emb_rel_v"][0],
            "ln1": tensors[lp + "layer_norm.weight"],
            "ln1_b": tensors[lp + "layer_norm.bias"],
            "fc1": _conv(tensors, lp + "feed_forward.conv_1"),
            "fc2": _conv(tensors, lp + "feed_forward.conv_2"),
            "ln2": tensors[lp + "final_layer_norm.weight"],
            "ln2_b": tensors[lp + "final_layer_norm.bias"],
        }

    dp = "duration_predictor."
    if cfg.use_stochastic_duration:
        duration: dict[str, Any] = {
            "conv_pre": _conv(tensors, dp + "conv_pre"),
            "conv_proj": _conv(tensors, dp + "conv_proj"),
            "dds": _dds(tensors, dp + "conv_dds", cfg.depth_separable_layers),
            # flows.0 is the elementwise affine; 1..N the conv flows
            "flows": {"affine": {"translate": tensors[dp + "flows.0.translate"],
                                 "log_scale": tensors[dp + "flows.0.log_scale"]}},
        }
        for i in range(1, cfg.duration_num_flows + 1):
            fp = f"{dp}flows.{i}."
            duration["flows"][str(i)] = {
                "conv_pre": _conv(tensors, fp + "conv_pre"),
                "dds": _dds(tensors, fp + "conv_dds", cfg.depth_separable_layers),
                "conv_proj": _conv(tensors, fp + "conv_proj"),
            }
    else:
        duration = {
            "conv1": _conv(tensors, dp + "conv_1"),
            "norm1": tensors[dp + "norm_1.weight"], "norm1_b": tensors[dp + "norm_1.bias"],
            "conv2": _conv(tensors, dp + "conv_2"),
            "norm2": tensors[dp + "norm_2.weight"], "norm2_b": tensors[dp + "norm_2.bias"],
            "proj": _conv(tensors, dp + "proj"),
        }
    params["duration"] = duration
    params["flow"] = {
        str(i): {"conv_pre": _conv(tensors, f"flow.flows.{i}.conv_pre"),
                 "wavenet": _wavenet(tensors, f"flow.flows.{i}.wavenet",
                                     cfg.prior_wavenet_layers),
                 "conv_post": _conv(tensors, f"flow.flows.{i}.conv_post")}
        for i in range(cfg.prior_num_flows)
    }
    n_kernels = len(cfg.resblock_kernels)
    params["decoder"] = {
        "conv_pre": _conv(tensors, "decoder.conv_pre"),
        "conv_post": _conv(tensors, "decoder.conv_post"),
        "up": {str(i): _conv(tensors, f"decoder.upsampler.{i}")
               for i in range(len(cfg.upsample_rates))},
        "res": {str(i): {
            f"convs{c}": {str(j): _conv(tensors, f"decoder.resblocks.{i}.convs{c}.{j}")
                          for j in range(len(cfg.resblock_dilations[i % n_kernels]))}
            for c in (1, 2)} for i in range(len(cfg.upsample_rates) * n_kernels)},
    }
    if "embed_speaker.weight" in tensors:
        params["embed_speaker"] = tensors["embed_speaker.weight"]
    return params


# ---------------------------------------------------------------------------
# primitives ([B, C, T], the torch layout)
# ---------------------------------------------------------------------------


def _f32_exact():
    """TF32 off for cuDNN convolutions and cuBLAS products, and cuDNN's
    deterministic algorithms (HiFiGAN's transposed convolutions), while
    VITS runs; the process's flags restored after (``layers.cudnn_exact``)."""
    return L.cudnn_exact(tf32=False)


def conv1d(x, p: dict, *, stride=1, dilation=1, padding=0, groups=1):
    return F.conv1d(x, p["w"].to(x.dtype), None if "b" not in p else p["b"].to(x.dtype),
                    stride=stride, padding=padding, dilation=dilation, groups=groups)


def conv_transpose1d(x, p: dict, *, stride, padding):
    """torch's ConvTranspose1d, which the JAX package spells out as a
    fractionally strided convolution."""
    return F.conv_transpose1d(x, p["w"].to(x.dtype),
                              None if "b" not in p else p["b"].to(x.dtype),
                              stride=stride, padding=padding)


def _length_mask(b: int, t: int, length, dtype, device):
    """[B, 1, T] {0, 1} mask of the real positions (< ``length``)."""
    idx = torch.arange(t, device=device).expand(b, 1, t)
    return (idx < length).to(dtype)


def _ln_channels(x, w, b, eps):
    """LayerNorm over the channels of [B, C, T]."""
    mean = torch.mean(x, dim=1, keepdim=True)
    var = torch.mean((x - mean) ** 2, dim=1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w[None, :, None] + b[None, :, None]


def _ln_last(x, w, b, eps):
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mean) ** 2, dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


# ---------------------------------------------------------------------------
# text encoder (windowed relative attention)
# ---------------------------------------------------------------------------


def _relative_embeddings(table, length: int, window: int):
    """[2 window + 1, head_dim] -> [2 length - 1, head_dim] (pad or slice)."""
    pad = max(length - (window + 1), 0)
    if pad > 0:
        table = F.pad(table, (0, 0, pad, pad))
    start = max((window + 1) - length, 0)
    return table[start : start + 2 * length - 1]


def _relative_to_absolute(x):
    """[BH, L, 2L - 1] relative logits -> [BH, L, L] absolute."""
    bh, length, _ = x.shape
    x = F.pad(x, (0, 1)).reshape(bh, length * 2 * length)
    x = F.pad(x, (0, length - 1)).reshape(bh, length + 1, 2 * length - 1)
    return x[:, :length, length - 1:]


def _absolute_to_relative(x):
    """[BH, L, L] -> [BH, L, 2L - 1]."""
    bh, length, _ = x.shape
    x = F.pad(x, (0, length - 1)).reshape(bh, length * (2 * length - 1))
    x = F.pad(x, (length, 0))
    return x.reshape(bh, length, 2 * length)[:, :, 1:]


def _encoder_attention(block, x, cfg: VitsConfig, key_mask=None):
    b, t, _ = x.shape
    h, hd = cfg.heads, cfg.head_dim
    q = (x @ block["wq"] + block["bq"]) * hd ** -0.5
    k = x @ block["wk"] + block["bk"]
    v = x @ block["wv"] + block["bv"]
    q, k, v = (z.reshape(b, t, h, hd).transpose(1, 2).reshape(b * h, t, hd) for z in (q, k, v))
    weights = q @ k.transpose(1, 2)  # [BH, T, T]
    rel_k = _relative_embeddings(block["rel_k"], t, cfg.window_size)
    weights = weights + _relative_to_absolute(q @ rel_k.T)
    if key_mask is not None:  # [B, 1, T]: bucket padding never attends
        km = torch.repeat_interleave(key_mask > 0, h, dim=0)
        weights = torch.where(km, weights, torch.finfo(weights.dtype).min)
    probs = torch.softmax(weights, dim=-1)
    rel_v = _relative_embeddings(block["rel_v"], t, cfg.window_size)
    out = probs @ v + _absolute_to_relative(probs) @ rel_v
    out = out.reshape(b, h, t, hd).transpose(1, 2).reshape(b, t, h * hd)
    return out @ block["wo"] + block["bo"]


def _encoder_ffn(block, x, cfg: VitsConfig, mask=None):
    h = x.transpose(1, 2)  # [B, C, T]
    if mask is not None:
        h = h * mask
    pads = ((cfg.ffn_kernel - 1) // 2, cfg.ffn_kernel // 2)
    h = torch.relu(conv1d(F.pad(h, pads), block["fc1"]))
    if mask is not None:  # the bias refills the padding; zero it before fc2 reads
        h = h * mask
    return conv1d(F.pad(h, pads), block["fc2"]).transpose(1, 2)


def _encode_text(params, cfg: VitsConfig, input_ids, length=None):
    dev = params["embed"].device
    input_ids = torch.as_tensor(input_ids, device=dev).long()
    b, t = input_ids.shape
    mask = None if length is None else _length_mask(b, t, length, params["embed"].dtype, dev)
    x = params["embed"][input_ids] * math.sqrt(cfg.dim)  # [B, T, dim]
    if mask is not None:
        x = x * mask.transpose(1, 2)
    for i in range(cfg.layers):
        block = params["enc_blocks"][str(i)]
        x = _ln_last(x + _encoder_attention(block, x, cfg, key_mask=mask),
                     block["ln1"], block["ln1_b"], cfg.norm_eps)
        x = _ln_last(x + _encoder_ffn(block, x, cfg, mask=mask),
                     block["ln2"], block["ln2_b"], cfg.norm_eps)
    h = x.transpose(1, 2)
    if mask is not None:
        h = h * mask
    means, log_var = conv1d(h, params["project"]).transpose(1, 2).chunk(2, dim=-1)
    return h, means, log_var


def encode_text(params, cfg: VitsConfig, input_ids, length=None):
    """input_ids [B, T] -> (hidden [B, dim, T], prior_means [B, T, flow],
    prior_log_var [B, T, flow]). ``length`` marks the real prefix of a
    bucket-padded batch: padding is masked out of attention and zeroed
    around every conv, so the real positions compute what an unpadded run
    computes."""
    with torch.no_grad(), _f32_exact():
        return _encode_text(params, cfg, input_ids, length)


# ---------------------------------------------------------------------------
# duration prediction
# ---------------------------------------------------------------------------


def _dds_forward(dds_params, x, cfg: VitsConfig, cond=None, mask=None):
    if cond is not None:
        x = x + cond
    k = cfg.duration_kernel
    for i in range(cfg.depth_separable_layers):
        layer = dds_params[str(i)]
        dilation = k ** i
        if mask is not None:  # keep the padding zero under the dilated taps
            x = x * mask
        h = conv1d(x, layer["dilated"], dilation=dilation, padding=(k * dilation - dilation) // 2,
                   groups=cfg.dim)
        h = F.gelu(_ln_channels(h, layer["norm1"], layer["norm1_b"], cfg.norm_eps))
        h = conv1d(h, layer["pointwise"])
        h = F.gelu(_ln_channels(h, layer["norm2"], layer["norm2_b"], cfg.norm_eps))
        x = x + h
    if mask is not None:
        x = x * mask
    return x


def _knots(u, n_bins: int, bound: float, minimum: float):
    """Bin edges [.., n_bins + 1] in [-bound, bound] from unnormalized
    widths or heights, each bin at least ``minimum`` of the range."""
    sizes = minimum + (1 - minimum * n_bins) * torch.softmax(u, dim=-1)
    cum = 2 * bound * F.pad(torch.cumsum(sizes, dim=-1), (1, 0)) - bound
    cum[..., 0] = -bound
    cum[..., -1] = bound
    return cum


def _spline_inverse(inputs, uw, uh, ud, cfg: VitsConfig):
    """Inverse unconstrained rational-quadratic spline (torch's
    ``_unconstrained_rational_quadratic_spline`` with reverse=True) over
    [B, C, T]; inputs outside the tail bound pass through."""
    bound = cfg.duration_tail_bound
    n_bins = cfg.duration_flow_bins
    min_d = 1e-3
    ud = F.pad(ud, (1, 1), value=math.log(math.exp(1 - min_d) - 1))
    inside = (inputs >= -bound) & (inputs <= bound)
    x = torch.clamp(inputs, -bound, bound)  # keeps the outside entries finite

    cumw = _knots(uw, n_bins, bound, 1e-3)
    widths = cumw[..., 1:] - cumw[..., :-1]
    derivs = min_d + F.softplus(ud)
    cumh = _knots(uh, n_bins, bound, 1e-3)
    heights = cumh[..., 1:] - cumh[..., :-1]

    locations = cumh.clone()
    locations[..., -1] += 1e-6  # reverse: bin by heights
    bin_idx = (x[..., None] >= locations).to(torch.int32).sum(dim=-1) - 1
    bin_idx = torch.clamp(bin_idx, 0, n_bins - 1)[..., None].long()

    def take(a):
        return torch.gather(a, -1, bin_idx)[..., 0]

    in_cumw = take(cumw[..., :-1])
    in_w = take(widths)
    in_cumh = take(cumh[..., :-1])
    in_delta = take(heights / widths)
    in_d = take(derivs[..., :-1])
    in_d1 = take(derivs[..., 1:])
    in_h = take(heights)

    inter1 = in_d + in_d1 - 2 * in_delta
    inter2 = x - in_cumh
    inter3 = inter2 * inter1
    a = in_h * (in_delta - in_d) + inter3
    b = in_h * in_d - inter3
    c = -in_delta * inter2
    disc = b ** 2 - 4 * a * c
    root = (2 * c) / (-b - torch.sqrt(torch.clamp(disc, min=0.0)))
    return torch.where(inside, root * in_w + in_cumw, inputs)


def _conv_flow_reverse(flow, x, cfg: VitsConfig, cond, mask=None):
    half = cfg.depth_separable_channels // 2
    first, second = x[:, :half], x[:, half:]
    h = conv1d(first, flow["conv_pre"])
    h = conv1d(_dds_forward(flow["dds"], h, cfg, cond=cond, mask=mask), flow["conv_proj"])
    b, _, t = first.shape
    h = h.reshape(b, half, -1, t).transpose(2, 3)  # [B, half, T, 3 bins - 1]
    n_bins = cfg.duration_flow_bins
    scale = math.sqrt(cfg.dim)
    second = _spline_inverse(second, h[..., :n_bins] / scale, h[..., n_bins:2 * n_bins] / scale,
                             h[..., 2 * n_bins:], cfg)
    return torch.cat([first, second], dim=1)


def _predict_log_duration(params, cfg: VitsConfig, hidden, noise_scale=None, length=None):
    dp = params["duration"]
    b, _, t = hidden.shape
    mask = None if length is None else _length_mask(b, t, length, hidden.dtype, hidden.device)
    if not cfg.use_stochastic_duration:
        k = cfg.duration_kernel
        h = torch.relu(conv1d(hidden, dp["conv1"], padding=k // 2))
        h = _ln_channels(h, dp["norm1"], dp["norm1_b"], cfg.norm_eps)
        if mask is not None:
            h = h * mask
        h = torch.relu(conv1d(h, dp["conv2"], padding=k // 2))
        h = _ln_channels(h, dp["norm2"], dp["norm2_b"], cfg.norm_eps)
        return conv1d(h, dp["proj"])

    if noise_scale is None:
        noise_scale = cfg.noise_scale_duration
    h = _dds_forward(dp["dds"], conv1d(hidden, dp["conv_pre"]), cfg, mask=mask)
    cond = conv1d(h, dp["conv_proj"])
    # no noise drawn: zeros scaled by noise_scale, as the JAX package serves
    latents = torch.zeros((b, cfg.depth_separable_channels, t), dtype=hidden.dtype,
                          device=hidden.device) * noise_scale
    # torch runs reversed(flows) without the "useless vflow": conv flows N..2,
    # then the elementwise affine, each after a channel flip
    affine = dp["flows"]["affine"]
    for name in [str(i) for i in range(cfg.duration_num_flows, 1, -1)] + ["affine"]:
        latents = torch.flip(latents, dims=(1,))
        if name == "affine":
            latents = (latents - affine["translate"]) * torch.exp(-affine["log_scale"])
        else:
            latents = _conv_flow_reverse(dp["flows"][name], latents, cfg, cond, mask=mask)
    return latents[:, :1]


def predict_log_duration(params, cfg: VitsConfig, hidden, noise_scale=None, length=None):
    """hidden [B, dim, T] -> log durations [B, 1, T]. ``length`` masks a
    bucket-padded batch; the padded positions are meaningless."""
    with torch.no_grad(), _f32_exact():
        return _predict_log_duration(params, cfg, hidden, noise_scale, length)


# ---------------------------------------------------------------------------
# flow + decoder
# ---------------------------------------------------------------------------


def _wavenet_forward(wn, x, cfg: VitsConfig, mask=None):
    outputs = torch.zeros_like(x)
    half = cfg.dim
    for i in range(cfg.prior_wavenet_layers):
        dilation = cfg.wavenet_dilation ** i
        if mask is not None:  # the residual carries conv bias into the padding
            x = x * mask
        h = conv1d(x, wn["in"][str(i)], dilation=dilation,
                   padding=(cfg.wavenet_kernel * dilation - dilation) // 2)
        acts = torch.tanh(h[:, :half]) * torch.sigmoid(h[:, half:])
        res_skip = conv1d(acts, wn["res_skip"][str(i)])
        if i < cfg.prior_wavenet_layers - 1:
            x = x + res_skip[:, :half]
            outputs = outputs + res_skip[:, half:]
        else:
            outputs = outputs + res_skip
    return outputs


def _flow_inverse(params, cfg: VitsConfig, latents, length=None):
    half = cfg.flow_size // 2
    b, _, t = latents.shape
    mask = None if length is None else _length_mask(b, t, length, latents.dtype, latents.device)
    x = latents
    for i in reversed(range(cfg.prior_num_flows)):
        x = torch.flip(x, dims=(1,))
        flow = params["flow"][str(i)]
        first, second = x[:, :half], x[:, half:]
        h = _wavenet_forward(flow["wavenet"], conv1d(first, flow["conv_pre"]), cfg, mask=mask)
        x = torch.cat([first, second - conv1d(h, flow["conv_post"])], dim=1)
        if mask is not None:
            x = x * mask
    return x


def flow_inverse(params, cfg: VitsConfig, latents, length=None):
    """The residual-coupling stack in reverse: prior latents [B, flow_size,
    T] -> decoder latents; ``length`` masks a frame-bucket padded batch."""
    with torch.no_grad(), _f32_exact():
        return _flow_inverse(params, cfg, latents, length)


def _hifigan(params, cfg: VitsConfig, latents, length=None):
    dec = params["decoder"]
    slope = cfg.leaky_relu_slope
    b, _, t = latents.shape
    cur_len = length
    mask = None if length is None else _length_mask(b, t, cur_len, latents.dtype, latents.device)
    h = conv1d(latents, dec["conv_pre"], padding=3)
    n_kernels = len(cfg.resblock_kernels)
    for i, (rate, kernel) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernels)):
        if mask is not None:
            h = h * mask
        h = conv_transpose1d(F.leaky_relu(h, slope), dec["up"][str(i)], stride=rate,
                             padding=(kernel - rate) // 2)
        if mask is not None:
            cur_len = cur_len * rate
            mask = _length_mask(b, h.shape[-1], cur_len, h.dtype, h.device)
            h = h * mask
        acc = None
        for j in range(n_kernels):
            rb = dec["res"][str(i * n_kernels + j)]
            k = cfg.resblock_kernels[j]
            r = h
            for d_idx, dilation in enumerate(cfg.resblock_dilations[j]):
                s = conv1d(F.leaky_relu(r, slope), rb["convs1"][str(d_idx)], dilation=dilation,
                           padding=(k * dilation - dilation) // 2)
                if mask is not None:
                    s = s * mask
                s = conv1d(F.leaky_relu(s, slope), rb["convs2"][str(d_idx)],
                           padding=(k - 1) // 2)
                if mask is not None:
                    s = s * mask
                r = r + s
            acc = r if acc is None else acc + r
        h = acc / n_kernels
    h = conv1d(F.leaky_relu(h, 0.01), dec["conv_post"], padding=3)  # torch's default slope
    return torch.tanh(h)[:, 0]


def hifigan(params, cfg: VitsConfig, latents, length=None):
    """latents [B, flow_size, T] -> waveform [B, samples]. ``length``
    (frames) masks a frame-bucket padded batch at every stage; the mask
    upsamples with the signal."""
    with torch.no_grad(), _f32_exact():
        return _hifigan(params, cfg, latents, length)


# ---------------------------------------------------------------------------
# synthesis
# ---------------------------------------------------------------------------


def durations(log_dur, speaking_rate: float) -> np.ndarray:
    """ceil(exp(log_dur) / rate) on the host in f32, as the JAX package's
    host path computes them: [B, 1, T] -> [B, T] int64."""
    ld = log_dur[:, 0].detach().to("cpu", torch.float32).numpy()
    return np.ceil(np.exp(ld) / speaking_rate).astype(np.int64)


def synthesize(params, cfg: VitsConfig, input_ids, noise_scale=None, noise_scale_duration=None,
               speaking_rate=None, generator: torch.Generator | None = None):
    """input_ids [B, T] -> waveform [B, samples] f32 on the parameters'
    device, each row zero-padded to the longest. Host-orchestrated: encode
    and durations on the device, the durations fetched and the phoneme ->
    frame repeat built on the host, then flow and HiFiGAN. The prior's noise
    (``noise_scale`` > 0) comes from ``generator``, else from
    ``np.random.default_rng()``; ``noise_scale=0`` is deterministic."""
    if noise_scale is None:
        noise_scale = cfg.noise_scale
    if speaking_rate is None:
        speaking_rate = cfg.speaking_rate
    dev = params["embed"].device
    hidden, means, log_var = encode_text(params, cfg, input_ids)
    repeats = durations(predict_log_duration(params, cfg, hidden,
                                             noise_scale=noise_scale_duration), speaking_rate)
    waves = []
    rng = None
    for b in range(means.shape[0]):
        reps = torch.from_numpy(repeats[b]).to(dev)
        latents = torch.repeat_interleave(means[b], reps, dim=0)
        if noise_scale:
            logv = torch.repeat_interleave(log_var[b], reps, dim=0)
            if generator is None:
                rng = rng or np.random.default_rng()
                noise = torch.from_numpy(rng.standard_normal(tuple(latents.shape)).astype(
                    np.float32)).to(dev)
            else:
                noise = torch.randn(latents.shape, generator=generator, device=dev)
            latents = latents + noise * torch.exp(logv) * noise_scale
        waves.append(hifigan(params, cfg, flow_inverse(params, cfg, latents.T[None]))[0])
    out = torch.zeros((len(waves), max(w.shape[0] for w in waves)), device=dev)
    for b, w in enumerate(waves):
        out[b, : w.shape[0]] = w
    return out


# ---------------------------------------------------------------------------
# bucketed synthesis (the serving path)
# ---------------------------------------------------------------------------

#: Serving buckets: text lengths and frame counts are padded up to the
#: nearest edge (the JAX package's bound on its compiles; here they bound
#: the distinct shapes cuDNN plans for).
TEXT_BUCKETS = (32, 64, 128, 256, 512)
FRAME_BUCKETS = (128, 256, 512, 1024, 2048, 4096)


def _bucket(n: int, buckets) -> int:
    for edge in buckets:
        if n <= edge:
            return edge
    last = buckets[-1]
    return (n + last - 1) // last * last  # oversize: multiples of the top


def upsample_factor(cfg: VitsConfig) -> int:
    return math.prod(cfg.upsample_rates)


def _duration_stage(params, cfg: VitsConfig, padded_ids, length: int, speaking_rate,
                    noise_scale_duration=None):
    """Stage 1, on the device: encode, durations and the token -> frame
    cumulative map. Returns (frames, cum [TB] int32, means [TB, C], log_var
    [TB, C]); nothing is fetched."""
    hidden, means, log_var = _encode_text(params, cfg, padded_ids, length=length)
    log_dur = _predict_log_duration(params, cfg, hidden, noise_scale=noise_scale_duration,
                                    length=length)
    tb = padded_ids.shape[1]
    live = torch.arange(tb, device=hidden.device) < length
    rate = torch.tensor(speaking_rate, dtype=torch.float32, device=hidden.device)
    dur = torch.where(live, torch.ceil(torch.exp(log_dur[0, 0]) / rate), 0.0).to(torch.int32)
    cum = torch.cumsum(dur, dim=0, dtype=torch.int32)
    return cum[-1], cum, means[0], log_var[0]


def _render_stage(params, cfg: VitsConfig, cum, means, log_var, frames, generator,
                  noise_scale, fb: int):
    """Stage 2, on the device: the frame alignment as a gather (frame j
    belongs to the token k with cum[k - 1] <= j < cum[k]), the prior's
    noise, flow inverse and HiFiGAN over ``fb`` frames, ``frames`` real."""
    dev = cum.device
    j = torch.arange(fb, device=dev)
    idx = torch.clamp((cum[None, :] <= j[:, None]).sum(dim=1), 0, cum.shape[0] - 1)
    live = (j < frames)[:, None]
    pm = torch.where(live, means[idx], 0.0)
    noise = torch.randn(pm.shape, generator=generator, device=dev, dtype=pm.dtype)
    latents = torch.where(live, pm + noise * torch.exp(log_var[idx]) * noise_scale, 0.0)
    z = _flow_inverse(params, cfg, latents.T[None], length=frames)
    return _hifigan(params, cfg, z, length=frames)


def synthesize_bucketed(params, cfg: VitsConfig, input_ids, noise_scale=None,
                        noise_scale_duration=None, speaking_rate=None,
                        text_buckets=TEXT_BUCKETS, frame_buckets=FRAME_BUCKETS,
                        generator: torch.Generator | None = None):
    """Bucket-padded :func:`synthesize` for one sentence (B = 1): text
    padded to a text bucket, frames to a frame bucket, the real lengths
    threaded through the masked stages. Two host round trips: the frame
    count, which picks the frame bucket, then the waveform (the caller's
    fetch). The prior's noise comes from ``generator``, else from a seed
    drawn with ``np.random.default_rng()``. Returns the waveform [1,
    samples] on the parameters' device, cut to the real length."""
    if noise_scale is None:
        noise_scale = cfg.noise_scale
    if speaking_rate is None:
        speaking_rate = cfg.speaking_rate
    dev = params["embed"].device
    ids = torch.as_tensor(input_ids)
    if ids.shape[0] != 1:
        raise ValueError(f"bucketed synthesis is batch-1 serving, not {ids.shape[0]}")
    t = ids.shape[1]
    padded = torch.zeros((1, _bucket(t, text_buckets)), dtype=torch.long, device=dev)
    padded[0, :t] = ids[0].to(dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(
            int(np.random.default_rng().integers(2 ** 31)))
    with torch.no_grad(), _f32_exact():
        frames_dev, cum, means0, logv0 = _duration_stage(
            params, cfg, padded, t, speaking_rate, noise_scale_duration=noise_scale_duration)
        frames = int(frames_dev)  # round trip 1: one scalar
        wav = _render_stage(params, cfg, cum, means0, logv0, frames, generator,
                            float(noise_scale), _bucket(frames, frame_buckets))
    return wav[:, : frames * upsample_factor(cfg)]
