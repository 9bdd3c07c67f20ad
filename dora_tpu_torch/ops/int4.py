"""Int4 weight quantization for the fused decode tier, on torch tensors.

Counterpart of dora_tpu/ops/int4.py: two 4-bit values a byte with one f32
scale per GROUP input rows per output column. Nibbles pair WITHIN each scale
group: for group g of G rows, packed byte ``[g*G/2 + j, n]`` holds
``q[g*G + j, n]`` (low nibble) and ``q[g*G + G/2 + j, n]`` (high nibble), so
any K range that is a whole number of groups is a contiguous run of packed
rows, and a group's packed block unpacks into its two contiguous halves.
Values are stored biased (q + 8 in [0, 15]); the group scales apply to the
f32 sums of each group.

``torch.round`` and ``jnp.round`` both round half to even and the division is
the same f32 operation, so the packed bytes, the group scales and the
``bf16`` sidecars are byte-identical to the JAX package's. The kernels of
ops/decode_block.py take these weights (their int4 branch); the unfused
products of models/layers.matmul dequantize them (:func:`dequantize_int4`),
as the JAX package does in XLA.
"""

from __future__ import annotations

import math

import torch

#: Preferred input rows per scale group; shapes not divisible by it fall back
#: to gcd(K, GROUP). The kernels read the group size off the scales:
#: K // gscale.shape[0].
GROUP = 128


def group_for(k: int) -> int:
    return math.gcd(k, GROUP)


def quantize_int4(w: torch.Tensor, keep_bf16: bool = False) -> dict:
    """[K, N] float -> {"int4": [K/2, N] uint8, "gscale": [K/G, N] f32}.

    Symmetric per (group, column): s = max|w_group| / 7, q = round(w / s)
    clipped to [-8, 7]. ``keep_bf16`` also keeps {"bf16": w in bf16} for the
    large-M products, like the int8 sidecar."""
    k, n = w.shape
    g = group_for(k)
    assert g % 2 == 0 and k % g == 0, (k, g)
    groups = w.float().reshape(k // g, g, n)
    scale = torch.clamp_min(groups.abs().amax(dim=1) / 7.0, 1e-12)  # [K/G, N]
    q = torch.clamp(torch.round(groups / scale[:, None, :]), -8, 7)
    biased = (q + 8).to(torch.uint8)  # [K/G, G, N]
    lo, hi = biased[:, : g // 2], biased[:, g // 2 :]
    out = {"int4": (lo | (hi << 4)).reshape(k // 2, n).contiguous(), "gscale": scale}
    if keep_bf16:
        out["bf16"] = w.to(torch.bfloat16).contiguous()
    return out


def unpack_grouped(packed: torch.Tensor, n_groups: int, dtype, biased: bool = False):
    """Packed [K/2, N] uint8 -> q [n_groups, G, N] in ``dtype``. With
    ``biased`` the stored q + 8 (0..15) come back as they are, for a caller
    that folds the bias out of its sums; otherwise q itself."""
    k2, n = packed.shape
    blocks = packed.reshape(n_groups, k2 // n_groups, n).to(torch.int32)
    lo, hi = blocks & 0xF, blocks >> 4
    if not biased:
        lo, hi = lo - 8, hi - 8
    return torch.cat([lo, hi], dim=1).to(dtype)  # [ng, G, N]


def dequantize_int4(wq: dict, dtype=torch.float32) -> torch.Tensor:
    """q * scale per group as [K, N] in ``dtype`` (the unfused products and
    the tests)."""
    packed, scale = wq["int4"], wq["gscale"]
    k2, n = packed.shape
    q = unpack_grouped(packed, scale.shape[0], torch.float32)
    return (q * scale.float()[:, None, :]).reshape(2 * k2, n).to(dtype)


def quantize_tree_int4(params, names=None, fuse: bool = True, keep_bf16: bool = True):
    """ops/int8_matmul.quantize_tree with the int4 quantizer (the fusion and
    the walk are shared)."""
    from dora_tpu_torch.ops.int8_matmul import DECODE_WEIGHTS, quantize_tree

    return quantize_tree(params, names if names is not None else DECODE_WEIGHTS,
                         keep_bf16, fuse, quantizer=quantize_int4)
