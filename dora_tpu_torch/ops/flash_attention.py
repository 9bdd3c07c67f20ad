"""Flash attention (online softmax), on torch tensors.

Counterpart of dora_tpu/ops/flash_attention.py: self-attention over q, k, v
[B, H, T, D] of one length T, scaled by 1/sqrt(D), with the softmax in f32,
``causal`` on request, returned in q's dtype. Callers are the no-cache
self-attention paths (the VLM's vision tower, full; training, causal)
through ``models/layers.attention_sublayer``'s ``flash=``.

Two versions, as in ops/decode_block.py:

* :func:`flash_attention_plain`, plain PyTorch: the f32 softmax over
  ``q.kT / sqrt(D)`` with masked keys at f32's lowest value and their
  weights zero, so a row whose every key is masked emits 0 as the
  kernel's finalize does. The CPU path runs it, and the card holds its
  kernel against it;
* the hand-written CUDA kernel of ``csrc/flash_attention.cu`` (bf16 q, k,
  v, any T, D a multiple of 8 up to 128), which :func:`flash_attention`
  launches for CUDA tensors, counted in its ``launches``. It reads the
  tensors through their strides (D contiguous), so the transposed
  projections of ``attention_sublayer`` are not copied, and nothing is
  padded in memory. Nothing falls back: a CUDA tensor the kernel does not
  take raises.

Training differentiates it (the JAX package's kernel has no backward, so
its gradients are those of the dense path): whenever grad mode is on and an
input requires grad, :func:`flash_attention` goes through
:class:`FlashAttention`, a ``torch.autograd.Function`` whose forward is the
same kernel on the card (the plain version on the CPU) and whose backward,
:func:`flash_attention_backward_plain`, is the exact softmax-attention
gradient in plain PyTorch, recomputed from the saved q, k and v with f32
scores. GQA callers pass k and v already repeated to q's heads (as
``models/layers`` does), so autograd sums their gradients back per kv head.
"""

from __future__ import annotations

import math

import torch

from dora_tpu_torch.ops import _build

_SIGNATURES = {
    "flash_attention": {
        "dora_flash_attention": [_build.P] * 4 + [_build.I] * 4 + [_build.L] * 12
        + [_build.I, _build.F, _build.P],
    },
}

#: the head_dims the kernel takes: multiples of this up to KERNEL_MAX_HEAD_DIM
KERNEL_HEAD_DIM_MULTIPLE = 8
KERNEL_MAX_HEAD_DIM = 128

_LOWEST = torch.finfo(torch.float32).min


def kernel_shape_limits(head_dim: int) -> list[str]:
    """The kernel's limits that a head_dim runs into, each named; empty when
    the kernel takes it."""
    if head_dim % KERNEL_HEAD_DIM_MULTIPLE or not 0 < head_dim <= KERNEL_MAX_HEAD_DIM:
        return [f"head_dim {head_dim}: the flash_attention kernel takes multiples of "
                f"{KERNEL_HEAD_DIM_MULTIPLE} up to {KERNEL_MAX_HEAD_DIM}"]
    return []


def flash_attention_plain(q, k, v, causal: bool = False):
    """Self-attention over [B, H, T, D] with an f32 softmax; q's dtype out."""
    p, l = _weights(q, k, causal)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()) / torch.where(l == 0, 1.0, l)
    return out.to(q.dtype)


def _weights(q, k, causal: bool):
    """The unnormalized f32 softmax weights of ``q.kT / sqrt(D)`` (masked
    weights zero) and their row sums."""
    t, d = q.shape[-2], q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        valid = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = torch.where(valid, s, _LOWEST)
        p = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    else:
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return p, p.sum(dim=-1, keepdim=True)


def flash_attention_backward_plain(q, k, v, grad_out, causal: bool = False):
    """The gradients (dq, dk, dv) of :func:`flash_attention` at q, k, v for
    the output's gradient ``grad_out``, in f32 and returned in the inputs'
    dtypes: with P the softmax, dV = PT.dO, dS = P * (dO.VT - rowsum(P *
    dO.VT)), dQ = dS.K / sqrt(D), dK = dST.Q / sqrt(D)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p, l = _weights(q, k, causal)
    p = p / torch.where(l == 0, 1.0, l)  # a row whose every key is masked stays zero
    g = grad_out.float()
    dv = torch.einsum("bhqk,bhqd->bhkd", p, g)
    dp = torch.einsum("bhqd,bhkd->bhqk", g, v.float())
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _strides(t: torch.Tensor, name: str) -> tuple[int, int, int]:
    if t.stride(3) != 1:
        raise ValueError(f"{name}: the kernel reads rows of D contiguous values")
    return t.stride(0), t.stride(1), t.stride(2)


def _flash_attention_kernel(q, k, v, causal: bool = False, lib=None):
    dev = q.device
    if q.dim() != 4:
        raise ValueError(f"q must be [B, H, T, D], got {tuple(q.shape)}")
    b, h, t, d = q.shape
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, expected {dev}")
        if x.dtype != torch.bfloat16:
            raise ValueError(f"{name} has dtype {x.dtype}, the kernel takes torch.bfloat16")
        if tuple(x.shape) != (b, h, t, d):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {(b, h, t, d)}")
    limits = kernel_shape_limits(d)
    if limits:
        raise ValueError("flash_attention kernel: " + "; ".join(limits))
    strides = (*_strides(q, "q"), *_strides(k, "k"), *_strides(v, "v"))
    out = torch.empty_like(q)  # q's layout: a transposed view stays one
    if out.numel() == 0:
        return out
    lib = lib if lib is not None else _build.library(
        "flash_attention", _SIGNATURES["flash_attention"])
    rc = lib.dora_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, t, d,
        *strides, *_strides(out, "out"), int(bool(causal)), 1.0 / math.sqrt(d),
        _build.stream_of(q),
    )
    flash_attention.launches += 1
    _build.check(rc, "flash_attention")
    return out


class FlashAttention(torch.autograd.Function):
    """Kernel 11 with a gradient: the forward is the kernel on the card (the
    plain version on the CPU), the backward
    :func:`flash_attention_backward_plain` from the saved q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        if not q.is_cuda:
            return flash_attention_plain(q, k, v, causal)
        return _flash_attention_kernel(q, k, v, causal)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_backward_plain(q, k, v, grad_out, ctx.causal), None)


def flash_attention(q, k, v, causal: bool = False):
    """Attention over [B, H, T, D] (self-attention, one length T): the
    softmax in f32, keys j <= i only with ``causal``; returns q's dtype
    (and, on the card, q's layout). Differentiable through
    :class:`FlashAttention` when grad mode is on and an input requires
    grad; its forward is the same kernel."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, bool(causal))
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal)
    return _flash_attention_kernel(q, k, v, causal)


flash_attention.launches = 0


def reset_launches() -> None:
    flash_attention.launches = 0
