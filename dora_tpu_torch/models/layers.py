"""Transformer primitives, on torch tensors.

Counterpart of the matching functions of dora_tpu/models/layers.py:
``compute_dtype`` (bf16 on the card, f32 on the CPU), the f32 rotary
tables (position-indexed, ``apply_rope``, or per token,
``apply_rope_tables``: the M-RoPE and 2-D vision case), RMSNorm and
LayerNorm with f32 statistics, and the unfused pre-norm block
(``block_forward`` = ``attention_sublayer`` + ``mlp_sublayer``, the
RMSNorm + SwiGLU layout of Qwen2) over plain or quantized weights, which
prefill and the unfused decode run; ``resize_image`` is the antialiased
resampling of ``jax.image.resize`` that the HF vision preprocessing uses.
``matmul`` keeps the JAX dispatch rule: a quantized weight goes through a
plain bf16 product of its ``bf16`` sidecar above 32 rows, else an int8
weight through the int8 kernel (ops/int8_matmul.py) and an int4 weight
through the product of its dequantized form (ops/int4.py). Attention is the
reference's einsum with an f32 softmax, rounded where the reference rounds
(no fused SDPA), or, for the no-cache self-attention paths that ask for it
(``flash="full"`` / ``"causal"``), flash attention (ops/flash_attention.py:
the hand-written kernel on the card), which ``use_flash`` turns on by
default on the card (``DORA_FLASH_ATTENTION`` overrides it either way).
The block takes both pre-norm layouts pretrained checkpoints use,
``norm="rms"`` + ``mlp="swiglu"`` (Qwen2) and ``norm="ln"`` + ``mlp="gelu"``
with full biases (ViT, Whisper).

On a mesh (parallel/mesh.py) the unfused float layout trains sharded:
``tp_rules`` are the Megatron rules ``parallel.shard_params`` applies, and
a block whose q/k/v/gate/up weights hold this rank's tp columns (wo and
w_down its rows) runs them column- and row-parallel, through
``parallel/comm.py``'s copy and reduce pair; a leaf that replicated (its
dimension does not divide tp) runs whole. With ``ring_axis`` the attention
runs over a sequence split on that axis, as ring attention
(parallel/ring.py) or, for ``sp_impl="ulysses"``, Ulysses
(parallel/ulysses.py).
"""

from __future__ import annotations

import contextlib
import math
import os

import torch

from dora_tpu_torch._device import compute_dtype, resolve_device

__all__ = [
    "Init", "apply_rope", "apply_rope_tables", "attention", "attention_sublayer",
    "block_forward", "causal_mask", "column", "compute_dtype", "cudnn_exact", "dense",
    "gathered", "layer_norm", "matmul", "mlp_sublayer", "resize_image", "rms_norm",
    "rope_table", "row", "tp_rules", "tp_size", "use_flash",
]

#: quantized products with more rows than this take the bf16 sidecar
MATVEC_MAX_ROWS = 32


class Init:
    """Seeded f32 initializers with the JAX package's shapes and
    distributions (``dense_init``, ``embed_init``, ``init_block`` of
    dora_tpu/models/layers.py): dense weights uniform in +-1/sqrt(d_in),
    embeddings normal x 0.02, norm weights one, drawn in call order from
    one ``torch.Generator`` on ``device`` (default cuda). The numbers are
    not the JAX package's; the models' ``params_from_jax`` carry those."""

    def __init__(self, seed: int, device=None):
        self.device = resolve_device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def uniform(self, shape, scale: float) -> torch.Tensor:
        w = torch.rand(tuple(shape), generator=self.gen, device=self.device)
        return w * (2 * scale) - scale

    def dense(self, d_in: int, d_out: int) -> torch.Tensor:
        return self.uniform((d_in, d_out), 1.0 / math.sqrt(d_in))

    def normal(self, *shape, std: float = 0.02) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device) * std

    def ones(self, n: int) -> torch.Tensor:
        return torch.ones((n,), device=self.device)

    def block(self, dim: int, heads: int, ffn: int, kv_heads: int | None = None) -> dict:
        """The RMSNorm + SwiGLU block's weights (``init_block``)."""
        hd = dim // heads
        kv = kv_heads or heads
        return {"attn_norm": self.ones(dim), "wq": self.dense(dim, heads * hd),
                "wk": self.dense(dim, kv * hd), "wv": self.dense(dim, kv * hd),
                "wo": self.dense(heads * hd, dim), "ffn_norm": self.ones(dim),
                "w_gate": self.dense(dim, ffn), "w_up": self.dense(dim, ffn),
                "w_down": self.dense(ffn, dim)}


@contextlib.contextmanager
def cudnn_exact(tf32: bool | None = None):
    """cuDNN's deterministic algorithms while the block runs (a transposed
    convolution's default one sums with atomics, so two runs on one input
    can part in the last bits), and with ``tf32`` False no TF32 in cuDNN or
    cuBLAS; the process's flags restored after. Only the card reads them."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.deterministic, cudnn.benchmark = True, False
    if tf32 is not None:
        cudnn.allow_tf32 = matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark, cudnn.allow_tf32, matmul.allow_tf32 = saved


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * weight.float()).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis: f32 mean and variance, then
    ``x * weight + bias`` in f32, cast back to x's dtype."""
    dtype = x.dtype
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mean) ** 2, dim=-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    return (xf * weight.float() + bias.float()).to(dtype)


def _norm(x, params, prefix: str, kind: str, eps: float):
    """The block's pre-norm: RMSNorm (weight only) or, for ``kind`` "ln",
    LayerNorm (weight and ``<prefix>_b`` bias)."""
    if kind == "ln":
        return layer_norm(x, params[prefix], params[prefix + "_b"], eps)
    if kind != "rms":
        raise ValueError(f"unknown norm {kind!r} (rms | ln)")
    return rms_norm(x, params[prefix], eps)


def matmul(x, w):
    """``x @ w`` for a float weight or a quantized dict {"int8", "scale"[,
    "bf16"]} or {"int4", "gscale"[, "bf16"]}: larger M than 32 rows with a
    sidecar take the plain product of the bf16 sidecar in x's dtype; else
    int8 takes the int8 kernel (decode, short prompts, the head on one row)
    and int4 the product of its dequantized weight in x's dtype, as the JAX
    package leaves it to XLA (the fused decode tier is int4's kernel path)."""
    if isinstance(w, dict):
        m = math.prod(x.shape[:-1])
        if m > MATVEC_MAX_ROWS and "bf16" in w:
            return x @ w["bf16"].to(x.dtype)
        if "int4" in w:
            from dora_tpu_torch.ops.int4 import dequantize_int4

            return x @ dequantize_int4(w, x.dtype)
        from dora_tpu_torch.ops.int8_matmul import int8_matmul

        return int8_matmul(x, w["int8"], w["scale"])
    return x @ w.to(x.dtype)


def dense(x, params, w: str, b: str):
    """x @ params[w] (+ params[b] when the checkpoint has the bias)."""
    out = matmul(x, params[w])
    bias = params.get(b)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def tp_size(mesh) -> int:
    return 1 if mesh is None else mesh.size("tp")


def column(x, params, w: str, b: str, n_out: int, mesh=None):
    """``dense(x, params, w, b)`` for a projection to ``n_out`` columns whose
    weight may hold only this tp rank's block of them (column-parallel).
    Returns (y, local): with ``local`` y holds this rank's columns."""
    weight = params[w]
    if tp_size(mesh) == 1 or weight.shape[-1] == n_out:
        return dense(x, params, w, b), False
    from dora_tpu_torch.parallel import comm

    y = matmul(comm.copy_to(x, mesh, "tp"), weight)
    bias = params.get(b)
    if bias is not None:  # replicated: this rank's columns of it
        y = y + comm.split(bias.to(x.dtype), mesh, "tp")
    return y, True


def row(x, local: bool, params, w: str, b: str, n_in: int, mesh=None):
    """``dense`` back to the model width for an input of ``n_in`` columns, of
    which x holds this tp rank's block when ``local``; the weight may hold
    only this rank's block of rows (row-parallel, its partial products
    summed over tp)."""
    weight = params[w]
    if tp_size(mesh) == 1 or weight.shape[0] == n_in:
        return dense(gathered(x, local, mesh), params, w, b)
    from dora_tpu_torch.parallel import comm

    if not local:
        x = comm.split(x, mesh, "tp")
    out = comm.reduce_from(matmul(x, weight), mesh, "tp")
    bias = params.get(b)
    return out if bias is None else out + bias.to(x.dtype)


def gathered(y, local: bool, mesh=None):
    """A :func:`column` output as the full columns on every rank."""
    if not local:
        return y
    from dora_tpu_torch.parallel import comm

    return comm.gather(y, mesh, "tp")


def rope_table(max_len: int, head_dim: int, base: float = 10000.0,
               device: str | torch.device | None = None):
    """(cos, sin) tables [max_len, head_dim/2] in float32."""
    device = resolve_device(device)
    inv_freq = 1.0 / base ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    )
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x, cos, sin, positions):
    """NeoX rotary. x [B, H, T, D]; positions [B, T] absolute positions into
    the (cos, sin) tables; computed in f32, returned in x's dtype."""
    idx = positions.long()
    return apply_rope_tables(x, cos[idx], sin[idx])


def apply_rope_tables(x, cos, sin):
    """NeoX rotary with per-token half-dim tables, [T, D/2] (shared by the
    batch) or [B, T, D/2]. x [B, H, T, D]; computed in f32, returned in x's
    dtype."""
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    c = cos[:, None].float()  # [B, 1, T, D/2]
    s = sin[:, None].float()
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def attention(q, k, v, mask=None):
    """Dense attention, [B, H, T, D]: scores in q's dtype, then an f32
    softmax (masked entries at f32's lowest value) cast back to q's dtype
    before the product with v, as the reference rounds."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() / math.sqrt(q.shape[-1])
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def resize_image(x: torch.Tensor, height: int, width: int, method: str) -> torch.Tensor:
    """An [H, W, C] float image resized to [height, width, C] with
    ``method`` "bilinear" or "bicubic", antialiased when it shrinks and with
    half-pixel centres: the resampling of ``jax.image.resize`` (a cubic
    kernel of a = -0.5, weights renormalized at the edges)."""
    out = torch.nn.functional.interpolate(
        x.permute(2, 0, 1)[None], size=(height, width), mode=method,
        align_corners=False, antialias=True)
    return out[0].permute(1, 2, 0)


def use_flash(device) -> bool:
    """Flash attention for the no-cache self-attention paths: on by default
    on the card (the port's counterpart of the JAX package's "on for TPU"),
    off on the CPU, where the plain twin would only repeat the dense
    einsum's work. ``DORA_FLASH_ATTENTION=1``/``0`` overrides it either way
    (an empty value is off), as in dora_tpu/models/layers.py."""
    v = os.environ.get("DORA_FLASH_ATTENTION")
    if v is not None:
        return v not in ("", "0")
    return torch.device(device).type == "cuda"


def causal_mask(tq: int, tk: int, offset: int = 0, device=None):
    """[1, 1, tq, tk] bool mask; ``offset`` cached tokens come before q."""
    device = resolve_device(device)
    qi = torch.arange(tq, device=device)[:, None] + offset
    ki = torch.arange(tk, device=device)[None, :]
    return (qi >= ki)[None, None]


def block_forward(params: dict, x, n_heads: int, *, n_kv_heads: int | None = None,
                  rope: tuple | None = None, positions=None,
                  rope_tables: tuple | None = None, mask=None,
                  cache: dict | None = None, cache_index: int | None = None,
                  norm: str = "rms", mlp: str = "swiglu", norm_eps: float = 1e-6,
                  head_dim: int | None = None, mesh=None, ring_axis=None, flash=None,
                  sp_impl=None, ffn: int | None = None):
    """One pre-norm block. Returns (y, new_cache). With ``cache`` k/v are
    written at ``cache_index`` (in place) and attention runs against the
    whole cache under ``mask``. ``ffn``, the MLP's global hidden width, is
    needed on a tp mesh only (``mlp_sublayer``)."""
    x, new_cache = attention_sublayer(
        params, x, n_heads, n_kv_heads=n_kv_heads, rope=rope, positions=positions,
        rope_tables=rope_tables, mask=mask, cache=cache, cache_index=cache_index, norm=norm,
        norm_eps=norm_eps, head_dim=head_dim, mesh=mesh, ring_axis=ring_axis, flash=flash,
        sp_impl=sp_impl,
    )
    x = mlp_sublayer(params, x, norm=norm, mlp=mlp, norm_eps=norm_eps, mesh=mesh, ffn=ffn)
    return x, new_cache


def attention_sublayer(params, x, n_heads, *, n_kv_heads=None, rope=None,
                       positions=None, rope_tables=None, mask=None, cache=None,
                       cache_index=None, norm="rms", norm_eps=1e-6, head_dim=None, mesh=None,
                       ring_axis=None, flash=None, sp_impl=None):
    """Pre-norm self-attention with residual. Returns (y, new_cache).

    ``rope=(cos, sin)`` position-indexed tables with ``positions`` [B, T]
    (default 0..T-1), or ``rope_tables=(cos, sin)`` per-token tables ([T,
    D/2] or [B, T, D/2]: M-RoPE, the 2-D vision rotary). With ``cache``
    ({"k", "v"} [B, KV, S, hd]) the rows' K/V are written at ``cache_index``
    in place (the start clamped so they fit, as ``dynamic_update_slice``
    clamps) and attention runs over the whole cache; the cache is returned
    as new_cache. ``flash`` ("full" or "causal") runs the no-cache path
    through ops/flash_attention.py instead of the einsum under ``mask``:
    only valid where the mask the caller would pass is exactly that pattern
    (with a cache it is ignored, as in the reference).

    With a ``mesh`` whose tp axis holds column shards of wq / wk / wv (rows
    of wo), each rank attends over its own heads when both head counts
    divide tp, else over all of them; with ``ring_axis`` x holds this rank's
    block of a sequence split on that axis (``positions`` its global
    positions) and attention runs as ring attention, or Ulysses for
    ``sp_impl`` "ulysses", causal when a ``mask`` is given."""
    b, t, dim = x.shape
    n_kv = n_kv_heads or n_heads
    head_dim = head_dim or dim // n_heads
    dtype = x.dtype

    h = _norm(x, params, "attn_norm", norm, norm_eps)
    local = False
    if "wqkv" in params:
        qkv = dense(h, params, "wqkv", "bqkv")
        q, k, v = qkv.split([n_heads * head_dim, n_kv * head_dim, n_kv * head_dim], dim=-1)
    else:
        (q, lq), (k, lk), (v, lv) = (
            column(h, params, w, bias, n * head_dim, mesh)
            for w, bias, n in (("wq", "bq", n_heads), ("wk", "bk", n_kv), ("wv", "bv", n_kv)))
        tp = tp_size(mesh)
        local = lq and lk and lv and n_heads % tp == 0 and n_kv % tp == 0
        if local:  # this rank's heads
            n_heads, n_kv = n_heads // tp, n_kv // tp
        else:
            q, k, v = gathered(q, lq, mesh), gathered(k, lk, mesh), gathered(v, lv, mesh)
    q = q.reshape(b, t, n_heads, head_dim).transpose(1, 2)  # [B, H, T, D]
    k = k.reshape(b, t, n_kv, head_dim).transpose(1, 2)
    v = v.reshape(b, t, n_kv, head_dim).transpose(1, 2)

    if rope is not None:
        cos, sin = rope
        if positions is None:
            positions = torch.arange(t, device=x.device).expand(b, t)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
    elif rope_tables is not None:
        cos, sin = rope_tables
        q = apply_rope_tables(q, cos, sin)
        k = apply_rope_tables(k, cos, sin)

    new_cache = None
    if cache is not None:
        kc, vc = cache["k"], cache["v"]
        start = max(0, min(int(cache_index), kc.shape[2] - t))
        kc[:, :, start : start + t] = k.to(kc.dtype)
        vc[:, :, start : start + t] = v.to(vc.dtype)
        k, v = kc, vc
        new_cache = {"k": kc, "v": vc}

    if n_kv != n_heads:  # grouped-query: repeat kv heads
        rep = n_heads // n_kv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)

    if ring_axis is not None and mesh is not None:
        causal = mask is not None
        if sp_impl == "ulysses":
            from dora_tpu_torch.parallel.ulysses import ulysses_attention

            out = ulysses_attention(q, k, v, mesh, causal=causal, axis=ring_axis)
        elif sp_impl in (None, "ring"):
            from dora_tpu_torch.parallel.ring import ring_attention

            out = ring_attention(q, k, v, mesh, causal=causal, axis=ring_axis)
        else:
            raise ValueError(f"unknown sp_impl {sp_impl!r} (ring | ulysses)")
    elif flash is not None and cache is None:
        from dora_tpu_torch.ops.flash_attention import flash_attention

        out = flash_attention(q, k.to(dtype), v.to(dtype), causal=flash == "causal")
    else:
        out = attention(q, k.to(dtype), v.to(dtype), mask)
    out = out.transpose(1, 2).reshape(b, t, n_heads * head_dim)
    n_in = n_heads * head_dim * (tp_size(mesh) if local else 1)
    return x + row(out, local, params, "wo", "bo", n_in, mesh), new_cache


def mlp_sublayer(params, x, *, norm="rms", mlp="swiglu", norm_eps=1e-6, mesh=None,
                 ffn: int | None = None):
    """Pre-norm feed-forward with residual: SwiGLU, or for ``mlp`` "gelu"
    the exact (erf) GELU between biased up and down projections. On a tp
    ``mesh`` the up / gate weights may hold this rank's columns of the
    ``ffn`` hidden units (the global width, which the shapes alone do not
    tell) and w_down its rows (column- and row-parallel)."""
    h = _norm(x, params, "ffn_norm", norm, norm_eps)
    if tp_size(mesh) > 1 and ffn is None:
        raise ValueError("mlp_sublayer on a tp mesh needs the global hidden width ffn")
    if mlp == "gelu":
        up, local = column(h, params, "w_up", "b_up", ffn, mesh)
        up = torch.nn.functional.gelu(up)
        return x + row(up, local, params, "w_down", "b_down", ffn, mesh)
    if mlp != "swiglu":
        raise ValueError(f"unknown mlp {mlp!r} (swiglu | gelu)")
    if "w_gateup" in params:  # decode-fused (see quantize_tree)
        gate, up = dense(h, params, "w_gateup", "b_gateup").chunk(2, dim=-1)
        gate = torch.nn.functional.silu(gate)
        local = False
    else:
        (gate, lg), (up, lu) = (column(h, params, w, bias, ffn, mesh)
                                for w, bias in (("w_gate", "b_gate"), ("w_up", "b_up")))
        local = lg and lu
        if not local:
            gate, up = gathered(gate, lg, mesh), gathered(up, lu, mesh)
        gate = torch.nn.functional.silu(gate)
    return x + row(gate * up, local, params, "w_down", "b_down", ffn, mesh)


def tp_rules():
    """Tensor-parallel rules for ``parallel.shard_params`` (Megatron
    layout): column-parallel q/k/v/gate/up, row-parallel o/down, the
    embedding by vocab rows, the head by vocab columns, the vision patch
    projection by columns. Names are exact leaf names; position tables and
    norms replicate by default. A spec is a tuple, one entry a dimension."""
    return [
        ("wq", (None, "tp")),
        ("wk", (None, "tp")),
        ("wv", (None, "tp")),
        ("wo", ("tp", None)),
        ("x_wq", (None, "tp")),
        ("x_wk", (None, "tp")),
        ("x_wv", (None, "tp")),
        ("x_wo", ("tp", None)),
        ("w_gate", (None, "tp")),
        ("w_up", (None, "tp")),
        ("w_down", ("tp", None)),
        ("embed", ("tp", None)),
        ("lm_head", (None, "tp")),
        ("patch_proj", (None, "tp")),
    ]
