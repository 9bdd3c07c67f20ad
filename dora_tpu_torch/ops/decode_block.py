"""The fused decode sublayers, on torch tensors.

Counterpart of dora_tpu/ops/decode_block.py (int8 weights with per-column
scales, or int4 weights with group scales, ops/int4.py, chosen by the weight's
dtype as there: uint8 is int4): the sublayers of
the paged serving path (fp or int8 KV pages, with the KV number format
``kv_quant_rows`` / ``kv_dequant``) and of the dense caches (the dense
batch engine's ``attention_batch_step``, batch-1 decode's
``attention_step`` and its speculative verify's ``attention_chunk_step``,
bf16 [B, KV, S, hd] planes). Each of the eight functions takes the
arguments and returns the tuple of its Pallas counterpart, and comes in two
versions in this module:

* a plain PyTorch version (``*_plain``) that repeats the reference math in
  the tensors' dtype, with f32 accumulators. The CPU path runs it, and the
  card checks its kernel against it;
* a hand-written CUDA kernel for sm_90a (``csrc/``), launched through ctypes
  (``ops/_build.py``) for CUDA tensors. Nothing falls back: a CUDA tensor the
  kernel does not take raises.

Each public wrapper counts its kernel launches in a plain ``launches``
attribute (the attention wrappers their int8-KV form apart, in
``launches_int8kv``), so a run can show that the main path went through the
kernel. On host tensors (the emulated build) the kernel wrappers check every
index operand before launching.

Pools and caches are updated IN PLACE on both paths (the JAX package
donates them, or aliases them to its outputs, to the same effect) and
returned, so callers keep the reference's ``(x_out, k_pool, v_pool)``
contract.
"""

from __future__ import annotations

import torch

from dora_tpu_torch.ops import _build
from dora_tpu_torch.ops.int4 import unpack_grouped

_P, _I, _F = _build.P, _build.I, _build.F

_SIGNATURES = {
    "mlp": {
        "dora_mlp_splits": [_I] * 5,
        "dora_mlp_scratch": [_I] * 5,
        "dora_tc_tile": [_P] * 4,
        "dora_tc_tile4": [_P] * 4,
        "dora_mlp_step": [_P] * 8 + [_I] * 6 + [_F] + [_P] * 4,
    },
    "lm_head": {
        "dora_head_tiles": [_I],
        "dora_lm_head_argmax": [_P] * 6 + [_I] * 4 + [_F] + [_P] * 4,
    },
    "paged_attention": {
        "dora_gemm_splits": [_I] * 4,
        "dora_attention_paged_batch_step":
            [_P] * 16 + [_I] * 10 + [_F] * 2 + [_P] * 8,
        "dora_attention_paged_chunk_step":
            [_P] * 13 + [_I] + [_P] * 2 + [_I] * 9 + [_F] * 2 + [_P] * 8,
        "dora_attention_paged_spec_step":
            [_P] * 16 + [_I] * 11 + [_F] * 2 + [_P] * 8,
        "dora_attention_dense_step":
            [_P] * 12 + [_I] + [_P] + [_I] * 9 + [_F] * 2 + [_P] * 8,
        "dora_attention_dense_chunk_step":
            [_P] * 11 + [_I] + [_P] + [_I] * 9 + [_F] * 2 + [_P] * 8,
        "dora_sweep_splits": [_I] * 5,
        "dora_batch_sweep_splits": [_I] * 5,
        "dora_mma_tile": [_P] * 4,
    },
}

#: head_dims the attention kernels are built for (csrc/paged_attention.cu
#: instantiates each); any other is refused
KERNEL_HEAD_DIMS = (64, 128)
#: the sweeps step 16 rows at a time inside one page, so pool pages are
#: multiples of this
KERNEL_PAGE_MULTIPLE = 16
#: an int4 weight's group (K / gscale rows) is a whole number of the
#: tensor-core product's deepest stage (csrc/common.cuh TC_MAX_BK: the int4
#: decode bands' 128), so that no stage straddles two groups; every Qwen2
#: width is a multiple of 128, whose group is 128
KERNEL_INT4_GROUP_MULTIPLE = 128


def _lib(name: str, lib=None):
    return lib if lib is not None else _build.library(name, _SIGNATURES[name])


# ---------------------------------------------------------------------------
# shared plain math
# ---------------------------------------------------------------------------


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 RMSNorm of [M, D] rows against weight [D] (decode_block._rms)."""
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return xf * w.float().reshape(-1)


def _wdot(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``x @ W`` in f32 for x [M, K]: int8 q [K, N] with the per-column scale
    s [1, N] on the accumulator; or int4 (q uint8 [K/2, N], ops/int4.py's
    packing) with group scales s [K/G, N], the reference's int4 arithmetic:
    the biased nibbles (q + 8) of each group against x's columns of that
    group, minus 8 * sum(x) per group, times the group's scales, summed over
    the groups. x holds compute-dtype values, exact in f32, so these are the
    reference's preferred_element_type=f32 dots."""
    if q.dtype != torch.uint8:
        return (x.float() @ q.float()) * s.float().reshape(1, -1)
    m, k = x.shape
    ng = s.shape[0]
    q3 = unpack_grouped(q, ng, torch.float32, biased=True)  # [ng, G, N]
    x3 = x.float().reshape(m, ng, k // ng).transpose(0, 1)  # [ng, M, G]
    parts = torch.bmm(x3, q3)  # [ng, M, N]
    xsum = x3.sum(dim=2)  # [ng, M]
    return ((parts - 8.0 * xsum[:, :, None]) * s.float()[:, None, :]).sum(dim=0)


def _k_of(w: torch.Tensor) -> int:
    """The K of a weight: its rows, twice them for int4."""
    return w.shape[0] * 2 if w.dtype == torch.uint8 else w.shape[0]


def _rotate(x: torch.Tensor, cos_full: torch.Tensor, sin_signed: torch.Tensor,
            half: int) -> torch.Tensor:
    """NeoX rotary with full-width tables (cos_full = [cos, cos],
    sin_signed = [-sin, sin]): x*cos_full + swap_halves(x)*sin_signed."""
    swapped = torch.cat([x[..., half:], x[..., :half]], dim=-1)
    return x * cos_full + swapped * sin_signed


def _split_qkv(qkv, rows: int, heads: int, kv_heads: int, head_dim: int):
    q = qkv[:, : heads * head_dim].reshape(rows, heads, head_dim)
    k = qkv[:, heads * head_dim : (heads + kv_heads) * head_dim].reshape(
        rows, kv_heads, head_dim
    )
    v = qkv[:, (heads + kv_heads) * head_dim :].reshape(rows, kv_heads, head_dim)
    return q, k, v


def _finish(x, o, residual: bool):
    if residual:
        return (x.float() + o).to(x.dtype)
    return o


def _project(x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, heads: int,
             kv_heads: int, head_dim: int, eps: float):
    """RMSNorm -> quantized qkv (+ bias) -> rope of x's rows: q [rows, H, hd] and
    k, v [rows, KV, hd] in f32."""
    h = _rms(x, norm_w, eps).to(x.dtype)
    qkv = _wdot(h, wqkv, sqkv)
    if bqkv is not None:
        qkv = qkv + bqkv.float().reshape(1, -1)
    q, k, v = _split_qkv(qkv, x.shape[0], heads, kv_heads, head_dim)
    cos = cos_rows.float()[:, None, :]
    sin = sin_rows.float()[:, None, :]
    half = head_dim // 2
    return _rotate(q, cos, sin, half), _rotate(k, cos, sin, half), v


def _live_context(ctx, live):
    """The context [B, KV, n, hd] in f32 with every row that is not ``live``
    [B, n] zeroed: those rows are never read (past a stream's position a
    dense cache may hold anything, NaN included)."""
    return ctx.float().masked_fill(~live[:, None, :, None], 0.0)


def _decode_attend(q, k, v, ctx_k, ctx_v, live, dtype):
    """Decode attention of B rows: q [B, H, hd] and the current row's k, v
    [B, KV, hd] in f32; ctx_k, ctx_v [B, KV, n, hd] the prior context in the
    compute dtype, of which the keys ``live`` [B, n] (idx < pos) count. The
    context is swept in the compute dtype, then the current row is folded in
    from f32 (the reference's exact merge), never from the cache row just
    written. Returns [B, H*hd] f32."""
    b, kv_heads, head_dim = k.shape
    scale = 1.0 / (head_dim ** 0.5)
    qg = q.reshape(b, kv_heads, -1, head_dim)
    s = torch.einsum("bkgd,bksd->bkgs", qg.to(dtype).float(),
                     _live_context(ctx_k, live)) * scale
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)  # -inf for a row with no prior context
    p = torch.exp(s - torch.where(torch.isinf(m), torch.zeros_like(m), m))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgs,bksd->bkgd", p.to(dtype).float(), _live_context(ctx_v, live))
    s_new = (qg * k[:, :, None, :]).sum(dim=-1, keepdim=True) * scale
    m2 = torch.maximum(m, s_new)
    alpha = torch.exp(m - m2)
    w_new = torch.exp(s_new - m2)
    attn = (acc * alpha + w_new * v[:, :, None, :]) / (l * alpha + w_new)
    return attn.reshape(b, -1)


def _verify_attend(q, k, v, ctx_k, ctx_v, live, dtype):
    """Attention of B streams' m rows each (a speculative verify, or a
    prefill chunk with B = 1): q [B, m, H, hd] and the rows' own k, v
    [B, m, KV, hd] in f32; ctx_k, ctx_v [B, KV, n, hd] the prior context in
    the compute dtype, of which the keys ``live`` [B, n] count. Row i sees
    the live context and, causally, own rows j <= i, folded from f32 cast to
    the compute dtype (never their cache rows); each row's maximum is
    clamped at -1e30, where the tensor-core sweep's starts. Returns
    [B*m, H*hd] f32."""
    b, m, kv_heads, head_dim = k.shape
    heads = q.shape[2]
    group = heads // kv_heads
    rows = m * group  # query rows per (stream, kv head), ordered (i, head)
    scale = 1.0 / (head_dim ** 0.5)
    dev = q.device
    keys = torch.cat([_live_context(ctx_k, live), k.transpose(1, 2).to(dtype).float()], dim=2)
    vals = torch.cat([_live_context(ctx_v, live), v.transpose(1, 2).to(dtype).float()], dim=2)
    qg = q.to(dtype).float().reshape(b, m, kv_heads, group, head_dim)
    qg = qg.permute(0, 2, 1, 3, 4).reshape(b, kv_heads, rows, head_dim)
    s = torch.einsum("bkrd,bksd->bkrs", qg, keys) * scale
    cand = torch.arange(rows, device=dev) // group
    causal = torch.arange(m, device=dev)[None, :] <= cand[:, None]  # [rows, m]
    n_ctx = ctx_k.shape[2]
    live_all = torch.cat([live[:, None, :].expand(b, rows, n_ctx),
                          causal[None].expand(b, rows, m)], dim=2)
    s = s.masked_fill(~live_all[:, None], float("-inf"))
    mx = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)  # the sweep starts at -1e30
    p = torch.exp(s - mx)
    attn = torch.einsum("bkrs,bksd->bkrd", p.to(dtype).float(), vals) / p.sum(dim=-1, keepdim=True)
    attn = attn.reshape(b, kv_heads, m, group, head_dim).permute(0, 2, 1, 3, 4)
    return attn.reshape(b * m, heads * head_dim)


# ---------------------------------------------------------------------------
# argument checks for the kernels
# ---------------------------------------------------------------------------


def _need(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _f32(t: torch.Tensor | None, name: str, n: int, device):
    """A per-column f32 vector (scale [1, N] or bias [N]) as contiguous f32."""
    if t is None:
        return None
    t = t.reshape(-1).float().contiguous()
    _need(t, name, torch.float32, (n,), device)
    return t


def _qweight(w: torch.Tensor, s: torch.Tensor, name: str, k: int, n: int, device):
    """A weight operand as the kernels take it: int8 [K, N] with a per-column
    scale [1, N] (or [N]), or int4 uint8 [K/2, N] with f32 group scales
    [K/G, N], G a multiple of KERNEL_INT4_GROUP_MULTIPLE. Returns (the scale
    as the kernel reads it, G; 0 for int8)."""
    if w.dtype != torch.uint8:
        _need(w, name, torch.int8, (k, n), device)
        _aligned16(w, name)
        if s.shape[-1] != n or s.numel() != n:
            raise ValueError(f"{name}: int8 weights take one scale a column, [1, {n}]; got "
                             f"{tuple(s.shape)}")
        return _f32(s, f"{name} scale", n, device), 0
    _need(w, name, torch.uint8, (k // 2, n), device)
    _aligned16(w, name)
    ng = s.shape[0] if s.dim() == 2 else 0
    if not ng or k % ng:
        raise ValueError(f"{name}: int4 weights take group scales [K/G, {n}] with K = {k}; got "
                         f"{tuple(s.shape)}")
    _need(s, f"{name} gscale", torch.float32, (ng, n), device)
    limits = int4_group_limits({name: k // ng})
    if limits:
        raise ValueError("; ".join(limits))
    return s, k // ng


def _aligned16(t: torch.Tensor, name: str) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads 16-byte rows; it must be 16-byte aligned")


def kernel_shape_limits(heads: int, kv_heads: int, head_dim: int,
                        page: int | None = None) -> list[str]:
    """The limits of the attention kernels that a model of these shapes (and
    a paged pool of ``page`` rows) runs into, each named; empty when the
    kernels take it. The engine factories refuse a model with any of them on
    the card before serving, and every kernel wrapper raises on them."""
    out = []
    if head_dim not in KERNEL_HEAD_DIMS:
        out.append(f"head_dim {head_dim}: the attention kernels take head_dim "
                   f"{' or '.join(map(str, KERNEL_HEAD_DIMS))}")
    if kv_heads < 1 or heads % kv_heads:
        out.append(f"{heads} query heads over {kv_heads} kv heads: the attention kernels "
                   f"take whole groups")
    if page is not None and (page < 1 or page % KERNEL_PAGE_MULTIPLE):
        out.append(f"page {page}: the paged attention kernels take pages that are "
                   f"multiples of {KERNEL_PAGE_MULTIPLE}")
    return out


def int4_group_limits(groups: dict) -> list[str]:
    """The limit of the int4 weight products that weights of these groups
    ({name: G}) run into, each named; empty when the kernels take them."""
    first: dict[int, str] = {}  # one line a group size, naming its first weight
    for n, g in groups.items():
        if g % KERNEL_INT4_GROUP_MULTIPLE:
            first.setdefault(g, n)
    return [f"int4 group {g} of {n}: the kernels take groups that are multiples of "
            f"{KERNEL_INT4_GROUP_MULTIPLE}" for g, n in first.items()]


def weight_groups(params: dict, prefix: str = "") -> dict:
    """{path: G} of every int4 weight of a parameter tree."""
    out = {}
    for key, v in params.items():
        if isinstance(v, dict) and "int4" in v:
            out[prefix + key] = 2 * v["int4"].shape[0] // v["gscale"].shape[0]
        elif isinstance(v, dict):
            out.update(weight_groups(v, f"{prefix}{key}/"))
    return out


def refuse_kernel_shapes(what: str, heads: int, kv_heads: int, head_dim: int,
                         page: int | None = None) -> None:
    """Raise, naming each limit, if ``what`` would launch an attention kernel
    at a shape it does not take."""
    limits = kernel_shape_limits(heads, kv_heads, head_dim, page)
    if limits:
        raise ValueError(f"{what}: " + "; ".join(limits))



# ---------------------------------------------------------------------------
# MLP block
# ---------------------------------------------------------------------------


def mlp_step_plain(x, norm_w, w_gateup, s_gateup, b_gateup, w_down, s_down,
                   *, eps: float = 1e-6, residual: bool = True):
    dtype = x.dtype
    f = _k_of(w_down)
    h = _rms(x, norm_w, eps).to(dtype)
    gu = _wdot(h, w_gateup, s_gateup)
    if b_gateup is not None:
        gu = gu + b_gateup.float().reshape(1, -1)
    g, u = gu[:, :f], gu[:, f:]
    a = (torch.nn.functional.silu(g) * u).to(dtype)
    return _finish(x, _wdot(a, w_down, s_down), residual)


def _mlp_step_kernel(x, norm_w, w_gateup, s_gateup, b_gateup, w_down, s_down,
                     *, eps: float, residual: bool, lib=None):
    dev = x.device
    m, d = x.shape
    f = _k_of(w_down)
    _need(x, "x", torch.bfloat16, (m, d), dev)
    sgu, g_gu = _qweight(w_gateup, s_gateup, "w_gateup", d, 2 * f, dev)
    sd, g_d = _qweight(w_down, s_down, "w_down", f, d, dev)
    nw = _f32(norm_w, "norm_w", d, dev)
    bgu = _f32(b_gateup, "b_gateup", 2 * f, dev)
    lib = _lib("mlp", lib)
    ws = lib.dora_mlp_scratch(m, d, f, g_gu, g_d)
    if ws < 0:
        raise ValueError(f"mlp_step: {m} rows of width {d} / ffn {f} overflow the kernel's "
                         f"scratch index")
    h = torch.empty((m, d), dtype=torch.bfloat16, device=dev)
    a = torch.empty((m, f), dtype=torch.bfloat16, device=dev)
    p = torch.empty((max(ws, 1),), dtype=torch.float32, device=dev)
    out = torch.empty((m, d), dtype=torch.bfloat16 if residual else torch.float32,
                      device=dev)
    rc = lib.dora_mlp_step(
        x.data_ptr(), nw.data_ptr(), w_gateup.data_ptr(), sgu.data_ptr(),
        bgu.data_ptr() if bgu is not None else None, w_down.data_ptr(),
        sd.data_ptr(), out.data_ptr(), int(residual), m, d, f, g_gu, g_d, eps,
        h.data_ptr(), a.data_ptr(), p.data_ptr(), _build.stream_of(x),
    )
    _count(mlp_step, False, bool(g_gu or g_d))
    _build.check(rc, "mlp_step")
    return out


def mlp_step(x, norm_w, w_gateup, s_gateup, b_gateup, w_down, s_down,
             *, eps: float = 1e-6, residual: bool = True):
    """Fused SwiGLU sublayer: x + down(silu(gate)·up) of rms(x).

    w_gateup int8 [D, 2F] (gate | up) with scales [1, 2F]; w_down int8
    [F, D] with scales [1, D]; or int4 (uint8, ops/int4.py): w_gateup
    [D/2, 2F] with group scales [D/G, 2F], w_down [F/2, D] with [F/G, D].
    b_gateup [2F] or None. x [M, D]. Returns [M, D] in x.dtype, or the raw
    f32 delta when ``residual`` is False."""
    if not x.is_cuda:
        return mlp_step_plain(x, norm_w, w_gateup, s_gateup, b_gateup, w_down,
                              s_down, eps=eps, residual=residual)
    return _mlp_step_kernel(x, norm_w, w_gateup, s_gateup, b_gateup, w_down,
                            s_down, eps=eps, residual=residual)




# ---------------------------------------------------------------------------
# lm_head + argmax
# ---------------------------------------------------------------------------


def lm_head_argmax_plain(x, norm_w, w, s, *, eps: float = 1e-6,
                         return_val: bool = False):
    h = _rms(x, norm_w, eps).to(x.dtype)
    val, idx = torch.max(_wdot(h, w, s), dim=-1)  # first index among ties
    idx = idx.to(torch.int32)
    return (idx, val) if return_val else idx


def _lm_head_argmax_kernel(x, norm_w, w, s, *, eps: float, return_val: bool,
                           lib=None):
    dev = x.device
    m, d = x.shape
    vocab = w.shape[1]
    _need(x, "x", torch.bfloat16, (m, d), dev)
    sv, g = _qweight(w, s, "w", d, vocab, dev)
    nw = _f32(norm_w, "norm_w", d, dev)
    lib = _lib("lm_head", lib)
    ntiles = lib.dora_head_tiles(vocab)
    h = torch.empty((m, d), dtype=torch.bfloat16, device=dev)
    tile_val = torch.empty((m, ntiles), dtype=torch.float32, device=dev)
    tile_idx = torch.empty((m, ntiles), dtype=torch.int32, device=dev)
    idx = torch.empty((m,), dtype=torch.int32, device=dev)
    val = torch.empty((m,), dtype=torch.float32, device=dev)
    rc = lib.dora_lm_head_argmax(
        x.data_ptr(), nw.data_ptr(), w.data_ptr(), sv.data_ptr(),
        idx.data_ptr(), val.data_ptr(), m, d, vocab, g, eps, h.data_ptr(),
        tile_val.data_ptr(), tile_idx.data_ptr(), _build.stream_of(x),
    )
    _count(lm_head_argmax, False, bool(g))
    _build.check(rc, "lm_head_argmax")
    return (idx, val) if return_val else idx


def lm_head_argmax(x, norm_w, w, s, *, eps: float = 1e-6,
                   return_val: bool = False):
    """Greedy next-token ids of rms(x) @ head without materializing logits.

    x [M, D]; w int8 [D, V] with scales [1, V], or int4 [D/2, V] with group
    scales [D/G, V]. Returns [M] int32 (the first
    index among equal maxima), and the winning f32 logit [M] with
    ``return_val``."""
    if not x.is_cuda:
        return lm_head_argmax_plain(x, norm_w, w, s, eps=eps, return_val=return_val)
    return _lm_head_argmax_kernel(x, norm_w, w, s, eps=eps, return_val=return_val)




# ---------------------------------------------------------------------------
# int8 KV pages: the number format and the pool access shared by the twins
# ---------------------------------------------------------------------------


def kv_quant_rows(x: torch.Tensor):
    """Symmetric int8 row quantization over the last axis (the KV-page
    number format of decode_block.kv_quant_rows): ``scale = max(amax / 127,
    1e-8)`` per row, ``q = clip(round(x / scale), -127, 127)`` with round
    half to even. Returns (q int8, scale f32 shaped like x minus its last
    axis)."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(dim=-1) / 127.0, 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127.0, 127.0).to(torch.int8)
    return q, scale


def kv_dequant(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`kv_quant_rows` at the sweep's read edge: ``q * scale``
    in f32, then cast to the compute dtype."""
    return (q.float() * scale[..., None]).to(dtype)


def _kv_rows(pool, scale, idx, dtype):
    """Pool pages ``idx`` in the compute dtype: fp pools cast, int8 pools
    dequantized through their scale planes."""
    if scale is None:
        return pool[idx].to(dtype)
    return kv_dequant(pool[idx], scale[idx], dtype)


def _kv_store(pool, scale, index, rows) -> None:
    """Write the f32 rows [..., hd] at ``index`` of the pool, quantized with
    their scales into the parallel plane when the pool is int8."""
    if scale is None:
        pool[index] = rows.to(pool.dtype)
    else:
        q, sc = kv_quant_rows(rows)
        pool[index] = q
        scale[index] = sc


def _pools_out(out, k_pool, v_pool, k_scale, v_scale):
    if k_scale is None:
        return out, k_pool, v_pool
    return out, k_pool, v_pool, k_scale, v_scale


def _kv_mode(k_pool, k_scale, v_scale) -> bool:
    """True for the int8-KV form; the scale planes come both or neither."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come both or neither")
    if k_scale is not None and k_pool.dtype != torch.int8:
        raise ValueError(f"the int8-KV form needs int8 pools, got {k_pool.dtype}")
    return k_scale is not None


def _need_pools(k_pool, v_pool, k_scale, v_scale, kv_heads, head_dim, dev):
    """The kernels take bf16 pools, or int8 pools with f32 [P, KV, page]
    scale planes."""
    n_pages, _, page, _ = k_pool.shape
    shape = (n_pages, kv_heads, page, head_dim)
    dtype = torch.int8 if k_scale is not None else torch.bfloat16
    _need(k_pool, "k_pool", dtype, shape, dev)
    _need(v_pool, "v_pool", dtype, shape, dev)
    if k_scale is not None:
        _need(k_scale, "k_scale", torch.float32, shape[:3], dev)
        _need(v_scale, "v_scale", torch.float32, shape[:3], dev)


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _partials(rows: int, d: int, heads: int, kv_heads: int, head_dim: int, g_qkv: int,
              g_o: int, lib) -> int:
    """f32 elements of the weight products' partials for ``rows`` rows: the
    larger of the qkv and wo products' splits x rows x width, each split as
    its format's product splits it (G 0: int8)."""
    n_qkv = (heads + 2 * kv_heads) * head_dim
    return max(lib.dora_gemm_splits(rows, n_qkv, d, g_qkv) * rows * n_qkv,
               lib.dora_gemm_splits(rows, d, heads * head_dim, g_o) * rows * d)


def _scratch(rows: int, d: int, heads: int, kv_heads: int, head_dim: int, g_qkv: int,
             g_o: int, lib, dev):
    """The scratch a dense or paged entry takes for ``rows`` rows: (h, p, q,
    kcur, vcur, attn)."""
    ws = _partials(rows, d, heads, kv_heads, head_dim, g_qkv, g_o, lib)
    f32, bf = torch.float32, torch.bfloat16
    return (torch.empty((rows, d), dtype=bf, device=dev),
            torch.empty((ws,), dtype=f32, device=dev),
            torch.empty((rows, heads, head_dim), dtype=f32, device=dev),
            torch.empty((rows, kv_heads, head_dim), dtype=f32, device=dev),
            torch.empty((rows, kv_heads, head_dim), dtype=f32, device=dev),
            torch.empty((rows, heads * head_dim), dtype=bf, device=dev))


def _sweep_partials(splits: int, rows: int, heads: int, head_dim: int, dev):
    """Scratch for the tensor-core sweep's context splits (kernels 3-5 and
    8-10): each split's (m, l, acc) for the rows x heads query rows of all
    its streams, f32."""
    return torch.empty((splits * rows * heads * (head_dim + 2),), dtype=torch.float32,
                       device=dev)


def _check_host_indices(positions, rows: int, block_tables, n_pages: int,
                        page: int) -> None:
    """The index operands of a kernel call on host tensors (the emulated
    build), checked before launching: every block-table entry names a pool
    page, and each stream's ``rows`` rows from its position stay inside its
    table. On the card these are the caller's contract."""
    bt = block_tables
    if bt.numel() and (int(bt.min()) < 0 or int(bt.max()) >= n_pages):
        raise ValueError(f"block table entries must lie in [0, {n_pages})")
    reach = bt.shape[-1] * page
    pos = positions.reshape(-1).long()
    if pos.numel() and (int(pos.min()) < 0 or int(pos.max()) + rows > reach):
        raise ValueError(f"positions + {rows} rows must stay inside the "
                         f"{bt.shape[-1]} x {page} rows of the block table")


# ---------------------------------------------------------------------------
# paged attention, decode: one row per stream
# ---------------------------------------------------------------------------


def attention_paged_batch_step_plain(
    x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, k_pool, v_pool, wo, swo,
    positions, block_tables, k_scale=None, v_scale=None, *, heads: int,
    kv_heads: int, head_dim: int, eps: float = 1e-6, residual: bool = True,
):
    dtype = x.dtype
    b = x.shape[0]
    page = k_pool.shape[2]
    _kv_mode(k_pool, k_scale, v_scale)
    q, k, v = _project(x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, heads,
                       kv_heads, head_dim, eps)

    # The row's K/V (quantized, for int8 pools) into page bt[b, pos // page],
    # row pos % page. Frozen rows all land on row 0 of null page 0; which one
    # wins is irrelevant.
    pos = positions.long()
    bt = block_tables.long()
    cur = bt[torch.arange(b, device=bt.device), pos // page]
    _kv_store(k_pool, k_scale, (cur, slice(None), pos % page), k)
    _kv_store(v_pool, v_scale, (cur, slice(None), pos % page), v)

    # Prior context (idx < pos) from the pool in the compute dtype.
    n_ctx = bt.shape[1] * page
    ctx_k = _kv_rows(k_pool, k_scale, bt, dtype).permute(0, 2, 1, 3, 4).reshape(
        b, kv_heads, n_ctx, head_dim)
    ctx_v = _kv_rows(v_pool, v_scale, bt, dtype).permute(0, 2, 1, 3, 4).reshape(
        b, kv_heads, n_ctx, head_dim)
    live = torch.arange(n_ctx, device=x.device)[None, :] < pos[:, None]
    attn = _decode_attend(q, k, v, ctx_k, ctx_v, live, dtype)
    o = _wdot(attn.to(dtype), wo, swo)
    return _pools_out(_finish(x, o, residual), k_pool, v_pool, k_scale, v_scale)


def _attention_paged_batch_step_kernel(
    x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, k_pool, v_pool, wo, swo,
    positions, block_tables, k_scale=None, v_scale=None, *, heads, kv_heads,
    head_dim, eps, residual, lib=None,
):
    dev = x.device
    b, d = x.shape
    n_pages, _, page, _ = k_pool.shape
    n_qkv = (heads + 2 * kv_heads) * head_dim
    max_pages = block_tables.shape[1]
    q8 = _kv_mode(k_pool, k_scale, v_scale)
    refuse_kernel_shapes("attention kernel", heads, kv_heads, head_dim, page)
    _need(x, "x", torch.bfloat16, (b, d), dev)
    sq, g_qkv = _qweight(wqkv, sqkv, "wqkv", d, n_qkv, dev)
    so, g_o = _qweight(wo, swo, "wo", heads * head_dim, d, dev)
    _need_pools(k_pool, v_pool, k_scale, v_scale, kv_heads, head_dim, dev)
    _aligned16(k_pool, "k_pool")
    _aligned16(v_pool, "v_pool")
    _need(positions, "positions", torch.int32, (b,), dev)
    _need(block_tables, "block_tables", torch.int32, (b, max_pages), dev)
    _need(cos_rows, "cos_rows", torch.float32, (b, head_dim), dev)
    _need(sin_rows, "sin_rows", torch.float32, (b, head_dim), dev)
    if not x.is_cuda:
        _check_host_indices(positions, 1, block_tables, n_pages, page)
    nw = _f32(norm_w, "norm_w", d, dev)
    bq = _f32(bqkv, "bqkv", n_qkv, dev)
    lib = _lib("paged_attention", lib)
    h, p, q, kcur, vcur, attn = _scratch(b, d, heads, kv_heads, head_dim, g_qkv, g_o, lib, dev)
    # the sweep's splits follow the table's width, never the positions
    part = _sweep_partials(lib.dora_batch_sweep_splits(b, 1, heads, kv_heads, max_pages * page),
                           b, heads, head_dim, dev)
    out = torch.empty((b, d), dtype=torch.bfloat16 if residual else torch.float32,
                      device=dev)
    rc = lib.dora_attention_paged_batch_step(
        x.data_ptr(), nw.data_ptr(), wqkv.data_ptr(), sq.data_ptr(), _ptr(bq),
        cos_rows.data_ptr(), sin_rows.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), _ptr(k_scale), _ptr(v_scale), wo.data_ptr(),
        so.data_ptr(), positions.data_ptr(), block_tables.data_ptr(),
        out.data_ptr(), int(residual), b, d, heads, kv_heads, head_dim, page,
        max_pages, g_qkv, g_o, eps, 1.0 / (head_dim ** 0.5), h.data_ptr(), p.data_ptr(),
        q.data_ptr(), kcur.data_ptr(), vcur.data_ptr(), attn.data_ptr(), part.data_ptr(),
        _build.stream_of(x),
    )
    _count(attention_paged_batch_step, q8, bool(g_qkv or g_o))
    _build.check(rc, "attention_paged_batch_step")
    return _pools_out(out, k_pool, v_pool, k_scale, v_scale)


def attention_paged_batch_step(
    x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, k_pool, v_pool, wo, swo,
    positions, block_tables, k_scale=None, v_scale=None, *, heads: int,
    kv_heads: int, head_dim: int, eps: float = 1e-6, residual: bool = True,
):
    """Paged decode attention sublayer for B independent streams.

    x [B, D]; pools [P, KV, page, hd], updated in place at each row's
    ``positions[b]`` inside page ``block_tables[b, positions[b] // page]``
    (page 0 is the null page); block_tables [B, max_pages] int32;
    cos/sin_rows [B, hd] f32 full-width rope rows. Returns
    (x_out [B, D], k_pool, v_pool).

    ``k_scale``/``v_scale`` (both or neither) select the int8-KV form: the
    pools are int8 and the scales parallel f32 [P, KV, page] planes under
    the same page ids; rows quantize on write (:func:`kv_quant_rows`) and
    dequantize in the sweep (:func:`kv_dequant`), and the return is
    (x_out, k_pool, v_pool, k_scale, v_scale)."""
    args = (x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, k_pool, v_pool,
            wo, swo, positions, block_tables, k_scale, v_scale)
    kw = dict(heads=heads, kv_heads=kv_heads, head_dim=head_dim, eps=eps,
              residual=residual)
    if not x.is_cuda:
        return attention_paged_batch_step_plain(*args, **kw)
    return _attention_paged_batch_step_kernel(*args, **kw)


# ---------------------------------------------------------------------------
# paged attention, prefill: M rows of one stream
# ---------------------------------------------------------------------------


def attention_paged_chunk_step_plain(
    x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, k_pool, v_pool, wo, swo,
    position, block_table, k_scale=None, v_scale=None, *, heads: int,
    kv_heads: int, head_dim: int, eps: float = 1e-6, residual: bool = True,
):
    dtype = x.dtype
    m = x.shape[0]
    page = k_pool.shape[2]
    pos = int(position)
    _kv_mode(k_pool, k_scale, v_scale)
    q, k, v = _project(x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, heads,
                       kv_heads, head_dim, eps)

    # The chunk's K/V land as whole pages (pos and M are page multiples), so
    # int8 pools get whole scale rows too.
    bt = block_table.long()
    n_chunk = m // page
    pages = bt[pos // page : pos // page + n_chunk]
    _kv_store(k_pool, k_scale, pages,
              k.reshape(n_chunk, page, kv_heads, head_dim).transpose(1, 2))
    _kv_store(v_pool, v_scale, pages,
              v.reshape(n_chunk, page, kv_heads, head_dim).transpose(1, 2))

    # Keys: the prior pages (all live) from the pool, then the chunk itself
    # from f32 cast to the compute dtype (never its quantized rows), causally.
    prior = bt[: pos // page]
    prior_k = _kv_rows(k_pool, k_scale, prior, dtype).transpose(0, 1).reshape(
        1, kv_heads, pos, head_dim)
    prior_v = _kv_rows(v_pool, v_scale, prior, dtype).transpose(0, 1).reshape(
        1, kv_heads, pos, head_dim)
    live = torch.ones((1, pos), dtype=torch.bool, device=x.device)
    attn = _verify_attend(q[None], k[None], v[None], prior_k, prior_v, live, dtype)
    o = _wdot(attn.to(dtype), wo, swo)
    return _pools_out(_finish(x, o, residual), k_pool, v_pool, k_scale, v_scale)


def _attention_paged_chunk_step_kernel(
    x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, k_pool, v_pool, wo, swo,
    position, block_table, k_scale=None, v_scale=None, *, heads, kv_heads,
    head_dim, eps, residual, lib=None,
):
    dev = x.device
    m, d = x.shape
    n_pages, _, page, _ = k_pool.shape
    n_qkv = (heads + 2 * kv_heads) * head_dim
    pos = int(position)
    q8 = _kv_mode(k_pool, k_scale, v_scale)
    refuse_kernel_shapes("attention kernel", heads, kv_heads, head_dim, page)
    if pos % page or m % page:
        raise ValueError(f"chunk position {pos} and rows {m} must be multiples of page {page}")
    if pos + m > block_table.shape[0] * page:
        raise ValueError(f"chunk {pos}+{m} runs past the block table")
    _need(x, "x", torch.bfloat16, (m, d), dev)
    sq, g_qkv = _qweight(wqkv, sqkv, "wqkv", d, n_qkv, dev)
    so, g_o = _qweight(wo, swo, "wo", heads * head_dim, d, dev)
    _need_pools(k_pool, v_pool, k_scale, v_scale, kv_heads, head_dim, dev)
    _need(block_table, "block_table", torch.int32, (block_table.shape[-1],), dev)
    _aligned16(k_pool, "k_pool")
    _aligned16(v_pool, "v_pool")
    _need(cos_rows, "cos_rows", torch.float32, (m, head_dim), dev)
    _need(sin_rows, "sin_rows", torch.float32, (m, head_dim), dev)
    if not x.is_cuda:
        _check_host_indices(torch.tensor([pos]), m, block_table, n_pages, page)
    nw = _f32(norm_w, "norm_w", d, dev)
    bq = _f32(bqkv, "bqkv", n_qkv, dev)
    lib = _lib("paged_attention", lib)
    ws = _partials(m, d, heads, kv_heads, head_dim, g_qkv, g_o, lib)
    h = torch.empty((m, d), dtype=torch.bfloat16, device=dev)
    p = torch.empty((ws,), dtype=torch.float32, device=dev)
    q = torch.empty((m, heads, head_dim), dtype=torch.float32, device=dev)
    # the int8 form folds the chunk's own rows from f32 scratch
    kcur = vcur = None
    if q8:
        kcur = torch.empty((m, kv_heads, head_dim), dtype=torch.float32, device=dev)
        vcur = torch.empty((m, kv_heads, head_dim), dtype=torch.float32, device=dev)
    attn = torch.empty((m, heads * head_dim), dtype=torch.bfloat16, device=dev)
    part = _sweep_partials(lib.dora_sweep_splits(0, m, heads, kv_heads, pos), m, heads,
                           head_dim, dev)
    out = torch.empty((m, d), dtype=torch.bfloat16 if residual else torch.float32,
                      device=dev)
    rc = lib.dora_attention_paged_chunk_step(
        x.data_ptr(), nw.data_ptr(), wqkv.data_ptr(), sq.data_ptr(), _ptr(bq),
        cos_rows.data_ptr(), sin_rows.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), _ptr(k_scale), _ptr(v_scale), wo.data_ptr(),
        so.data_ptr(), pos, block_table.data_ptr(), out.data_ptr(),
        int(residual), m, d, heads, kv_heads, head_dim, page, g_qkv, g_o, eps,
        1.0 / (head_dim ** 0.5), h.data_ptr(), p.data_ptr(), q.data_ptr(), _ptr(kcur),
        _ptr(vcur), attn.data_ptr(), part.data_ptr(), _build.stream_of(x),
    )
    _count(attention_paged_chunk_step, q8, bool(g_qkv or g_o))
    _build.check(rc, "attention_paged_chunk_step")
    return _pools_out(out, k_pool, v_pool, k_scale, v_scale)


def attention_paged_chunk_step(
    x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, k_pool, v_pool, wo, swo,
    position, block_table, k_scale=None, v_scale=None, *, heads: int,
    kv_heads: int, head_dim: int, eps: float = 1e-6, residual: bool = True,
):
    """Paged attention sublayer for one prefill chunk.

    x [M, D]: the chunk's rows at positions ``position..position+M-1``
    (``position`` and M multiples of the page size); block_table
    [max_pages] int32 of this stream. The chunk's K/V land as whole pool
    pages (in place); rows attend the prior pages and the chunk causally.
    Returns (x_out [M, D], k_pool, v_pool); with ``k_scale``/``v_scale``
    the int8-KV form (see :func:`attention_paged_batch_step`), whose
    within-chunk fold uses the chunk's fp values, returning
    (x_out, k_pool, v_pool, k_scale, v_scale)."""
    args = (x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, k_pool, v_pool,
            wo, swo, position, block_table, k_scale, v_scale)
    kw = dict(heads=heads, kv_heads=kv_heads, head_dim=head_dim, eps=eps,
              residual=residual)
    if not x.is_cuda:
        return attention_paged_chunk_step_plain(*args, **kw)
    return _attention_paged_chunk_step_kernel(*args, **kw)


# ---------------------------------------------------------------------------
# paged attention, speculative verify: m candidate rows for each of B streams
# ---------------------------------------------------------------------------


def attention_paged_spec_step_plain(
    x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, k_pool, v_pool, wo, swo,
    positions, block_tables, k_scale=None, v_scale=None, *, heads: int,
    kv_heads: int, head_dim: int, m: int, eps: float = 1e-6,
    residual: bool = True,
):
    dtype = x.dtype
    bm = x.shape[0]
    b = bm // m
    page = k_pool.shape[2]
    _kv_mode(k_pool, k_scale, v_scale)
    q, k, v = _project(x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, heads,
                       kv_heads, head_dim, eps)

    # Row i of stream b into page bt[b, (pos+i) // page], row (pos+i) % page:
    # the m rows may straddle a page, and for int8 pools each writes its own
    # scale entry. Frozen streams (pos 0, zeroed table row) all land on rows
    # 0..m-1 of null page 0; which one wins is irrelevant.
    pos = positions.long()
    bt = block_tables.long()
    rpos = (pos[:, None] + torch.arange(m, device=pos.device)[None, :]).reshape(bm)
    stream = torch.arange(b, device=pos.device).repeat_interleave(m)
    cur = bt[stream, rpos // page]
    _kv_store(k_pool, k_scale, (cur, slice(None), rpos % page), k)
    _kv_store(v_pool, v_scale, (cur, slice(None), rpos % page), v)

    # Keys: the prior context (idx < pos; the rows just written sit at
    # idx >= pos and stay masked) from the pool, then the stream's own m
    # rows causally from f32 cast to the compute dtype (never their
    # quantized rows); never another stream's.
    n_ctx = bt.shape[1] * page
    ctx_k = _kv_rows(k_pool, k_scale, bt, dtype).permute(0, 2, 1, 3, 4).reshape(
        b, kv_heads, n_ctx, head_dim)
    ctx_v = _kv_rows(v_pool, v_scale, bt, dtype).permute(0, 2, 1, 3, 4).reshape(
        b, kv_heads, n_ctx, head_dim)
    live = torch.arange(n_ctx, device=x.device)[None, :] < pos[:, None]  # [B, n_ctx]
    attn = _verify_attend(q.reshape(b, m, heads, head_dim),
                          k.reshape(b, m, kv_heads, head_dim),
                          v.reshape(b, m, kv_heads, head_dim), ctx_k, ctx_v, live, dtype)
    o = _wdot(attn.to(dtype), wo, swo)
    return _pools_out(_finish(x, o, residual), k_pool, v_pool, k_scale, v_scale)


def _attention_paged_spec_step_kernel(
    x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, k_pool, v_pool, wo, swo,
    positions, block_tables, k_scale=None, v_scale=None, *, heads, kv_heads,
    head_dim, m, eps, residual, lib=None,
):
    dev = x.device
    bm, d = x.shape
    n_pages, _, page, _ = k_pool.shape
    n_qkv = (heads + 2 * kv_heads) * head_dim
    q8 = _kv_mode(k_pool, k_scale, v_scale)
    refuse_kernel_shapes("attention kernel", heads, kv_heads, head_dim, page)
    if m < 1:
        raise ValueError(f"spec kernel takes m >= 1 candidate rows, got {m}")
    if bm % m or positions.shape != (bm // m,):
        raise ValueError(f"x has {bm} rows: expected m = {m} rows for each of the "
                         f"{tuple(positions.shape)} positions")
    b = bm // m
    max_pages = block_tables.shape[-1]
    _need(x, "x", torch.bfloat16, (bm, d), dev)
    sq, g_qkv = _qweight(wqkv, sqkv, "wqkv", d, n_qkv, dev)
    so, g_o = _qweight(wo, swo, "wo", heads * head_dim, d, dev)
    _need_pools(k_pool, v_pool, k_scale, v_scale, kv_heads, head_dim, dev)
    _aligned16(k_pool, "k_pool")
    _aligned16(v_pool, "v_pool")
    _need(positions, "positions", torch.int32, (b,), dev)
    _need(block_tables, "block_tables", torch.int32, (b, max_pages), dev)
    _need(cos_rows, "cos_rows", torch.float32, (bm, head_dim), dev)
    _need(sin_rows, "sin_rows", torch.float32, (bm, head_dim), dev)
    if not x.is_cuda:
        _check_host_indices(positions, m, block_tables, n_pages, page)
    nw = _f32(norm_w, "norm_w", d, dev)
    bq = _f32(bqkv, "bqkv", n_qkv, dev)
    lib = _lib("paged_attention", lib)
    h, p, q, kcur, vcur, attn = _scratch(bm, d, heads, kv_heads, head_dim, g_qkv, g_o, lib, dev)
    # the sweep's splits follow the table's width, never the positions
    part = _sweep_partials(lib.dora_batch_sweep_splits(b, m, heads, kv_heads, max_pages * page),
                           bm, heads, head_dim, dev)
    out = torch.empty((bm, d), dtype=torch.bfloat16 if residual else torch.float32,
                      device=dev)
    rc = lib.dora_attention_paged_spec_step(
        x.data_ptr(), nw.data_ptr(), wqkv.data_ptr(), sq.data_ptr(), _ptr(bq),
        cos_rows.data_ptr(), sin_rows.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), _ptr(k_scale), _ptr(v_scale), wo.data_ptr(),
        so.data_ptr(), positions.data_ptr(), block_tables.data_ptr(),
        out.data_ptr(), int(residual), b, m, d, heads, kv_heads, head_dim, page,
        max_pages, g_qkv, g_o, eps, 1.0 / (head_dim ** 0.5), h.data_ptr(), p.data_ptr(),
        q.data_ptr(), kcur.data_ptr(), vcur.data_ptr(), attn.data_ptr(), part.data_ptr(),
        _build.stream_of(x),
    )
    _count(attention_paged_spec_step, q8, bool(g_qkv or g_o))
    _build.check(rc, "attention_paged_spec_step")
    return _pools_out(out, k_pool, v_pool, k_scale, v_scale)


def attention_paged_spec_step(
    x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, k_pool, v_pool, wo, swo,
    positions, block_tables, k_scale=None, v_scale=None, *, heads: int,
    kv_heads: int, head_dim: int, m: int, eps: float = 1e-6,
    residual: bool = True,
):
    """Paged attention sublayer for B speculative-verify chunks.

    x [B*m, D]: stream b's m candidate rows (its last token and m-1 drafts),
    stream-major, at positions ``positions[b]..positions[b]+m-1`` of its
    paged context; cos/sin_rows [B*m, hd] rope rows at every flattened
    position; block_tables [B, max_pages] int32 (0 = the null page). The
    m rows' K/V land in the pools in place (they may straddle a page);
    each row attends its stream's prior context and, causally, its own
    chunk. Callers keep ``positions[b] + m <= max_seq`` (the engine's spec
    headroom). Returns (x_out [B*m, D], k_pool, v_pool); with
    ``k_scale``/``v_scale`` the int8-KV form (see
    :func:`attention_paged_batch_step`), which writes exactly the m value
    rows and m scale entries of each (stream, kv head), returning
    (x_out, k_pool, v_pool, k_scale, v_scale)."""
    args = (x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, k_pool, v_pool,
            wo, swo, positions, block_tables, k_scale, v_scale)
    kw = dict(heads=heads, kv_heads=kv_heads, head_dim=head_dim, m=m, eps=eps,
              residual=residual)
    if not x.is_cuda:
        return attention_paged_spec_step_plain(*args, **kw)
    return _attention_paged_spec_step_kernel(*args, **kw)


# ---------------------------------------------------------------------------
# dense caches: the batch engine's decode, batch-1 decode and its verify
# ---------------------------------------------------------------------------


def _check_dense_positions(positions, rows: int, seq: int) -> None:
    """Every stream's ``rows`` rows from its position lie inside its
    ``seq``-row cache plane: 0 <= position and position + rows <= seq. Host
    positions are checked before every launch; device positions (the dense
    engine's) only on host tensors (the emulated build), since reading them
    back would stall the stream: on the card they are the caller's
    contract."""
    pos = positions.reshape(-1).long()
    if pos.numel() and (int(pos.min()) < 0 or int(pos.max()) + rows > seq):
        raise ValueError(f"positions must lie in [0, {seq - rows}]: {rows} row(s) from "
                         f"each must fit the {seq}-row cache")


def _dense_kernel_args(x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, k_cache,
                       v_cache, wo, swo, *, heads, kv_heads, head_dim, streams: int):
    """The checks every dense wrapper makes before launching (bf16 caches
    [streams, KV, S, hd] or, batch 1, [KV, S, hd]) and the f32 vectors it
    passes. Returns (rows, width, S, norm_w, sqkv, bqkv, swo, g_qkv, g_o)."""
    dev = x.device
    rows, d = x.shape
    n_qkv = (heads + 2 * kv_heads) * head_dim
    seq = k_cache.shape[-2]
    refuse_kernel_shapes("attention kernel", heads, kv_heads, head_dim)
    _need(x, "x", torch.bfloat16, (rows, d), dev)
    sq, g_qkv = _qweight(wqkv, sqkv, "wqkv", d, n_qkv, dev)
    so, g_o = _qweight(wo, swo, "wo", heads * head_dim, d, dev)
    shape = (kv_heads, seq, head_dim) if k_cache.dim() == 3 else (streams, kv_heads, seq, head_dim)
    _need(k_cache, "k_cache", torch.bfloat16, shape, dev)
    _need(v_cache, "v_cache", torch.bfloat16, shape, dev)
    _aligned16(k_cache, "k_cache")
    _aligned16(v_cache, "v_cache")
    _need(cos_rows, "cos_rows", torch.float32, (rows, head_dim), dev)
    _need(sin_rows, "sin_rows", torch.float32, (rows, head_dim), dev)
    return (rows, d, seq, _f32(norm_w, "norm_w", d, dev), sq, _f32(bqkv, "bqkv", n_qkv, dev),
            so, g_qkv, g_o)


def attention_batch_step_plain(
    x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, k_caches, v_caches, wo, swo,
    positions, *, heads: int, kv_heads: int, head_dim: int, eps: float = 1e-6,
    residual: bool = True,
):
    dtype = x.dtype
    b = x.shape[0]
    q, k, v = _project(x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, heads,
                       kv_heads, head_dim, eps)
    # Row b's K/V into plane b at positions[b]; then its prior rows (idx <
    # pos) in the compute dtype, and the row itself folded from f32.
    pos = positions.long()
    planes = torch.arange(b, device=pos.device)
    k_caches[planes, :, pos] = k.to(k_caches.dtype)
    v_caches[planes, :, pos] = v.to(v_caches.dtype)
    live = torch.arange(k_caches.shape[2], device=pos.device)[None, :] < pos[:, None]
    attn = _decode_attend(q, k, v, k_caches.to(dtype), v_caches.to(dtype), live, dtype)
    return _finish(x, _wdot(attn.to(dtype), wo, swo), residual), k_caches, v_caches


def _attention_batch_step_kernel(
    x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, k_caches, v_caches, wo, swo,
    positions, *, heads, kv_heads, head_dim, eps, residual, lib=None,
):
    dev = x.device
    b = x.shape[0]
    if k_caches.dim() != 4:
        raise ValueError(f"k_caches must be [B, KV, S, hd], got {tuple(k_caches.shape)}")
    rows, d, seq, nw, sq, bq, so, g_qkv, g_o = _dense_kernel_args(
        x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, k_caches, v_caches, wo, swo,
        heads=heads, kv_heads=kv_heads, head_dim=head_dim, streams=b)
    _need(positions, "positions", torch.int32, (b,), dev)
    if not x.is_cuda:
        _check_dense_positions(positions, 1, seq)
    lib = _lib("paged_attention", lib)
    h, p, q, kcur, vcur, attn = _scratch(b, d, heads, kv_heads, head_dim, g_qkv, g_o, lib, dev)
    # the sweep's splits follow the planes' length, never the positions
    part = _sweep_partials(lib.dora_batch_sweep_splits(b, 1, heads, kv_heads, seq), b, heads,
                           head_dim, dev)
    out = torch.empty((b, d), dtype=torch.bfloat16 if residual else torch.float32,
                      device=dev)
    rc = lib.dora_attention_dense_step(
        x.data_ptr(), nw.data_ptr(), wqkv.data_ptr(), sq.data_ptr(), _ptr(bq),
        cos_rows.data_ptr(), sin_rows.data_ptr(), k_caches.data_ptr(),
        v_caches.data_ptr(), wo.data_ptr(), so.data_ptr(), positions.data_ptr(), 0,
        out.data_ptr(), int(residual), b, d, heads, kv_heads, head_dim, seq, g_qkv, g_o, eps,
        1.0 / (head_dim ** 0.5), h.data_ptr(), p.data_ptr(), q.data_ptr(),
        kcur.data_ptr(), vcur.data_ptr(), attn.data_ptr(), part.data_ptr(),
        _build.stream_of(x),
    )
    _count(attention_batch_step, False, bool(g_qkv or g_o))
    _build.check(rc, "attention_batch_step")
    return out, k_caches, v_caches


def attention_batch_step(
    x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, k_caches, v_caches, wo, swo,
    positions, *, heads: int, kv_heads: int, head_dim: int, eps: float = 1e-6,
    residual: bool = True,
):
    """Fused decode attention for B independent sequences over dense caches.

    x [B, D]; caches [B, KV, S, hd], updated in place: row b's K/V at
    ``positions[b]`` of plane b, which must lie in [0, S) (checked on host
    tensors); cos/sin_rows [B, hd] f32 rope rows at each row's position. Row
    b attends its own plane's rows < positions[b] and itself; nothing crosses
    rows, so an idle slot pinned at position 0 only attends itself. Returns
    (x_out [B, D], k_caches, v_caches); x_out is the raw f32 delta with
    ``residual=False``."""
    args = (x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, k_caches, v_caches,
            wo, swo, positions)
    kw = dict(heads=heads, kv_heads=kv_heads, head_dim=head_dim, eps=eps,
              residual=residual)
    if not x.is_cuda:
        return attention_batch_step_plain(*args, **kw)
    return _attention_batch_step_kernel(*args, **kw)


def attention_step_plain(
    x, norm_w, wqkv, sqkv, bqkv, cos_full, sin_signed, k_cache, v_cache, wo, swo,
    position, *, heads: int, kv_heads: int, head_dim: int, eps: float = 1e-6,
    residual: bool = True,
):
    pos = torch.tensor([int(position)], dtype=torch.int32, device=x.device)
    out, _, _ = attention_batch_step_plain(
        x, norm_w, wqkv, sqkv, bqkv, cos_full, sin_signed, k_cache[None],
        v_cache[None], wo, swo, pos, heads=heads, kv_heads=kv_heads,
        head_dim=head_dim, eps=eps, residual=residual)
    return out, k_cache, v_cache


def _attention_step_kernel(
    x, norm_w, wqkv, sqkv, bqkv, cos_full, sin_signed, k_cache, v_cache, wo, swo,
    position, *, heads, kv_heads, head_dim, eps, residual, lib=None,
):
    dev = x.device
    if x.shape[0] != 1 or k_cache.dim() != 3:
        raise ValueError(f"attention_step takes one row and [KV, S, hd] caches, got x "
                         f"{tuple(x.shape)} and {tuple(k_cache.shape)}")
    rows, d, seq, nw, sq, bq, so, g_qkv, g_o = _dense_kernel_args(
        x, norm_w, wqkv, sqkv, bqkv, cos_full, sin_signed, k_cache, v_cache, wo, swo,
        heads=heads, kv_heads=kv_heads, head_dim=head_dim, streams=1)
    pos = int(position)
    _check_dense_positions(torch.tensor([pos]), 1, seq)
    lib = _lib("paged_attention", lib)
    h, p, q, kcur, vcur, attn = _scratch(1, d, heads, kv_heads, head_dim, g_qkv, g_o, lib, dev)
    part = _sweep_partials(lib.dora_batch_sweep_splits(1, 1, heads, kv_heads, seq), 1, heads,
                           head_dim, dev)
    out = torch.empty((1, d), dtype=torch.bfloat16 if residual else torch.float32,
                      device=dev)
    rc = lib.dora_attention_dense_step(
        x.data_ptr(), nw.data_ptr(), wqkv.data_ptr(), sq.data_ptr(), _ptr(bq),
        cos_full.data_ptr(), sin_signed.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), wo.data_ptr(), so.data_ptr(), None, pos,
        out.data_ptr(), int(residual), 1, d, heads, kv_heads, head_dim, seq, g_qkv, g_o, eps,
        1.0 / (head_dim ** 0.5), h.data_ptr(), p.data_ptr(), q.data_ptr(),
        kcur.data_ptr(), vcur.data_ptr(), attn.data_ptr(), part.data_ptr(),
        _build.stream_of(x),
    )
    _count(attention_step, False, bool(g_qkv or g_o))
    _build.check(rc, "attention_step")
    return out, k_cache, v_cache


def attention_step(
    x, norm_w, wqkv, sqkv, bqkv, cos_full, sin_signed, k_cache, v_cache, wo, swo,
    position, *, heads: int, kv_heads: int, head_dim: int, eps: float = 1e-6,
    residual: bool = True,
):
    """One fused batch-1 decode attention sublayer.

    x [1, D]; caches [KV, S, hd], updated in place at ``position`` (a host
    int in [0, S), checked); cos_full / sin_signed [1, hd] f32 rope rows at
    that position. Returns (x_out [1, D], k_cache, v_cache); x_out is the
    raw f32 delta with ``residual=False``."""
    args = (x, norm_w, wqkv, sqkv, bqkv, cos_full, sin_signed, k_cache, v_cache,
            wo, swo, position)
    kw = dict(heads=heads, kv_heads=kv_heads, head_dim=head_dim, eps=eps,
              residual=residual)
    if not x.is_cuda:
        return attention_step_plain(*args, **kw)
    return _attention_step_kernel(*args, **kw)


def attention_chunk_step_plain(
    x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, k_cache, v_cache, wo, swo,
    position, *, heads: int, kv_heads: int, head_dim: int, eps: float = 1e-6,
    residual: bool = True,
):
    dtype = x.dtype
    m = x.shape[0]
    pos = int(position)
    q, k, v = _project(x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, heads,
                       kv_heads, head_dim, eps)
    # Exactly the M rows pos..pos+M-1; then the prior rows (idx < pos) in the
    # compute dtype, and the chunk causally from bf16 of its f32 rows.
    k_cache[:, pos : pos + m] = k.transpose(0, 1).to(k_cache.dtype)
    v_cache[:, pos : pos + m] = v.transpose(0, 1).to(v_cache.dtype)
    live = torch.arange(k_cache.shape[1], device=x.device)[None, :] < pos
    attn = _verify_attend(q[None], k[None], v[None], k_cache[None].to(dtype),
                          v_cache[None].to(dtype), live, dtype)
    return _finish(x, _wdot(attn.to(dtype), wo, swo), residual), k_cache, v_cache


def _attention_chunk_step_kernel(
    x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, k_cache, v_cache, wo, swo,
    position, *, heads, kv_heads, head_dim, eps, residual, lib=None,
):
    dev = x.device
    m = x.shape[0]
    if k_cache.dim() != 3:
        raise ValueError(f"attention_chunk_step takes [KV, S, hd] caches, got "
                         f"{tuple(k_cache.shape)}")
    if m < 1:
        raise ValueError(f"chunk kernel takes M >= 1 rows, got {m}")
    rows, d, seq, nw, sq, bq, so, g_qkv, g_o = _dense_kernel_args(
        x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, k_cache, v_cache, wo, swo,
        heads=heads, kv_heads=kv_heads, head_dim=head_dim, streams=1)
    pos = int(position)
    _check_dense_positions(torch.tensor([pos]), m, seq)
    lib = _lib("paged_attention", lib)
    h, p, q, kcur, vcur, attn = _scratch(m, d, heads, kv_heads, head_dim, g_qkv, g_o, lib, dev)
    part = _sweep_partials(lib.dora_sweep_splits(1, m, heads, kv_heads, pos), m, heads,
                           head_dim, dev)
    out = torch.empty((m, d), dtype=torch.bfloat16 if residual else torch.float32,
                      device=dev)
    rc = lib.dora_attention_dense_chunk_step(
        x.data_ptr(), nw.data_ptr(), wqkv.data_ptr(), sq.data_ptr(), _ptr(bq),
        cos_rows.data_ptr(), sin_rows.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), wo.data_ptr(), so.data_ptr(), pos, out.data_ptr(),
        int(residual), m, d, heads, kv_heads, head_dim, seq, g_qkv, g_o, eps,
        1.0 / (head_dim ** 0.5),
        h.data_ptr(), p.data_ptr(), q.data_ptr(), kcur.data_ptr(), vcur.data_ptr(),
        attn.data_ptr(), part.data_ptr(), _build.stream_of(x),
    )
    _count(attention_chunk_step, False, bool(g_qkv or g_o))
    _build.check(rc, "attention_chunk_step")
    return out, k_cache, v_cache


def attention_chunk_step(
    x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, k_cache, v_cache, wo, swo,
    position, *, heads: int, kv_heads: int, head_dim: int, eps: float = 1e-6,
    residual: bool = True,
):
    """M-row fused attention sublayer of one stream (speculative verify).

    x [M, D]: the chunk's rows at positions ``position..position+M-1``
    (``position`` a host int; ``position + M <= S`` is checked, the
    speculation headroom contract); cos/sin_rows [M, hd] f32 rope rows.
    Exactly those M rows of the caches [KV, S, hd] are written, in place;
    each row attends the rows < position and, causally, the chunk. Returns
    (x_out [M, D], k_cache, v_cache); x_out is the raw f32 delta with
    ``residual=False``."""
    args = (x, norm_w, wqkv, sqkv, bqkv, cos_rows, sin_rows, k_cache, v_cache,
            wo, swo, position)
    kw = dict(heads=heads, kv_heads=kv_heads, head_dim=head_dim, eps=eps,
              residual=residual)
    if not x.is_cuda:
        return attention_chunk_step_plain(*args, **kw)
    return _attention_chunk_step_kernel(*args, **kw)


# ---------------------------------------------------------------------------
# rope rows and the frozen-row view (shared by the fused steps)
# ---------------------------------------------------------------------------


def freeze_inactive(positions, block_tables, active):
    """Inactive rows pin to position 0 with an all-zero block-table row, so
    their KV writes land in the null page and their sweep is empty.
    positions [B] i32, block_tables [B, P] i32, active [B] bool."""
    a = active.to(torch.int32)
    return torch.where(active, positions, torch.zeros_like(positions)), block_tables * a[:, None]


def rope_rows_at(cos_table, sin_table, positions):
    """Rope rows at independent positions [B], as two [B, hd] f32 arrays in
    the kernels' full-width layout ([cos, cos], [-sin, sin])."""
    idx = positions.long()
    cos = cos_table[idx]
    sin = sin_table[idx]
    return (
        torch.cat([cos, cos], dim=-1).float(),
        torch.cat([-sin, sin], dim=-1).float(),
    )


def rope_rows(cos_table, sin_table, position: int, length: int = 1):
    """``length`` rope rows from ``position`` in the full-width layout. The
    start is clamped so the slice stays inside the table, as
    ``lax.dynamic_slice`` does."""
    start = min(max(int(position), 0), cos_table.shape[0] - length)
    cos = cos_table[start : start + length]
    sin = sin_table[start : start + length]
    return (
        torch.cat([cos, cos], dim=-1).float(),
        torch.cat([-sin, sin], dim=-1).float(),
    )


def mma_tile(a: torch.Tensor, b: torch.Tensor, lib=None) -> torch.Tensor:
    """``a @ b`` in f32 for bf16 a [16, 16] and b [16, 8], through the
    tensor-core helper the attention sweeps use (one m16n8k16 mma, every
    lane's fragments built by the sweeps' layout). A check of that layout,
    not a kernel of any path: the card and the emulated build run it
    against ``torch.matmul``."""
    dev = a.device
    _need(a, "a", torch.bfloat16, (16, 16), dev)
    _need(b, "b", torch.bfloat16, (16, 8), dev)
    d = torch.empty((16, 8), dtype=torch.float32, device=dev)
    lib = _lib("paged_attention", lib)
    _build.check(lib.dora_mma_tile(a.data_ptr(), b.data_ptr(), d.data_ptr(),
                                   _build.stream_of(a)), "mma_tile")
    return d


def tc_tile4(a: torch.Tensor, w: torch.Tensor, lib=None) -> torch.Tensor:
    """``a @ q`` in f32 for bf16 a [16, 32] and one 32-row group of int4
    weights w, uint8 [16, 16] packed as ops/int4.py packs it (q = the low
    nibble of row j for rows j < 16, the high nibble of row j - 16 after,
    each minus 8), through the fragment path of the int4 tensor-core product
    (one ``ldmatrix.trans`` of the packed bytes, ``widen_u4_cols``, two k
    steps of an even and an odd mma). A check of that path, not a kernel of
    any path: the card and the emulated build run it against
    ``torch.matmul``."""
    dev = a.device
    _need(a, "a", torch.bfloat16, (16, 32), dev)
    _need(w, "w", torch.uint8, (16, 16), dev)
    d = torch.empty((16, 16), dtype=torch.float32, device=dev)
    lib = _lib("mlp", lib)
    _build.check(lib.dora_tc_tile4(a.data_ptr(), w.data_ptr(), d.data_ptr(),
                                   _build.stream_of(a)), "tc_tile4")
    return d


def tc_tile(a: torch.Tensor, w: torch.Tensor, lib=None) -> torch.Tensor:
    """``a @ w`` in f32 for bf16 a [16, 16] and int8 w [16, 16], through the
    fragment path of the tensor-core int8 product of kernels 1 and 2
    (``ldmatrix`` of a, ``ldmatrix.trans`` of w's bytes as 16-bit pairs,
    ``widen_i8_cols``, an m16n8k16 mma for the even columns and one for the
    odd). A check of that path, not a kernel of any path: the card and the
    emulated build run it against ``torch.matmul``."""
    dev = a.device
    _need(a, "a", torch.bfloat16, (16, 16), dev)
    _need(w, "w", torch.int8, (16, 16), dev)
    d = torch.empty((16, 16), dtype=torch.float32, device=dev)
    lib = _lib("mlp", lib)
    _build.check(lib.dora_tc_tile(a.data_ptr(), w.data_ptr(), d.data_ptr(),
                                  _build.stream_of(a)), "tc_tile")
    return d


#: the kernel wrappers of this module: the paged serving path's in the order a
#: layer runs them, then the dense caches' (dense engine, batch-1 decode and
#: its verify)
KERNELS = (attention_paged_chunk_step, attention_paged_batch_step,
           attention_paged_spec_step, mlp_step, lm_head_argmax,
           attention_batch_step, attention_step, attention_chunk_step)
#: the wrappers that also launch an int8-KV form, counted apart as
#: ``launches_int8kv`` (``launches`` counts their fp form); every wrapper's
#: int4-weight launches (of either KV form) are counted apart as
#: ``launches_int4``
KV_INT8_KERNELS = (attention_paged_chunk_step, attention_paged_batch_step,
                   attention_paged_spec_step)


def _count(fn, int8kv: bool, int4: bool = False) -> None:
    if int4:
        fn.launches_int4 += 1
    elif int8kv:
        fn.launches_int8kv += 1
    else:
        fn.launches += 1


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0
        fn.launches_int4 = 0
    for fn in KV_INT8_KERNELS:
        fn.launches_int8kv = 0


def launch_counts() -> dict[str, int]:
    """Launches per kernel since :func:`reset_launches`: int8 weights under
    the kernel's name (the int8-KV forms as ``<name>_int8kv``), int4 weights
    as ``<name>_int4``."""
    counts = {fn.__name__: fn.launches for fn in KERNELS}
    counts.update({f"{fn.__name__}_int8kv": fn.launches_int8kv for fn in KV_INT8_KERNELS})
    counts.update({f"{fn.__name__}_int4": fn.launches_int4 for fn in KERNELS})
    return counts


reset_launches()
