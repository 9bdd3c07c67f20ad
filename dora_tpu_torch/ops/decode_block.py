"""The fused decode sublayers of the paged serving path, on torch tensors.

Counterpart of dora_tpu/ops/decode_block.py (int8 weights; fp or int8 KV
pages, with the KV number format ``kv_quant_rows`` / ``kv_dequant``). Each
of the five functions takes the arguments and returns the tuple of its
Pallas counterpart, and comes in two versions in this module:

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

Pools are updated IN PLACE on both paths (the JAX package donates them to
the same effect) and returned, so callers keep the reference's
``(x_out, k_pool, v_pool)`` contract.
"""

from __future__ import annotations

import torch

from dora_tpu_torch.ops import _build

_P, _I, _F = _build.P, _build.I, _build.F

_SIGNATURES = {
    "mlp": {
        "dora_gemm_splits": [_I, _I, _I],
        "dora_mlp_step": [_P] * 8 + [_I] * 4 + [_F] + [_P] * 4,
    },
    "lm_head": {
        "dora_head_tiles": [_I],
        "dora_lm_head_argmax": [_P] * 6 + [_I] * 3 + [_F] + [_P] * 4,
    },
    "paged_attention": {
        "dora_gemm_splits": [_I, _I, _I],
        "dora_attention_paged_batch_step":
            [_P] * 16 + [_I] * 6 + [_F] * 2 + [_P] * 7,
        "dora_attention_paged_chunk_step":
            [_P] * 13 + [_I] + [_P] * 2 + [_I] * 5 + [_F] * 2 + [_P] * 7,
        "dora_attention_paged_spec_step":
            [_P] * 16 + [_I] * 7 + [_F] * 2 + [_P] * 7,
    },
}

#: shapes the attention kernels are written for
KERNEL_HEAD_DIM = 128
KERNEL_PAGE = 16
KERNEL_MAX_GROUP = 8
KERNEL_MAX_QKV_HEADS = 32
#: the spec kernel holds m candidate rows x the group's heads in one block
KERNEL_SPEC_MAX_ROWS = 64


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
    """``x @ q`` in f32 for int8 q [K, N], per-column scale s [1, N] on the
    accumulator. x holds compute-dtype values, exact in f32, so this is the
    reference's preferred_element_type=f32 dot."""
    return (x.float() @ q.float()) * s.float().reshape(1, -1)


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


def _int8_weight(w: torch.Tensor, name: str, k: int, n: int, device) -> None:
    _need(w, name, torch.int8, (k, n), device)
    if w.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel reads 16-byte rows; the weight must be 16-byte aligned")


def _attn_shapes(heads: int, kv_heads: int, head_dim: int, page: int) -> None:
    if head_dim != KERNEL_HEAD_DIM or page != KERNEL_PAGE:
        raise ValueError(
            f"attention kernels take head_dim {KERNEL_HEAD_DIM} and page "
            f"{KERNEL_PAGE}, got {head_dim} and {page}"
        )
    if heads % kv_heads or heads // kv_heads > KERNEL_MAX_GROUP:
        raise ValueError(f"attention kernels take groups <= {KERNEL_MAX_GROUP}, got {heads}/{kv_heads}")
    if heads + 2 * kv_heads > KERNEL_MAX_QKV_HEADS:
        raise ValueError(f"attention kernels take <= {KERNEL_MAX_QKV_HEADS} q+k+v heads")


# ---------------------------------------------------------------------------
# MLP block
# ---------------------------------------------------------------------------


def mlp_step_plain(x, norm_w, w_gateup, s_gateup, b_gateup, w_down, s_down,
                   *, eps: float = 1e-6, residual: bool = True):
    dtype = x.dtype
    f = w_down.shape[0]
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
    f = w_down.shape[0]
    _need(x, "x", torch.bfloat16, (m, d), dev)
    _int8_weight(w_gateup, "w_gateup", d, 2 * f, dev)
    _int8_weight(w_down, "w_down", f, d, dev)
    nw = _f32(norm_w, "norm_w", d, dev)
    sgu = _f32(s_gateup, "s_gateup", 2 * f, dev)
    bgu = _f32(b_gateup, "b_gateup", 2 * f, dev)
    sd = _f32(s_down, "s_down", d, dev)
    lib = _lib("mlp", lib)
    ws = max(
        lib.dora_gemm_splits(m, 2 * f, d) * m * 2 * f,
        lib.dora_gemm_splits(m, d, f) * m * d,
    )
    h = torch.empty((m, d), dtype=torch.bfloat16, device=dev)
    a = torch.empty((m, f), dtype=torch.bfloat16, device=dev)
    p = torch.empty((ws,), dtype=torch.float32, device=dev)
    out = torch.empty((m, d), dtype=torch.bfloat16 if residual else torch.float32,
                      device=dev)
    rc = lib.dora_mlp_step(
        x.data_ptr(), nw.data_ptr(), w_gateup.data_ptr(), sgu.data_ptr(),
        bgu.data_ptr() if bgu is not None else None, w_down.data_ptr(),
        sd.data_ptr(), out.data_ptr(), int(residual), m, d, f, eps,
        h.data_ptr(), a.data_ptr(), p.data_ptr(), _build.stream_of(x),
    )
    mlp_step.launches += 1
    _build.check(rc, "mlp_step")
    return out


def mlp_step(x, norm_w, w_gateup, s_gateup, b_gateup, w_down, s_down,
             *, eps: float = 1e-6, residual: bool = True):
    """Fused SwiGLU sublayer: x + down(silu(gate)·up) of rms(x).

    w_gateup int8 [D, 2F] (gate | up) with scales [1, 2F]; w_down int8
    [F, D] with scales [1, D]; b_gateup [2F] or None. x [M, D]. Returns
    [M, D] in x.dtype, or the raw f32 delta when ``residual`` is False."""
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
    _int8_weight(w, "w", d, vocab, dev)
    nw = _f32(norm_w, "norm_w", d, dev)
    sv = _f32(s, "s", vocab, dev)
    lib = _lib("lm_head", lib)
    ntiles = lib.dora_head_tiles(vocab)
    h = torch.empty((m, d), dtype=torch.bfloat16, device=dev)
    tile_val = torch.empty((m, ntiles), dtype=torch.float32, device=dev)
    tile_idx = torch.empty((m, ntiles), dtype=torch.int32, device=dev)
    idx = torch.empty((m,), dtype=torch.int32, device=dev)
    val = torch.empty((m,), dtype=torch.float32, device=dev)
    rc = lib.dora_lm_head_argmax(
        x.data_ptr(), nw.data_ptr(), w.data_ptr(), sv.data_ptr(),
        idx.data_ptr(), val.data_ptr(), m, d, vocab, eps, h.data_ptr(),
        tile_val.data_ptr(), tile_idx.data_ptr(), _build.stream_of(x),
    )
    lm_head_argmax.launches += 1
    _build.check(rc, "lm_head_argmax")
    return (idx, val) if return_val else idx


def lm_head_argmax(x, norm_w, w, s, *, eps: float = 1e-6,
                   return_val: bool = False):
    """Greedy next-token ids of rms(x) @ head without materializing logits.

    x [M, D]; w int8 [D, V] with scales [1, V]. Returns [M] int32 (the first
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
    group = heads // kv_heads
    half = head_dim // 2
    scale = 1.0 / (head_dim ** 0.5)
    _kv_mode(k_pool, k_scale, v_scale)

    h = _rms(x, norm_w, eps).to(dtype)
    qkv = _wdot(h, wqkv, sqkv)
    if bqkv is not None:
        qkv = qkv + bqkv.float().reshape(1, -1)
    q, k, v = _split_qkv(qkv, b, heads, kv_heads, head_dim)
    cos = cos_rows.float()[:, None, :]
    sin = sin_rows.float()[:, None, :]
    q = _rotate(q, cos, sin, half)
    k = _rotate(k, cos, sin, half)

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
    qg = q.reshape(b, kv_heads, group, head_dim)
    s = torch.einsum("bkgd,bksd->bkgs", qg.to(dtype).float(), ctx_k.float()) * scale
    live = torch.arange(n_ctx, device=x.device)[None, :] < pos[:, None]
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)  # -inf for a row with no prior context
    p = torch.exp(s - torch.where(torch.isinf(m), torch.zeros_like(m), m))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgs,bksd->bkgd", p.to(dtype).float(), ctx_v.float())

    # Fold in the current position from f32 (the reference's exact merge),
    # never from the pool row just written.
    s_new = (qg * k[:, :, None, :]).sum(dim=-1, keepdim=True) * scale
    m2 = torch.maximum(m, s_new)
    alpha = torch.exp(m - m2)
    w_new = torch.exp(s_new - m2)
    attn = (acc * alpha + w_new * v[:, :, None, :]) / (l * alpha + w_new)
    o = _wdot(attn.reshape(b, heads * head_dim).to(dtype), wo, swo)
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
    _attn_shapes(heads, kv_heads, head_dim, page)
    _need(x, "x", torch.bfloat16, (b, d), dev)
    _int8_weight(wqkv, "wqkv", d, n_qkv, dev)
    _int8_weight(wo, "wo", heads * head_dim, d, dev)
    _need_pools(k_pool, v_pool, k_scale, v_scale, kv_heads, head_dim, dev)
    _need(positions, "positions", torch.int32, (b,), dev)
    _need(block_tables, "block_tables", torch.int32, (b, max_pages), dev)
    _need(cos_rows, "cos_rows", torch.float32, (b, head_dim), dev)
    _need(sin_rows, "sin_rows", torch.float32, (b, head_dim), dev)
    if not x.is_cuda:
        _check_host_indices(positions, 1, block_tables, n_pages, page)
    nw = _f32(norm_w, "norm_w", d, dev)
    sq = _f32(sqkv, "sqkv", n_qkv, dev)
    bq = _f32(bqkv, "bqkv", n_qkv, dev)
    so = _f32(swo, "swo", d, dev)
    lib = _lib("paged_attention", lib)
    ws = max(
        lib.dora_gemm_splits(b, n_qkv, d) * b * n_qkv,
        lib.dora_gemm_splits(b, d, heads * head_dim) * b * d,
    )
    h = torch.empty((b, d), dtype=torch.bfloat16, device=dev)
    p = torch.empty((ws,), dtype=torch.float32, device=dev)
    q = torch.empty((b, heads, head_dim), dtype=torch.float32, device=dev)
    kcur = torch.empty((b, kv_heads, head_dim), dtype=torch.float32, device=dev)
    vcur = torch.empty((b, kv_heads, head_dim), dtype=torch.float32, device=dev)
    attn = torch.empty((b, heads * head_dim), dtype=torch.bfloat16, device=dev)
    out = torch.empty((b, d), dtype=torch.bfloat16 if residual else torch.float32,
                      device=dev)
    rc = lib.dora_attention_paged_batch_step(
        x.data_ptr(), nw.data_ptr(), wqkv.data_ptr(), sq.data_ptr(), _ptr(bq),
        cos_rows.data_ptr(), sin_rows.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), _ptr(k_scale), _ptr(v_scale), wo.data_ptr(),
        so.data_ptr(), positions.data_ptr(), block_tables.data_ptr(),
        out.data_ptr(), int(residual), b, d, heads, kv_heads, max_pages, eps,
        1.0 / (head_dim ** 0.5), h.data_ptr(), p.data_ptr(), q.data_ptr(),
        kcur.data_ptr(), vcur.data_ptr(), attn.data_ptr(), _build.stream_of(x),
    )
    _count(attention_paged_batch_step, q8)
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
    group = heads // kv_heads
    half = head_dim // 2
    scale = 1.0 / (head_dim ** 0.5)
    pos = int(position)
    _kv_mode(k_pool, k_scale, v_scale)

    h = _rms(x, norm_w, eps).to(dtype)
    qkv = _wdot(h, wqkv, sqkv)
    if bqkv is not None:
        qkv = qkv + bqkv.float().reshape(1, -1)
    q, k, v = _split_qkv(qkv, m, heads, kv_heads, head_dim)
    cos = cos_rows.float()[:, None, :]
    sin = sin_rows.float()[:, None, :]
    q = _rotate(q, cos, sin, half)
    k = _rotate(k, cos, sin, half)

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
        kv_heads, pos, head_dim)
    prior_v = _kv_rows(v_pool, v_scale, prior, dtype).transpose(0, 1).reshape(
        kv_heads, pos, head_dim)
    keys = torch.cat([prior_k, k.transpose(0, 1).to(dtype)], dim=1).float()
    vals = torch.cat([prior_v, v.transpose(0, 1).to(dtype)], dim=1).float()
    qg = q.to(dtype).float().reshape(m, kv_heads, group, head_dim).transpose(0, 1)
    s = torch.einsum("kmgd,ksd->kmgs", qg, keys) * scale
    kidx = torch.arange(pos + m, device=x.device)
    live = kidx[None, :] <= pos + torch.arange(m, device=x.device)[:, None]
    s = s.masked_fill(~live[None, :, None, :], float("-inf"))
    mx = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)  # the sweep starts at -1e30
    p = torch.exp(s - mx)
    attn = torch.einsum("kmgs,ksd->kmgd", p.to(dtype).float(), vals) / p.sum(dim=-1, keepdim=True)
    attn = attn.transpose(0, 1).reshape(m, heads * head_dim)
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
    _attn_shapes(heads, kv_heads, head_dim, page)
    if pos % page or m % page:
        raise ValueError(f"chunk position {pos} and rows {m} must be multiples of page {page}")
    if pos + m > block_table.shape[0] * page:
        raise ValueError(f"chunk {pos}+{m} runs past the block table")
    _need(x, "x", torch.bfloat16, (m, d), dev)
    _int8_weight(wqkv, "wqkv", d, n_qkv, dev)
    _int8_weight(wo, "wo", heads * head_dim, d, dev)
    _need_pools(k_pool, v_pool, k_scale, v_scale, kv_heads, head_dim, dev)
    _need(block_table, "block_table", torch.int32, (block_table.shape[-1],), dev)
    _need(cos_rows, "cos_rows", torch.float32, (m, head_dim), dev)
    _need(sin_rows, "sin_rows", torch.float32, (m, head_dim), dev)
    if not x.is_cuda:
        _check_host_indices(torch.tensor([pos]), m, block_table, n_pages, page)
    nw = _f32(norm_w, "norm_w", d, dev)
    sq = _f32(sqkv, "sqkv", n_qkv, dev)
    bq = _f32(bqkv, "bqkv", n_qkv, dev)
    so = _f32(swo, "swo", d, dev)
    lib = _lib("paged_attention", lib)
    ws = max(
        lib.dora_gemm_splits(m, n_qkv, d) * m * n_qkv,
        lib.dora_gemm_splits(m, d, heads * head_dim) * m * d,
    )
    h = torch.empty((m, d), dtype=torch.bfloat16, device=dev)
    p = torch.empty((ws,), dtype=torch.float32, device=dev)
    q = torch.empty((m, heads, head_dim), dtype=torch.float32, device=dev)
    # the int8 form folds the chunk's own rows from f32 scratch
    kcur = vcur = None
    if q8:
        kcur = torch.empty((m, kv_heads, head_dim), dtype=torch.float32, device=dev)
        vcur = torch.empty((m, kv_heads, head_dim), dtype=torch.float32, device=dev)
    attn = torch.empty((m, heads * head_dim), dtype=torch.bfloat16, device=dev)
    out = torch.empty((m, d), dtype=torch.bfloat16 if residual else torch.float32,
                      device=dev)
    rc = lib.dora_attention_paged_chunk_step(
        x.data_ptr(), nw.data_ptr(), wqkv.data_ptr(), sq.data_ptr(), _ptr(bq),
        cos_rows.data_ptr(), sin_rows.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), _ptr(k_scale), _ptr(v_scale), wo.data_ptr(),
        so.data_ptr(), pos, block_table.data_ptr(), out.data_ptr(),
        int(residual), m, d, heads, kv_heads, eps, 1.0 / (head_dim ** 0.5),
        h.data_ptr(), p.data_ptr(), q.data_ptr(), _ptr(kcur), _ptr(vcur),
        attn.data_ptr(), _build.stream_of(x),
    )
    _count(attention_paged_chunk_step, q8)
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
    group = heads // kv_heads
    half = head_dim // 2
    scale = 1.0 / (head_dim ** 0.5)
    rows = m * group  # query rows per (stream, kv head), ordered (i, head)
    _kv_mode(k_pool, k_scale, v_scale)

    h = _rms(x, norm_w, eps).to(dtype)
    qkv = _wdot(h, wqkv, sqkv)
    if bqkv is not None:
        qkv = qkv + bqkv.float().reshape(1, -1)
    q, k, v = _split_qkv(qkv, bm, heads, kv_heads, head_dim)
    cos = cos_rows.float()[:, None, :]
    sin = sin_rows.float()[:, None, :]
    q = _rotate(q, cos, sin, half)
    k = _rotate(k, cos, sin, half)

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
    own_k = k.reshape(b, m, kv_heads, head_dim).transpose(1, 2)
    own_v = v.reshape(b, m, kv_heads, head_dim).transpose(1, 2)
    keys = torch.cat([ctx_k, own_k.to(dtype)], dim=2).float()
    vals = torch.cat([ctx_v, own_v.to(dtype)], dim=2).float()
    qg = q.to(dtype).float().reshape(b, m, kv_heads, group, head_dim)
    qg = qg.permute(0, 2, 1, 3, 4).reshape(b, kv_heads, rows, head_dim)
    s = torch.einsum("bkrd,bksd->bkrs", qg, keys) * scale
    live_ctx = torch.arange(n_ctx, device=x.device)[None, :] < pos[:, None]  # [B, n_ctx]
    cand = torch.arange(rows, device=x.device) // group
    causal = torch.arange(m, device=x.device)[None, :] <= cand[:, None]  # [rows, m]
    live = torch.cat([live_ctx[:, None, :].expand(b, rows, n_ctx),
                      causal[None].expand(b, rows, m)], dim=2)
    s = s.masked_fill(~live[:, None], float("-inf"))
    mx = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)  # the sweep starts at -1e30
    p = torch.exp(s - mx)
    attn = torch.einsum("bkrs,bksd->bkrd", p.to(dtype).float(), vals) / p.sum(dim=-1, keepdim=True)
    attn = attn.reshape(b, kv_heads, m, group, head_dim).permute(0, 2, 1, 3, 4)
    o = _wdot(attn.reshape(bm, heads * head_dim).to(dtype), wo, swo)
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
    _attn_shapes(heads, kv_heads, head_dim, page)
    if not 1 <= m <= page:
        raise ValueError(f"spec kernel takes 1 <= m <= page {page} candidate rows, got {m}")
    if m * (heads // kv_heads) > KERNEL_SPEC_MAX_ROWS:
        raise ValueError(f"spec kernel takes m * group <= {KERNEL_SPEC_MAX_ROWS}, "
                         f"got {m} * {heads // kv_heads}")
    if bm % m or positions.shape != (bm // m,):
        raise ValueError(f"x has {bm} rows: expected m = {m} rows for each of the "
                         f"{tuple(positions.shape)} positions")
    b = bm // m
    max_pages = block_tables.shape[-1]
    _need(x, "x", torch.bfloat16, (bm, d), dev)
    _int8_weight(wqkv, "wqkv", d, n_qkv, dev)
    _int8_weight(wo, "wo", heads * head_dim, d, dev)
    _need_pools(k_pool, v_pool, k_scale, v_scale, kv_heads, head_dim, dev)
    _need(positions, "positions", torch.int32, (b,), dev)
    _need(block_tables, "block_tables", torch.int32, (b, max_pages), dev)
    _need(cos_rows, "cos_rows", torch.float32, (bm, head_dim), dev)
    _need(sin_rows, "sin_rows", torch.float32, (bm, head_dim), dev)
    if not x.is_cuda:
        _check_host_indices(positions, m, block_tables, n_pages, page)
    nw = _f32(norm_w, "norm_w", d, dev)
    sq = _f32(sqkv, "sqkv", n_qkv, dev)
    bq = _f32(bqkv, "bqkv", n_qkv, dev)
    so = _f32(swo, "swo", d, dev)
    lib = _lib("paged_attention", lib)
    ws = max(
        lib.dora_gemm_splits(bm, n_qkv, d) * bm * n_qkv,
        lib.dora_gemm_splits(bm, d, heads * head_dim) * bm * d,
    )
    h = torch.empty((bm, d), dtype=torch.bfloat16, device=dev)
    p = torch.empty((ws,), dtype=torch.float32, device=dev)
    q = torch.empty((bm, heads, head_dim), dtype=torch.float32, device=dev)
    kcur = torch.empty((bm, kv_heads, head_dim), dtype=torch.float32, device=dev)
    vcur = torch.empty((bm, kv_heads, head_dim), dtype=torch.float32, device=dev)
    attn = torch.empty((bm, heads * head_dim), dtype=torch.bfloat16, device=dev)
    out = torch.empty((bm, d), dtype=torch.bfloat16 if residual else torch.float32,
                      device=dev)
    rc = lib.dora_attention_paged_spec_step(
        x.data_ptr(), nw.data_ptr(), wqkv.data_ptr(), sq.data_ptr(), _ptr(bq),
        cos_rows.data_ptr(), sin_rows.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), _ptr(k_scale), _ptr(v_scale), wo.data_ptr(),
        so.data_ptr(), positions.data_ptr(), block_tables.data_ptr(),
        out.data_ptr(), int(residual), b, m, d, heads, kv_heads, max_pages, eps,
        1.0 / (head_dim ** 0.5), h.data_ptr(), p.data_ptr(), q.data_ptr(),
        kcur.data_ptr(), vcur.data_ptr(), attn.data_ptr(), _build.stream_of(x),
    )
    _count(attention_paged_spec_step, q8)
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


#: the kernel wrappers of the paged serving path, in the order a layer runs them
KERNELS = (attention_paged_chunk_step, attention_paged_batch_step,
           attention_paged_spec_step, mlp_step, lm_head_argmax)
#: the wrappers that also launch an int8-KV form, counted apart as
#: ``launches_int8kv`` (``launches`` counts their fp form)
KV_INT8_KERNELS = (attention_paged_chunk_step, attention_paged_batch_step,
                   attention_paged_spec_step)


def _count(fn, int8kv: bool) -> None:
    if int8kv:
        fn.launches_int8kv += 1
    else:
        fn.launches += 1


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0
    for fn in KV_INT8_KERNELS:
        fn.launches_int8kv = 0


def launch_counts() -> dict[str, int]:
    """Launches per kernel since :func:`reset_launches`, the int8-KV forms
    as ``<name>_int8kv``."""
    counts = {fn.__name__: fn.launches for fn in KERNELS}
    counts.update({f"{fn.__name__}_int8kv": fn.launches_int8kv for fn in KV_INT8_KERNELS})
    return counts


reset_launches()
