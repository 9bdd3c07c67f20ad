"""Int8 weight quantization in the fused decode layout, and the int8 product.

Counterpart of dora_tpu/ops/int8_matmul.py: symmetric per-output-channel
int8 (``w ~ q * scale[None, :]``, q in [-127, 127]), the parameter-tree
walk that fuses q/k/v and gate/up into single ``wqkv`` / ``w_gateup``
weights, and ``int8_matmul``, ``x @ dequantize(q, scale)`` with int8-only
weight traffic. ``torch.round`` and ``jnp.round`` both round half to even,
and f32 -> bf16 rounds to nearest even in both, so the payloads, scales and
``bf16`` sidecars (``keep_bf16``: the original weight in bf16, which the
large-M products of models/layers.matmul read) are byte-identical to the
JAX package's.

``int8_matmul`` comes in two versions, as the kernels of
ops/decode_block.py do: :func:`int8_matmul_plain` (plain PyTorch, f32
accumulation; the CPU path and the card's oracle) and the hand-written CUDA
kernel of ``csrc/int8_matmul.cu`` (the tensor-core int8-weight product of
kernels 1 and 2, whose K splits the library reports), which
:func:`int8_matmul` launches for CUDA tensors (counted in its
``launches``). Nothing falls back: a CUDA tensor the kernel does not take
raises.
"""

from __future__ import annotations

import torch

from dora_tpu_torch.ops import _build

_SIGNATURES = {
    "int8_matmul": {
        "dora_int8_matmul_splits": [_build.I] * 3,
        "dora_int8_matmul": [_build.P] * 4 + [_build.I] * 3 + [_build.P] * 2,
    },
}

#: Weight leaves worth quantizing in a decode path: the per-token matmul set.
DECODE_WEIGHTS = frozenset(
    {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"}
)


def quantize_int8(w: torch.Tensor, keep_bf16: bool = False) -> dict:
    """[K, N] float -> {"int8": [K, N] int8, "scale": [1, N] f32}, with
    ``keep_bf16`` also {"bf16": w in bf16} for the large-M products."""
    wf = w.float()
    scale = wf.abs().amax(dim=0, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    # A transposed input (a tied head, embed.T) would keep its strides.
    out = {"int8": q.contiguous(), "scale": scale}
    if keep_bf16:
        out["bf16"] = w.to(torch.bfloat16).contiguous()
    return out


def dequantize(wq: dict, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (wq["int8"].float() * wq["scale"]).to(dtype)


def _fusable(params: dict, names) -> bool:
    return all(
        n in params
        and isinstance(params[n], torch.Tensor)
        and params[n].ndim == 2
        for n in names
    )


def _fuse(params, out, w_names, b_names, w_key, b_key, keep_bf16, quantizer) -> None:
    """Concatenate the named projections along N into one quantized weight;
    biases concatenate with zero fill for absent segments."""
    ws = [params[n] for n in w_names]
    out[w_key] = quantizer(torch.cat(ws, dim=1), keep_bf16)
    if any(b in params for b in b_names):
        out[b_key] = torch.cat(
            [
                params[b].float()
                if b in params
                else torch.zeros(w.shape[1], dtype=torch.float32, device=w.device)
                for b, w in zip(b_names, ws)
            ]
        )


def quantize_tree(params, names=DECODE_WEIGHTS, keep_bf16: bool = True,
                  fuse: bool = True, quantizer=quantize_int8):
    """Replace named 2-D float weight leaves with quantized dicts.

    Walks nested dicts; already-quantized dicts (int8 or int4) pass through.
    With ``fuse``, co-resident q/k/v and gate/up projections become ``wqkv``
    (+ ``bqkv``) and ``w_gateup`` (+ ``b_gateup``), in that concatenation
    order. ``keep_bf16`` keeps each weight's bf16 sidecar (see
    :func:`quantize_int8`), as the JAX package does by default.
    ``quantizer`` picks the weight format: :func:`quantize_int8`, or
    ops/int4.quantize_int4."""
    if not isinstance(params, dict):
        return params
    if "int8" in params or "int4" in params:
        return params
    out: dict = {}
    skip: set[str] = set()
    if fuse and {"wq", "wk", "wv"} <= names and _fusable(params, ("wq", "wk", "wv")):
        _fuse(params, out, ("wq", "wk", "wv"), ("bq", "bk", "bv"), "wqkv", "bqkv",
              keep_bf16, quantizer)
        skip |= {"wq", "wk", "wv", "bq", "bk", "bv"}
    if fuse and {"w_gate", "w_up"} <= names and _fusable(params, ("w_gate", "w_up")):
        _fuse(params, out, ("w_gate", "w_up"), ("b_gate", "b_up"),
              "w_gateup", "b_gateup", keep_bf16, quantizer)
        skip |= {"w_gate", "w_up", "b_gate", "b_up"}
    for key, value in params.items():
        if key in skip:
            continue
        if (
            key in names
            and isinstance(value, torch.Tensor)
            and value.ndim == 2
            and value.is_floating_point()
        ):
            out[key] = quantizer(value, keep_bf16)
        else:
            out[key] = quantize_tree(value, names, keep_bf16, fuse, quantizer)
    return out


# ---------------------------------------------------------------------------
# the int8 product
# ---------------------------------------------------------------------------


def int8_matmul_plain(x, q, scale):
    """``x @ q`` in f32 with the per-column scale on the accumulator, in
    x.dtype: the reference order. x holds compute-dtype values, exact in
    f32, so the f32 product is the TPU kernel's preferred_element_type=f32
    dot up to summation order."""
    acc = x.float() @ q.float()
    return (acc * scale.float().reshape(-1)).to(x.dtype)


def _int8_matmul_kernel(x, q, scale, lib=None):
    from dora_tpu_torch.ops.decode_block import _aligned16, _f32, _need

    dev = x.device
    *lead, k = x.shape
    n = q.shape[-1]
    x2 = x.reshape(-1, k).contiguous()  # a view of strided rows (h[:, -1]) packs
    m = x2.shape[0]
    _need(x2, "x", torch.bfloat16, (m, k), dev)
    _need(q, "q", torch.int8, (k, n), dev)
    _aligned16(q, "q")
    s = _f32(scale, "scale", n, dev)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    if m == 0:
        return out.reshape(*lead, n)
    lib = lib if lib is not None else _build.library("int8_matmul",
                                                     _SIGNATURES["int8_matmul"])
    # f32 partials only where K is split; one split writes bf16 directly
    splits = lib.dora_int8_matmul_splits(m, n, k)
    p = torch.empty((splits * m * n,), dtype=torch.float32, device=dev) if splits > 1 else None
    rc = lib.dora_int8_matmul(x2.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                              m, n, k, None if p is None else p.data_ptr(),
                              _build.stream_of(x))
    int8_matmul.launches += 1
    _build.check(rc, "int8_matmul")
    return out.reshape(*lead, n)


def int8_matmul(x, q, scale):
    """``x @ dequantize(q, scale)`` reading the int8 weight only.

    x [..., K] (bf16 on the card); q int8 [K, N]; scale [1, N] f32. Returns
    [..., N] in x.dtype from f32 accumulation, the scale applied to the
    accumulator. Any M, K and N."""
    if not x.is_cuda:
        return int8_matmul_plain(x, q, scale)
    return _int8_matmul_kernel(x, q, scale)


int8_matmul.launches = 0


def reset_launches() -> None:
    int8_matmul.launches = 0
