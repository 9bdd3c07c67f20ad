"""Int8 weight quantization in the fused decode layout.

Counterpart of dora_tpu/ops/int8_matmul.py: symmetric per-output-channel
int8 (``w ~ q * scale[None, :]``, q in [-127, 127]), and the parameter-tree
walk that fuses q/k/v and gate/up into single ``wqkv`` / ``w_gateup``
weights. ``torch.round`` and ``jnp.round`` both round half to even, so the
payloads and scales are byte-identical to the JAX package's.

Not ported here: the ``bf16`` sidecar (``keep_bf16``), which only the
unfused large-M paths read, and the ``int8_matmul`` kernel itself, which the
paged serving path never calls (its weights go through the fused kernels of
ops/decode_block.py).
"""

from __future__ import annotations

import torch

#: Weight leaves worth quantizing in a decode path: the per-token matmul set.
DECODE_WEIGHTS = frozenset(
    {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head"}
)


def quantize_int8(w: torch.Tensor) -> dict:
    """[K, N] float -> {"int8": [K, N] int8, "scale": [1, N] f32}."""
    wf = w.float()
    scale = wf.abs().amax(dim=0, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    # A transposed input (a tied head, embed.T) would keep its strides.
    return {"int8": q.contiguous(), "scale": scale}


def dequantize(wq: dict, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (wq["int8"].float() * wq["scale"]).to(dtype)


def _fusable(params: dict, names) -> bool:
    return all(
        n in params
        and isinstance(params[n], torch.Tensor)
        and params[n].ndim == 2
        for n in names
    )


def _fuse(params, out, w_names, b_names, w_key, b_key) -> None:
    """Concatenate the named projections along N into one quantized weight;
    biases concatenate with zero fill for absent segments."""
    ws = [params[n] for n in w_names]
    out[w_key] = quantize_int8(torch.cat(ws, dim=1))
    if any(b in params for b in b_names):
        out[b_key] = torch.cat(
            [
                params[b].float()
                if b in params
                else torch.zeros(w.shape[1], dtype=torch.float32, device=w.device)
                for b, w in zip(b_names, ws)
            ]
        )


def quantize_tree(params, names=DECODE_WEIGHTS, fuse: bool = True):
    """Replace named 2-D float weight leaves with quantized dicts.

    Walks nested dicts; already-quantized dicts pass through. With ``fuse``,
    co-resident q/k/v and gate/up projections become ``wqkv`` (+ ``bqkv``)
    and ``w_gateup`` (+ ``b_gateup``), in that concatenation order."""
    if not isinstance(params, dict):
        return params
    if "int8" in params:
        return params
    out: dict = {}
    skip: set[str] = set()
    if fuse and {"wq", "wk", "wv"} <= names and _fusable(params, ("wq", "wk", "wv")):
        _fuse(params, out, ("wq", "wk", "wv"), ("bq", "bk", "bv"), "wqkv", "bqkv")
        skip |= {"wq", "wk", "wv", "bq", "bk", "bv"}
    if fuse and {"w_gate", "w_up"} <= names and _fusable(params, ("w_gate", "w_up")):
        _fuse(params, out, ("w_gate", "w_up"), ("b_gate", "b_up"),
              "w_gateup", "b_gateup")
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
            out[key] = quantize_int8(value)
        else:
            out[key] = quantize_tree(value, names, fuse)
    return out
