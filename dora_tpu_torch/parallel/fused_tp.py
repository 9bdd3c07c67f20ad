"""Tensor-parallel fused decode: the decode kernels over a tp mesh.

Counterpart of dora_tpu/parallel/fused_tp.py. The same three kernels run on
each tp rank over its weight shards (``attention_step`` or
``attention_chunk_step``, then ``mlp_step``, with ``residual=False`` so each
returns its raw f32 partial), one f32 all-reduce SUM per sublayer stitches
the Megatron column / row partials together before the residual add in f32,
and ``lm_head_argmax`` with ``return_val=True`` gives each rank's winner
over its vocab shard: the global token is the smallest global index among
the ranks that hold the all-reduce MAX of the values, JAX's first-index
tie-break.

Layout (:func:`prepare_decode_params`, this rank's shards):

* ``wqkv`` [D, (H+2KV)*hd]: columns permuted into rank-block order (rank r
  holds ``[q_r | k_r | v_r]``, its local heads' fused weight), then this
  rank's block; its scales and bias likewise.
* ``wo`` [H*hd, D]: rows are head-major, so rank r's rows are its heads.
* ``w_gateup`` [D, 2F]: ``[gate | up]`` permuted to ``[gate_r | up_r]``;
  ``w_down`` [F, D] rows to match.
* ``lm_head`` [D, V]: vocab columns.
* KV caches (:func:`shard_caches`): the kv-head axis.

Where the JAX package places the global arrays for ``shard_map``, these
return this rank's local blocks.
"""

from __future__ import annotations

import numpy as np
import torch

from dora_tpu_torch.parallel import comm

AXIS = "tp"


def tp_degree(mesh) -> int:
    if mesh is None:
        return 1
    return mesh.shape.get(AXIS, 1)


def tp_compatible(tp: int, *, heads: int, kv_heads: int, ffn: int, vocab: int) -> bool:
    """True when the fused kernel tier can shard over ``tp`` ranks: every
    partitioned dimension must tile (kv_heads caps tp for GQA models)."""
    return (
        tp > 1
        and heads % tp == 0
        and kv_heads % tp == 0
        and ffn % tp == 0
        and vocab % tp == 0
    )


# ---------------------------------------------------------------------------
# column permutations (rank-block order)
# ---------------------------------------------------------------------------


def _perm_qkv(heads: int, kv_heads: int, head_dim: int, tp: int):
    """Column permutation [q|k|v] -> [q_0|k_0|v_0 | q_1|k_1|v_1 | ...]."""
    hl, kvl = heads // tp, kv_heads // tp
    q0, k0 = 0, heads * head_dim
    v0 = k0 + kv_heads * head_dim
    idx = []
    for r in range(tp):
        idx.append(np.arange(q0 + r * hl * head_dim, q0 + (r + 1) * hl * head_dim))
        idx.append(np.arange(k0 + r * kvl * head_dim, k0 + (r + 1) * kvl * head_dim))
        idx.append(np.arange(v0 + r * kvl * head_dim, v0 + (r + 1) * kvl * head_dim))
    return np.concatenate(idx)


def _perm_gateup(ffn: int, tp: int):
    """[gate|up] -> [gate_0|up_0 | gate_1|up_1 | ...]."""
    fl = ffn // tp
    idx = []
    for r in range(tp):
        idx.append(np.arange(r * fl, (r + 1) * fl))
        idx.append(np.arange(ffn + r * fl, ffn + (r + 1) * fl))
    return np.concatenate(idx)


# ---------------------------------------------------------------------------
# parameter prep
# ---------------------------------------------------------------------------


def _qw(d: dict):
    if "int4" in d:
        return d["int4"], d["gscale"]
    return d["int8"], d["scale"]


def _check_row_groups(w, s, tp: int, what: str) -> None:
    """int4 row-sharding must slice whole nibble-pack groups."""
    if w.dtype == torch.uint8:
        k = 2 * w.shape[0]
        group = k // s.shape[0]
        if (k // tp) % group:
            raise ValueError(
                f"{what}: K={k} over tp={tp} does not tile int4 "
                f"groups of {group}"
            )


def prepare_decode_params(params, mesh, *, heads: int, kv_heads: int, head_dim: int,
                          layers: int, eps: float = 1e-6):
    """Quantized fused-layout params -> this rank's tp decode tree.

    Input is the ``quantize_decode`` tree (fused wqkv / w_gateup dicts, int8
    or int4). Output is a flat-per-block tree of tensors (the ``_qw``
    dispatch resolved) with columns permuted into rank-block order and each
    leaf this rank's block of it (a contiguous tensor of its own). bf16
    prefill sidecars are not carried: prefill runs on the original tree."""
    del eps
    tp = tp_degree(mesh)
    r = 0 if mesh is None else mesh.index(AXIS)

    def block(t, dim):
        return t.chunk(tp, dim=dim)[r].contiguous().clone()

    def cols(t, perm=None):
        return block(t if perm is None else t[..., torch.as_tensor(perm, device=t.device)], -1)

    pq = _perm_qkv(heads, kv_heads, head_dim, tp)
    out = {"blocks": {}}
    for i in range(layers):
        blk = params["blocks"][str(i)]
        wqkv, sqkv = _qw(blk["wqkv"])
        wo, swo = _qw(blk["wo"])
        wgu, sgu = _qw(blk["w_gateup"])
        wd, sd = _qw(blk["w_down"])
        _check_row_groups(wo, swo, tp, f"blocks.{i}.wo")
        _check_row_groups(wd, sd, tp, f"blocks.{i}.w_down")
        ffn = wd.shape[0] * (2 if "int4" in blk["w_down"] else 1)
        pgu = _perm_gateup(ffn, tp)
        n_qkv = (heads + 2 * kv_heads) * head_dim
        dev = wqkv.device
        bqkv = blk.get("bqkv")
        if bqkv is None:
            bqkv = torch.zeros((n_qkv,), dtype=torch.float32, device=dev)
        bgu = blk.get("b_gateup")
        if bgu is None:
            bgu = torch.zeros((2 * ffn,), dtype=torch.float32, device=dev)
        out["blocks"][str(i)] = {
            "attn_norm": blk["attn_norm"].clone(),
            "wqkv": cols(wqkv, pq),
            "sqkv": cols(sqkv, pq),
            "bqkv": cols(bqkv, pq),
            "wo": block(wo, 0),
            "swo": block(swo, 0) if swo.shape[0] > 1 else swo.clone(),
            "ffn_norm": blk["ffn_norm"].clone(),
            "wgu": cols(wgu, pgu),
            "sgu": cols(sgu, pgu),
            "bgu": cols(bgu, pgu),
            "wd": block(wd, 0),
            "sd": block(sd, 0) if sd.shape[0] > 1 else sd.clone(),
        }
    wh, sh = _qw(params["lm_head"])
    out["out_norm"] = params["out_norm"].clone()
    out["wh"] = cols(wh)
    out["sh"] = cols(sh)
    return out


def shard_caches(caches, mesh):
    """This rank's block of a cache tree {layer: {k, v}} [B, KV, S, hd]: the
    kv heads it serves, as contiguous tensors of its own."""
    tp = tp_degree(mesh)
    r = 0 if mesh is None else mesh.index(AXIS)
    return {
        name: {kv: x.chunk(tp, dim=1)[r].contiguous().clone() for kv, x in layer.items()}
        for name, layer in caches.items()
    }


# ---------------------------------------------------------------------------
# the tp pass
# ---------------------------------------------------------------------------


def decode_pass_tp(params_tp, x, caches, position: int, cos_rows, sin_rows, *, heads: int,
                   kv_heads: int, head_dim: int, layers: int, mesh, eps: float = 1e-6):
    """M-row fused greedy pass over the tp mesh, this rank's share of it.

    Mirrors ``models/vlm.fused_decode_pass``: x [M, D] embedded rows (the
    same on every rank), cos / sin [M, hd] rope rows, caches this rank's
    [1, KV/tp, S, hd] per layer (updated in place). Returns (greedy [M]
    int32, the same on every rank, and the caches)."""
    from dora_tpu_torch.ops import decode_block as DB

    tp = tp_degree(mesh)
    r = 0 if mesh is None else mesh.index(AXIS)
    heads_l, kv_l = heads // tp, kv_heads // tp
    vocab_l = params_tp["wh"].shape[1]
    attn = DB.attention_step if x.shape[0] == 1 else DB.attention_chunk_step
    new_caches = {}
    for i in range(layers):
        blk = params_tp["blocks"][str(i)]
        kc = caches[str(i)]["k"][0]  # [KV_l, S, hd], a view of the cache
        vc = caches[str(i)]["v"][0]
        o, kc, vc = attn(
            x, blk["attn_norm"], blk["wqkv"], blk["sqkv"], blk["bqkv"], cos_rows, sin_rows,
            kc, vc, blk["wo"], blk["swo"], position, heads=heads_l, kv_heads=kv_l,
            head_dim=head_dim, eps=eps, residual=False,
        )
        o = comm.all_reduce(o, mesh, AXIS)
        x = (x.float() + o).to(x.dtype)
        new_caches[str(i)] = {"k": kc[None], "v": vc[None]}
        a = DB.mlp_step(x, blk["ffn_norm"], blk["wgu"], blk["sgu"], blk["bgu"], blk["wd"],
                        blk["sd"], eps=eps, residual=False)
        a = comm.all_reduce(a, mesh, AXIS)
        x = (x.float() + a).to(x.dtype)
    idx, val = DB.lm_head_argmax(x, params_tp["out_norm"], params_tp["wh"], params_tp["sh"],
                                 eps=eps, return_val=True)
    # The global argmax with the first-index tie-break: among the ranks that
    # hold the global max, the smallest global index wins.
    gmax = comm.all_reduce(val, mesh, AXIS, "max")
    cand = torch.where(val >= gmax, idx + r * vocab_l,
                       torch.full_like(idx, torch.iinfo(torch.int32).max))
    return comm.all_reduce(cand, mesh, AXIS, "min").to(torch.int32), new_caches


__all__ = ["decode_pass_tp", "prepare_decode_params", "shard_caches", "tp_compatible",
           "tp_degree"]
