"""The fused paged decode passes and the K-tick decode window.

Counterpart of the paged serving part of dora_tpu/models/vlm.py
(``_qw``, ``_fused_pass``, ``fused_paged_pass_batch``,
``fused_paged_pass_chunk``, ``fused_batch_ready``, ``make_paged_window``).
Each layer runs one attention kernel and ``mlp_step``; the pass ends in
``lm_head_argmax`` (ops/decode_block.py). The vision tower, training and
the dense and speculative passes are not ported yet.
"""

from __future__ import annotations

import torch

from dora_tpu_torch.ops import decode_block as DB


def _qw(d: dict):
    """Quantized dict -> (weights, scales) in the kernel layout."""
    return d["int8"], d["scale"]


def fused_batch_ready(params) -> bool:
    """True when params hold the int8 fused layout of ``quantize_decode``
    (wqkv / w_gateup / wo / w_down / lm_head) and no output-projection
    biases, which the fused passes need."""
    blk = params.get("blocks", {}).get("0")
    if blk is None:
        return False

    def _q(x):
        return isinstance(x, dict) and "int8" in x

    return (
        _q(blk.get("wqkv"))
        and _q(blk.get("w_gateup"))
        and _q(blk.get("wo"))
        and _q(blk.get("w_down"))
        and _q(params.get("lm_head"))
        and "bo" not in blk
        and "b_down" not in blk
    )


def _fused_pass(params, x, attn_apply, *, layers: int, eps: float):
    """Shared skeleton of the fused passes: per layer ``attn_apply(i, x,
    blk, wqkv, sqkv, bqkv, wo, swo) -> (x, pools entry)`` then the MLP
    kernel; then the streamed lm_head argmax. Absent biases stay None (the
    kernels skip them; the reference adds zeros)."""
    new_pools = {}
    for i in range(layers):
        blk = params["blocks"][str(i)]
        wqkv, sqkv = _qw(blk["wqkv"])
        wo, swo = _qw(blk["wo"])
        x, new_pools[str(i)] = attn_apply(
            i, x, blk, wqkv, sqkv, blk.get("bqkv"), wo, swo
        )
        wgu, sgu = _qw(blk["w_gateup"])
        wd, sd = _qw(blk["w_down"])
        x = DB.mlp_step(x, blk["ffn_norm"], wgu, sgu, blk.get("b_gateup"), wd,
                        sd, eps=eps)
    wh, sh = _qw(params["lm_head"])
    greedy = DB.lm_head_argmax(x, params["out_norm"], wh, sh, eps=eps)
    return greedy, new_pools


def fused_paged_pass_batch(params, x, pools, positions, block_tables,
                           cos_rows, sin_rows, *, heads: int, kv_heads: int,
                           head_dim: int, layers: int, eps: float = 1e-6):
    """Batched fused pass over paged KV pools ``{layer: {k, v}}`` of
    [P, KV, page, hd] blocks; each row's context streams through its
    ``block_tables`` row. Returns (greedy [B], pools)."""

    def attn_apply(i, x, blk, wqkv, sqkv, bqkv, wo, swo):
        lp = pools[str(i)]
        x, kp, vp = DB.attention_paged_batch_step(
            x, blk["attn_norm"], wqkv, sqkv, bqkv, cos_rows, sin_rows,
            lp["k"], lp["v"], wo, swo, positions, block_tables,
            heads=heads, kv_heads=kv_heads, head_dim=head_dim, eps=eps,
        )
        return x, {"k": kp, "v": vp}

    return _fused_pass(params, x, attn_apply, layers=layers, eps=eps)


def fused_paged_pass_chunk(params, x, pools, position, block_table,
                           cos_rows, sin_rows, *, heads: int, kv_heads: int,
                           head_dim: int, layers: int, eps: float = 1e-6):
    """One prefill chunk x [M, dim] at positions ``position..position+M-1``
    (page multiples) through the fused kernels into paged pools. Returns
    (greedy [M], pools); greedy[i] continues the prefix through row i."""

    def attn_apply(i, x, blk, wqkv, sqkv, bqkv, wo, swo):
        lp = pools[str(i)]
        x, kp, vp = DB.attention_paged_chunk_step(
            x, blk["attn_norm"], wqkv, sqkv, bqkv, cos_rows, sin_rows,
            lp["k"], lp["v"], wo, swo, position, block_table,
            heads=heads, kv_heads=kv_heads, head_dim=head_dim, eps=eps,
        )
        return x, {"k": kp, "v": vp}

    return _fused_pass(params, x, attn_apply, layers=layers, eps=eps)


def make_paged_window(step_fn, *, k: int, eos: int | None = None):
    """K-tick decode window over a paged batch step.

    ``window(tokens, pools, positions, bts, active, emitted, max_new) ->
    (mat [B, k+1], tokens, positions, active, emitted, pools)`` runs ``k``
    batched ticks on the device, where the JAX package scans. Completion
    (EOS, or ``emitted >= max_new``) is detected on the device and a
    finished row freezes the same tick (:func:`freeze_inactive`: position 0,
    zeroed block-table row, so its writes go to the null page). ``mat``
    holds the k emitted-token columns (-1 where a row was already frozen)
    and the final active mask as its last column: the host copies it once
    per window. ``step_fn(tokens, pools, positions, bts) -> (greedy [B],
    pools)`` is the family's batched paged step."""

    def window(tokens, pools, positions, bts, active, emitted, max_new):
        cols = []
        for _ in range(k):
            alive = active.to(torch.int32)
            pos_in, bts_in = DB.freeze_inactive(positions, bts, active)
            nxt, pools = step_fn(tokens, pools, pos_in, bts_in)
            cols.append(torch.where(active, nxt, torch.full_like(nxt, -1)))
            emitted = emitted + alive
            done = emitted >= max_new
            if eos is not None:
                done = done | (nxt == eos)
            # A frozen row keeps its last real token and position.
            tokens = torch.where(active, nxt, tokens)
            positions = pos_in + alive
            active = active & ~done
        mat = torch.cat(
            [torch.stack(cols, dim=1), active.to(torch.int32)[:, None]], dim=1
        )
        return mat, tokens, positions, active, emitted, pools

    return window
