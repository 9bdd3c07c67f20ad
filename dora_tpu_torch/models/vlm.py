"""The fused decode passes and the K-tick decode window.

Counterpart of the fused-tier part of dora_tpu/models/vlm.py (``_qw``,
``_fused_pass``, ``fused_decode_ready``, ``fused_batch_ready``, the
dense-cache passes ``fused_decode_pass`` (batch 1: one row, or a
speculative verify's rows) and ``fused_decode_pass_batch`` (the dense
engine), the paged ``fused_paged_pass_batch``, ``fused_paged_pass_chunk``,
``fused_paged_pass_spec``, ``make_paged_window``, ``make_paged_spec_window``,
``window_row_stats``, ``spec_window_row_stats``). Each layer runs one
attention kernel and ``mlp_step``, then, with multi-tenant LoRA,
``lora_gather_matmul``; the pass ends in ``lm_head_argmax``
(ops/decode_block.py, ops/lora.py). Pools hold fp pages, or int8 pages with
their ``ks``/``vs`` scale planes, which select the kernels' int8-KV forms.
The vision tower, training and the ``VLMConfig`` decode functions
(``decode_step_fused`` and the rest) are not ported yet.
"""

from __future__ import annotations

import os

import torch

from dora_tpu_torch.ops import decode_block as DB
from dora_tpu_torch.ops import lora as LO


def _qw(d: dict):
    """Quantized dict -> (weights, scales) in the kernel layout."""
    return d["int8"], d["scale"]


def fused_decode_ready(params, batch: int = 1) -> bool:
    """True when a decode step can run the fused tier: batch 1, params in
    the int8 fused layout of ``quantize_decode`` (wqkv / w_gateup / wo /
    w_down / lm_head) and no output-projection biases. Opt-out:
    ``DORA_FUSED_DECODE=0`` (or empty), as in the JAX package."""
    if os.environ.get("DORA_FUSED_DECODE", "1") in ("", "0"):
        return False
    if batch != 1:
        return False
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


def fused_batch_ready(params) -> bool:
    """True when the batched fused tier can serve (the dense and paged
    engines): :func:`fused_decode_ready` without its batch-1 gate."""
    return fused_decode_ready(params, 1)


def _fused_pass(params, x, attn_apply, *, layers: int, eps: float, lora=None):
    """Shared skeleton of the fused passes: per layer ``attn_apply(i, x,
    blk, wqkv, sqkv, bqkv, wo, swo) -> (x, pools entry)`` then the MLP
    kernel; then the streamed lm_head argmax. Absent biases stay None (the
    kernels skip them; the reference adds zeros).

    ``lora`` is ``(groups [R], a_stack [S, L, D, r], b_stack [S, L, r, D])``:
    after each layer's MLP every row adds its adapter's rank-r delta,
    gathered by id (slot 0 the all-zeros base) and rounded to x's dtype
    before the add."""
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
        if lora is not None:
            groups, a_stack, b_stack = lora
            x = x + LO.lora_gather_matmul(x, groups, a_stack[:, i],
                                          b_stack[:, i]).to(x.dtype)
    wh, sh = _qw(params["lm_head"])
    greedy = DB.lm_head_argmax(x, params["out_norm"], wh, sh, eps=eps)
    return greedy, new_pools


def fused_decode_pass(params, x, caches, position: int, cos_rows, sin_rows, *,
                      heads: int, kv_heads: int, head_dim: int, layers: int,
                      eps: float = 1e-6):
    """Batch-1 fused pass over dense caches {layer: {k, v}} [1, KV, S, hd]:
    x [M, dim] holds the embedded tokens at positions ``position..position+
    M-1`` with their rope rows. One row runs ``attention_step``, more rows
    (a speculative verify) ``attention_chunk_step``. Returns (greedy [M],
    caches), greedy[i] continuing the prefix through row i; the caches are
    updated in place."""
    attn = DB.attention_step if x.shape[0] == 1 else DB.attention_chunk_step

    def attn_apply(i, x, blk, wqkv, sqkv, bqkv, wo, swo):
        kc = caches[str(i)]["k"][0]  # [KV, S, hd], a view of the cache
        vc = caches[str(i)]["v"][0]
        x, kc, vc = attn(
            x, blk["attn_norm"], wqkv, sqkv, bqkv, cos_rows, sin_rows, kc, vc,
            wo, swo, position, heads=heads, kv_heads=kv_heads, head_dim=head_dim,
            eps=eps,
        )
        return x, {"k": kc[None], "v": vc[None]}

    return _fused_pass(params, x, attn_apply, layers=layers, eps=eps)


def fused_decode_pass_batch(params, x, caches, positions, cos_rows, sin_rows, *,
                            heads: int, kv_heads: int, head_dim: int, layers: int,
                            eps: float = 1e-6):
    """Batched fused pass over dense caches {layer: {k, v}} [B, KV, S, hd]:
    row b (x [B, dim]) at ``positions[b]`` of plane b, through
    ``attention_batch_step``. Returns (greedy [B], caches)."""

    def attn_apply(i, x, blk, wqkv, sqkv, bqkv, wo, swo):
        x, kc, vc = DB.attention_batch_step(
            x, blk["attn_norm"], wqkv, sqkv, bqkv, cos_rows, sin_rows,
            caches[str(i)]["k"], caches[str(i)]["v"], wo, swo, positions,
            heads=heads, kv_heads=kv_heads, head_dim=head_dim, eps=eps,
        )
        return x, {"k": kc, "v": vc}

    return _fused_pass(params, x, attn_apply, layers=layers, eps=eps)


def _pool_args(lp):
    """A layer's pools as the attention wrappers take them: k and v, then
    the scale planes of an int8 pool (None for fp)."""
    return lp["k"], lp["v"], lp.get("ks"), lp.get("vs")


def _pool_entry(out):
    """The (x, pools) of an attention wrapper's 3- or 5-tuple."""
    if len(out) == 5:
        x, kp, vp, ks, vs = out
        return x, {"k": kp, "v": vp, "ks": ks, "vs": vs}
    x, kp, vp = out
    return x, {"k": kp, "v": vp}


def fused_paged_pass_batch(params, x, pools, positions, block_tables,
                           cos_rows, sin_rows, *, heads: int, kv_heads: int,
                           head_dim: int, layers: int, eps: float = 1e-6,
                           lora=None):
    """Batched fused pass over paged KV pools ``{layer: {k, v}}`` of
    [P, KV, page, hd] blocks (int8 pools add their ``ks``/``vs`` [P, KV,
    page] scale planes); each row's context streams through its
    ``block_tables`` row. ``lora`` as in :func:`_fused_pass`. Returns
    (greedy [B], pools)."""

    def attn_apply(i, x, blk, wqkv, sqkv, bqkv, wo, swo):
        kp, vp, ks, vs = _pool_args(pools[str(i)])
        return _pool_entry(DB.attention_paged_batch_step(
            x, blk["attn_norm"], wqkv, sqkv, bqkv, cos_rows, sin_rows,
            kp, vp, wo, swo, positions, block_tables, ks, vs,
            heads=heads, kv_heads=kv_heads, head_dim=head_dim, eps=eps,
        ))

    return _fused_pass(params, x, attn_apply, layers=layers, eps=eps, lora=lora)


def fused_paged_pass_chunk(params, x, pools, position, block_table,
                           cos_rows, sin_rows, *, heads: int, kv_heads: int,
                           head_dim: int, layers: int, eps: float = 1e-6,
                           lora=None):
    """One prefill chunk x [M, dim] at positions ``position..position+M-1``
    (page multiples) through the fused kernels into paged pools (fp or
    int8). Returns (greedy [M], pools); greedy[i] continues the prefix
    through row i."""

    def attn_apply(i, x, blk, wqkv, sqkv, bqkv, wo, swo):
        kp, vp, ks, vs = _pool_args(pools[str(i)])
        return _pool_entry(DB.attention_paged_chunk_step(
            x, blk["attn_norm"], wqkv, sqkv, bqkv, cos_rows, sin_rows,
            kp, vp, wo, swo, position, block_table, ks, vs,
            heads=heads, kv_heads=kv_heads, head_dim=head_dim, eps=eps,
        ))

    return _fused_pass(params, x, attn_apply, layers=layers, eps=eps, lora=lora)


def fused_paged_pass_spec(params, x, pools, positions, block_tables,
                          cos_rows, sin_rows, *, heads: int, kv_heads: int,
                          head_dim: int, layers: int, m: int, eps: float = 1e-6,
                          lora=None):
    """Speculative verification pass over paged KV pools (fp or int8): x
    [B*m, dim] holds, stream-major, each stream's m candidate rows (last
    token + m-1 drafts) at positions ``positions[b]..positions[b]+m-1``.
    One weight stream verifies all B*m rows; greedy[b*m + i] continues
    stream b's prefix through candidate i. ``lora`` groups are per row
    (B*m). Returns (greedy [B*m], pools)."""

    def attn_apply(i, x, blk, wqkv, sqkv, bqkv, wo, swo):
        kp, vp, ks, vs = _pool_args(pools[str(i)])
        return _pool_entry(DB.attention_paged_spec_step(
            x, blk["attn_norm"], wqkv, sqkv, bqkv, cos_rows, sin_rows,
            kp, vp, wo, swo, positions, block_tables, ks, vs,
            heads=heads, kv_heads=kv_heads, head_dim=head_dim, m=m, eps=eps,
        ))

    return _fused_pass(params, x, attn_apply, layers=layers, eps=eps, lora=lora)


def make_paged_window(step_fn, *, k: int, eos: int | None = None,
                      lora: bool = False):
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
    pools)`` is the family's batched paged step.

    With ``lora=True`` the window takes two more trailing operands, the
    per-row adapter slots ``adapters [B]`` and the resident adapter stack,
    and calls ``step_fn(tokens, pools, positions, bts, adapters,
    lora_state)``."""

    def window(tokens, pools, positions, bts, active, emitted, max_new,
               adapters=None, lora_state=None):
        extra = (adapters, lora_state) if lora else ()
        cols = []
        for _ in range(k):
            alive = active.to(torch.int32)
            pos_in, bts_in = DB.freeze_inactive(positions, bts, active)
            nxt, pools = step_fn(tokens, pools, pos_in, bts_in, *extra)
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


def make_paged_spec_window(spec_step_fn, *, k: int, spec_k: int, ngram: int,
                           eos: int | None = None, lora: bool = False):
    """K-tick decode window with prompt-lookup speculation in every tick:
    one call can emit up to ``k * (spec_k + 1)`` tokens per stream.

    Each tick, for every stream at once and on the device: draft ``spec_k``
    tokens from the stream's history (:func:`spec_decode.lookup`), verify
    the (last token + drafts) chunk in one batched pass through
    ``spec_step_fn``, accept the longest agreeing draft prefix plus the
    bonus token, cut the emission at the first accepted candidate that
    completes the stream (EOS or ``max_new``) and freeze it there
    (:func:`freeze_inactive`), write the emitted tokens into the history
    (keeping the old values past them) and advance the position by the
    emitted count, so rejected tail rows in the pool are overwritten by the
    next chunk before any sweep can attend them.

    ``spec_step_fn(chunks [B, spec_k+1], pools, positions, bts) -> (greedy
    [B, spec_k+1], pools)`` is the family's batched verification step.
    Returns ``window(tokens, pools, positions, bts, active, emitted,
    max_new, history, hist_len) -> (mat, tokens, positions, active,
    emitted, pools, history, hist_len)``: ``mat`` is one [B, k*(spec_k+1)
    + 1] int32 matrix, k tick-blocks of spec_k+1 token columns (``-1``
    past a tick's emission and for frozen streams) and the final active
    mask, which the host copies once per window.

    With ``lora=True`` the window takes the same two trailing operands as
    :func:`make_paged_window` and the verification pass is called as
    ``spec_step_fn(chunks, pools, positions, bts, adapters, lora_state)``:
    drafts and verify read the stream's own adapter."""
    from dora_tpu_torch.models import spec_decode

    m = spec_k + 1

    def window(tokens, pools, positions, bts, active, emitted, max_new,
               history, hist_len, adapters=None, lora_state=None):
        extra = (adapters, lora_state) if lora else ()
        hbuf = history.shape[1]
        nslots = tokens.shape[0]
        dev = tokens.device
        idx = torch.arange(m, device=dev)[None, :]
        rows = torch.arange(nslots, device=dev)[:, None]
        blocks = []
        for _ in range(k):
            alive = active.to(torch.int32)
            pos_in, bts_in = DB.freeze_inactive(positions, bts, active)
            draft = spec_decode.lookup(history, hist_len, hbuf, spec_k, ngram)
            chunks = torch.cat([tokens[:, None], draft], dim=1)
            greedy, pools = spec_step_fn(chunks, pools, pos_in, bts_in, *extra)
            # accepted = the first disagreement (argmin of agree ++ [False])
            agree = torch.cat([greedy[:, :spec_k] == draft,
                               torch.zeros((nslots, 1), dtype=torch.bool, device=dev)],
                              dim=1)
            n_emit = torch.argmin(agree.to(torch.int32), dim=1) + 1
            # Candidate i is the (emitted+i+1)-th token: the first accepted
            # one that hits EOS or max_new ends the emission there.
            stop = (emitted[:, None] + idx + 1) >= max_new[:, None]
            if eos is not None:
                stop = stop | (greedy == eos)
            stop = stop & (idx < n_emit[:, None])
            has_stop = stop.any(dim=1)
            first_stop = torch.argmax(stop.to(torch.int32), dim=1)
            e = torch.where(has_stop, first_stop + 1, n_emit).to(torch.int32) * alive
            blocks.append(torch.where((idx < e[:, None]) & active[:, None], greedy,
                                      torch.full_like(greedy, -1)))
            last = greedy[rows[:, 0], (e.long() - 1).clamp_min(0)]
            # A frozen row keeps its last real token; e is 0 there, so its
            # position, count and history stay put too.
            tokens = torch.where(active, last, tokens)
            positions = pos_in + e
            emitted = emitted + e
            active = active & ~has_stop
            # Commit: the e emitted candidates at hist_len, the rest kept.
            cols = (hist_len.long()[:, None] + idx).clamp_max(hbuf - 1)
            keep = history[rows, cols]
            history = history.scatter(1, cols, torch.where(idx < e[:, None], greedy, keep))
            hist_len = hist_len + e
        mat = torch.cat([torch.cat(blocks, dim=1), active.to(torch.int32)[:, None]], dim=1)
        return mat, tokens, positions, active, emitted, pools, history, hist_len

    return window


def window_row_stats(row, k: int) -> tuple[int, int | None]:
    """One stream's row of the plain window's [B, k+1] matrix as
    ``(emitted, frozen_at)``: its real tokens this window and the tick at
    which the device froze it (None if it ran the whole window). Columns
    past completion hold -1; column k is the final active flag."""
    emitted = 0
    for j in range(k):
        if int(row[j]) < 0:
            return emitted, j
        emitted += 1
    return emitted, (None if int(row[k]) else k)


def spec_window_row_stats(row, k: int, m: int) -> tuple[int, int | None]:
    """Ragged counterpart of :func:`window_row_stats` for the spec window's
    [B, k*m + 1] matrix (m = spec_k + 1): ``(emitted, frozen_at)`` with
    ``emitted`` the row's real tokens over all k tick-blocks and
    ``frozen_at`` the last tick on which it emitted before the device froze
    it (None if still active). A -1 inside a block only pads past that
    tick's accepted length, so freezing is read from the final active
    flag."""
    emitted = 0
    last_live = None
    for t in range(k):
        got = 0
        for i in range(m):
            if int(row[t * m + i]) < 0:
                break
            got += 1
        if got:
            last_live = t
        emitted += got
    if int(row[k * m]):
        return emitted, None
    return emitted, (last_live if last_live is not None else 0)
