"""The self-contained vision-language model, the fused decode passes and the
K-tick decode window.

Counterpart of dora_tpu/models/vlm.py. The model (``VLMConfig`` with its
``tiny`` and ``bench_2b`` shapes, ``init_params``, ``param_count``,
``quantize_decode``, ``params_from_jax``): a ViT patch encoder
(``patchify``, ``encode_image``: non-causal pre-norm blocks over patch
embeddings with learned positions, whose attention is flash attention on
the card, ``layers.use_flash``) projected to the LM width and prefixed to
the prompt, then a causal LM (RoPE, GQA, SwiGLU; ``_lm_forward``,
``init_cache``, ``prefill``, ``decode_step``). Greedy ``generate`` is a host
loop of decode steps, each the fused batch-1 pass (``decode_step_fused``,
``decode_chunk_fused``: ``attention_step`` or ``attention_chunk_step`` and
``mlp_step`` per layer, then ``lm_head_argmax``) when
``fused_decode_ready`` allows, else the unfused blocks;
``generate_speculative`` runs prompt-lookup speculation over
``spec_decode.run_loop``; ``decode_batch_fused`` steps B independent rows.

The fused tier (``_qw``, ``_fused_pass``, ``fused_decode_ready``,
``fused_batch_ready``, the dense-cache passes ``fused_decode_pass`` (batch
1: one row, or a speculative verify's rows) and ``fused_decode_pass_batch``
(the dense engine), the paged ``fused_paged_pass_batch``,
``fused_paged_pass_chunk``, ``fused_paged_pass_spec``, ``make_paged_window``,
``make_paged_spec_window``, ``window_row_stats``,
``spec_window_row_stats``): each layer runs one attention kernel and
``mlp_step``, then, with multi-tenant LoRA, ``lora_gather_matmul``; the pass
ends in ``lm_head_argmax`` (ops/decode_block.py, ops/lora.py). Pools hold
fp pages, or int8 pages with their ``ks``/``vs`` scale planes, which select
the kernels' int8-KV forms. ``refuse_unkernelled`` is the engine factories'
check that a model's shapes are ones the attention kernels take.
``GraphedWindow`` runs a window, or the dense engine's step, as one
CUDA-graph replay over static buffers (``use_graphs`` resolves an engine's
``graphs`` argument).

Not ported yet: training (``loss_fn``, ``make_train_step``) and the
tensor-parallel ``generate_tp``.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import torch

from dora_tpu_torch._device import resolve_device
from dora_tpu_torch.models import layers as L
# params_from_jax: the generic tree conversion, re-exported for the VLM's tree
from dora_tpu_torch.models.hf.qwen2 import params_from_jax  # noqa: F401
from dora_tpu_torch.ops import decode_block as DB
from dora_tpu_torch.ops import flash_attention as FA
from dora_tpu_torch.ops import lora as LO


@dataclass(frozen=True)
class VLMConfig:
    # vision tower
    image_size: int = 224
    patch_size: int = 16
    vision_dim: int = 256
    vision_layers: int = 4
    vision_heads: int = 4
    vision_ffn: int = 1024
    # language model
    vocab: int = 32000
    dim: int = 512
    layers: int = 6
    heads: int = 8
    kv_heads: int = 4
    ffn: int = 1408
    max_seq: int = 1024

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @property
    def vision_head_dim(self) -> int:
        return self.vision_dim // self.vision_heads

    @classmethod
    def tiny(cls) -> "VLMConfig":
        """Test-size config: runs in seconds on the CPU."""
        return cls(
            image_size=32, patch_size=8, vision_dim=32, vision_layers=2,
            vision_heads=2, vision_ffn=64, vocab=256, dim=64, layers=2,
            heads=4, kv_heads=2, ffn=128, max_seq=64,
        )

    @classmethod
    def bench_2b(cls) -> "VLMConfig":
        """Qwen2-VL-2B-shaped config: a 32-layer ViT 1280 wide (16 heads of
        80 over 256 patches of a 224 x 224 image) and a Qwen2-1.5B-shaped
        LM."""
        return cls(
            image_size=224, patch_size=14, vision_dim=1280, vision_layers=32,
            vision_heads=16, vision_ffn=5120, vocab=151936, dim=1536,
            layers=28, heads=12, kv_heads=2, ffn=8960, max_seq=2048,
        )


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def init_params(cfg: VLMConfig, *, seed: int = 0, device=None) -> dict:
    """Seeded random f32 parameters on ``device`` (default cuda), with the
    JAX package's shapes and distributions: dense weights uniform in
    +-1/sqrt(d_in), the embedding and the vision positions normal x 0.02,
    norm weights one. The numbers come from a ``torch.Generator``, so they
    are not the JAX package's (``params_from_jax`` carries those over)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def dense(d_in, d_out):
        scale = 1.0 / math.sqrt(d_in)
        w = torch.rand((d_in, d_out), generator=gen, device=dev)
        return w * (2 * scale) - scale

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev) * 0.02

    def ones(n):
        return torch.ones((n,), device=dev)

    def block(dim, heads, ffn, kv_heads):
        hd = dim // heads
        return {
            "attn_norm": ones(dim),
            "wq": dense(dim, heads * hd),
            "wk": dense(dim, kv_heads * hd),
            "wv": dense(dim, kv_heads * hd),
            "wo": dense(heads * hd, dim),
            "ffn_norm": ones(dim),
            "w_gate": dense(dim, ffn),
            "w_up": dense(dim, ffn),
            "w_down": dense(ffn, dim),
        }

    patch_dim = cfg.patch_size * cfg.patch_size * 3
    vision = {
        "patch_proj": dense(patch_dim, cfg.vision_dim),
        "pos_embed": normal(cfg.n_patches, cfg.vision_dim),
        "blocks": {
            str(i): block(cfg.vision_dim, cfg.vision_heads, cfg.vision_ffn,
                          cfg.vision_heads)
            for i in range(cfg.vision_layers)
        },
        "out_norm": ones(cfg.vision_dim),
        "project": dense(cfg.vision_dim, cfg.dim),
    }
    return {
        "vision": vision,
        "embed": normal(cfg.vocab, cfg.dim),
        "blocks": {
            str(i): block(cfg.dim, cfg.heads, cfg.ffn, cfg.kv_heads)
            for i in range(cfg.layers)
        },
        "out_norm": ones(cfg.dim),
        "lm_head": dense(cfg.dim, cfg.vocab),
    }


def param_count(params) -> int:
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return params.numel()


def quantize_decode(params) -> dict:
    """Quantize the decode-path weights (LM blocks and lm_head) into the
    int8 fused layout, or with ``DORA_INT4_DECODE`` the grouped int4 one
    (ops/int4.py), each with its bf16 sidecar for the large-M products
    unless ``DORA_INT8_PURE``. The vision tower and the embedding stay
    float: they run once per image in prefill. As in the JAX package, this
    reads only those two knobs (``DORA_WEIGHT_BITS`` is the text model's)."""
    from dora_tpu_torch.ops.int8_matmul import quantize_int8, quantize_tree

    quantizer = quantize_int8
    if os.environ.get("DORA_INT4_DECODE"):
        from dora_tpu_torch.ops.int4 import quantize_int4 as quantizer
    keep_bf16 = not os.environ.get("DORA_INT8_PURE")
    out = dict(params)
    out["blocks"] = quantize_tree(params["blocks"], keep_bf16=keep_bf16, quantizer=quantizer)
    out["lm_head"] = quantize_tree({"lm_head": params["lm_head"]}, keep_bf16=keep_bf16,
                                   quantizer=quantizer)["lm_head"]
    return out


def on_card(device) -> bool:
    """True when ``device`` (None: the default, cuda) is a CUDA device."""
    return torch.device("cuda" if device is None else device).type == "cuda"


def refuse_unkernelled(what: str, device, *, heads: int, kv_heads: int,
                       head_dim: int, page: int | None = None, params=None) -> None:
    """On the card, raise before serving when a model's attention shapes
    (and a paged pool of ``page`` rows), or the groups of its int4 weights in
    ``params``, are ones the kernels do not take, naming each limit
    (ops/decode_block.kernel_shape_limits, int4_group_limits); the CPU's
    plain versions take every shape."""
    if on_card(device):
        limits = DB.kernel_shape_limits(heads, kv_heads, head_dim, page)
        if params is not None:
            limits += DB.int4_group_limits(DB.weight_groups(params))
        if limits:
            raise ValueError(f"{what}: " + "; ".join(limits))


# ---------------------------------------------------------------------------
# vision tower
# ---------------------------------------------------------------------------


def patchify(images, patch: int):
    """[B, H, W, 3] -> [B, n_patches, patch*patch*3]."""
    b, h, w, c = images.shape
    gh, gw = h // patch, w // patch
    x = images.reshape(b, gh, patch, gw, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)


def encode_image(params, cfg: VLMConfig, images):
    """[B, H, W, 3] float -> [B, n_patches, dim] image tokens (LM width), in
    the compute dtype of the parameters' device. The vision blocks attend
    through flash attention when ``layers.use_flash`` is on (the card's
    default), else through the dense einsum."""
    dev = params["embed"].device
    dtype = L.compute_dtype(dev)
    vp = params["vision"]
    x = patchify(images.to(dev, dtype), cfg.patch_size)
    x = x @ vp["patch_proj"].to(dtype)
    x = x + vp["pos_embed"].to(dtype)[None]
    flash = "full" if L.use_flash(dev) else None
    for i in range(cfg.vision_layers):
        x, _ = L.block_forward(vp["blocks"][str(i)], x, cfg.vision_heads, mask=None,
                               flash=flash)
    x = L.rms_norm(x, vp["out_norm"])
    return x @ vp["project"].to(dtype)


# ---------------------------------------------------------------------------
# language model
# ---------------------------------------------------------------------------


def _rope(cfg: VLMConfig, device):
    return L.rope_table(cfg.max_seq, cfg.head_dim, device=device)


def _lm_forward(params, cfg: VLMConfig, h, positions, mask, caches=None,
                cache_index=None, flash=None, rope=None):
    """The LM blocks over h [B, T, dim], then the final norm. With
    ``caches`` each layer writes its rows at ``cache_index`` in place.
    Returns (h, caches or {})."""
    rope = rope if rope is not None else _rope(cfg, h.device)
    new_caches = {}
    for i in range(cfg.layers):
        h, new_cache = L.block_forward(
            params["blocks"][str(i)], h, cfg.heads, n_kv_heads=cfg.kv_heads,
            rope=rope, positions=positions, mask=mask,
            cache=None if caches is None else caches[str(i)],
            cache_index=cache_index, flash=flash,
        )
        if new_cache is not None:
            new_caches[str(i)] = new_cache
    return L.rms_norm(h, params["out_norm"]), new_caches


def init_cache(cfg: VLMConfig, batch: int, dtype=None, device=None):
    """Dense KV caches {layer: {k/v: [batch, KV, max_seq, hd]}}, zeroed, in
    the compute dtype of ``device`` (default cuda)."""
    dev = resolve_device(device)
    dtype = dtype or L.compute_dtype(dev)
    shape = (batch, cfg.kv_heads, cfg.max_seq, cfg.head_dim)
    return {
        str(i): {"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev)}
        for i in range(cfg.layers)
    }


def _embed(params, ids):
    """Embedding rows of ``ids``; an id past the vocab takes the last row,
    as the JAX package's gather clamps (``DORA_SPEC_WORST_CASE`` drafts
    such ids, and only the discarded rows of a verify see them)."""
    embed = params["embed"]
    ids = ids.long().to(embed.device).clamp(0, embed.shape[0] - 1)
    return embed[ids].to(L.compute_dtype(embed.device))


def prefill(params, cfg: VLMConfig, images, prompt_ids, rope=None):
    """Encode image + prompt and fill fresh KV caches. Returns
    (last_logits [B, vocab] f32, caches, next_position)."""
    dev = params["embed"].device
    b = prompt_ids.shape[0]
    img_tokens = encode_image(params, cfg, images)  # [B, P, dim]
    h = torch.cat([img_tokens, _embed(params, prompt_ids)], dim=1)
    t = h.shape[1]
    positions = torch.arange(t, device=dev).expand(b, t)
    mask = L.causal_mask(t, cfg.max_seq, device=dev) & (
        torch.arange(cfg.max_seq, device=dev)[None, None, None, :] < t)
    caches = init_cache(cfg, b, device=dev)
    h, caches = _lm_forward(params, cfg, h, positions, mask, caches=caches,
                            cache_index=0, rope=rope)
    logits = L.matmul(h[:, -1], params["lm_head"]).float()
    return logits, caches, t


def decode_step(params, cfg: VLMConfig, token, caches, position: int, rope=None):
    """One unfused greedy decode step. token [B] int32 at cache position
    ``position``. Returns (logits [B, vocab] f32, caches)."""
    dev = params["embed"].device
    b = token.shape[0]
    h = _embed(params, token)[:, None, :]  # [B, 1, dim]
    positions = torch.full((b, 1), int(position), device=dev)
    mask = (torch.arange(cfg.max_seq, device=dev) <= position)[None, None, None, :]
    h, caches = _lm_forward(params, cfg, h, positions, mask, caches=caches,
                            cache_index=position, rope=rope)
    return L.matmul(h[:, -1], params["lm_head"]).float(), caches


def decode_step_fused(params, cfg: VLMConfig, token, caches, position: int, rope=None):
    """One greedy decode step through the fused kernels (two per layer and
    the head), caches updated in place. Requires :func:`fused_decode_ready`.
    token [1] int32. Returns (next_token [1] int32, caches)."""
    return decode_chunk_fused(params, cfg, token[:, None], caches, position, rope)


def decode_chunk_fused(params, cfg: VLMConfig, tokens, caches, position: int, rope=None):
    """M-row fused greedy pass: tokens [1, M] at positions
    ``position..position+M-1`` (the speculative-verify shape: one weight
    stream serves all rows). Returns (greedy [M] int32, greedy[i]
    continuing the prefix through row i, and the caches, updated in place).
    The caller keeps ``position + M <= max_seq``."""
    cos_t, sin_t = rope if rope is not None else _rope(cfg, params["embed"].device)
    m = tokens.shape[1]
    cos_rows, sin_rows = DB.rope_rows(cos_t, sin_t, position, m)
    return fused_decode_pass(
        params, _embed(params, tokens[0]), caches, position, cos_rows, sin_rows,
        heads=cfg.heads, kv_heads=cfg.kv_heads, head_dim=cfg.head_dim,
        layers=cfg.layers,
    )


def _refuse_for_generation(what: str, params, cfg: VLMConfig, fused: bool) -> None:
    """On the card, refuse before any work a model whose shapes a kernel of
    this generation would refuse: the vision tower's flash attention (when
    ``use_flash``) and the fused decode tier's attention kernels."""
    dev = params["embed"].device
    if not on_card(dev):
        return
    limits = FA.kernel_shape_limits(cfg.vision_head_dim) if L.use_flash(dev) else []
    if fused:
        limits += DB.kernel_shape_limits(cfg.heads, cfg.kv_heads, cfg.head_dim)
        limits += DB.int4_group_limits(DB.weight_groups(params))
    if limits:
        raise ValueError(f"{what}: " + "; ".join(limits))


def generate(params, cfg: VLMConfig, images, prompt_ids, max_new_tokens: int):
    """Greedy generation of ``max_new_tokens`` per row, as a host loop of
    decode steps (the JAX package scans). Returns [B, max_new_tokens]
    int32 ([B, 0] at 0, as the scan returns). Each step is the fused batch-1 pass when
    :func:`fused_decode_ready` allows (B = 1, the quantized layout,
    ``DORA_FUSED_DECODE`` not 0), else the unfused blocks."""
    b, t = prompt_ids.shape
    if cfg.n_patches + t + max_new_tokens > cfg.max_seq:
        raise ValueError(
            f"image ({cfg.n_patches}) + prompt ({t}) + max_new_tokens "
            f"({max_new_tokens}) exceeds max_seq ({cfg.max_seq})")
    if max_new_tokens == 0:
        # The JAX scan of length 0: no token, not even the prefill's.
        return torch.zeros((b, 0), dtype=torch.int32, device=prompt_ids.device)
    use_fused = fused_decode_ready(params, b)
    _refuse_for_generation("vlm.generate", params, cfg, use_fused)
    rope = _rope(cfg, params["embed"].device)
    logits, caches, position = prefill(params, cfg, images, prompt_ids, rope)
    token = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [token]
    # Token j + 1 comes from the step at position + j; the last token needs
    # no step after it.
    for pos in range(position, position + max_new_tokens - 1):
        if use_fused:
            token, caches = decode_step_fused(params, cfg, token, caches, pos, rope)
        else:
            logits, caches = decode_step(params, cfg, token, caches, pos, rope)
            token = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(token)
    return torch.stack(out, dim=1)


def decode_batch_fused(params, cfg: VLMConfig, tokens, caches, positions, rope=None):
    """One greedy decode step for B independent rows: tokens and positions
    [B] int32 (each row's own cache position), caches the [B, KV, S, hd]
    per-layer tree. One LM weight stream serves all B rows
    (``attention_batch_step``). Returns (greedy [B], caches)."""
    cos_t, sin_t = rope if rope is not None else _rope(cfg, params["embed"].device)
    cos_rows, sin_rows = DB.rope_rows_at(cos_t, sin_t, positions)
    return fused_decode_pass_batch(
        params, _embed(params, tokens), caches, positions, cos_rows, sin_rows,
        heads=cfg.heads, kv_heads=cfg.kv_heads, head_dim=cfg.head_dim,
        layers=cfg.layers,
    )


def generate_speculative(params, cfg: VLMConfig, images, prompt_ids,
                         max_new_tokens: int, k: int = 4, ngram: int = 2):
    """Greedy generation with prompt-lookup speculation: the tokens of
    :func:`generate`, up to ``k + 1`` of them per model pass. Drafts are the
    continuation of the most recent earlier occurrence of the trailing
    ``ngram`` in the prompt text and the generated tokens; each pass
    verifies the last token and its drafts in one weight stream (the fused
    ``attention_chunk_step`` tier when :func:`fused_decode_ready`, else the
    unfused blocks), and rejected rows of the cache are overwritten by the
    next pass before they become attendable. Batch 1. Returns (tokens
    [1, max_new_tokens] int32, model passes)."""
    from dora_tpu_torch.models import spec_decode

    if prompt_ids.shape[0] != 1:
        raise ValueError("speculative decode is batch-1")
    t_prompt = prompt_ids.shape[1]
    seq = cfg.max_seq
    # Exactness guard: the loop must never hit the context limit with tokens
    # still owed. Context = image patches + prompt text.
    spec_decode.check_headroom(cfg.n_patches + t_prompt, max_new_tokens, seq, "prompt", k)
    use_fused = fused_decode_ready(params)
    _refuse_for_generation("vlm.generate_speculative", params, cfg, use_fused)
    dev = params["embed"].device
    rope = _rope(cfg, dev)
    logits, caches, position = prefill(params, cfg, images, prompt_ids, rope)
    first = torch.argmax(logits, dim=-1).to(torch.int32)  # [1]
    # Rolling token history for the lookup (prompt text + generated).
    history = torch.zeros((seq,), dtype=torch.int32, device=dev)
    history[:t_prompt] = prompt_ids[0].to(dev, torch.int32)
    history[t_prompt] = first[0]

    def verify(chunk, n_emitted, caches):
        # generated token j lives at cache position `position + j`;
        # chunk[0, 0] is generated index n_emitted - 1.
        cache_index = position + n_emitted - 1
        if use_fused:
            return decode_chunk_fused(params, cfg, chunk, caches, cache_index, rope)
        chunk_pos = cache_index + torch.arange(chunk.shape[1], device=dev)
        mask = (torch.arange(seq, device=dev)[None, None, None, :]
                <= chunk_pos[None, None, :, None])
        h, new_caches = _lm_forward(params, cfg, _embed(params, chunk), chunk_pos[None],
                                    mask, caches=caches, cache_index=cache_index, rope=rope)
        greedy = torch.argmax(L.matmul(h[0], params["lm_head"]).float(), dim=-1)
        return greedy.to(torch.int32), new_caches

    return spec_decode.run_loop(
        caches=caches, history=history, hist_len=t_prompt + 1, first=first[0],
        max_new_tokens=max_new_tokens, seq=seq, verify=verify, k=k, ngram=ngram,
        body=spec_decode.fitting_body_passes(cfg.n_patches + t_prompt, max_new_tokens,
                                             seq, k),
    )


# ---------------------------------------------------------------------------
# the fused tier
# ---------------------------------------------------------------------------


def _qw(d: dict):
    """Quantized dict -> (weights, scales) in the kernel layout: int8 with
    its per-column scales, or int4 nibbles with their group scales."""
    if "int4" in d:
        return d["int4"], d["gscale"]
    return d["int8"], d["scale"]


def fused_decode_ready(params, batch: int = 1) -> bool:
    """True when a decode step can run the fused tier: batch 1, params in
    the fused layout of ``quantize_decode`` (wqkv / w_gateup / wo / w_down /
    lm_head, int8 or int4) and no output-projection biases. Opt-out:
    ``DORA_FUSED_DECODE=0`` (or empty), as in the JAX package."""
    if os.environ.get("DORA_FUSED_DECODE", "1") in ("", "0"):
        return False
    if batch != 1:
        return False
    blk = params.get("blocks", {}).get("0")
    if blk is None:
        return False

    def _q(x):
        return isinstance(x, dict) and ("int8" in x or "int4" in x)

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


#: where each carried return of a window goes back in: the argument index of
#: ``tokens, positions, active, emitted, pools`` (:func:`make_paged_window`'s
#: returns after ``mat``), then ``history, hist_len`` (the spec window's)
WINDOW_CARRY = (0, 2, 4, 5, 1)
SPEC_WINDOW_CARRY = WINDOW_CARRY + (7, 8)


def use_graphs(graphs: bool | None, device) -> bool:
    """An engine's ``graphs`` argument resolved for ``device``: None means
    on for a CUDA device, True on the CPU raises (there is no graph to
    capture), False is the eager path."""
    cuda = torch.device(device).type == "cuda"
    if graphs is None:
        return cuda
    if graphs and not cuda:
        raise ValueError(f"graphs=True needs a CUDA device, not {device}")
    return bool(graphs)


def _leaves(x):
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    return [] if x is None else [x]


def _layout(args):
    """What a graph is bound to: each argument's tensors by address, shape
    and dtype."""
    return [[(t.data_ptr(), tuple(t.shape), t.dtype) for t in _leaves(a)] for a in args]


def _counters():
    """(function, attribute) of every launch counter a decode pass bumps."""
    return ([(fn, "launches") for fn in DB.KERNELS]
            + [(fn, "launches_int8kv") for fn in DB.KV_INT8_KERNELS]
            + [(fn, "launches_int4") for fn in DB.KERNELS]
            + [(LO.lora_gather_matmul, "launches")])


class GraphedWindow:
    """A decode window, or the dense engine's step, run as ONE CUDA graph
    replay over static buffers: the port's counterpart of the jitted
    ``lax.scan`` window with donated pools.

    ``fn(*args) -> (out, *results)`` is the eager body (a window of
    :func:`make_paged_window` or :func:`make_paged_spec_window`, their LoRA
    forms included); ``carry[i]`` is the argument that ``results[i]``
    continues (:data:`WINDOW_CARRY`, :data:`SPEC_WINDOW_CARRY`). The first
    call binds the runner to its arguments, which become its static buffers:
    the carried vectors, the block tables, the pools and the LoRA stack.
    Every later call must pass the SAME tensors (same address, shape and
    dtype) and raises otherwise: a caller updates them in place
    (``copy_``), never rebinds them. The body ends by copying each carried
    result into its argument, so one call continues from the last as the
    scan carry does; pools (and the LoRA stack) are read and written in
    place, and a returned pool tensor that is not the one passed in raises.
    A call returns ``out`` and the static buffers in ``results``' order.

    With ``graph=True`` (a CUDA device) the first call is the warm-up: it
    runs the body eagerly on a side stream (the kernels' one-time
    ``cudaFuncSetAttribute`` calls happen there, outside capture) and its
    result is that call's answer; then the body is captured once with
    ``torch.cuda.graph`` into a private memory pool, and every later call
    is one ``replay``. ``out`` of a replay lives in the graph's pool and
    the next replay overwrites it, so copy it out first. A capture that
    fails raises; nothing falls back to the eager body. The kernels'
    wrappers count launches while their Python runs, so the capture's
    counts are taken back and recorded per replay in ``launches``, and each
    replay adds them to the counters: every counter stays the number of
    launches that ran. With ``graph=False`` (the CPU, or a caller who asks
    for the eager path) every call runs the body eagerly through the same
    static buffers and the same identity checks."""

    def __init__(self, fn, *, carry: tuple[int, ...], graph: bool):
        self.fn = fn
        self.carry = carry
        self.graph = graph
        #: bindings of the static buffers: one CUDA-graph capture each with
        #: graph=True, else the first call
        self.captures = 0
        #: replays of the captured graph
        self.replays = 0
        #: kernel launches of one replay, by counter name
        self.launches: dict[str, int] = {}
        self._credits: list[tuple] = []
        self._args = None
        self._layout = None
        self._graph = None
        self._out = None

    def __call__(self, *args):
        if self._args is None:
            self._args, self._layout = args, _layout(args)
            if not self.graph:
                self.captures += 1
        elif _layout(args) != self._layout:
            bad = next(i for i, (a, b) in enumerate(zip(_layout(args), self._layout))
                       if a != b)
            raise ValueError(
                f"window argument {bad} is not the static buffer this window was "
                f"bound to: update it in place (copy_), never rebind it")
        if not self.graph:
            return self._run()
        if self._graph is None:
            return self._capture()
        self._graph.replay()
        self.replays += 1
        for fn, attr, n in self._credits:
            setattr(fn, attr, getattr(fn, attr) + n)
        return self._out

    def _run(self):
        out, *results = self.fn(*self._args)
        for j, res in zip(self.carry, results):
            arg = self._args[j]
            if isinstance(arg, torch.Tensor):
                if res is not arg:
                    arg.copy_(res)
            elif [t.data_ptr() for t in _leaves(res)] != [t.data_ptr() for t in _leaves(arg)]:
                raise RuntimeError(
                    f"window result {j} returned pool tensors other than the ones passed "
                    f"in: pools are updated in place")
        return (out, *(self._args[j] for j in self.carry))

    def _capture(self):
        device = _leaves(self._args[0])[0].device
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            first = self._run()
        torch.cuda.current_stream(device).wait_stream(side)
        before = [(fn, attr, getattr(fn, attr)) for fn, attr in _counters()]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                self._out = self._run()
        finally:
            # the capture launched nothing: take its counts back
            self._credits = [(fn, attr, getattr(fn, attr) - n) for fn, attr, n in before
                             if getattr(fn, attr) != n]
            for fn, attr, n in before:
                setattr(fn, attr, n)
        self.launches = {f"{fn.__name__}.{attr}": n for fn, attr, n in self._credits}
        self._graph = graph
        self.captures += 1
        return first


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
