"""Ring attention: exact attention over a sequence split across ranks.

Counterpart of dora_tpu/parallel/ring.py. The sequence axis is split over
the mesh's ``sp`` axis; each rank holds a Q/K/V block, the K/V blocks rotate
to the next rank each step (``comm.ring_shift``: one ``batch_isend_irecv``,
differentiable, its gradient rotating back) and a numerically stable
log-sum-exp accumulator merges the partial attentions, so no rank holds the
whole sequence. Where the JAX function takes the global arrays and
``shard_map`` splits them, :func:`ring_attention` takes this rank's blocks
and returns its block of the output.
"""

from __future__ import annotations

import torch

from dora_tpu_torch.parallel import comm
from dora_tpu_torch.parallel.mesh import AXIS_SP


def _scale(q):
    """``sqrt(D)`` in q's dtype, as ``jnp.sqrt(D).astype(q.dtype)``."""
    return torch.tensor(float(q.shape[-1]), device=q.device).sqrt().to(q.dtype)


def _block_attend(q, k, v, mask=None):
    """One Q-block x K/V-block partial attention in q's dtype. Returns
    (unnormalized out, running max m, running denominator l) for the
    log-sum-exp merge. Shapes: q [B, H, Tq, D], k/v [B, H, Tk, D]."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / _scale(q)
    lowest = torch.finfo(scores.dtype).min
    if mask is not None:
        scores = torch.where(mask, scores, lowest)
    m = scores.amax(dim=-1, keepdim=True)
    # Fully masked rows: the max is the lowest value; clamp so exp() stays finite.
    m = torch.clamp(m, min=lowest / 2)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v), m, l


def _merge(acc, new):
    """Merge two partial attention accumulators with a stable LSE."""
    out_a, m_a, l_a = acc
    out_b, m_b, l_b = new
    m = torch.maximum(m_a, m_b)
    a_scale = torch.exp(m_a - m)
    b_scale = torch.exp(m_b - m)
    return out_a * a_scale + out_b * b_scale, m, l_a * a_scale + l_b * b_scale


def _causal_mask(tq: int, tk: int, q_off: int, k_off: int, device):
    qi = torch.arange(tq, device=device)[:, None] + q_off
    ki = torch.arange(tk, device=device)[None, :] + k_off
    return qi >= ki


def _block_causal_mask(block_len: int, q_block_idx: int, k_block_idx: int, device):
    """The causal mask between the local Q block and the K block held now
    (global block indices)."""
    return _causal_mask(block_len, block_len, q_block_idx * block_len,
                        k_block_idx * block_len, device)[None, None]


def ring_attention(q, k, v, mesh, causal: bool = True, axis: str = AXIS_SP):
    """Exact (optionally causal) attention over a sequence split on ``axis``:
    q/k/v are this rank's blocks [batch, heads, seq / sp, head_dim], in the
    order of the rank's index. Causality across blocks uses global
    positions: block i attends to block j fully when j < i, diagonally when
    j == i, not at all when j > i. At sp 1 it is the dense form."""
    sp = 1 if mesh is None else mesh.size(axis)
    if sp == 1:
        mask = _causal_mask(q.shape[2], k.shape[2], 0, 0, q.device) if causal else None
        out, _, l = _block_attend(q, k, v, mask)
        return out / l
    idx = mesh.index(axis)
    block_len = q.shape[2]
    lowest = torch.finfo(q.dtype).min
    acc = (torch.zeros_like(q), torch.full_like(q[..., :1], lowest / 2),
           torch.zeros_like(q[..., :1]))
    k_blk, v_blk, src = k, v, idx
    for step in range(sp):
        mask = _block_causal_mask(block_len, idx, src, q.device) if causal else None
        acc = _merge(acc, _block_attend(q, k_blk, v_blk, mask))
        if step < sp - 1:  # the last rotation would carry nothing used
            k_blk, v_blk = comm.ring_shift((k_blk, v_blk), mesh, axis)
        src = (src - 1) % sp
    out, _, l = acc
    return out / torch.clamp(l, min=1e-20)


__all__ = ["ring_attention"]
