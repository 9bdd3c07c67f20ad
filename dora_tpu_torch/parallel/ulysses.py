"""Ulysses sequence parallelism: all-to-all head redistribution.

Counterpart of dora_tpu/parallel/ulysses.py, the second long-context
strategy beside ring attention: with the sequence split over ``sp``, two
``all_to_all`` exchanges turn this rank's [seq / sp, heads] blocks into
[seq, heads / sp], dense attention runs over the whole sequence for its
heads, and the inverse exchange restores the sequence split. Both
exchanges are differentiable (``comm.all_to_all``). Constraint: heads %
sp == 0. As in ring.py, the function takes this rank's blocks.
"""

from __future__ import annotations

import torch

from dora_tpu_torch.parallel import comm
from dora_tpu_torch.parallel.mesh import AXIS_SP
from dora_tpu_torch.parallel.ring import _scale


def ulysses_attention(q, k, v, mesh, causal: bool = True, axis: str = AXIS_SP):
    """Exact (optionally causal) attention over a sequence split on ``axis``;
    q/k/v are this rank's blocks [batch, heads, seq / sp, head_dim]. The
    first exchange gathers the sequence while it scatters the heads, dense
    attention runs per head slice, the second restores the sequence split."""
    sp = 1 if mesh is None else mesh.size(axis)
    h = q.shape[1]
    if sp == 1:
        return _dense(q, k, v, causal, 0)
    if h % sp:
        raise ValueError(f"ulysses: heads={h} not divisible by sp={sp}")
    qg, kg, vg = (comm.all_to_all(x, mesh, axis, split_dim=1, concat_dim=2) for x in (q, k, v))
    out = _dense(qg, kg, vg, causal, 0)
    return comm.all_to_all(out, mesh, axis, split_dim=2, concat_dim=1)


def _dense(q, k, v, causal: bool, offset: int):
    """Dense attention: scores in q's dtype, the softmax in f32, cast back."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) / _scale(q)
    if causal:
        tq, tk = q.shape[2], k.shape[2]
        qi = torch.arange(tq, device=q.device)[:, None] + offset
        ki = torch.arange(tk, device=q.device)[None, :]
        scores = torch.where((qi >= ki)[None, None], scores, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


__all__ = ["ulysses_attention"]
