"""Prompt-lookup speculative decoding: the draft rule, on torch tensors.

Counterpart of ``SPEC_K``, ``SPEC_NGRAM``, ``spec_headroom`` and ``lookup``
of dora_tpu/models/spec_decode.py. Drafts are the continuation of the most
recent earlier occurrence of a stream's trailing ngram (no draft model); a
verification pass over the last token and its drafts costs one weight
stream, and every emitted token is an argmax of the full model, so output
is identical to plain greedy decoding. The paged spec window
(models/vlm.make_paged_spec_window) drafts for every stream at once, so
:func:`lookup` works on a batch of histories where the JAX package vmaps a
one-stream function. The batch-1 ``run_loop`` is not ported yet.
"""

from __future__ import annotations

import torch

#: default draft length / lookup ngram
SPEC_K = 4
SPEC_NGRAM = 2


def spec_headroom(k: int = SPEC_K) -> int:
    """Rows past ``prompt + max_new`` one verification pass may write
    (k + 1): the sequence slack every admission gate reserves."""
    return k + 1


def lookup(history: torch.Tensor, hist_len: torch.Tensor, seq: int, k: int,
           ngram: int) -> torch.Tensor:
    """Draft ``k`` tokens per stream: ``history`` [B, seq] int32 holds each
    stream's known ids, ``hist_len`` [B] how many are filled. The draft is
    what followed the most recent earlier occurrence of the trailing
    ``ngram`` (its start clipped to ``seq - k``); with no occurrence it
    repeats the last token. Any draft is safe: verification decides.
    Returns [B, k] int32."""
    b = history.shape[0]
    dev = history.device
    rows = torch.arange(b, device=dev)[:, None]
    hl = hist_len.long()
    tail_start = hl - ngram
    t0 = tail_start.clamp(0, seq - ngram)
    tail = history[rows, t0[:, None] + torch.arange(ngram, device=dev)]  # [B, ngram]
    idx = torch.arange(seq, device=dev)
    # windows[:, i, j] = history[:, (i + j) % seq]; the wrap is masked below
    windows = torch.stack([torch.roll(history, -j, dims=1) for j in range(ngram)], dim=-1)
    match = (windows == tail[:, None, :]).all(dim=-1)  # [B, seq]
    valid = (match & (idx[None, :] + ngram <= hl[:, None] - 1)
             & (idx[None, :] < tail_start[:, None]))
    m = torch.where(valid, idx[None, :], torch.full_like(idx[None, :], -1)).amax(dim=1)
    start = (m + ngram).clamp(0, seq - k)
    draft = history[rows, start[:, None] + torch.arange(k, device=dev)]
    last = history[torch.arange(b, device=dev), (hl - 1).clamp(0, seq - 1)]
    return torch.where((m >= 0)[:, None], draft, last[:, None].expand(b, k))
