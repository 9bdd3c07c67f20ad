"""Prompt-lookup speculative decoding, on torch tensors.

Counterpart of dora_tpu/models/spec_decode.py: the constants, ``lookup``,
``spec_headroom``, ``body_passes``, ``fitting_body_passes``,
``check_headroom``, the serving gates ``fits`` and ``gate_speculation``
(``DORA_SPEC_DECODE``) and the batch-1 loop ``run_loop``. Drafts are the
continuation of the most recent earlier occurrence of a stream's trailing
ngram (no draft model); a verification pass over the last token and its
drafts costs one weight stream, and every emitted token is an argmax of the
full model, so output is identical to plain greedy decoding. The paged spec
window (models/vlm.make_paged_spec_window) drafts for every stream at once,
so :func:`lookup` works on a batch of histories where the JAX package vmaps
a one-stream function. ``run_loop`` is a host loop where the JAX package
runs a ``while_loop``: one device-to-host copy of each pass's greedy tokens
decides the acceptance, with the JAX loop's pass counting, body fusion
(``DORA_SPEC_BODY``) and adaptive gating (``DORA_SPEC_ADAPTIVE``).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

#: default draft length / lookup ngram; headroom every gate must check
SPEC_K = 4
SPEC_NGRAM = 2
SPEC_HEADROOM = SPEC_K + 1  # single-pass slack; gates use spec_headroom()

#: Adaptive gating: below an acceptance EMA of ADAPT_THRESHOLD the loop takes
#: single-token passes, drifting back up by ADAPT_RECOVER per plain pass until
#: it probes a full chunk again; each spec pass moves the EMA by ADAPT_ALPHA
#: toward its acceptance rate (float32 arithmetic, as the JAX loop's).
ADAPT_THRESHOLD = 0.3
ADAPT_ALPHA = 0.5
ADAPT_RECOVER = 0.03


def spec_headroom(k: int = SPEC_K) -> int:
    """Rows past ``prompt + max_new`` one verification pass may write
    (k + 1): the sequence slack every admission gate reserves."""
    return k + 1


def body_passes() -> int:
    """Speculation passes fused into one loop body (``DORA_SPEC_BODY``,
    default 4). The loop tests for completion once per body, so it can
    overshoot by up to body - 1 passes after max_new; their tokens are
    discarded and they are not counted."""
    return max(1, int(os.environ.get("DORA_SPEC_BODY", "4")))


def fitting_body_passes(context_len: int, max_new_tokens: int, max_seq: int,
                        k: int = SPEC_K) -> int:
    """Largest body factor (<= ``DORA_SPEC_BODY``) whose overshoot slack
    still fits max_seq: tight contexts degrade toward 1."""
    ppb = body_passes()
    while ppb > 1 and context_len + max_new_tokens + ppb * (k + 1) > max_seq:
        ppb //= 2
    return max(1, ppb)


def check_headroom(context_len: int, max_new_tokens: int, max_seq: int, what: str,
                   k: int = SPEC_K) -> None:
    """Raise unless a speculation run of ``max_new_tokens`` after
    ``context_len`` tokens keeps its one-pass headroom inside max_seq."""
    headroom = spec_headroom(k)
    total = context_len + max_new_tokens + headroom
    if total > max_seq:
        raise ValueError(
            f"{what} ({context_len}) + max_new_tokens ({max_new_tokens}) "
            f"+ speculation headroom ({headroom}) exceeds max_seq "
            f"({max_seq})"
        )


def fits(context_len: int, max_new_tokens: int, max_seq: int, k: int = SPEC_K) -> bool:
    """Gate helper for serving paths that degrade instead of raising."""
    return context_len + max_new_tokens + spec_headroom(k) <= max_seq


def gate_speculation(context_len: int, max_new_tokens: int, max_seq: int,
                     batch_ok: bool = True) -> bool:
    """The serving-path ``DORA_SPEC_DECODE`` gate: True when the env asks
    for speculation and the constraints (batch 1, k + 1 headroom within
    max_seq) allow it; otherwise it warns and the caller serves plain
    greedy."""
    if not os.environ.get("DORA_SPEC_DECODE"):
        return False
    if batch_ok and fits(context_len, max_new_tokens, max_seq):
        return True
    logging.getLogger(__name__).warning(
        "DORA_SPEC_DECODE disabled: needs batch-1 and %d tokens of "
        "context within max_seq (%d); serving vanilla greedy",
        context_len + max_new_tokens + spec_headroom(), max_seq,
    )
    return False


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


def _dus(buf: list, update: list, start: int) -> None:
    """``lax.dynamic_update_slice`` on a host list: the start clamps so the
    update fits."""
    start = max(0, min(start, len(buf) - len(update)))
    buf[start : start + len(update)] = update


def run_loop(*, caches, history, hist_len, first, max_new_tokens: int, seq: int,
             verify, k: int = SPEC_K, ngram: int = SPEC_NGRAM,
             adaptive: bool | None = None, return_stats: bool = False,
             body: int | None = None):
    """The batch-1 speculation loop.

    ``history`` is a [seq] int32 tensor of the known token ids (prompt +
    ``first``), ``hist_len`` how many are filled. ``verify(chunk [1, W]
    int32, n_emitted, caches) -> (greedy [W], caches)`` runs the family's
    model over the chunk (W = k + 1 for a speculative pass, 1 for an
    adaptive plain pass), greedy[i] continuing the prefix through
    chunk[0, i]; n_emitted counts the tokens emitted so far (``first``
    included), so the chunk's first token is generated index n_emitted - 1.

    ``body`` passes run per loop iteration (default :func:`body_passes`),
    and ``adaptive`` (default: ``DORA_SPEC_ADAPTIVE``, off) switches to
    single-token passes while the acceptance EMA is below
    ADAPT_THRESHOLD. ``DORA_SPEC_WORST_CASE`` (any non-empty value, read
    per call) drafts ``last + 1 + i`` in place of the lookup, as the JAX
    loop does to measure the adversarial floor. Returns (tokens [1,
    max_new_tokens] int32,
    model_passes); with ``return_stats`` also the number of full k + 1
    passes. Like the JAX loop's, ``model_passes`` starts at 1 and counts
    only passes that still owed tokens."""
    if adaptive is None:
        adaptive = os.environ.get("DORA_SPEC_ADAPTIVE", "0") not in ("", "0")
    worst_case = bool(os.environ.get("DORA_SPEC_WORST_CASE"))
    ppb = body_passes() if body is None else max(1, body)
    dev = history.device
    hist = history.to("cpu", torch.int32).clone()
    hist_len = int(hist_len)
    out = [0] * (max_new_tokens + ppb * (k + 1))
    out[0] = int(first)
    n_emitted = passes = 1
    spec_passes = 0
    ema = np.float32(1.0)
    f32 = np.float32

    def commit(greedy: list, emitted: int, spec: bool) -> None:
        nonlocal hist_len, n_emitted, passes, spec_passes
        _dus(out, greedy, n_emitted)
        width = len(greedy)
        start = max(0, min(hist_len, seq - width))
        keep = hist[start : start + width].tolist()
        hist[start : start + width] = torch.tensor(
            [g if i < emitted else c for i, (g, c) in enumerate(zip(greedy, keep))],
            dtype=torch.int32)
        useful = int(n_emitted < max_new_tokens)  # overshoot passes count nothing
        hist_len += emitted
        n_emitted += emitted
        passes += useful
        spec_passes += int(spec) * useful

    while n_emitted < max_new_tokens:
        for _ in range(ppb):
            last = out[n_emitted - 1]
            if not adaptive or ema >= f32(ADAPT_THRESHOLD):
                if worst_case:
                    draft = [last + 1 + i for i in range(k)]
                else:
                    draft = lookup(hist[None], torch.tensor([hist_len]), seq, k,
                                   ngram)[0].tolist()
                chunk = torch.tensor([[last, *draft]], dtype=torch.int32, device=dev)
                greedy, caches = verify(chunk, n_emitted, caches)
                greedy = greedy.reshape(-1).tolist()
                agree = [g == d for g, d in zip(greedy[:k], draft)] + [False]
                accepted = agree.index(False)
                ema = f32(1 - ADAPT_ALPHA) * ema + f32(ADAPT_ALPHA) * (f32(accepted) / f32(k))
                commit(greedy, accepted + 1, True)
            else:
                chunk = torch.tensor([[last]], dtype=torch.int32, device=dev)
                greedy, caches = verify(chunk, n_emitted, caches)
                ema = np.minimum(ema + f32(ADAPT_RECOVER), f32(1.0))
                commit(greedy.reshape(-1).tolist(), 1, False)
    tokens = torch.tensor([out[:max_new_tokens]], dtype=torch.int32, device=dev)
    if return_stats:
        return tokens, passes, spec_passes
    return tokens, passes
