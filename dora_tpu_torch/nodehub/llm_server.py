"""LLM serving entry of the port: build the engine and answer prompts.

Counterpart of ``make_engine`` and ``main`` of dora_tpu/nodehub/llm_server.py.
``make_engine`` reads the same knobs with the same meaning
(``DORA_PAGED_KV`` (0: the dense batch engine, whose ``DORA_BATCH_SLOTS``
defaults to 4), ``DORA_BATCH_SLOTS``, ``DORA_PAGE_SIZE``, ``DORA_PREFILL_CHUNK``,
``DORA_MULTISTEP_K``, ``DORA_PREFIX_CACHE`` (on by default here),
``DORA_PREFIX_CACHE_PAGES``, ``DORA_SPEC_K``, ``DORA_SPEC_NGRAM``,
``DORA_KV_INT8`` (int8 KV pages in the fp pool's byte budget),
``DORA_LORA_DIR`` / ``DORA_LORA_MAX_RESIDENT`` / ``DORA_LORA_RANK``
(multi-tenant LoRA from a catalog of ``<tenant>.npz`` adapters)). ``main`` answers a list of token-id prompts through
``submit``/``step``; wiring it into a dataflow node waits for a port of the
node API.

Usage::

    python -m dora_tpu_torch.nodehub.llm_server --prompts prompts.json
    python -m dora_tpu_torch.nodehub.llm_server --prompts prompts.json \\
        --random-config qwen2_1_5b --max-new 128

``prompts.json`` is a JSON list of token-id lists. Weights come from the
checkpoint directory in ``DORA_HF_CHECKPOINT`` (``DORA_MAX_SEQ`` caps the
context), or are seeded random at a named config with ``--random-config``.
With a checkpoint, a stream ends at the tokenizer's end-of-turn token (the
first of :data:`EOS_NAMES` among its added tokens, as the JAX server picks
it) or at ``--max-new``; seeded random weights have no tokenizer and run to
``--max-new``. One JSON line per request goes to stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import deque


#: end-of-turn tokens a checkpoint's tokenizer may carry, in the order of
#: preference of dora_tpu/nodehub/llm_server.py's main
EOS_NAMES = ("<|im_end|>", "<|endoftext|>", "</s>", "<|eot_id|>")


def eos_token(tok) -> int | None:
    """The id of the first of :data:`EOS_NAMES` among the added tokens of
    ``tok`` (a models/tokenizer.BPETokenizer, or None: no tokenizer)."""
    if tok is None:
        return None
    return next((tok.added[name] for name in EOS_NAMES if name in tok.added), None)


def make_engine(params, cfg, eos=None, device=None, graphs: bool | None = None):
    """The serving engine from the env knobs: paged by default, the dense
    batch engine (``qwen2.make_batch_engine``, ``DORA_BATCH_SLOTS`` slots,
    default 4) with ``DORA_PAGED_KV=0``. On the paged engine the prefix
    cache is on unless ``DORA_PREFIX_CACHE=0``; ``DORA_SPEC_K`` /
    ``DORA_SPEC_NGRAM``, ``DORA_KV_INT8`` and the LoRA knobs
    (``DORA_LORA_DIR``, ``DORA_LORA_MAX_RESIDENT``, ``DORA_LORA_RANK``)
    reach it through ``make_paged_engine``. ``graphs`` reaches either
    factory: None runs the decode windows (or the dense step) as CUDA-graph
    replays on a CUDA device, False eagerly."""
    from dora_tpu_torch.models.hf import qwen2

    paged = os.environ.get("DORA_PAGED_KV", "1") != "0"
    slots = int(os.environ.get("DORA_BATCH_SLOTS", "16" if paged else "4"))
    if not paged:
        return qwen2.make_batch_engine(params, cfg, max_slots=slots, eos=eos,
                                       device=device, graphs=graphs)
    chunk_env = os.environ.get("DORA_PREFILL_CHUNK")
    return qwen2.make_paged_engine(
        params, cfg,
        max_slots=slots,
        eos=eos,
        page_size=int(os.environ.get("DORA_PAGE_SIZE", "16")),
        chunk=int(chunk_env) if chunk_env else None,
        window=int(os.environ.get("DORA_MULTISTEP_K", "8")),
        prefix_cache=os.environ.get("DORA_PREFIX_CACHE", "1") != "0",
        prefix_cache_pages=int(os.environ.get("DORA_PREFIX_CACHE_PAGES", "0")),
        device=device,
        graphs=graphs,
    )


def serve_prompts(engine, prompts, max_new: int, on_token=None, others=None,
                  adapters=None):
    """Serve every prompt to completion on either engine, admitting in
    order: a request the engine cannot admit yet waits at the head of the
    line until slots, pages and its adapter's residency free up. Returns
    {request index: tokens} and per-request time-to-first-token seconds
    (from the start of the run). ``on_token(index, token, done)`` sees every
    emission. Streams already in the engine run on beside them; ``others``
    maps each such request id to the list their tokens are appended to.
    ``adapters`` names each request's LoRA tenant (None = the base model),
    as the JAX server routes a request's ``model`` field; it reaches the
    engine only where one is set (the dense engine takes none). A submit
    that returns a token (the dense engine's synchronous first token) is
    emitted at once, as the JAX server does."""
    adapters = list(adapters) if adapters is not None else [None] * len(prompts)
    if len(adapters) != len(prompts):
        raise ValueError(f"{len(adapters)} adapters for {len(prompts)} prompts")

    def tenant(i):
        return {"adapter": adapters[i]} if adapters[i] else {}

    waiting = deque(range(len(prompts)))
    for i in waiting:
        if not engine.fits(len(prompts[i]), max_new, **tenant(i)):
            raise ValueError(f"request {i} can never fit ({len(prompts[i])}+{max_new}"
                             + (f", adapter {adapters[i]!r}" if adapters[i] else "") + ")")
    out: dict[int, list[int]] = {i: [] for i in range(len(prompts))}
    ttft: dict[int, float] = {}
    t0 = time.perf_counter()

    def emit(rid: str, token: int, done: bool) -> None:
        if others is not None and rid in others:
            others[rid].append(token)
            return
        i = int(rid)
        if not out[i]:
            ttft[i] = time.perf_counter() - t0
        out[i].append(token)
        if on_token is not None:
            on_token(i, token, done)

    while waiting or engine.active:
        while waiting and engine.can_admit(len(prompts[waiting[0]]), max_new,
                                           **tenant(waiting[0])):
            i = waiting.popleft()
            first = engine.submit(str(i), prompts[i], max_new, **tenant(i))
            if first is not None:  # dense engine: the first token is synchronous
                emit(str(i), *first)
        for rid, token, done in engine.step():
            emit(rid, token, done)
    return out, ttft


def main(argv=None) -> int:
    from dora_tpu_torch.models.hf import qwen2

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--prompts", required=True,
                    help="JSON file: a list of token-id lists")
    ap.add_argument("--max-new", type=int,
                    default=int(os.environ.get("DORA_MAX_NEW_TOKENS", "32")))
    ap.add_argument("--random-config", choices=sorted(qwen2.CONFIGS),
                    help="seeded random weights at this config (no checkpoint)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    max_seq = int(os.environ.get("DORA_MAX_SEQ", "2048"))
    eos = None
    if args.random_config:
        cfg = qwen2.CONFIGS[args.random_config](max_seq=max_seq)
        params = qwen2.random_params(cfg, seed=args.seed, device=args.device)
    else:
        from dora_tpu_torch.nodehub.ops import _hf_tokenizer

        path = os.environ.get("DORA_HF_CHECKPOINT")
        if not path:
            ap.error("set DORA_HF_CHECKPOINT or pass --random-config")
        cfg, params = qwen2.load(path, max_seq=max_seq, device=args.device)
        eos = eos_token(_hf_tokenizer(path))
    params = qwen2.quantize_decode(params, cfg)

    with open(args.prompts) as f:
        prompts = [[int(t) for t in p] for p in json.load(f)]
    engine = make_engine(params, cfg, eos=eos, device=args.device)
    out, ttft = serve_prompts(engine, prompts, args.max_new)
    for i in range(len(prompts)):
        print(json.dumps({"id": i, "ttft_s": ttft.get(i), "tokens": out[i]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
